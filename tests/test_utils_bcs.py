"""Utility + boundary-condition + stratigraphy tests.

Wires in equivalents of the reference's orphaned test files (SURVEY §4 notes
`test/utils.jl`, `test/boundary_conditions.jl`,
`test/soil/soil_composition_tests.jl` are never included by runtests.jl):
fixed versions of those checks. NOTE the orphaned `test/utils.jl` expects
``safediv(x, 0) == 0`` while the implementation returns Inf
(`src/utils/utils.jl:25`); the implementation is authoritative here.
"""
import jax.numpy as jnp
import numpy as np

import terrarium_tpu as tt
from terrarium_tpu.ops.bcs import (Dirichlet, Flux, InputRef, Neumann, NoFlux,
                                   get_bc, merge_boundary_conditions,
                                   resolve_bc_value)
from terrarium_tpu.ops.vertical_ops import (apply_flux_bcs, div_faces, ghosts,
                                            grad_faces, interp_faces_mid,
                                            interp_faces_min)
from terrarium_tpu.processes.soil.stratigraphy import (SoilTexture, SoilVolume,
                                                       volumetric_fractions)
from terrarium_tpu.utils.utils import merge_recursive, piecewise_linear, safediv


def test_safediv():
    """Implementation semantics: x/(y+eps) if y != 0 else Inf
    (reference `utils.jl:25`; the orphaned test contradicted this)."""
    assert float(safediv(1.0, 2.0)) == 1.0 / (2.0 + np.finfo(np.float64).eps)
    assert float(safediv(1.0, 0.0)) == np.inf
    assert float(safediv(-1.0, 0.0)) == np.inf  # reference returns Inf for any x


def test_piecewise_linear():
    f = piecewise_linear((0.0, 5.0), (1.0, 1.0), (10.0, 1.5))
    np.testing.assert_allclose(float(f(0.5)), 3.0)
    # flat extrapolation
    np.testing.assert_allclose(float(f(-1.0)), 5.0)
    np.testing.assert_allclose(float(f(20.0)), 1.5)


def test_merge_boundary_conditions():
    """Recursive BC merge, later precedence (reference `boundary_conditions.jl:17`)."""
    a = tt.PrescribedSurfaceTemperature(1.0)
    b = tt.GeothermalHeatFlux(0.02)
    c = {"temperature": {"bottom": Dirichlet(-5.0)}}
    merged = merge_boundary_conditions(a, b, c)
    assert isinstance(get_bc(merged, "temperature", "top"), Dirichlet)
    assert isinstance(get_bc(merged, "temperature", "bottom"), Dirichlet)
    assert isinstance(get_bc(merged, "internal_energy", "bottom"), Flux)
    # later args override
    merged2 = merge_boundary_conditions(a, tt.PrescribedSurfaceTemperature(9.0))
    assert get_bc(merged2, "temperature", "top").value == 9.0


def test_bc_value_resolution():
    grid = tt.ColumnGrid.of(cells=3, spacing=tt.UniformSpacing(N=4), nf=np.float64)
    model = tt.SoilModel(grid=grid)
    sim = tt.initialize(model, initializers={"temperature": 1.0,
                                             "saturation_water_ice": 0.5})
    st = sim.state
    np.testing.assert_allclose(np.asarray(resolve_bc_value(2.5, st)), 2.5)
    np.testing.assert_allclose(
        np.asarray(resolve_bc_value(lambda t: t + 1.0, st)), 1.0)
    np.testing.assert_allclose(
        np.asarray(resolve_bc_value("ground_temperature", st)),
        np.asarray(st.ground_temperature))
    np.testing.assert_allclose(
        np.asarray(resolve_bc_value(InputRef("ground_temperature", -2.0), st)),
        -2.0 * np.asarray(st.ground_temperature))


def test_ghost_semantics():
    """Value BC halo: ghost = 2v - c; Gradient BC: ghost = c +/- g*dzf;
    Flux/none: zero gradient (Oceananigans halo-fill semantics)."""
    c = jnp.asarray(np.arange(8.0).reshape(4, 2))
    dzf = jnp.asarray(np.full((5, 1), 0.5))
    gb, gt = ghosts(c, Dirichlet(10.0), NoFlux(), None, dzf)
    np.testing.assert_allclose(gb, 2 * 10.0 - np.asarray(c[:1]))
    np.testing.assert_allclose(gt, np.asarray(c[-1:]))
    gb, gt = ghosts(c, Neumann(2.0), Neumann(3.0), None, dzf)
    np.testing.assert_allclose(gb, np.asarray(c[:1]) - 2.0 * 0.5)
    np.testing.assert_allclose(gt, np.asarray(c[-1:]) + 3.0 * 0.5)


def test_operator_identities():
    """grad/div/interp against hand-computed stencils."""
    c = jnp.asarray([[1.0], [3.0], [6.0]])
    dzf = jnp.asarray([[1.0], [1.0], [1.0], [1.0]])
    dz = jnp.asarray([[1.0], [1.0], [1.0]])
    g = grad_faces(c, dzf)
    np.testing.assert_allclose(np.asarray(g).ravel(), [0.0, 2.0, 3.0, 0.0])
    m = interp_faces_mid(c)
    np.testing.assert_allclose(np.asarray(m).ravel(), [1.0, 2.0, 4.5, 6.0])
    mn = interp_faces_min(c)
    np.testing.assert_allclose(np.asarray(mn).ravel(), [1.0, 1.0, 3.0, 6.0])
    q = jnp.asarray([[1.0], [2.0], [4.0], [7.0]])
    d = div_faces(q, dz)
    np.testing.assert_allclose(np.asarray(d).ravel(), [1.0, 2.0, 3.0])


def test_flux_bc_tendency_signs():
    """Positive top flux removes, positive bottom flux adds (positive-up
    convention; Oceananigans `apply_z_top/bottom_bc!`)."""
    tend = jnp.zeros((3, 2))
    dz = jnp.asarray([[0.5], [0.5], [0.5]])
    bcs = {"top": Flux(2.0), "bottom": Flux(1.0)}
    out = np.asarray(apply_flux_bcs(tend, bcs, None, dz))
    np.testing.assert_allclose(out[-1], -2.0 / 0.5)
    np.testing.assert_allclose(out[0], 1.0 / 0.5)
    np.testing.assert_allclose(out[1], 0.0)


def test_soil_composition():
    """Volumetric fractions sum to one and respect phase partitioning
    (fixed equivalent of the orphaned `soil_composition_tests.jl`)."""
    vol = SoilVolume(porosity=0.4, saturation=0.5, liquid=0.5, organic=0.25,
                     texture=SoilTexture.preset("loam"))
    fr = volumetric_fractions(vol)
    total = sum(float(np.asarray(v)) for v in fr.values())
    np.testing.assert_allclose(total, 1.0, rtol=1e-12)
    np.testing.assert_allclose(fr["water"], 0.4 * 0.5 * 0.5)
    np.testing.assert_allclose(fr["ice"], 0.4 * 0.5 * 0.5)
    np.testing.assert_allclose(fr["air"], 0.4 * 0.5)
    np.testing.assert_allclose(fr["organic"], 0.6 * 0.25)
    np.testing.assert_allclose(fr["mineral"], 0.6 * 0.75)


def test_texture_presets_and_validation():
    import pytest

    for name in ("sand", "silt", "clay", "loam", "sandyloam", "clayloam"):
        tex = SoilTexture.preset(name)
        np.testing.assert_allclose(tex.sand + tex.silt + tex.clay, 1.0)
    with pytest.raises(ValueError):
        SoilTexture(sand=0.9, clay=0.9, silt=0.9)


def test_stratigraphy_porosity_mix():
    """Bulk porosity = (1-organic)*por_m + organic*por_o with organic fraction
    from SOC density (reference `homogeneous_strat.jl:34-61`)."""
    strat = tt.HomogeneousStratigraphy(
        porosity=tt.ConstantSoilPorosity(mineral_porosity=0.4,
                                         organic_porosity=0.8))
    bgc = tt.ConstantSoilCarbonDensity(rho_soc=65.0, rho_org=1300.0)
    organic = strat.organic_fraction(bgc, None, None)
    np.testing.assert_allclose(organic, 65.0 / ((1 - 0.8) * 1300.0))
    por = strat.bulk_porosity(bgc, None, None)
    np.testing.assert_allclose(por, (1 - organic) * 0.4 + organic * 0.8)


def test_cummin_cumsum_variants_exact():
    """All cummin_z implementations/radices are bit-identical to numpy's
    sequential accumulate (min is exact under reordering); cumsum_z matches
    numpy at f32. The variants are perf knobs only (docs/performance.md)."""
    import jax.numpy as jnp

    from terrarium_tpu.ops import vertical_ops as V

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((30, 13)).astype(np.float32))
    fwd = np.minimum.accumulate(np.asarray(x), axis=0)
    rev = np.minimum.accumulate(np.asarray(x)[::-1], axis=0)[::-1]
    impl0, radix0 = V.CUMMIN_IMPL, V.CUMMIN_RADIX
    try:
        for impl, radix in (("hs", 2), ("dot", 2), ("pad", 2), ("pad", 4),
                            ("pad", 8), ("pad", 32)):
            V.CUMMIN_IMPL, V.CUMMIN_RADIX = impl, radix
            assert np.array_equal(np.asarray(V.cummin_z(x)), fwd), (impl, radix)
            assert np.array_equal(np.asarray(V.cummin_z(x, reverse=True)),
                                  rev), (impl, radix)
    finally:
        V.CUMMIN_IMPL, V.CUMMIN_RADIX = impl0, radix0

    # different summation order than sequential numpy: compare with an
    # absolute tolerance scaled to the running-sum magnitude (relative
    # tolerance blows up where sums cross zero)
    s = np.asarray(V.cumsum_z(x))
    np.testing.assert_allclose(s, np.cumsum(np.asarray(x), axis=0), atol=1e-5)
    s2 = np.asarray(V.cumsum_z(x, reverse=True))
    np.testing.assert_allclose(
        s2, np.cumsum(np.asarray(x)[::-1], axis=0)[::-1], atol=1e-5)


def test_input_variable_bc_drives_physics():
    """A Dirichlet BC referencing an input variable by name (reference
    `getbc` Variable-placeholder semantics, `boundary_conditions.jl:25-28`)
    must read the forcing value each step — not a stale zero. A warm
    constant forcing must pull the top soil layer toward it."""
    import terrarium_tpu as tt

    grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=10),
                            nf=np.float64)
    model = tt.SoilModel(grid=grid)
    hours = np.arange(0.0, 3 * 86400.0, 3600.0)
    ts = np.full((hours.size, 4), 10.0)
    forcing = tt.TimeSeriesInputSource(times=hours,
                                       series={"surface_temperature": ts})
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=300.0),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(forcing,))
    sim.run(steps=288, dt=300.0)
    top = np.asarray(sim.state.temperature)[-1]
    assert np.all(top > 5.0), top  # warming toward the 10 degC forcing
    assert np.all(top < 10.0 + 1e-6), top


def test_bc_callable_arity_dispatch():
    """f(t) vs f(t, state) dispatch counts only REQUIRED positional params:
    defaulted/keyword-only/**kwargs parameters must not flip the form."""
    import types

    import jax.numpy as jnp

    from terrarium_tpu.ops.bcs import resolve_bc_value

    state = types.SimpleNamespace(
        clock=types.SimpleNamespace(time=jnp.asarray(100.0)),
        inputs={})

    assert float(resolve_bc_value(lambda t: t * 2.0, state)) == 200.0
    # defaulted second parameter: still the f(t) form
    assert float(resolve_bc_value(
        lambda t, amplitude=5.0: amplitude + 0.0 * t, state)) == 5.0
    # keyword-only and **kwargs: still f(t)
    assert float(resolve_bc_value(
        lambda t, *, tz=0.0: t + tz, state)) == 100.0
    assert float(resolve_bc_value(
        lambda t, **kw: t, state)) == 100.0
    # two required positional params: the f(t, state) form
    assert float(resolve_bc_value(
        lambda t, st: t + st.clock.time, state)) == 200.0


def test_fast_pow_shortcuts_and_fallback():
    """`ops/fastpow.fast_pow`: algebraic shortcuts for small-rational static
    exponents agree with the pow lowering to float rounding; irrational
    exponents fall back to `**` exactly."""
    import jax.numpy as jnp

    from terrarium_tpu.ops import fastpow

    x = jnp.asarray(np.abs(np.random.default_rng(3).normal(size=500)) + 1e-3)
    for p in (2.0, 3.0, -1.0, -2.0, 0.5, -0.5, 1.5, -1.5, 2.0 / 3.0,
              -1.0 / 3.0, 7.0 / 2.0, 11.0 / 3.0, 0.0, 1.0):
        np.testing.assert_allclose(np.asarray(fastpow.fast_pow(x, p)),
                                   np.asarray(x) ** p, rtol=1e-12,
                                   err_msg=f"p={p}")
    # non-rational exponent: exact fallback
    p = 0.3517
    np.testing.assert_array_equal(np.asarray(fastpow.fast_pow(x, p)),
                                  np.asarray(x ** p))
