"""Differentiability tests (jax.grad replacing Enzyme).

Mirrors the reference Enzyme test battery (`test/differentiability/
soil_energy_diff.jl`, `soil_hydrology_diff.jl`): exact subgradients of the
free-water freeze curve, inverse-function-theorem checks on the
saturation<->pressure closure, hydraulic-conductivity gradients vs finite
differences, and finite gradients through full timesteps and checkpointed
rollouts (BASELINE config #5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import terrarium_tpu as tt
from terrarium_tpu.processes.soil.stratigraphy import SoilVolume
from terrarium_tpu.processes.soil.thermal import FreeWater
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn, make_step_fn


# ---------------------------------------------------------------------------
# Free-water freeze curve subgradients (reference `soil_energy_diff.jl:28-66`)
# ---------------------------------------------------------------------------
def test_freewater_liquid_fraction_gradients():
    fc = FreeWater()
    L_theta = 3.34e8 * 1.0 * 0.5

    g = jax.grad(lambda U: fc.liquid_water_fraction(U, L_theta))(-1.0e7)
    np.testing.assert_allclose(float(g), 1.0 / L_theta, rtol=1e-6)
    # L_theta == 0: gradient must be exactly zero
    g0 = jax.grad(lambda U: fc.liquid_water_fraction(U, 0.0))(-1.0e7)
    assert float(g0) == 0.0


def test_freewater_temperature_gradients():
    fc = FreeWater()
    L_theta = 3.34e8 * 0.5
    C = 2.0e5
    # frozen: dT/dU = 1/C  (note reference evaluates at U = Ltheta - 1e7 which
    # for these values is thawed; we test all three analytic regimes)
    g = jax.grad(lambda U: fc.temperature(U, L_theta, C))(-L_theta - 1.0e7)
    np.testing.assert_allclose(float(g), 1.0 / C, rtol=1e-6)
    # phase change plateau: dT/dU = 0 exactly
    g = jax.grad(lambda U: fc.temperature(U, L_theta, C))(-L_theta / 2.0)
    assert float(g) == 0.0
    # thawed: dT/dU = 1/C
    g = jax.grad(lambda U: fc.temperature(U, L_theta, C))(L_theta / 2.0)
    np.testing.assert_allclose(float(g), 1.0 / C, rtol=1e-6)


# ---------------------------------------------------------------------------
# Saturation <-> pressure closure (reference `soil_hydrology_diff.jl:23-70`)
# ---------------------------------------------------------------------------
def _swrc_derivative(swrc, psi_m, theta_sat, eps=1e-7):
    """d(theta)/d(psi) by central differences."""
    tp = float(swrc(jnp.float64(psi_m + eps), theta_sat))
    tm = float(swrc(jnp.float64(psi_m - eps), theta_sat))
    return (tp - tm) / (2 * eps)


def test_closure_inverse_function_theorem():
    por, sat = 0.5, 0.5
    swrc = tt.BrooksCorey()  # ConstantSoilHydraulics default

    # forward: psi_m(sat) — d(psi)/d(sat) = por / (dtheta/dpsi)
    def psi_of_sat(s):
        return swrc.inverse(s * por, por)

    g = float(jax.grad(psi_of_sat)(jnp.float64(sat)))
    psi_m = float(psi_of_sat(jnp.float64(sat)))
    dtheta_dpsi = _swrc_derivative(swrc, psi_m, por)
    np.testing.assert_allclose(g, por / dtheta_dpsi, rtol=1e-5)

    # inverse: sat(psi) — d(sat)/d(psi) = (dtheta/dpsi) / por
    def sat_of_psi(p):
        return swrc(p, por) / por

    g_inv = float(jax.grad(sat_of_psi)(jnp.float64(psi_m)))
    np.testing.assert_allclose(g_inv, dtheta_dpsi / por, rtol=1e-5)
    # consistency: the two gradients are reciprocal
    np.testing.assert_allclose(g * g_inv, 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# Hydraulic conductivity gradients (reference `soil_hydrology_diff.jl:72-88`)
# ---------------------------------------------------------------------------
def test_unsat_k_vangenuchten_gradients():
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=1.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())

    def eval_K(x):
        por, sat, liq = x
        return props.hydraulic_conductivity(
            SoilVolume(porosity=por, saturation=sat, liquid=liq))

    x = jnp.asarray([0.5, 0.75, 0.9])
    g = jax.grad(eval_K)(x)
    # dK/dpor ~ 0 at this point (K depends on theta_w/theta_sat = sat*liq...)
    np.testing.assert_allclose(float(g[0]), 0.0, atol=1e-8)
    # match finite differences
    eps = 1e-6
    fd = np.array([
        (float(eval_K(x.at[i].add(eps))) - float(eval_K(x.at[i].add(-eps))))
        / (2 * eps) for i in range(3)])
    np.testing.assert_allclose(np.asarray(g), fd, rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# Full-step gradients (reference `soil_energy_diff.jl:69-76`,
# `soil_hydrology_diff.jl:136-150`)
# ---------------------------------------------------------------------------
def _coupled_sim(stepper=None):
    grid = tt.ColumnGrid.of(cells=2, spacing=tt.ExponentialSpacing(N=10),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil,
                         initializer=tt.SoilInitializer())
    return tt.initialize(model, stepper or tt.ForwardEuler())


def test_grad_through_timestep():
    sim = _coupled_sim()
    step = make_step_fn(sim.model, sim.timestepper, sim.ctx, sim.input_sources)

    def loss(state):
        out = step(state, 60.0)
        return jnp.mean(out.temperature)

    grads = jax.grad(loss, allow_int=True)(sim.state)
    gT = np.asarray(grads.prognostic["internal_energy"])
    gS = np.asarray(grads.prognostic["saturation_water_ice"])
    assert np.all(np.isfinite(gT))
    assert np.all(np.isfinite(gS))
    assert np.any(gT != 0.0)


def test_grad_through_implicit_step():
    """The tridiagonal solve (lax.scan Thomas) is differentiable."""
    sim = _coupled_sim(tt.ImplicitEuler())
    step = make_step_fn(sim.model, sim.timestepper, sim.ctx, sim.input_sources)

    def loss(state):
        out = step(state, 900.0)
        return jnp.mean(out.temperature)

    grads = jax.grad(loss, allow_int=True)(sim.state)
    assert np.all(np.isfinite(np.asarray(grads.prognostic["internal_energy"])))
    assert np.all(np.isfinite(np.asarray(grads.prognostic["saturation_water_ice"])))


def test_checkpointed_rollout_gradients_match():
    """jax.checkpoint rollout gradients equal plain rollout gradients
    (replacing Checkpointing.jl Revolve, `TerrariumCheckpointingExt:16-31`)."""
    sim = _coupled_sim()
    loss_fns = {}
    for remat in (False, True):
        roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                               sim.input_sources, steps=20, remat=remat)
        loss_fns[remat] = jax.jit(
            lambda state, _roll=roll: jnp.mean(_roll(state, 60.0).temperature))
    g_plain = jax.grad(loss_fns[False], allow_int=True)(sim.state)
    g_remat = jax.grad(loss_fns[True], allow_int=True)(sim.state)
    for key in ("internal_energy", "saturation_water_ice"):
        a = np.asarray(g_plain.prognostic[key])
        b = np.asarray(g_remat.prognostic[key])
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_parameter_sensitivity():
    """Gradient of rolled-out mean temperature w.r.t. a physical parameter
    (mineral thermal conductivity) matches finite differences — the
    parameter-calibration use case of BASELINE config #5."""
    def mean_T_after(k_mineral, steps=10):
        grid = tt.ColumnGrid.of(cells=1, spacing=tt.ExponentialSpacing(N=10),
                                nf=np.float64)
        tp = tt.SoilThermalProperties(
            conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
        soil = tt.SoilEnergyWaterCarbon(
            energy=tt.SoilEnergyBalance(thermal_properties=tp),
            strat=tt.HomogeneousStratigraphy(
                porosity=tt.ConstantSoilPorosity(mineral_porosity=0.0)))
        model = tt.SoilModel(grid=grid, soil=soil)
        sim = tt.initialize(
            model, tt.ForwardEuler(),
            initializers={"temperature": 1.0, "saturation_water_ice": 0.0},
            boundary_conditions=tt.PrescribedSurfaceTemperature(5.0))
        step = make_step_fn(sim.model, sim.timestepper, sim.ctx, ())

        def body(s, _):
            return step(s, 60.0), None

        out, _ = jax.lax.scan(body, sim.state, None, length=steps)
        return jnp.mean(out.temperature[-3:])

    g = float(jax.grad(mean_T_after)(jnp.float64(3.8)))
    eps = 1e-4
    fd = (float(mean_T_after(jnp.float64(3.8 + eps)))
          - float(mean_T_after(jnp.float64(3.8 - eps)))) / (2 * eps)
    assert np.isfinite(g)
    assert g > 0  # higher conductivity -> faster warming from the warm surface
    np.testing.assert_allclose(g, fd, rtol=1e-5)


def test_grad_through_snowpack_parameter():
    """Parameter sensitivity through the snow extension: d(final SWE)/d(k_dd)
    matches finite differences through several melt steps."""
    from terrarium_tpu.timesteppers.autodiff import make_step_fn

    def final_swe(k_dd):
        grid = tt.ColumnGrid.of(cells=1, spacing=tt.ExponentialSpacing(N=8),
                                nf=np.float64)
        soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
            vertical_flow=tt.RichardsEq()))
        model = tt.LandModel(grid=grid, soil=soil,
                             snow=tt.Snowpack(degree_day_factor=k_dd))
        sim = tt.initialize(
            model, tt.ForwardEuler(),
            initializers={"temperature": 2.0, "saturation_water_ice": 0.6,
                          "snow_water_equivalent": 0.05},
            input_sources=(tt.FieldInputSource(fields={
                "air_temperature": 6.0, "snowfall": 1e-8}),))
        step = make_step_fn(sim.model, sim.timestepper, sim.ctx,
                            sim.input_sources)
        state = sim.state
        for _ in range(5):
            state = step(state, 300.0)
        return jnp.sum(state.snow_water_equivalent)

    k0 = 5.0e-3 / 86400.0
    g = float(jax.grad(final_swe)(jnp.float64(k0)))
    eps = k0 * 1e-3
    fd = float((final_swe(k0 + eps) - final_swe(k0 - eps)) / (2 * eps))
    # melting at 6 degC for 5 steps: dSWE/dk = -T_excess * t (exact while
    # the pack stays positive)
    assert np.isclose(g, -6.0 * 5 * 300.0, rtol=1e-6), g
    assert np.isclose(g, fd, rtol=1e-6), (g, fd)


def test_scanned_rollout_gradients_finite_with_frozen_saturated_cells():
    """Round-3 regression (found by bench_configs config #6): a scanned
    rollout propagates explicit ZERO cotangents through every carry leaf, so
    any Inf partial in the step turns into 0*Inf = NaN — even when the loss
    never reads that leaf (the direct, un-scanned step DCEs the path and
    hides it). Two such Inf partials existed for f32 states:

    * `VanGenuchten.inverse`'s upper clip `1 - 1e-12` rounds to 1.0 in f32,
      so saturated cells evaluated sqrt(0) (Inf VJP);
    * `UnsatKVanGenuchten` at se = 0 (fully-frozen cells: zero liquid
      water) hit d(cbrt)/dse = d(sqrt)/dse = Inf.

    The coupled model here has BOTH regimes: T=-1 C freezes the column
    (liquid fraction 0) and the deep cells start saturated (sat = 1).
    """
    grid = tt.ColumnGrid.of(cells=8, spacing=tt.ExponentialSpacing(N=10),
                            nf=np.float32)
    props = tt.ConstantSoilHydraulics(
        sat_hydraulic_cond=1e-5,
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil)
    sim = tt.initialize(
        model, tt.ForwardEuler(),
        initializers={
            "temperature": -1.0,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)},
        boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))
    assert float(np.max(np.asarray(sim.state.saturation_water_ice))) == 1.0

    def loss(state):
        roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx, (),
                               steps=4, remat=True)
        out = roll(state, 300.0)
        return jnp.mean(out.temperature) + jnp.mean(out.saturation_water_ice)

    g = jax.grad(loss, allow_int=True)(sim.state)
    for key in ("internal_energy", "saturation_water_ice"):
        assert np.all(np.isfinite(np.asarray(g.prognostic[key]))), key


@pytest.mark.slow
def test_remat_policy_variants_same_gradient():
    """All backward-pass remat schedules (per-step, sqrt-segment, policy,
    lean carry) compute the same PARAMETER gradient as the plain rollout
    (timesteppers/autodiff.py policy space). The calibration parameter (mineral thermal
    conductivity) enters only the tendencies, never the closure, so the
    lean closure-rotation is gradient-neutral for it; state-gradients wrt
    prognostics legitimately differ between lean and plain by the
    initial-step aux attribution (the lean cycle re-derives the initial
    closure vars from the prognostics)."""
    def make_loss(kw):
        def loss(k_mineral):
            grid = tt.ColumnGrid.of(cells=2,
                                    spacing=tt.ExponentialSpacing(N=10),
                                    nf=np.float64)
            tp = tt.SoilThermalProperties(
                conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
            props = tt.ConstantSoilHydraulics(
                swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
            soil = tt.SoilEnergyWaterCarbon(
                energy=tt.SoilEnergyBalance(thermal_properties=tp),
                hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                           hydraulic_properties=props))
            model = tt.SoilModel(grid=grid, soil=soil,
                                 initializer=tt.SoilInitializer())
            sim = tt.initialize(
                model, tt.ForwardEuler(),
                boundary_conditions=tt.PrescribedSurfaceTemperature(5.0))
            roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                                   sim.input_sources, steps=20, **kw)
            out = roll(sim.state, 60.0)
            return jnp.mean(out.temperature) + jnp.mean(
                out.saturation_water_ice)
        return loss

    variants = {
        "plain": dict(),
        "per_step": dict(remat=True),
        "segment4": dict(segment=4),
        "policy_dots": dict(remat=True,
                            policy=jax.checkpoint_policies.dots_saveable),
        "lean": dict(lean=True),
        "lean_remat": dict(lean=True, remat=True),
    }
    grads = {name: float(jax.jit(jax.grad(make_loss(kw)))(3.8))
             for name, kw in variants.items()}
    ref = grads["plain"]
    assert np.isfinite(ref) and abs(ref) > 0
    for name, g in grads.items():
        np.testing.assert_allclose(g, ref, rtol=1e-10, err_msg=name)
