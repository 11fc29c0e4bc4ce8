"""Implicit tridiagonal stepper tests (new capability vs reference;
BASELINE config #2).

Validated against: exact tridiagonal algebra, the erfc analytic solution at a
timestep far beyond the explicit stability limit, explicit small-dt runs
(incl. phase change), and Richards mass conservation.
"""
import jax.numpy as jnp
import numpy as np
from scipy.special import erfc

import terrarium_tpu as tt
from terrarium_tpu.ops.tridiag import tridiag_solve, tridiag_solve_pcr


def test_tridiag_solver_matches_dense(rng):
    nz, cells = 17, 5
    a = rng.uniform(0.1, 1.0, (nz, cells))
    c = rng.uniform(0.1, 1.0, (nz, cells))
    b = 2.0 + a + c  # diagonally dominant
    d = rng.normal(size=(nz, cells))
    x = np.asarray(tridiag_solve(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                                 jnp.asarray(d)))
    for j in range(cells):
        M = np.diag(b[:, j]) + np.diag(a[1:, j], -1) + np.diag(c[:-1, j], 1)
        np.testing.assert_allclose(x[:, j], np.linalg.solve(M, d[:, j]),
                                   rtol=1e-10)


def test_tridiag_pcr_matches_thomas(rng):
    """Parallel cyclic reduction == Thomas scan on diagonally-dominant
    systems (incl. non-power-of-two Nz)."""
    for nz in (2, 7, 30, 33):
        cells = 9
        a = rng.uniform(-1.0, 0.0, (nz, cells))
        c = rng.uniform(-1.0, 0.0, (nz, cells))
        b = 2.5 + rng.uniform(0.0, 1.0, (nz, cells))
        d = rng.normal(size=(nz, cells))
        x1 = np.asarray(tridiag_solve(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(c), jnp.asarray(d)))
        x2 = np.asarray(tridiag_solve_pcr(jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(c), jnp.asarray(d)))
        np.testing.assert_allclose(x2, x1, rtol=1e-10, atol=1e-12)


def _solid_medium_model(spacing, k=2.0, c=1.0e6, cells=1):
    grid = tt.ColumnGrid.of(cells=cells, spacing=spacing, nf=np.float64)
    strat = tt.HomogeneousStratigraphy(
        porosity=tt.ConstantSoilPorosity(mineral_porosity=0.0))
    tp = tt.SoilThermalProperties(
        conductivities=tt.SoilThermalConductivities(mineral=k),
        heat_capacities=tt.SoilHeatCapacities(mineral=c))
    soil = tt.SoilEnergyWaterCarbon(
        strat=strat, energy=tt.SoilEnergyBalance(thermal_properties=tp))
    return tt.SoilModel(grid=grid, soil=soil)


def test_implicit_heat_step_response_large_dt():
    """erfc step response with dt = 600 s where the explicit limit for the
    1 cm top cell is dz^2/(2*alpha) ~ 26 s: the implicit solve must stay
    stable and accurate."""
    T0, T1 = 1.0, 2.0
    k, c = 3.8, 2.0e6
    alpha = k / c
    spacing = tt.ExponentialSpacing(dz_min=0.01, dz_max=100.0, N=100)
    model = _solid_medium_model(spacing, k=k, c=c)
    sim = tt.initialize(model, tt.ImplicitEuler(),
                        initializers={"temperature": T0,
                                      "saturation_water_ice": 0.0},
                        boundary_conditions=tt.PrescribedSurfaceTemperature(T1))
    dt = 600.0
    t_end = 24 * 3600.0
    sim.run(steps=int(t_end / dt), dt=dt)
    z_depth = -model.grid.vertical.z_centers
    target = T0 + (T1 - T0) * erfc(z_depth / (2 * np.sqrt(alpha * t_end)))
    Ts = np.asarray(sim.state.temperature[:, 0])
    assert np.all(np.isfinite(Ts))
    rel_err = np.abs((Ts - target) / target)
    # first-order in time at 60x the explicit limit: still < 1% everywhere
    assert np.max(rel_err) < 1.0e-2, np.max(rel_err)


def test_implicit_matches_explicit_with_phase_change():
    """Freeze-front propagation: implicit at dt=300 s vs explicit at dt=30 s
    must agree closely (saturated soil, -10 degC surface)."""
    spacing = tt.ExponentialSpacing(dz_min=0.05, dz_max=10.0, N=40)

    def build(stepper):
        grid = tt.ColumnGrid.of(cells=1, spacing=spacing, nf=np.float64)
        model = tt.SoilModel(grid=grid)
        return tt.initialize(
            model, stepper,
            initializers={"temperature": 1.0, "saturation_water_ice": 1.0},
            boundary_conditions=tt.PrescribedSurfaceTemperature(-10.0))

    t_end = 2 * 86400.0
    sim_i = build(tt.ImplicitEuler()).run(steps=int(t_end / 300.0), dt=300.0)
    sim_e = build(tt.ForwardEuler()).run(steps=int(t_end / 30.0), dt=30.0)
    Ti = np.asarray(sim_i.state.temperature[:, 0])
    Te = np.asarray(sim_e.state.temperature[:, 0])
    liq_i = np.asarray(sim_i.state.liquid_water_fraction[:, 0])
    liq_e = np.asarray(sim_e.state.liquid_water_fraction[:, 0])
    assert np.all(np.isfinite(Ti))
    # the freeze front (where liq transitions) must coincide within one cell
    assert abs(int(np.argmin(liq_i > 0.5)) - int(np.argmin(liq_e > 0.5))) <= 1
    np.testing.assert_allclose(Ti, Te, atol=0.25)
    # energy conservation: implicit flux-form must conserve sum(U*dz) up to
    # boundary fluxes — compare total energy change against explicit run
    dz = np.asarray(sim_i.model.grid.vertical.dz)
    Ui = np.asarray(sim_i.state.internal_energy[:, 0])
    Ue = np.asarray(sim_e.state.internal_energy[:, 0])
    assert abs(np.sum((Ui - Ue) * dz)) / abs(np.sum(Ue * dz)) < 0.05


def test_implicit_richards_mass_conservation():
    """Variably-saturated Richards with the implicit stepper: saturation
    stays in [0, 1] and total water (incl. surface excess) is conserved."""
    grid = tt.ColumnGrid.of(cells=1, spacing=tt.UniformSpacing(dz=0.1, N=100),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    hydrology = tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                 hydraulic_properties=props)
    soil = tt.SoilEnergyWaterCarbon(hydrology=hydrology)
    model = tt.SoilModel(grid=grid, soil=soil)
    sim = tt.initialize(
        model, tt.ImplicitEuler(),
        initializers={"temperature": 1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.1 * z)})
    dz = np.asarray(grid.vertical.dz)[:, None]
    total0 = np.sum(np.asarray(sim.state.saturation_water_ice) * dz)
    sim.run(steps=24, dt=900.0)  # 6 hours at dt = 900 s
    sat = np.asarray(sim.state.saturation_water_ice)
    assert np.all(np.isfinite(sat))
    assert np.all((0 <= sat) & (sat <= 1))
    total1 = np.sum(sat * dz) + float(np.sum(np.asarray(sim.state.surface_excess_water)))
    np.testing.assert_allclose(total1, total0, rtol=1e-9)


def test_implicit_land_model():
    """ImplicitEuler drives the coupled LandModel (heat + Richards implicit,
    everything else explicit) stably at dt = 900 s."""
    grid = tt.ColumnGrid.of(cells=2, spacing=tt.ExponentialSpacing(N=15),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten(), sat_hydraulic_cond=1e-6)
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(
            texture=tt.SoilTexture.preset("loam")),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=props))
    model = tt.LandModel(
        grid=grid, soil=soil,
        surface_energy_balance=tt.SurfaceEnergyBalance.consistent(),
        surface_hydrology=tt.SurfaceHydrology(
            evapotranspiration=tt.BareGroundEvaporation.consistent_units()))
    sim = tt.initialize(
        model, tt.ImplicitEuler(),
        initializers={"temperature": 8.0, "saturation_water_ice": 0.7},
        input_sources=(tt.FieldInputSource(fields={
            "surface_shortwave_down": 400.0, "air_temperature": 12.0,
            "rainfall": 5.0e-8, "windspeed": 1.0}),))
    sim.run(steps=96, dt=900.0)  # one day
    st = sim.state
    for name in ("temperature", "saturation_water_ice", "skin_temperature",
                 "ground_heat_flux"):
        assert np.all(np.isfinite(np.asarray(st[name]))), name
    sat = np.asarray(st.saturation_water_ice)
    assert np.all((0.0 <= sat) & (sat <= 1.0))


def test_stacked_solve_matches_sequential():
    """stack_solves=True (one batched PCR over heat+Richards) matches
    per-variable solves to machine precision (independent columns; bitwise
    differences are only XLA FMA contraction choices)."""
    def run(stack):
        grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=16),
                                nf=np.float64)
        props = tt.ConstantSoilHydraulics(
            swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
        soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
            vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
        model = tt.SoilModel(grid=grid, soil=soil)
        sim = tt.initialize(
            model, tt.ImplicitEuler(solver="pcr", stack_solves=stack),
            initializers={"temperature": 2.0,
                          "saturation_water_ice":
                              lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
            boundary_conditions=tt.PrescribedSurfaceTemperature(8.0))
        sim.run(steps=10, dt=900.0)
        return sim.state

    a = run(True)
    b = run(False)
    # mathematically identical; bit-level differences are XLA FMA/
    # vectorization choices that vary with the array width
    np.testing.assert_allclose(np.asarray(a.temperature),
                               np.asarray(b.temperature),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a.saturation_water_ice),
                               np.asarray(b.saturation_water_ice),
                               rtol=1e-12, atol=1e-14)


def test_tridiag_pair_rows_matches_independent(rng):
    """`tridiag_solve_pair_rows` (heat+Richards rows packed into (2, cells)
    sweep ops) solves both systems identically to independent solves."""
    from terrarium_tpu.ops.tridiag import tridiag_solve_pair_rows

    nz, cells = 30, 8

    def system():
        a = rng.uniform(0.1, 1.0, (nz, cells))
        c = rng.uniform(0.1, 1.0, (nz, cells))
        b = 2.0 + a + c
        d = rng.normal(size=(nz, cells))
        return tuple(jnp.asarray(v) for v in (a, b, c, d))

    A, B = system(), system()
    xa, xb = tridiag_solve_pair_rows(A, B)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(tridiag_solve(*A)),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(xb), np.asarray(tridiag_solve(*B)),
                               rtol=1e-12)


def test_implicit_stack_rows_matches_default():
    """ImplicitEuler(stack_solves="rows") reproduces the independent-solve
    stepper on a coupled heat+Richards column batch."""
    grid = tt.ColumnGrid.of(cells=24, spacing=tt.ExponentialSpacing(N=12),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil)

    def run(stack):
        sim = tt.initialize(
            model, tt.ImplicitEuler(dt=3600.0, solver="thomas",
                                    stack_solves=stack),
            initializers={"temperature": 2.0,
                          "saturation_water_ice":
                              lambda x, z: np.minimum(1.0, 0.6 - 0.03 * z)},
            boundary_conditions=tt.PrescribedSurfaceTemperature(-5.0))
        sim.run(steps=6, dt=3600.0)
        return sim.state

    s_ref, s_rows = run(False), run("rows")
    for name in ("internal_energy", "saturation_water_ice"):
        np.testing.assert_allclose(
            np.asarray(s_rows.prognostic[name]),
            np.asarray(s_ref.prognostic[name]), rtol=1e-10, err_msg=name)
