"""The lean-scan rollout (`Simulation.run`) against a step-by-step
`Simulation.timestep` loop, in every source/stepper/model configuration the
rollout must handle: static and time-varying sources (with flat end
extrapolation, scalar series and last-wins source order), Heun,
ImplicitEuler (PCR and paired-rows Thomas), scan unrolling, chunked runs
with callbacks, and the coupled LandModel with snow and vegetation.

The scanned body and the single-step executable are separate XLA
compilations that may contract multiply-adds differently, so the comparison
is at float64 machine precision relative to each field's scale, not
bitwise.
"""
import numpy as np
import pytest

import terrarium_tpu as tt

RTOL = 1e-12  # of max(max |field|, SCALE_FLOOR)
#: Small fields formed as differences of larger fluxes (canopy water, ~1e-5
#: m) carry the rounding of those fluxes, not their own magnitude.
SCALE_FLOOR = 1e-2


def _soil(cells=6, nz=8, richards=True):
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                            nf=np.float64)
    if not richards:
        return tt.SoilModel(grid=grid)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
    return tt.SoilModel(grid=grid, soil=soil)


_INIT = {"temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
         "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.04 * z)}


def static_sources():
    return tt.initialize(
        _soil(richards=False), tt.ForwardEuler(dt=900.0), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(tt.FieldInputSource(
            fields={"surface_temperature": np.linspace(-4.0, 6.0, 6)}),)), 16, 900.0


def forcing_past_series_end():
    hours = np.arange(0.0, 5 * 3600.0, 3600.0)  # 16 steps run to 4 h past it
    ts = (5.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)
          + np.linspace(-1.0, 1.0, 6)[None, :])
    return tt.initialize(
        _soil(), tt.ForwardEuler(dt=1800.0), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(tt.TimeSeriesInputSource(
            times=hours, series={"surface_temperature": ts}),)), 16, 1800.0


def scalar_time_series():
    hours = np.arange(0.0, 6 * 3600.0, 3600.0)  # T == cells: no mis-broadcast
    ts = 5.0 + 4.0 * np.sin(2 * np.pi * hours / 86400.0)
    return tt.initialize(
        _soil(), tt.ForwardEuler(dt=900.0), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(tt.TimeSeriesInputSource(
            times=hours, series={"surface_temperature": ts}),)), 12, 900.0


def source_order_last_wins():
    hours = np.arange(0.0, 8 * 3600.0, 3600.0)
    forcing = tt.TimeSeriesInputSource(
        times=hours, series={"surface_temperature": np.full((8, 6), 2.0)})
    static = tt.FieldInputSource(fields={"surface_temperature": 7.0})
    sim = tt.initialize(
        _soil(richards=False), tt.ForwardEuler(dt=900.0), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(forcing, static))
    return sim, 8, 900.0


def heun():
    return tt.initialize(
        _soil(), tt.Heun(dt=300.0), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature(-3.0)), 12, 300.0


def implicit_pcr():
    return tt.initialize(
        _soil(), tt.ImplicitEuler(dt=3600.0, solver="pcr"), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature(-6.0)), 8, 3600.0


def implicit_rows():
    return tt.initialize(
        _soil(), tt.ImplicitEuler(dt=3600.0, solver="thomas",
                                  stack_solves="rows"), initializers=_INIT,
        boundary_conditions=tt.PrescribedSurfaceTemperature(-6.0)), 8, 3600.0


def coupled_land_snow_vegetation():
    grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=8),
                            nf=np.float64)
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(texture=tt.SoilTexture.preset("loam")),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq()))
    model = tt.LandModel(grid=grid, soil=soil,
                         vegetation=tt.VegetationCarbon.consistent_units(),
                         snow=tt.Snowpack())
    hours = np.arange(0.0, 8 * 3600.0, 3600.0)
    day = hours[:, None] / 86400.0
    ta = (np.linspace(-2.0, 12.0, 4)[None, :]
          + 6.0 * np.sin(2 * np.pi * (day - 0.3)))
    sw = 800.0 * np.maximum(0.0, np.sin(2 * np.pi * (day - 0.25))) \
        * np.ones((1, 4))
    forcing = tt.TimeSeriesInputSource(
        times=hours, series={"air_temperature": ta,
                             "surface_shortwave_down": sw})
    static = tt.FieldInputSource(fields={
        "surface_longwave_down": 330.0, "rainfall": 4.0e-8,
        "snowfall": 2.0e-8, "windspeed": 3.0, "specific_humidity": 0.006})
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=600.0),
        initializers={"temperature": 8.0, "saturation_water_ice": 0.6,
                      "snow_water_equivalent": 0.01,
                      "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5},
        input_sources=(forcing, static))
    return sim, 12, 600.0


CASES = {f.__name__: f for f in (
    static_sources, forcing_past_series_end, scalar_time_series,
    source_order_last_wins, heun, implicit_pcr, implicit_rows,
    coupled_land_snow_vegetation)}


def _assert_same(a, b):
    for name in sorted(b.prognostic):
        x, y = np.asarray(a.prognostic[name]), np.asarray(b.prognostic[name])
        assert np.all(np.isfinite(y)), name
        np.testing.assert_allclose(
            x, y, rtol=0.0, atol=RTOL * max(np.abs(y).max(), SCALE_FLOOR),
            err_msg=name)
    assert float(a.clock.time) == float(b.clock.time)
    assert int(a.clock.iteration) == int(b.clock.iteration)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lean_rollout_matches_stepwise(case):
    sim, steps, dt = CASES[case]()
    ref, _, _ = CASES[case]()
    sim.run(steps=steps, dt=dt)
    for _ in range(steps):
        ref.timestep(dt, finalize=False)
    ref.compute_auxiliary()
    _assert_same(sim.state, ref.state)


def test_static_fields_apply_once_series_every_step():
    """Sources initialize in order (the later static field wins), and a
    time series refreshes its inputs every step of the rollout."""
    sim, steps, dt = source_order_last_wins()
    np.testing.assert_array_equal(
        np.asarray(sim.state.inputs["surface_temperature"]), 7.0)
    sim.run(steps=steps, dt=dt)
    np.testing.assert_array_equal(
        np.asarray(sim.state.inputs["surface_temperature"]), 2.0)


@pytest.mark.parametrize("unroll", [2, 3])
def test_scan_unroll_matches(unroll):
    a, steps, dt = forcing_past_series_end()
    b, _, _ = forcing_past_series_end()
    b.scan_unroll = unroll
    a.run(steps=steps, dt=dt)
    b.run(steps=steps, dt=dt)
    _assert_same(b.state, a.state)


def test_chunked_run_with_callbacks_matches_one_rollout():
    a, steps, dt = forcing_past_series_end()
    b, _, _ = forcing_past_series_end()
    seen = []
    a.run(steps=steps, dt=dt)
    b.run(steps=steps, dt=dt, callbacks=[lambda s: seen.append(s.iteration)],
          callback_interval=5)
    assert seen == [5, 10, 15, 16]
    _assert_same(b.state, a.state)
