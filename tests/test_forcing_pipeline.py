"""Chunked forcing pipeline tests (SURVEY hard part #5)."""
import numpy as np
import pytest

import terrarium_tpu as tt
from terrarium_tpu.io.forcing_pipeline import ChunkedForcingPipeline


def _build(sources):
    grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=10),
                            nf=np.float64)
    model = tt.SoilModel(grid=grid)
    return tt.initialize(
        model, tt.ForwardEuler(),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temp"),
        input_sources=sources)


def test_chunked_pipeline_matches_monolithic(rng):
    """Streaming the forcing in small windows must reproduce the monolithic
    (all-in-memory) time-series source exactly."""
    T = 40
    times = np.arange(T) * 1800.0  # half-hourly
    surface_temp = 5.0 * np.sin(2 * np.pi * times / 86400.0)[:, None] \
        + rng.normal(0, 0.5, (T, 4))

    steps, dt = 96, 300.0

    # monolithic reference
    mono = tt.TimeSeriesInputSource(times=times,
                                    series={"surface_temp": surface_temp})
    sim_a = _build((mono,))
    sim_a.run(steps=steps, dt=dt)

    # chunked: window of 8 slices
    pipeline = ChunkedForcingPipeline(times, {"surface_temp": surface_temp},
                                      window=8)
    sim_b = _build((mono,))  # declares the input variable; values streamed
    pipeline.run(sim_b, steps=steps, dt=dt)

    np.testing.assert_allclose(np.asarray(sim_b.state.temperature),
                               np.asarray(sim_a.state.temperature),
                               rtol=1e-12)
    assert sim_b.iteration == sim_a.iteration


def test_pipeline_single_compilation(rng):
    """All windows share one compiled executable (the window is a traced
    argument, not a baked constant)."""
    T = 64
    times = np.arange(T) * 600.0
    vals = rng.normal(0, 1, (T, 4))
    pipeline = ChunkedForcingPipeline(times, {"surface_temp": vals}, window=8)
    mono = tt.TimeSeriesInputSource(times=times, series={"surface_temp": vals})
    sim = _build((mono,))
    import jax

    before = sim.state
    pipeline.run(sim, steps=60, dt=600.0)
    assert np.all(np.isfinite(np.asarray(sim.state.temperature)))
    assert float(sim.state.clock.time) == 60 * 600.0


def test_run_fused_streamed_matches_full_series():
    """Streaming hourly float32 forcing through `ChunkedForcingPipeline.run`
    must match the lean-scan rollout holding the FULL series device-resident.
    Chunks cross window boundaries and the series end (flat
    extrapolation)."""
    cells, nz = 24, 6
    hours = np.arange(0.0, 40 * 3600.0, 3600.0)
    rng = np.random.default_rng(11)
    ts = (4.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)
          + rng.normal(0, 0.5, (hours.size, cells))).astype(np.float32)

    def build(sources):
        grid = tt.ColumnGrid.of(cells=cells,
                                spacing=tt.ExponentialSpacing(N=nz),
                                nf=np.float32)
        model = tt.SoilModel(grid=grid)
        return tt.initialize(
            model, tt.ForwardEuler(dt=900.0),
            initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
            boundary_conditions=tt.PrescribedSurfaceTemperature(
                "surface_temperature"),
            input_sources=sources)

    steps = 144  # 36 h: several chunks + extrapolation past hour 39
    full = tt.TimeSeriesInputSource(times=hours,
                                    series={"surface_temperature": ts})
    sim_ref = build((full,))
    sim_ref.run(steps=steps, dt=900.0)

    pipe = ChunkedForcingPipeline(times=hours,
                                  series={"surface_temperature": ts},
                                  window=8)
    sim_f = build((pipe,))
    pipe.run(sim_f, steps=steps, dt=900.0)

    np.testing.assert_allclose(
        np.asarray(sim_f.state.prognostic["internal_energy"]),
        np.asarray(sim_ref.state.prognostic["internal_energy"]),
        rtol=3e-5, atol=1e-5)
    assert float(sim_f.state.clock.time) == float(sim_ref.state.clock.time)


def test_run_fused_lazy_series_provider():
    """Series values may be callables (lazy providers) so a multi-GB year
    never materializes on host; results identical to the array form."""
    cells, nz = 16, 5
    hours = np.arange(0.0, 24 * 3600.0, 3600.0)
    base = (3.0 * np.cos(2 * np.pi * hours[:, None] / 86400.0)
            * np.ones((1, cells))).astype(np.float32)

    def provider(i0, i1):
        return base[i0:i1]

    def build(pipe):
        grid = tt.ColumnGrid.of(cells=cells,
                                spacing=tt.ExponentialSpacing(N=nz),
                                nf=np.float32)
        model = tt.SoilModel(grid=grid)
        return tt.initialize(
            model, tt.ForwardEuler(dt=1800.0),
            initializers={"temperature": 0.5, "saturation_water_ice": 0.5},
            boundary_conditions=tt.PrescribedSurfaceTemperature(
                "surface_temperature"),
            input_sources=(pipe,))

    out = {}
    for key, series in (("lazy", {"surface_temperature": provider}),
                        ("array", {"surface_temperature": base})):
        pipe = ChunkedForcingPipeline(times=hours, series=series, window=6)
        sim = build(pipe)
        pipe.run(sim, steps=32, dt=1800.0)
        out[key] = np.asarray(sim.state.prognostic["internal_energy"])
    np.testing.assert_array_equal(out["lazy"], out["array"])


def test_run_fused_multi_variable_and_static_sources():
    """`run` with TWO streamed series variables plus a static source (the
    coupled-forcing shape): matches the device-resident reference."""
    cells, nz = 16, 6
    hours = np.arange(0.0, 30 * 3600.0, 3600.0)
    rng = np.random.default_rng(23)
    ta = (5.0 + 3.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)
          + rng.normal(0, 0.3, (hours.size, cells))).astype(np.float32)
    tb = (2.0 + 0.5 * np.sin(2 * np.pi * hours[:, None] / (5 * 86400.0))
          + rng.normal(0, 0.1, (hours.size, cells))).astype(np.float32)

    def build(sources):
        grid = tt.ColumnGrid.of(cells=cells,
                                spacing=tt.ExponentialSpacing(N=nz),
                                nf=np.float32)
        model = tt.SoilModel(grid=grid)
        bcs = tt.merge_boundary_conditions(
            tt.PrescribedSurfaceTemperature("surface_temperature"),
            tt.PrescribedBottomTemperature("bottom_temperature"))
        return tt.initialize(
            model, tt.ForwardEuler(dt=1800.0),
            initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
            boundary_conditions=bcs,
            input_sources=sources)

    steps = 48
    series = {"surface_temperature": ta, "bottom_temperature": tb}
    full = tt.TimeSeriesInputSource(times=hours, series=series)
    sim_ref = build((full,))
    sim_ref.run(steps=steps, dt=1800.0)

    pipe = ChunkedForcingPipeline(times=hours, series=series, window=8)
    sim_f = build((pipe,))
    pipe.run(sim_f, steps=steps, dt=1800.0)

    np.testing.assert_allclose(
        np.asarray(sim_f.state.prognostic["internal_energy"]),
        np.asarray(sim_ref.state.prognostic["internal_energy"]),
        rtol=3e-5, atol=1e-5)


def test_run_fused_coupled_land_model():
    """Streamed forcing through the COUPLED LandModel: the production
    composition of io/forcing_pipeline with the BASELINE #4 model family."""
    cells, nz = 24, 6
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=nz),
                            nf=np.float32)
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(
            texture=tt.SoilTexture.preset("loam")),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq()))
    model = tt.LandModel(grid=grid,
                         vegetation=tt.VegetationCarbon.consistent_units(),
                         soil=soil)
    hours = np.arange(0.0, 30 * 3600.0, 3600.0)
    day = hours / 86400.0
    sw = (600.0 * np.maximum(0.0, np.sin(2 * np.pi * (day[:, None] - 0.25)))
          * np.ones((1, cells))).astype(np.float32)
    ta = ((10.0 + 5.0 * np.sin(2 * np.pi * (day[:, None] - 0.3)))
          * np.ones((1, cells))).astype(np.float32)
    series = {"surface_shortwave_down": sw, "air_temperature": ta}
    static = tt.FieldInputSource(fields={"surface_longwave_down": 330.0,
                                         "rainfall": 4.0e-8,
                                         "windspeed": 3.0,
                                         "specific_humidity": 0.006})

    def build(sources):
        return tt.initialize(
            model, tt.ForwardEuler(dt=1800.0),
            initializers={"temperature": 8.0, "saturation_water_ice": 0.6,
                          "carbon_vegetation": 2.0,
                          "vegetation_area_fraction": 0.5},
            input_sources=sources)

    steps = 32
    full = tt.TimeSeriesInputSource(times=hours, series=series)
    sim_ref = build((full, static))
    sim_ref.run(steps=steps, dt=1800.0)

    pipe = ChunkedForcingPipeline(times=hours, series=series, window=8)
    sim_f = build((pipe, static))
    pipe.run(sim_f, steps=steps, dt=1800.0)

    for name in ("internal_energy", "saturation_water_ice",
                 "carbon_vegetation"):
        np.testing.assert_allclose(
            np.asarray(sim_f.state.prognostic[name]),
            np.asarray(sim_ref.state.prognostic[name]),
            rtol=5e-5, atol=1e-6, err_msg=name)
