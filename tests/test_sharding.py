"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The reference has no distributed execution (SURVEY §2.11); these validate the
strategy: cells sharded over the mesh, z local, step collective-
free, results identical to single-device execution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import terrarium_tpu as tt
from terrarium_tpu.parallel.sharding import (cell_mesh, shard_sources,
                                             shard_state, state_shardings)
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _flagship(cells):
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=10),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil)
    return tt.initialize(
        model, tt.ForwardEuler(),
        initializers={
            "temperature": lambda x, z: 1.0 + np.sin(2 * np.pi * x) + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature(5.0))


def test_sharded_rollout_matches_single_device():
    """Sharded execution must be bit-identical to single-device execution
    (per-column physics has no lateral dependencies)."""
    cells = 64
    sim = _flagship(cells)
    roll = jax.jit(make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                                   sim.input_sources, steps=10))

    out_single = roll(sim.state, 300.0)

    mesh = cell_mesh()
    state_sharded = shard_state(sim.state, mesh)
    out_sharded = roll(state_sharded, 300.0)

    for name in ("internal_energy", "saturation_water_ice"):
        a = np.asarray(out_single.prognostic[name])
        b = np.asarray(out_sharded.prognostic[name])
        np.testing.assert_array_equal(a, b)


def test_output_stays_sharded():
    """The step keeps the cells axis sharded (no implicit regather)."""
    sim = _flagship(64)
    mesh = cell_mesh()
    state = shard_state(sim.state, mesh)
    roll = jax.jit(make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                                   sim.input_sources, steps=3))
    out = roll(state, 300.0)
    sh = out.prognostic["internal_energy"].sharding
    expected = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "cells"))
    assert sh.is_equivalent_to(expected, ndim=2), sh


def test_ring_grid_padding_divides_mesh():
    ring = tt.full_gaussian_grid(4)
    rng = np.random.default_rng(0)
    mask = rng.random(ring.shape) > 0.5
    grid = tt.ColumnRingGrid.create(ring, mask, spacing=tt.UniformSpacing(N=4),
                                    pad_multiple=8)
    assert grid.cells % 8 == 0
    model = tt.SoilModel(grid=grid)
    sim = tt.initialize(model, tt.ForwardEuler(),
                        initializers={"temperature": 1.0,
                                      "saturation_water_ice": 0.5})
    state = shard_state(sim.state, cell_mesh())
    sim.state = state
    sim.run(steps=5, dt=300.0)
    assert np.all(np.isfinite(np.asarray(sim.state.temperature)))


def test_global_diagnostic_collective():
    """Global means over sharded cells work via standard XLA collectives
    (the only communication this model family needs, SURVEY §2.11)."""
    sim = _flagship(64)
    state = shard_state(sim.state, cell_mesh())

    @jax.jit
    def global_mean_T(state):
        return jnp.mean(state.temperature)

    np.testing.assert_allclose(float(global_mean_T(state)),
                               float(np.mean(np.asarray(sim.state.temperature))))


def _coupled_land(cells):
    """Full coupled LandModel: snow + SEB + vegetation + Richards soil +
    DirectSurfaceRunoff + time-varying forcing (VERDICT r2 item 5: the
    config where a stray gather/replication would hide)."""
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=8),
                            nf=np.float64)
    soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq()))
    model = tt.LandModel(grid=grid, soil=soil,
                         vegetation=tt.VegetationCarbon(),
                         snow=tt.Snowpack())
    times = np.arange(0.0, 86401.0, 21600.0)
    per_cell = np.linspace(-12.0, 18.0, cells)[None, :]
    ta = per_cell + 8.0 * np.sin(2 * np.pi * times / 86400.0)[:, None]
    sw = np.maximum(0.0, 600.0 * np.sin(2 * np.pi * times / 86400.0))[:, None] \
        * np.ones((1, cells))
    forcing = tt.TimeSeriesInputSource(
        times=times, series={"air_temperature": ta,
                             "surface_shortwave_down": sw})
    static = tt.FieldInputSource(fields={"surface_longwave_down": 320.0,
                                         "rainfall": 4.0e-8,
                                         "windspeed": 3.0})
    return tt.initialize(
        model, tt.ForwardEuler(),
        initializers={"temperature": 2.0, "saturation_water_ice": 0.6,
                      "snow_water_equivalent": 0.01},
        input_sources=(forcing, static))


@pytest.mark.slow
def test_sharded_coupled_land_model_bit_identical():
    """The coupled LandModel steps bit-identically on the 8-device mesh, and
    the compiled sharded rollout contains NO cross-device communication
    (collective-free step, SURVEY §2.11)."""
    cells = 64
    sim = _coupled_land(cells)

    def roll_fn(state, sources):
        ts, model_, ctx = sim.timestepper, sim.model, sim.ctx
        for _ in range(6):
            state = ts.step(model_, state, ctx, sources, 900.0)
        return state

    roll = jax.jit(roll_fn)
    out_single = roll(sim.state, sim.input_sources)

    mesh = cell_mesh()
    state_sharded = shard_state(sim.state, mesh)
    sources_sharded = shard_sources(sim.input_sources, cells, mesh)
    out_sharded = roll(state_sharded, sources_sharded)

    for name in ("internal_energy", "saturation_water_ice", "canopy_water",
                 "carbon_vegetation", "snow_water_equivalent",
                 "skin_temperature", "vegetation_area_fraction"):
        a = np.asarray(out_single.prognostic[name])
        b = np.asarray(out_sharded.prognostic[name])
        np.testing.assert_array_equal(a, b, err_msg=name)
    # prognostics stay sharded on cells
    sh = out_sharded.prognostic["internal_energy"].sharding
    expected = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "cells"))
    assert sh.is_equivalent_to(expected, ndim=2), sh

    # no resharding/communication in the compiled HLO: per-column physics
    # must lower without any collective or gather ops
    hlo = roll.lower(state_sharded, sources_sharded).compile().as_text()
    for op in ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter"):
        assert op not in hlo, f"unexpected {op} in sharded LandModel HLO"


def test_sharded_time_varying_forcing():
    """(T, cells) forcing series shard on the cells axis like every field
    (SURVEY §2.11: 'forcing ingestion sharded'); time interpolation inside
    the step is elementwise over cells, so the sharded run is bit-identical
    and collective-free."""
    cells = 64
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=8),
                            nf=np.float64)
    model = tt.SoilModel(grid=grid)
    times = np.arange(0.0, 86400.0 + 1, 21600.0)
    per_cell = np.linspace(-5.0, 15.0, cells)[None, :]
    series = per_cell + 8.0 * np.sin(2 * np.pi * times / 86400.0)[:, None]
    src = tt.TimeSeriesInputSource(times=times,
                                   series={"air_temperature": series})
    sim = tt.initialize(
        model, tt.ForwardEuler(),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
        boundary_conditions=tt.PrescribedSurfaceTemperature("air_temperature"),
        input_sources=(src,))

    def roll_fn(state, sources):
        ts, model_, ctx = sim.timestepper, sim.model, sim.ctx
        for _ in range(8):
            state = ts.step(model_, state, ctx, sources, 3600.0)
        return state

    roll = jax.jit(roll_fn)
    out_single = roll(sim.state, sim.input_sources)

    mesh = cell_mesh()
    state_sharded = shard_state(sim.state, mesh)
    sources_sharded = shard_sources(sim.input_sources, cells, mesh)
    # the (T, cells) series really is sharded on its trailing axis
    leaf = sources_sharded[0].series["air_temperature"]
    assert leaf.sharding.spec == jax.sharding.PartitionSpec(None, "cells")
    out_sharded = roll(state_sharded, sources_sharded)

    np.testing.assert_array_equal(
        np.asarray(out_single.prognostic["internal_energy"]),
        np.asarray(out_sharded.prognostic["internal_energy"]))
    # forcing actually varied in time and space
    T = np.asarray(out_sharded.inputs["air_temperature"])
    assert T.std() > 1.0


@pytest.mark.parametrize("series", ["scalar_T", "per_cell_T_cells"])
def test_sharded_simulation_run_with_time_series(series):
    """`Simulation.run` (the lean-scan rollout) on a cells-sharded state with
    sharded forcing: a (T,) series replicates — its only axis is time, even
    when T == cells — and a (T, cells) series shards on cells. The result
    matches the unsharded run, stays cells-sharded, and the compiled rollout
    holds no collective."""
    from terrarium_tpu.timesteppers.integrator import _split_sources

    cells, steps = 16, 16
    hours = np.arange(0.0, 16 * 3600.0, 3600.0)  # T == cells
    wave = 5.0 + 4.0 * np.sin(2 * np.pi * hours / 86400.0)
    values = (wave if series == "scalar_T"
              else wave[:, None] + np.linspace(-3.0, 3.0, cells)[None, :])

    def build():
        grid = tt.ColumnGrid.of(cells=cells,
                                spacing=tt.ExponentialSpacing(N=8),
                                nf=np.float64)
        return tt.initialize(
            tt.SoilModel(grid=grid), tt.ForwardEuler(dt=900.0),
            initializers={"temperature": 1.0, "saturation_water_ice": 0.5},
            boundary_conditions=tt.PrescribedSurfaceTemperature(
                "surface_temperature"),
            input_sources=(tt.TimeSeriesInputSource(
                times=hours, series={"surface_temperature": values}),))

    ref = build()
    ref.run(steps=steps, dt=900.0)

    mesh = cell_mesh()
    sim = build()
    sim.state = shard_state(sim.state, mesh)
    sim.input_sources = shard_sources(sim.input_sources, cells, mesh)
    leaf = sim.input_sources[0].series["surface_temperature"]
    want = (jax.sharding.PartitionSpec() if series == "scalar_T"
            else jax.sharding.PartitionSpec(None, "cells"))
    assert leaf.sharding.spec == want, leaf.sharding
    sim.run(steps=steps, dt=900.0)

    for name in sorted(ref.state.prognostic):
        a = np.asarray(sim.state.prognostic[name])
        b = np.asarray(ref.state.prognostic[name])
        np.testing.assert_allclose(a, b, rtol=0.0,
                                   atol=1e-12 * np.abs(b).max(), err_msg=name)
    sh = sim.state.prognostic["internal_energy"].sharding
    assert sh.is_equivalent_to(jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "cells")), ndim=2), sh
    roll = sim._rollout_fn(steps)
    hlo = roll._jit.lower(sim.state, 900.0,
                          _split_sources(sim.input_sources)[0],
                          n=steps).compile().as_text()
    for op in ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter"):
        assert op not in hlo, f"unexpected {op} in the sharded rollout"
