"""Compile-health checks.

The analogue of the reference's compiler audits (SURVEY §4.8:
`test/benchmarks/compilation/compiler_analysis.jl` asserts zero
Terrarium-caused method invalidations). Here the invariants that keep the
hot path fast are structural properties of the lowered HLO:

* no gathers / scatters / sorts / dynamic slicing in the step (the
  conventions of the codebase — CLAUDE.md);
* a bounded fusion count (launch overhead dominates at production sizes,
  so fusion-count regressions are throughput regressions);
* the jitted step retraces zero times for repeated calls (cache stability).
"""
import jax
import numpy as np

import terrarium_tpu as tt

FORBIDDEN = ("gather(", "scatter(", " sort(", "dynamic-slice(",
             "dynamic-update-slice(")


def _soil_sim():
    grid = tt.ColumnGrid.of(cells=64, spacing=tt.ExponentialSpacing(N=16),
                            nf=np.float32)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil)
    return tt.initialize(
        model, tt.ForwardEuler(dt=60.0),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.8},
        boundary_conditions=tt.PrescribedSurfaceTemperature(5.0))


def _land_sim():
    grid = tt.ColumnGrid.of(cells=64, spacing=tt.ExponentialSpacing(N=12),
                            nf=np.float32)
    model = tt.LandModel(grid=grid, vegetation=tt.VegetationCarbon())
    return tt.initialize(
        model, tt.ForwardEuler(dt=300.0),
        initializers={"temperature": 5.0, "saturation_water_ice": 0.8,
                      "carbon_vegetation": 2.0, "vegetation_area_fraction": 0.5},
        input_sources=(tt.FieldInputSource(fields={
            "surface_shortwave_down": 300.0, "air_temperature": 10.0}),))


def _step_hlo(sim):
    model, ts, ctx, sources = (sim.model, sim.timestepper, sim.ctx,
                               sim.input_sources)
    lowered = jax.jit(
        lambda s, d: ts.step(model, s, ctx, sources, d)).lower(sim.state, 60.0)
    return lowered.compile().as_text()


def test_soil_step_hlo_is_gather_free():
    hlo = _step_hlo(_soil_sim())
    for op in FORBIDDEN:
        assert op not in hlo, f"hot-path HLO contains {op.strip('( ')}"


def test_land_step_hlo_is_gather_free():
    hlo = _step_hlo(_land_sim())
    for op in FORBIDDEN:
        assert op not in hlo, f"hot-path HLO contains {op.strip('( ')}"


def test_soil_step_fusion_budget():
    """Fusion count == kernel launches per step; keep it bounded (CPU
    fusion counts differ from the GPU's, but large regressions show up on
    both backends)."""
    hlo = _step_hlo(_soil_sim())
    n_fusions = hlo.count(" fusion(")
    assert n_fusions < 80, f"step fusion count regressed: {n_fusions}"


def test_step_does_not_retrace():
    sim = _soil_sim()
    fn = sim.step_fn
    s = fn(sim.state, 60.0)
    n0 = fn._cache_size()
    s = fn(s, 60.0)
    s = fn(s, 60.0)
    assert fn._cache_size() == n0 == 1
