"""`timesteppers.autodiff.make_rollout_fn` gradients against central finite
differences, for each stepper, the coupled LandModel, and the remat
variants (lean carry without remat, per-step, a checkpoint policy; the
full-carry scan with per-step remat and with sqrt-N segments).

The parameter is the mineral thermal conductivity; the objective mixes the
mean final temperature and saturation. The states stay clear of the model's
kinks (the 0 degC freeze curve, saturation 1), where a finite difference
would straddle a change of derivative. Float64, small grids: a central
difference with step 1e-4 of the parameter has truncation error far below
the 1e-6 relative tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import terrarium_tpu as tt
from terrarium_tpu.timesteppers.autodiff import make_rollout_fn

K0 = 3.8


def _soil(k_mineral, richards=True, loam=False):
    tp = tt.SoilThermalProperties(
        conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
    kw = {"energy": tt.SoilEnergyBalance(thermal_properties=tp)}
    if richards:
        kw["hydrology"] = tt.SoilHydrology(
            vertical_flow=tt.RichardsEq(),
            hydraulic_properties=tt.ConstantSoilHydraulics(
                swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                unsat_hydraulic_cond=tt.UnsatKVanGenuchten()))
    if loam:
        kw["strat"] = tt.HomogeneousStratigraphy(
            texture=tt.SoilTexture.preset("loam"))
        kw["hydrology"] = tt.SoilHydrology(vertical_flow=tt.RichardsEq())
    return tt.SoilEnergyWaterCarbon(**kw)


def _grid(nz=8):
    return tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=nz),
                            nf=np.float64)


def _soil_sim(k, stepper):
    return tt.initialize(
        tt.SoilModel(grid=_grid(), soil=_soil(k)), stepper,
        initializers={
            "temperature": lambda x, z: 6.0 + np.sin(2 * np.pi * x) + 0.0 * z,
            "saturation_water_ice": lambda x, z: 0.5 + 0.1 * x + 0.0 * z},
        boundary_conditions=tt.PrescribedSurfaceTemperature(12.0))


def _land_sim(k, stepper):
    model = tt.LandModel(grid=_grid(), soil=_soil(k, loam=True),
                         vegetation=tt.VegetationCarbon.consistent_units())
    forcing = tt.FieldInputSource(fields={
        "air_temperature": 8.0, "surface_shortwave_down": 300.0,
        "surface_longwave_down": 330.0, "rainfall": 4.0e-8,
        "windspeed": 3.0, "specific_humidity": 0.006})
    return tt.initialize(
        model, stepper,
        initializers={"temperature": 6.0, "saturation_water_ice": 0.5,
                      "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5},
        input_sources=(forcing,))


CASES = {
    "forward_euler": (_soil_sim, tt.ForwardEuler(dt=300.0), 12,
                      {"lean": True}),
    "forward_euler_remat": (_soil_sim, tt.ForwardEuler(dt=300.0), 12,
                            {"lean": True, "remat": True}),
    "forward_euler_policy": (_soil_sim, tt.ForwardEuler(dt=300.0), 12,
                             {"lean": True, "policy":
                              jax.checkpoint_policies.dots_saveable}),
    "forward_euler_full_carry": (_soil_sim, tt.ForwardEuler(dt=300.0), 12,
                                 {"remat": True}),
    "forward_euler_segments": (_soil_sim, tt.ForwardEuler(dt=300.0), 12,
                               {"segment": 4}),
    "heun": (_soil_sim, tt.Heun(dt=300.0), 12, {"lean": True, "remat": True}),
    "implicit_euler": (_soil_sim, tt.ImplicitEuler(dt=3600.0), 6,
                       {"lean": True, "remat": True}),
    "land_model": (_land_sim, tt.ForwardEuler(dt=600.0), 8,
                   {"lean": True, "remat": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_gradient_matches_finite_difference(case):
    build, stepper, steps, kw = CASES[case]

    def loss(k):
        sim = build(k, stepper)
        roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                               sim.input_sources, steps=steps, **kw)
        out = roll(sim.state, stepper.dt)
        return jnp.mean(out.temperature) + jnp.mean(out.saturation_water_ice)

    g = float(jax.jit(jax.grad(loss))(K0))
    h = 1e-4 * K0
    f = jax.jit(loss)
    fd = (float(f(K0 + h)) - float(f(K0 - h))) / (2 * h)
    assert np.isfinite(g) and abs(g) > 1e-8, g
    np.testing.assert_allclose(g, fd, rtol=1e-6)
