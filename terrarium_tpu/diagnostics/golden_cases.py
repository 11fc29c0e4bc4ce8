"""Short deterministic reference trajectories (the regression goldens).

The reference ships no regression data (SURVEY §4 gap); these cases pin
short trajectories of the flagship configurations so refactors are checked
for *numerical* changes, not just invariants. The stored results live in
``tests/goldens/<name>.npz``; ``tests/test_goldens.py`` compares against them
on the CPU and ``chip_smoke.py`` on the GPU, both in float64 at
``RTOL``/``ATOL``. Regenerate with ``python tests/test_goldens.py`` after an
intentional change.
"""
from __future__ import annotations

import numpy as np

import terrarium_tpu as tt

__all__ = ["CASES", "RTOL", "ATOL", "run_case"]

#: Golden comparison tolerances (float64 runs).
RTOL = 1e-12
ATOL = 1e-12


def _soil_heat_richards_sim():
    grid = tt.ColumnGrid.of(cells=8, spacing=tt.ExponentialSpacing(N=20),
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
            "temperature": lambda x, z: 2.0 * np.sin(2 * np.pi * x) - 0.05 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.6 - 0.05 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature(
            lambda t: -5.0 + 0.0 * t))


def _land_model_sim():
    grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=15),
                            nf=np.float64)
    model = tt.LandModel(grid=grid)
    return tt.initialize(
        model, tt.ForwardEuler(),
        initializers={"temperature": 5.0, "saturation_water_ice": 0.8},
        input_sources=(tt.FieldInputSource(fields={
            "surface_shortwave_down": 400.0, "air_temperature": 12.0,
            "rainfall": 1.0e-7}),))


def _land_snow_sim():
    grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=12),
                            nf=np.float64)
    soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
        vertical_flow=tt.RichardsEq()))
    model = tt.LandModel(grid=grid, soil=soil, snow=tt.Snowpack())
    return tt.initialize(
        model, tt.ForwardEuler(),
        initializers={"temperature": 1.0, "saturation_water_ice": 0.6,
                      "snow_water_equivalent": 0.02},
        input_sources=(tt.FieldInputSource(fields={
            "air_temperature": 4.0, "snowfall": 5.0e-8,
            "surface_shortwave_down": 250.0}),))


def _heun_forced_sim():
    """Heun + time-varying forcing inside the lean rollout."""
    grid = tt.ColumnGrid.of(cells=4, spacing=tt.ExponentialSpacing(N=15),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil)
    times = np.arange(0.0, 86401.0, 7200.0)
    series = (np.linspace(-4.0, 8.0, 4)[None, :]
              + 6.0 * np.sin(2 * np.pi * times / 86400.0)[:, None])
    return tt.initialize(
        model, tt.Heun(),
        initializers={"temperature": 1.0,
                      "saturation_water_ice": lambda x, z: np.minimum(
                          1.0, 0.7 - 0.04 * z)},
        boundary_conditions=tt.PrescribedSurfaceTemperature("air_temperature"),
        input_sources=(tt.TimeSeriesInputSource(
            times=times, series={"air_temperature": series}),))


def _implicit_sim():
    """ImplicitEuler (PCR solves, Picard-1) on coupled heat+Richards with a
    freeze front."""
    grid = tt.ColumnGrid.of(cells=6, spacing=tt.ExponentialSpacing(N=16),
                            nf=np.float64)
    props = tt.ConstantSoilHydraulics(
        swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
        unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
    soil = tt.SoilEnergyWaterCarbon(
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                   hydraulic_properties=props))
    model = tt.SoilModel(grid=grid, soil=soil)
    return tt.initialize(
        model, tt.ImplicitEuler(dt=3600.0),
        initializers={
            "temperature": lambda x, z: 3.0 * np.cos(2 * np.pi * x) + 0.1 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.65 - 0.04 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature(
            lambda t: -8.0 + 0.0 * t))


CASES = {
    "soil_heat_richards": (_soil_heat_richards_sim, 120, 300.0,
                           ("internal_energy", "saturation_water_ice",
                            "temperature", "pressure_head")),
    "heun_forced": (_heun_forced_sim, 96, 300.0,
                    ("internal_energy", "saturation_water_ice",
                     "temperature", "pressure_head")),
    "land_model": (_land_model_sim, 48, 300.0,
                   ("internal_energy", "saturation_water_ice",
                    "skin_temperature", "ground_heat_flux")),
    "land_snow": (_land_snow_sim, 48, 300.0,
                  ("internal_energy", "saturation_water_ice",
                   "snow_water_equivalent", "snow_cover_fraction",
                   "surface_shortwave_up")),
    "implicit_freeze": (_implicit_sim, 48, 3600.0,
                        ("internal_energy", "saturation_water_ice",
                         "temperature", "liquid_water_fraction")),
}


def run_case(name):
    build, steps, dt, fields = CASES[name]
    sim = build()
    sim.run(steps=steps, dt=dt)
    return {f: np.asarray(sim.state[f]) for f in fields}
