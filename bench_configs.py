"""Per-config benchmark suite for the five BASELINE.json workloads.

`bench.py` remains the driver's single-line headline benchmark (N145 soil
heat + Richards, explicit). This suite measures all five BASELINE configs on
the real chip and prints ONE JSON line per config:

1. column_heat_explicit      — single-column SoilModel, heat only, ForwardEuler
                               (reference `examples/simulations/soil_heat_column.jl`)
2. column_implicit_tridiag   — heat + Richards, ImplicitEuler (PCR tridiagonal
                               solves), N145-sized cell batch (new capability —
                               the reference has only explicit steppers)
3. global_heat_n72_forcing   — soil heat over the masked N72 ERA5-land grid
                               with a time-interpolated forcing source
                               (reference `examples/simulations/soil_heat_global.jl`)
4. land_coupled_n145         — full LandModel (SEB + surface hydrology +
                               PALADYN vegetation + soil heat/water) on N145
5. grad_n145_heat            — value_and_grad of mean final soil temperature
                               wrt mineral conductivity through a remat
                               rollout on N145 (fwd+bwd per step counted)

Timing methodology matches bench.py: on-device scan blocks that end in
``block_until_ready``, persistent compilation cache, median of 5 blocks.
Configs 3-6 run on the ERA5-land N72/N145 masked ring grids and need the
mask files (``--mask-dir``); without them they fail. Needs a GPU.

    python bench_configs.py [--mask-dir DIR] [CONFIG ...]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

#: ERA5-land N145 land cells: the width of the ColumnGrid configs.
N145_CELLS = 56951


def _time_blocks(roll, state, dt, reps=5):
    import jax

    t0 = time.perf_counter()
    state = jax.block_until_ready(roll(state, dt))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = jax.block_until_ready(roll(state, dt))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), compile_s, state


def _emit(name, cells, steps, med_s, compile_s, dt, extra=None):
    rec = {
        "config": name,
        "metric": "cells_steps_per_s_per_chip",
        "value": round(cells * steps / med_s, 1),
        "unit": "cells*steps/s",
        "detail": {"cells": cells, "steps_per_block": steps, "dt_s": dt,
                   "median_block_s": round(med_s, 4),
                   "steps_per_s": round(steps / med_s, 1),
                   "compile_s": round(compile_s, 2), **(extra or {})},
    }
    print(json.dumps(rec), flush=True)


def _ring_grid(n, nz, tt, mask_dir, pad_multiple=8):
    path = os.path.join(mask_dir or "", f"era5-land_land_sea_mask_N{n}.nc")
    if mask_dir is None or not os.path.exists(path):
        raise FileNotFoundError(
            f"N{n} ERA5-land mask not found ({path!r}); pass --mask-dir")
    mask, _, _ = tt.load_land_mask(path)
    ring = tt.full_gaussian_grid(n)
    return tt.ColumnRingGrid.create(
        ring, mask, spacing=tt.ExponentialSpacing(N=nz),
        nf=np.float32, pad_multiple=pad_multiple)


def config1_column_heat(tt, mask_dir=None):
    grid = tt.ColumnGrid.of(cells=1, spacing=tt.ExponentialSpacing(N=30),
                            nf=np.float32)
    model = tt.SoilModel(grid=grid)
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=300.0),
        initializers={"temperature": -2.0, "saturation_water_ice": 1.0},
        boundary_conditions=tt.PrescribedSurfaceTemperature(
            _diurnal_bc()),
    )
    steps = 57600
    roll = sim._rollout_fn(steps)
    med, comp, _ = _time_blocks(roll, sim.state, 300.0)
    _emit("column_heat_explicit", 1, steps, med, comp, 300.0)


def _diurnal_bc():
    import jax.numpy as jnp

    return lambda t: 5.0 * jnp.sin(2 * jnp.pi * t / 86400.0)


def config2_implicit(tt, mask_dir=None):
    cells = N145_CELLS
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=30),
                            nf=np.float32)
    hydrology = tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(),
        hydraulic_properties=tt.ConstantSoilHydraulics(
            swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tt.UnsatKVanGenuchten()))
    model = tt.SoilModel(grid=grid,
                         soil=tt.SoilEnergyWaterCarbon(hydrology=hydrology))
    sim = tt.initialize(
        model, tt.ImplicitEuler(dt=900.0),
        initializers={
            "temperature": lambda x, z: 1.0 + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature(_diurnal_bc()),
    )
    steps = 1920  # 20 simulated days at dt=900
    roll = sim._rollout_fn(steps)
    med, comp, _ = _time_blocks(roll, sim.state, 900.0)
    _emit("column_implicit_tridiag", cells, steps, med, comp, 900.0,
          {"solver": sim.timestepper.solver})


def config3_global_heat_n72(tt, mask_dir=None):
    grid = _ring_grid(72, 30, tt, mask_dir)
    model = tt.SoilModel(grid=grid)
    lat = np.asarray(grid.cell_lats, dtype=np.float64)
    T_mean = 25.0 * np.maximum(np.cos(np.deg2rad(lat)), 0.05) - 5.0
    hours = np.arange(0.0, 31 * 86400.0, 3600.0)
    ts = (T_mean[None, :]
          + 8.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)).astype(np.float32)
    forcing = tt.TimeSeriesInputSource(times=hours,
                                       series={"surface_temperature": ts})
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=300.0),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.8},
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(forcing,),
    )
    steps = 5760  # 20 simulated days at dt=300
    roll = sim._rollout_fn(steps)
    med, comp, _ = _time_blocks(roll, sim.state, 300.0)
    _emit("global_heat_n72_forcing", grid.cells, steps, med, comp, 300.0,
          {"land_cells": int(grid.n_land)})


def config4_land_coupled_n145(tt, mask_dir=None):
    import jax.numpy as jnp

    grid = _ring_grid(145, 20, tt, mask_dir)
    soil = tt.SoilEnergyWaterCarbon(
        strat=tt.HomogeneousStratigraphy(texture=tt.SoilTexture.preset("loam")),
        hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq()),
    )
    model = tt.LandModel(grid=grid, vegetation=tt.VegetationCarbon(), soil=soil)
    lat = np.asarray(grid.cell_lats, dtype=np.float64)
    coslat = np.maximum(np.cos(np.deg2rad(lat)), 0.05)
    T_mean = 28.0 * coslat - 8.0
    hours = np.arange(0.0, 31 * 86400.0, 3600.0)
    day_frac = hours / 86400.0
    sw = (900.0 * coslat[None, :]
          * np.maximum(0.0, np.sin(2 * np.pi * (day_frac[:, None] - 0.25))))
    ta = T_mean[None, :] + 6.0 * np.sin(2 * np.pi * (day_frac[:, None] - 0.3))
    forcing = tt.TimeSeriesInputSource(
        times=hours, series={"surface_shortwave_down": sw.astype(np.float32),
                             "air_temperature": ta.astype(np.float32)})
    static = tt.FieldInputSource(fields={"surface_longwave_down": 330.0,
                                         "rainfall": 4.0e-8, "windspeed": 3.0})
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=600.0),
        initializers={"temperature": lambda x, z: T_mean[None, :] + 0.0 * z,
                      "saturation_water_ice": 0.6,
                      "carbon_vegetation": 2.0,
                      "vegetation_area_fraction": 0.5},
        input_sources=(forcing, static),
    )
    steps = 1440  # 10 simulated days at dt=600
    roll = sim._rollout_fn(steps)
    med, comp, _ = _time_blocks(roll, sim.state, 600.0)
    _emit("land_coupled_n145", grid.cells, steps, med, comp, 600.0,
          {"land_cells": int(grid.n_land), "nz": 20})


def config5_grad_n145(tt, mask_dir=None):
    import jax
    import jax.numpy as jnp

    from terrarium_tpu.timesteppers.autodiff import make_rollout_fn

    grid = _ring_grid(145, 20, tt, mask_dir)
    steps = 288

    def mean_final_temperature(k_mineral):
        tp = tt.SoilThermalProperties(
            conductivities=tt.SoilThermalConductivities(mineral=k_mineral))
        soil = tt.SoilEnergyWaterCarbon(
            energy=tt.SoilEnergyBalance(thermal_properties=tp))
        model = tt.SoilModel(grid=grid, soil=soil)
        sim = tt.initialize(
            model, tt.ForwardEuler(),
            initializers={"temperature": -1.0, "saturation_water_ice": 0.8},
            boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))
        roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx, (),
                               steps=steps, remat=True)
        out = roll(sim.state, 300.0)
        return jnp.mean(out.temperature)

    vg = jax.jit(jax.value_and_grad(mean_final_temperature))
    t0 = time.perf_counter()
    v, g = jax.block_until_ready(vg(3.8))
    comp = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        v, g = jax.block_until_ready(vg(3.8))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    _emit("grad_n145_heat", grid.cells, steps, med, comp, 300.0,
          {"land_cells": int(grid.n_land), "includes": "forward+backward",
           "dT_dk_mineral": float(g)})


def config6_grad_n145_coupled(tt, mask_dir=None):
    """BASELINE config #5 at full coupling: gradient through the COUPLED
    heat + Richards N145 rollout (fwd+bwd), parameter = log saturated
    hydraulic conductivity, objective mixing both prognostic families.
    Includes a central-difference cross-check at reduced size (VERDICT r2
    item 9)."""
    import jax
    import jax.numpy as jnp

    from terrarium_tpu.timesteppers.autodiff import make_rollout_fn

    def model_fn_for(grid):
        def model_fn(log_ksat):
            props = tt.ConstantSoilHydraulics(
                sat_hydraulic_cond=jnp.exp(log_ksat),
                swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
                unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
            soil = tt.SoilEnergyWaterCarbon(hydrology=tt.SoilHydrology(
                vertical_flow=tt.RichardsEq(), hydraulic_properties=props))
            return tt.SoilModel(grid=grid, soil=soil)
        return model_fn

    def sim_for(model):
        return tt.initialize(
            model, tt.ForwardEuler(),
            initializers={
                "temperature": -1.0,
                "saturation_water_ice": lambda x, z: np.minimum(
                    1.0, 0.6 - 0.04 * z)},
            boundary_conditions=tt.PrescribedSurfaceTemperature(4.0))

    def make_loss(grid, steps, dt):
        model_fn = model_fn_for(grid)

        def loss(log_ksat):
            sim = sim_for(model_fn(log_ksat))
            # lean-carry per-step remat
            roll = make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                                   (), steps=steps, remat=True, lean=True)
            out = roll(sim.state, dt)
            return (jnp.mean(out.temperature)
                    + jnp.mean(out.saturation_water_ice))
        return loss

    # finite-difference cross-check at reduced size (64 columns, nz=10)
    small = tt.ColumnGrid.of(cells=64, spacing=tt.ExponentialSpacing(N=10),
                             nf=np.float32)
    loss_s = make_loss(small, steps=48, dt=300.0)
    x0, h = float(np.log(1e-5)), 0.02
    g_ad = float(jax.jit(jax.grad(loss_s))(x0))
    f_p = float(jax.jit(loss_s)(x0 + h))
    f_m = float(jax.jit(loss_s)(x0 - h))
    g_fd = (f_p - f_m) / (2 * h)
    fd_rel_err = abs(g_ad - g_fd) / max(abs(g_fd), 1e-12)

    grid = _ring_grid(145, 20, tt, mask_dir)
    steps = 288
    vg = jax.jit(jax.value_and_grad(make_loss(grid, steps, 300.0)))
    t0 = time.perf_counter()
    v, g = jax.block_until_ready(vg(x0))
    comp = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        v, g = jax.block_until_ready(vg(x0))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    _emit("grad_n145_heat_richards", grid.cells, steps, med, comp, 300.0,
          {"land_cells": int(grid.n_land), "includes": "forward+backward",
           "param": "log_K_sat", "dloss_dlogksat": float(g),
           "fd_rel_err_reduced": fd_rel_err,
           "grad_path": "xla_lean_remat"})


def config7_heun_n145(tt, mask_dir=None):
    """Heun (2nd-order) on the headline N145 heat+Richards workload with
    time-varying forcing — exercises the predictor/corrector staging and the
    input re-update at t+dt inside the lean scan (VERDICT r2 weak #7)."""
    cells = N145_CELLS
    grid = tt.ColumnGrid.of(cells=cells, spacing=tt.ExponentialSpacing(N=30),
                            nf=np.float32)
    hydrology = tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(),
        hydraulic_properties=tt.ConstantSoilHydraulics(
            swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tt.UnsatKVanGenuchten()))
    model = tt.SoilModel(grid=grid,
                         soil=tt.SoilEnergyWaterCarbon(hydrology=hydrology))
    hours = np.arange(0.0, 31 * 86400.0, 3600.0)
    ts = (5.0 * np.sin(2 * np.pi * hours[:, None] / 86400.0)
          * np.ones((1, cells))).astype(np.float32)
    forcing = tt.TimeSeriesInputSource(times=hours,
                                       series={"surface_temperature": ts})
    sim = tt.initialize(
        model, tt.Heun(dt=60.0),
        initializers={
            "temperature": lambda x, z: 1.0 + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature("surface_temperature"),
        input_sources=(forcing,),
    )
    steps = 2880  # 2 simulated days at dt=60 (Heun does 2 stages/step)
    roll = sim._rollout_fn(steps)
    med, comp, _ = _time_blocks(roll, sim.state, 60.0)
    _emit("heun_n145_heat_richards_forcing", cells, steps, med, comp, 60.0,
          {"stages_per_step": 2})


CONFIGS = {
    "1": config1_column_heat, "2": config2_implicit,
    "3": config3_global_heat_n72, "4": config4_land_coupled_n145,
    "5": config5_grad_n145, "6": config6_grad_n145_coupled,
    "7": config7_heun_n145,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mask-dir", default=None,
                    help="directory holding era5-land_land_sea_mask_N72.nc "
                         "and ..._N145.nc (configs 3-6)")
    ap.add_argument("configs", nargs="*", help=f"any of {sorted(CONFIGS)}")
    args = ap.parse_args()
    unknown = sorted(set(args.configs) - set(CONFIGS))
    if unknown:
        ap.error(f"unknown configs {unknown}")

    import jax

    from terrarium_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_configs.py needs a GPU, JAX found "
                         f"{dev.platform!r}")
    configure_compile_cache()
    import terrarium_tpu as tt

    failed = []
    for key in args.configs or sorted(CONFIGS):
        fn = CONFIGS[key]
        try:
            fn(tt, args.mask_dir)
        except Exception as e:  # report, run the rest, then exit nonzero
            failed.append(fn.__name__)
            print(json.dumps({"config": fn.__name__, "error": repr(e)[:300]}),
                  flush=True)
    if failed:
        sys.exit(f"bench_configs.py: failed configs {failed}")


if __name__ == "__main__":
    main()
