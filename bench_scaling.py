"""Scaling efficiency of the cells-sharded rollout over a device mesh.

Weak scaling: cells proportional to devices, one ``cell_mesh`` per device
count, the same rollout (`timesteppers.autodiff.make_rollout_fn`) under
`shard_state`; then the SPMD partitioning overhead at constant compute (the
same cells sharded over all devices vs unsharded on one).

    python bench_scaling.py --devices 4          # the GPUs of this host
    python bench_scaling.py --cpu --devices 8    # virtual CPU devices

With ``--cpu`` the devices are virtual (``xla_force_host_platform_device_count``)
and share the host's cores, so the efficiency numbers there say nothing about
GPUs; they check the method. Prints one JSON line per mesh size and a summary.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="virtual CPU devices instead of the host's GPUs")
    ap.add_argument("--cells-per-device", type=int, default=8192)
    ap.add_argument("--nz", type=int, default=30)
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_force_host_platform_device_count={args.devices}")

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_scaling.py needs GPUs (or --cpu)")

    from terrarium_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    import terrarium_tpu as tt
    from terrarium_tpu.parallel.sharding import cell_mesh, shard_state
    from terrarium_tpu.timesteppers.autodiff import make_rollout_fn

    def build(cells):
        grid = tt.ColumnGrid.of(cells=cells,
                                spacing=tt.ExponentialSpacing(N=args.nz),
                                nf=np.float32)
        props = tt.ConstantSoilHydraulics(
            swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tt.UnsatKVanGenuchten())
        soil = tt.SoilEnergyWaterCarbon(
            hydrology=tt.SoilHydrology(vertical_flow=tt.RichardsEq(),
                                       hydraulic_properties=props))
        model = tt.SoilModel(grid=grid, soil=soil)
        return tt.initialize(
            model, tt.ForwardEuler(),
            initializers={"temperature": lambda x, z: 1.0 + 0.0 * z,
                          "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z)},
            boundary_conditions=tt.PrescribedSurfaceTemperature(5.0))

    results = {}
    all_devices = jax.devices()
    for n_dev in sorted({1, 2, max(1, args.devices // 2), args.devices}):
        if n_dev > len(all_devices):
            continue
        # weak scaling: cells proportional to devices
        cells = args.cells_per_device * n_dev
        sim = build(cells)
        mesh = cell_mesh(all_devices[:n_dev])
        state = shard_state(sim.state, mesh)
        roll = jax.jit(make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                                       sim.input_sources, steps=args.steps))
        state = jax.block_until_ready(roll(state, 60.0))  # compile + warm
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            state = jax.block_until_ready(roll(state, 60.0))
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        rate = cells * args.steps / med
        results[n_dev] = rate
        print(json.dumps({"devices": n_dev, "cells": cells,
                          "cell_steps_per_s": round(rate, 1),
                          "s_per_block": round(med, 4)}))

    base = results[min(results)]
    summary = {
        f"{n}dev_efficiency": round(rate / (base * n / min(results)), 3)
        for n, rate in results.items()}
    print(json.dumps({"metric": "weak_scaling_efficiency",
                      "platform": all_devices[0].platform,
                      "device_kind": all_devices[0].device_kind,
                      **summary}))

    # SPMD partitioning overhead at constant compute: the same total cells,
    # sharded over the full mesh vs unsharded on one device
    import os

    cells = args.cells_per_device * args.devices
    sim = build(cells)
    roll = jax.jit(make_rollout_fn(sim.model, sim.timestepper, sim.ctx,
                                   sim.input_sources, steps=args.steps))

    def timed(state):
        state = jax.block_until_ready(roll(state, 60.0))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            state = jax.block_until_ready(roll(state, 60.0))
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    t_unsharded = timed(sim.state)
    t_sharded = timed(shard_state(sim.state, cell_mesh(all_devices)))
    print(json.dumps({
        "metric": "sharding_overhead_constant_compute",
        "cells": cells, "devices": args.devices,
        "host_cpus": os.cpu_count(),
        "t_unsharded_s": round(t_unsharded, 4),
        "t_sharded_s": round(t_sharded, 4),
        "sharded_over_unsharded": round(t_sharded / t_unsharded, 3)}))


if __name__ == "__main__":
    main()
