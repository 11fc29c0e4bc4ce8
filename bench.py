"""Benchmark: global soil heat + Richards water at the N145 land-cell count.

Reproduces the reference benchmark protocol
(`test/benchmarks/gpu/soil_heat_hydrology_global.jl:39-103`): SoilModel with
heat conduction + Richards hydrology, Nz=30 ExponentialSpacing, float32,
dt=60 s, over the 56,951 land columns of the ERA5-land N145 mask (run as a
``ColumnGrid``: the column physics is laterally independent).

Prints ONE JSON line: {"metric", "value", "unit", "detail"}; ``value`` is
cells * steps / s on one GPU, the median of timed one-day rollouts that end
in ``block_until_ready``. Needs a GPU; there is no CPU fallback.

    python bench.py
"""
from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np

N145_CELLS = 56951
NZ = 30
DT = 60.0
STEPS_PER_BLOCK = 1440  # one simulated day per timed rollout
REPS = 5


def main():
    import jax

    from terrarium_tpu.utils.compile_cache import configure_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU, JAX found {dev.platform!r}")
    cache = configure_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    import terrarium_tpu as tt

    grid = tt.ColumnGrid.of(cells=N145_CELLS, spacing=tt.ExponentialSpacing(N=NZ),
                            nf=np.float32)
    hydrology = tt.SoilHydrology(
        vertical_flow=tt.RichardsEq(),
        hydraulic_properties=tt.ConstantSoilHydraulics(
            swrc=tt.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tt.UnsatKVanGenuchten()))
    soil = tt.SoilEnergyWaterCarbon(hydrology=hydrology)
    model = tt.SoilModel(grid=grid, soil=soil)
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=DT),
        initializers={
            "temperature": lambda x, z: 1.0 + 0.0 * z,
            "saturation_water_ice": lambda x, z: np.minimum(1.0, 0.5 - 0.05 * z),
        },
        boundary_conditions=tt.PrescribedSurfaceTemperature(
            lambda t: 5.0 * jax.numpy.sin(2 * jax.numpy.pi * t / 86400.0)),
    )

    roll = sim._rollout_fn(STEPS_PER_BLOCK)
    t0 = time.perf_counter()
    state = jax.block_until_ready(roll(sim.state, DT))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        state = jax.block_until_ready(roll(state, DT))
        times.append(time.perf_counter() - t0)
    if not np.all(np.isfinite(np.asarray(state.temperature))):
        raise SystemExit("bench.py: non-finite temperature")
    med = float(np.median(times))
    steps_per_s = STEPS_PER_BLOCK / med
    # simulated years per wall-clock day (the reference harness's metric)
    sypd = steps_per_s * DT / 365.0

    print(json.dumps({
        "metric": "cells_steps_per_s_n145_heat_richards",
        "value": N145_CELLS * steps_per_s,
        "unit": "cells*steps/s",
        "detail": {
            "cells": N145_CELLS, "nz": NZ, "dt_s": DT,
            "steps_per_block": STEPS_PER_BLOCK, "block_s": times,
            "median_block_s": med, "us_per_step": 1e6 * med / STEPS_PER_BLOCK,
            "sypd": sypd, "compile_and_first_block_s": compile_s,
            "platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "nvidia_smi": smi,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": cache, "jax": jax.__version__,
        },
    }))


if __name__ == "__main__":
    main()
