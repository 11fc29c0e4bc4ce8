"""Profiling / tracing utilities.

The reference has no built-in tracer — perf work uses `@time`/BenchmarkTools
in example scripts and SnoopCompile for compile latency (SURVEY §5). The
JAX equivalents here:

* :func:`trace` — context manager around `jax.profiler` writing a TensorBoard
  trace directory (kernel timeline, HBM usage) for any code region.
* :func:`profile_rollout` — profile ``n`` steps of a :class:`Simulation`
  under a trace and return wall-clock stats.
* :func:`step_timings` — median/percentile per-step wall time of the jitted
  step at steady state (the number `bench.py` optimizes), without a trace.
* :func:`compile_seconds` — compile-latency tracking (the analogue of the
  reference's SnoopCompile compile-time audits).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["trace", "profile_rollout", "step_timings", "compile_seconds"]


@contextlib.contextmanager
def trace(logdir: str):
    """Record a `jax.profiler` trace of the enclosed region into ``logdir``
    (view with TensorBoard's profile plugin or Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def _sync(x):
    """Wait until every array of ``x`` is computed."""
    import jax

    return jax.block_until_ready(x)


def profile_rollout(sim, steps: int, logdir: str, dt: Optional[float] = None
                    ) -> Dict[str, float]:
    """Profile a ``steps``-step on-device rollout of ``sim`` under a trace.

    Compiles (and warms) the rollout outside the trace so the trace contains
    only steady-state device work. Returns wall-clock stats; the kernel
    timeline lands in ``logdir``.
    """
    dt = dt if dt is not None else sim.timestepper.default_dt()
    roll = sim._rollout_fn(int(steps))
    state = roll(sim.state, dt)  # compile + warm
    _sync(state)
    with trace(logdir):
        t0 = time.perf_counter()
        state = roll(state, dt)
        _sync(state)
        wall = time.perf_counter() - t0
    sim.state = state
    sim.compute_auxiliary()  # finalize like Simulation.run (fresh aux)
    return {"steps": float(steps), "wall_s": wall,
            "steps_per_s": steps / wall, "logdir": logdir}


def step_timings(sim, dt: Optional[float] = None, block: int = 1440,
                 reps: int = 5) -> Dict[str, float]:
    """Steady-state per-step wall time via timed on-device blocks (median of
    ``reps`` blocks of ``block`` steps; large blocks amortize the dispatch
    sync, matching the bench.py methodology)."""
    dt = dt if dt is not None else sim.timestepper.default_dt()
    roll = sim._rollout_fn(int(block))
    state = roll(sim.state, dt)
    _sync(state)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = roll(state, dt)
        _sync(state)
        times.append(time.perf_counter() - t0)
    sim.state = state
    sim.compute_auxiliary()  # finalize like Simulation.run (fresh aux)
    med = float(np.median(times))
    return {"block_steps": float(block), "median_block_s": med,
            "us_per_step": 1e6 * med / block,
            "steps_per_s": block / med}


def compile_seconds(fn, *args, **kwargs) -> float:
    """Wall-clock compile latency of a jitted callable on example arguments
    (lower + compile, no execution)."""
    t0 = time.perf_counter()
    fn.lower(*args, **kwargs).compile()
    return time.perf_counter() - t0
