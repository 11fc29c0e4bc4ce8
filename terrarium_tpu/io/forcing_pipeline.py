"""Chunked host->device forcing pipeline for long time series.

SURVEY hard part #5: hourly global ERA5 series (years x 8760 x ~57k cells)
cannot live in device memory. This pipeline keeps the full series on host (numpy or
memmap), streams fixed-size time windows to the device, and runs the
simulation in window-sized `lax.scan` chunks. The window enters the jitted
rollout as a *traced argument* (not a baked constant), so every window reuses
one compiled executable; `jax.device_put` of the next window is asynchronous
and overlaps with the current chunk's compute.

Per-step time interpolation inside the chunk is linear with flat
extrapolation, identical to :class:`TimeSeriesInputSource` (and the
reference's raster interpolation, `TerrariumRastersExt.jl:96-121`).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .input_sources import TimeSeriesInputSource

__all__ = ["ChunkedForcingPipeline"]


class ChunkedForcingPipeline:
    """Streams a long forcing time series through device-resident windows.

    Args:
        times: ``(T,)`` seconds (monotonic) on host.
        series: name -> ``(T, ...)`` host arrays (numpy / memmap).
        window: number of consecutive time slices per device window.
    """

    def __init__(self, times, series: Dict[str, np.ndarray], window: int = 64):
        self.times = np.asarray(times, dtype=np.float64)
        # values may be (T, ...) arrays/memmaps OR callables
        # ``v(i0, i1) -> (i1-i0, ...)`` (lazy providers: on-demand decode /
        # synthesis, so a multi-GB year never materializes on host at once)
        self.series = {k: v for k, v in series.items()}
        if window < 2:
            raise ValueError("window must be >= 2")
        self.window = int(window)

    def _slice(self, v, i0, i1):
        return v(i0, i1) if callable(v) else v[i0:i1]

    def _decl_source(self):
        return TimeSeriesInputSource(
            times=self.times[: 2],
            series={k: self._slice(v, 0, 2) for k, v in self.series.items()})

    def variables(self):
        return self._decl_source().variables()

    def initialize_inputs(self, state):
        """Seed the input fields from the first two slices, so the pipeline
        can be passed directly in ``input_sources=`` at `initialize`."""
        return self._decl_source().initialize_inputs(state)

    def update_inputs(self, state):
        raise RuntimeError(
            "ChunkedForcingPipeline streams from host — drive the "
            "simulation with pipeline.run(sim, ...), not sim.run()")

    def _window_arrays(self, i0: int, nf):
        i1 = min(i0 + self.window, self.times.shape[0])
        pad = self.window - (i1 - i0)
        t = self.times[i0:i1]
        out = {"__times__": np.pad(t, (0, pad), mode="edge")}
        for k, v in self.series.items():
            w = self._slice(v, i0, i1)
            if pad:
                w = np.pad(w, ((0, pad),) + ((0, 0),) * (w.ndim - 1), mode="edge")
            out[k] = np.asarray(w, dtype=nf)
        return out

    def run(self, sim, steps: int, dt: float):
        """Advance ``sim`` by ``steps`` of size ``dt`` streaming the forcing.

        The rollout is chunked at window-coverage boundaries; one compiled
        executable serves all windows.
        """
        model, ts, ctx = sim.model, sim.timestepper, sim.ctx
        static_sources = tuple(s for s in sim.input_sources
                               if not hasattr(s, "times"))
        nf = model.grid.nf

        @partial(jax.jit, static_argnums=(3,))
        def rollout(state, dt, window, n):
            src = TimeSeriesInputSource(
                times=window["__times__"],
                series={k: v for k, v in window.items() if k != "__times__"})

            def body(s, _):
                return ts.step(model, s, ctx, (src,) + static_sources, dt), None

            out, _ = jax.lax.scan(body, state, None, length=n)
            return out

        done = 0
        # pre-stage the first window
        i0 = int(np.searchsorted(self.times, float(sim.state.clock.time),
                                 side="right") - 1)
        i0 = max(0, min(i0, self.times.shape[0] - 2))
        window = jax.device_put(self._window_arrays(i0, nf))
        while done < steps:
            t_now = float(sim.state.clock.time)
            # steps covered by this window (flat extrapolation past the end)
            i1 = min(i0 + self.window, self.times.shape[0])
            if i1 >= self.times.shape[0]:
                n = steps - done  # last window extrapolates flat
            else:
                t_end = self.times[i1 - 1]
                n = min(steps - done, max(1, int((t_end - t_now) // dt)))
            # prefetch the next window asynchronously
            next_i0 = i1 - 1 if i1 < self.times.shape[0] else i0
            next_window = (jax.device_put(self._window_arrays(next_i0, nf))
                           if next_i0 != i0 else window)
            sim.state = rollout(sim.state, dt, window, int(n))
            done += n
            i0, window = next_i0, next_window
        sim.compute_auxiliary()
        return sim
