"""Input (forcing) sources.

JAX equivalent of reference `src/input_output/input_sources.jl` and the
raster extension (`ext/TerrariumRastersExt`). A source declares input
variables, seeds them at initialization, and updates them every step. Updates
are pure functions of the state clock so they trace into the jitted step; time
interpolation is linear with flat extrapolation at the ends, matching the
reference (`TerrariumRastersExt.jl:96-121`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..variables import Variable, XY, XYZ, input as input_var

__all__ = ["FieldInputSource", "TimeSeriesInputSource", "collect_input_variables"]


@dataclasses.dataclass(frozen=True)
class FieldInputSource:
    """Static input field(s) copied once at initialization
    (reference `input_sources.jl:81-131`).

    ``fields`` maps input-variable name -> array (broadcastable to the
    variable's shape). ``dims`` maps name -> XY()/XYZ() for declaration.
    """

    fields: Any  # dict[str, array]
    dims: Any = None  # dict[str, VarDims]; default XY

    def variables(self):
        dims = self.dims or {}
        return tuple(input_var(name, dims.get(name, XY()))
                     for name in self.fields)

    def initialize_inputs(self, state):
        updates = {name: jnp.broadcast_to(jnp.asarray(val, dtype=state.inputs[name].dtype),
                                          state.inputs[name].shape)
                   for name, val in self.fields.items()}
        return state.update(updates)

    def update_inputs(self, state):
        return state  # static


@dataclasses.dataclass(frozen=True)
class TimeSeriesInputSource:
    """Time-varying inputs with per-step linear interpolation
    (reference `FieldTimeSeriesInputSource`, `input_sources.jl:142-171`;
    raster time interpolation `TerrariumRastersExt.jl:96-121`).

    ``times``: (T,) seconds; ``series``: name -> (T, ...) arrays whose
    trailing shape broadcasts to the input variable's shape. Interpolation is
    linear in time with flat extrapolation beyond the ends.
    """

    times: Any  # (T,) array-like, seconds
    series: Any  # dict[str, (T, ...) array]
    dims: Any = None

    def variables(self):
        dims = self.dims or {}
        return tuple(input_var(name, dims.get(name, XY()))
                     for name in self.series)

    def _interp(self, name, t, like):
        times = jnp.asarray(self.times, dtype=like.dtype)
        values = jnp.asarray(self.series[name], dtype=like.dtype)
        t = jnp.clip(t, times[0], times[-1])
        idx = jnp.clip(jnp.searchsorted(times, t, side="right") - 1, 0, times.shape[0] - 2)
        t0, t1 = times[idx], times[idx + 1]
        w = jnp.where(t1 > t0, (t - t0) / (t1 - t0), 0.0)
        val = (1.0 - w) * values[idx] + w * values[idx + 1]
        return jnp.broadcast_to(val, like.shape)

    def initialize_inputs(self, state):
        return self.update_inputs(state)

    def update_inputs(self, state):
        t = state.clock.time
        updates = {name: self._interp(name, t, state.inputs[name])
                   for name in self.series}
        return state.update(updates)


# -- pytree registration ----------------------------------------------------
# Sources are registered as JAX pytrees so the integrator can pass them as
# *runtime arguments* to the jitted step/rollout instead of closure captures.
# Closure-captured arrays are baked into the HLO as literal constants — at
# N145 coupled scale the (T, cells) forcing series are ~170 MB each, which
# bloats the executable. As pytree leaves they lower to ordinary parameters.

def _flatten_field_source(src: FieldInputSource):
    names = tuple(sorted(src.fields))
    dims = tuple(sorted(src.dims.items())) if src.dims else None
    return tuple(src.fields[k] for k in names), (names, dims)


def _unflatten_field_source(aux, children) -> FieldInputSource:
    names, dims = aux
    return FieldInputSource(fields=dict(zip(names, children)),
                            dims=dict(dims) if dims else None)


def _flatten_ts_source(src: TimeSeriesInputSource):
    names = tuple(sorted(src.series))
    dims = tuple(sorted(src.dims.items())) if src.dims else None
    return (src.times,) + tuple(src.series[k] for k in names), (names, dims)


def _unflatten_ts_source(aux, children) -> TimeSeriesInputSource:
    names, dims = aux
    return TimeSeriesInputSource(times=children[0],
                                 series=dict(zip(names, children[1:])),
                                 dims=dict(dims) if dims else None)


import jax.tree_util as _jtu  # noqa: E402

_jtu.register_pytree_node(FieldInputSource, _flatten_field_source,
                          _unflatten_field_source)
_jtu.register_pytree_node(TimeSeriesInputSource, _flatten_ts_source,
                          _unflatten_ts_source)


def collect_input_variables(sources) -> Tuple[Variable, ...]:
    """Collect input variable declarations from all sources
    (reference `model_integrator.jl:154-155`)."""
    out: tuple = ()
    for src in sources:
        out = out + tuple(src.variables())
    return out
