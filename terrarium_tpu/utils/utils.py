"""General utilities.

JAX reimplementation of the helpers in the reference framework
(`src/utils/utils.jl`). These are plain-Python / jax.numpy equivalents of the
type-stable tuple machinery in the Julia reference; in JAX no special machinery
is needed since pytrees are traced statically.
"""
from __future__ import annotations

import datetime as _dt
from typing import Any, Mapping

import jax.numpy as jnp
import numpy as np

__all__ = [
    "safediv",
    "convert_dt",
    "merge_recursive",
    "deduplicate",
    "piecewise_linear",
]


def safediv(x, y):
    """``x / (y + eps)`` if ``y != 0`` else ``Inf``.

    Mirrors reference `src/utils/utils.jl:25`. The ``eps`` regularisation uses
    the machine epsilon of the result dtype.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    eps = jnp.finfo(jnp.result_type(x, y)).eps
    return jnp.where(y == 0, jnp.inf, x / (y + eps))


def convert_dt(dt) -> float:
    """Convert a timedelta-like ``dt`` to seconds (reference `utils.jl:convert_dt`)."""
    if isinstance(dt, _dt.timedelta):
        return dt.total_seconds()
    if isinstance(dt, np.timedelta64):
        return float(dt / np.timedelta64(1, "s"))
    return float(dt)


def merge_recursive(*dicts: Mapping[str, Any]) -> dict:
    """Recursively merge mappings; later arguments take precedence.

    Mirrors `merge_recursive` used by `merge_boundary_conditions`
    (reference `src/boundary_conditions.jl:17`).
    """
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
                out[k] = merge_recursive(out[k], v)
            else:
                out[k] = v
    return out


def deduplicate(items, key=lambda x: x):
    """Stable dedup preserving first occurrence (reference `utils.jl:deduplicate`)."""
    seen = set()
    out = []
    for it in items:
        k = key(it)
        if k not in seen:
            seen.add(k)
            out.append(it)
    return out


def piecewise_linear(*knots):
    """Piecewise-linear profile from ``(depth, value)`` knots with flat
    extrapolation (reference `src/utils/interpolation_utils.jl:6-13`).

    Returns a function ``f(z_depth)`` operating on (positive-down) depths.
    """
    depths = np.asarray([k[0] for k in knots], dtype=np.float64)
    values = np.asarray([k[1] for k in knots], dtype=np.float64)
    order = np.argsort(depths)
    depths, values = depths[order], values[order]

    def f(z):
        return jnp.interp(jnp.asarray(z), depths, values)

    return f
