"""Debugging / NaN-check hooks.

JAX equivalent of the reference debug subsystem
(`src/diagnostics/debugging.jl`): a global debug flag (environment variable
``TERRARIUM_TPU_DEBUG``) that, when enabled, turns on JAX NaN checking
(`jax_debug_nans` — the analogue of the reference's NaN-check hook after
every kernel launch) and enables the host-side `nancheck` state validator.
Pure functions make data races structurally impossible (SURVEY §5), so no
sanitizers are needed beyond numerical checks.
"""
from __future__ import annotations

import os
from typing import List

import jax
import numpy as np

__all__ = ["DEBUG", "enable_debug", "nancheck", "debug_callback"]

DEBUG = os.environ.get("TERRARIUM_TPU_DEBUG", "").lower() in ("1", "true", "yes")


def enable_debug(on: bool = True):
    """Toggle debug mode at runtime (reference `debugging.jl:1-10`)."""
    global DEBUG
    DEBUG = on
    jax.config.update("jax_debug_nans", on)


if DEBUG:
    jax.config.update("jax_debug_nans", True)


def nancheck(state, where: str = "") -> List[str]:
    """Check every field for non-finite values; raise with the offending
    variable names (reference `nancheck!`, `debugging.jl:20-48`)."""
    bad = []
    for group in ("prognostic", "auxiliary", "inputs", "tendencies"):
        for name, arr in getattr(state, group).items():
            if not np.all(np.isfinite(np.asarray(arr))):
                bad.append(f"{group}.{name}")
    for ns, sub in state.namespaces.items():
        bad.extend(f"{ns}.{b}" for b in nancheck_soft(sub))
    if bad:
        raise FloatingPointError(
            f"non-finite values detected{' at ' + where if where else ''}: {bad}")
    return bad


def nancheck_soft(state) -> List[str]:
    try:
        nancheck(state)
        return []
    except FloatingPointError as e:
        return [str(e)]


def debug_callback(sim):
    """Simulation callback validating the state when DEBUG is on (the
    reference's `debugsite!` hook after every launch,
    `grid_utils.jl:5`); cheap no-op otherwise."""
    if DEBUG:
        nancheck(sim.state, where=f"t={sim.current_time}")
