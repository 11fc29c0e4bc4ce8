"""Vertical boundary conditions.

JAX replacement for the reference's Oceananigans BC machinery
(`src/boundary_conditions.jl`, halo fills in `src/state_variables.jl:85-100`).
Instead of filling halo regions of mutable fields, boundary conditions are
applied *inside* the vertical operators:

* :class:`Dirichlet` (Value BC) -> ghost value ``2*value - c_boundary`` so the
  boundary-face interpolation hits ``value`` exactly (Oceananigans halo-fill
  semantics for Value BCs).
* :class:`Neumann` (Gradient BC) -> prescribed gradient at the boundary face.
* :class:`Flux` -> added directly to the tendency of the boundary cell during
  the explicit step (`compute_z_bcs!` semantics,
  `src/timesteppers/abstract_timestepper.jl:65-77`). Sign convention matches
  Oceananigans: fluxes point in +z, so a positive top flux cools/drains the
  column (``tend[top] -= q/dz_top``) and a positive bottom flux feeds it
  (``tend[bottom] += q/dz_bot``).
* default (no BC) -> zero-gradient ghost, i.e. zero diffusive boundary flux.

BC *values* may be: a Python scalar, a ``(cells,)`` array, the name of an
input variable (string; reads ``state.inputs[name]`` each step — the
reference's `Variable` placeholder BCs, `boundary_conditions.jl:25-28`), or a
callable traced into the step — ``f(t)`` or ``f(t, state)`` (dispatched on
the number of REQUIRED positional parameters, so defaulted/keyword-only/
**kwargs parameters do not change which form is called); the two-argument
form enables state-dependent boundary values, a superset of the reference's
placeholder BCs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax.numpy as jnp

__all__ = ["Dirichlet", "Neumann", "Flux", "NoFlux", "resolve_bc_value",
           "get_bc", "merge_boundary_conditions", "FieldBCs"]


@dataclasses.dataclass(frozen=True)
class InputRef:
    """A scaled reference to a state variable used as a BC value — the
    reference's `Variable` placeholder BCs with an optional sign flip (the
    LandModel installs ``-infiltration`` as the water top BC,
    `land_model.jl:46-66`)."""

    name: str
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """Value boundary condition (Oceananigans `ValueBoundaryCondition`)."""

    value: Any


@dataclasses.dataclass(frozen=True)
class Neumann:
    """Gradient boundary condition (Oceananigans `GradientBoundaryCondition`)."""

    gradient: Any


@dataclasses.dataclass(frozen=True)
class Flux:
    """Flux boundary condition (Oceananigans `FluxBoundaryCondition`).
    Flux is in the +z direction (positive up)."""

    value: Any


def NoFlux():
    """Zero-flux BC (Oceananigans `NoFluxBoundaryCondition`)."""
    return Flux(0.0)


FieldBCs = Dict[str, Dict[str, Any]]  # {var_name: {"top": bc, "bottom": bc}}


def merge_boundary_conditions(*bcs: FieldBCs) -> FieldBCs:
    """Recursively merge BC dicts; later args take precedence
    (reference `boundary_conditions.jl:17`)."""
    from ..utils.utils import merge_recursive

    return merge_recursive(*bcs)


def get_bc(bcs: Optional[FieldBCs], var: str, side: str):
    """Look up the BC for ``var`` on ``side`` ('top'|'bottom'), or None."""
    if not bcs:
        return None
    return bcs.get(var, {}).get(side, None)


def resolve_bc_value(value, state):
    """Evaluate a BC value spec against the current state/clock (see module
    docstring for supported forms). Returns a scalar or ``(cells,)`` array.

    Callables may take ``(t)`` or ``(t, state)`` — the two-argument form
    enables state-dependent boundary values (a superset of the reference's
    `getbc` Variable placeholders, `boundary_conditions.jl:25-28`, which can
    only read an input field verbatim)."""
    if isinstance(value, str):
        return state.inputs[value] if value in state.inputs else state[value]
    if isinstance(value, InputRef):
        base = (state.inputs[value.name] if value.name in state.inputs
                else state[value.name])
        return value.scale * base
    if callable(value):
        import inspect

        try:
            params = inspect.signature(value).parameters.values()
            # only required positional parameters decide the call form —
            # defaulted/keyword-only/**kwargs params must not flip a
            # documented f(t) callable into the f(t, state) form
            nreq = sum(1 for p in params
                       if p.kind in (p.POSITIONAL_ONLY,
                                     p.POSITIONAL_OR_KEYWORD)
                       and p.default is p.empty)
        except (TypeError, ValueError):  # builtins/ufuncs without signature
            nreq = 1
        return value(state.clock.time, state) if nreq >= 2 \
            else value(state.clock.time)
    return jnp.asarray(value)
