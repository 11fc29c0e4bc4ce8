"""Process/model interface.

JAX equivalent of the reference process protocol
(`src/abstract_model.jl`): a *process* declares variables and contributes pure
state transformations. Where the reference mutates fields via kernel launches,
here every hook is a pure function ``state -> state`` (auxiliary updates via
``state.update``, tendency contributions via ``state.add_tendencies`` which
accumulates with ``+=`` so multiple processes can feed one prognostic
variable, reference `soil_energy.jl:107`).

Processes are frozen dataclasses (hashable, static under ``jax.jit``); all
array work happens on the state they receive. The ``ctx`` argument carries
cross-process dependencies the reference passes positionally (constants,
sibling processes, boundary conditions).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..constants import PhysicalConstants

__all__ = ["Context", "Process"]


@dataclasses.dataclass(frozen=True)
class Context:
    """Cross-cutting dependencies passed to process hooks.

    Mirrors the positional plumbing of the reference's interface methods
    (grid, constants, sibling processes, BCs).
    """

    constants: PhysicalConstants = PhysicalConstants()
    bcs: Any = None  # FieldBCs dict
    extras: Any = None  # model-specific sibling handles (e.g. evapotranspiration)
    #: generic user forcings (reference `src/forcings.jl:13-19`): a dict
    #: ``prognostic_name -> fn(state, grid)`` of source/sink terms added to
    #: the named tendency every step (the prognostic's own units per second).
    #: Dotted names ("ns.var") address namespaced prognostics.
    forcings: Any = None

    def with_bcs(self, bcs):
        return dataclasses.replace(self, bcs=bcs)

    def with_forcings(self, forcings):
        return dataclasses.replace(self, forcings=forcings)


class Process:
    """Base class documenting the process protocol (duck-typed).

    Hooks (all optional, default no-op), mirroring
    `src/abstract_model.jl:109-215`:

    * ``variables() -> tuple[Variable | Namespace, ...]``
    * ``initialize(state, grid, ctx) -> state``
    * ``compute_auxiliary(state, grid, ctx) -> state``
    * ``compute_tendencies(state, grid, ctx) -> state``
    * ``closure(state, grid, ctx) -> state`` — conserved -> continuous remap
    * ``invclosure(state, grid, ctx) -> state`` — continuous -> conserved
    """

    def variables(self):
        return ()

    def initialize(self, state, grid, ctx: Context):
        return state

    def compute_auxiliary(self, state, grid, ctx: Context):
        return state

    def compute_tendencies(self, state, grid, ctx: Context):
        return state

    def closure(self, state, grid, ctx: Context):
        return state

    def invclosure(self, state, grid, ctx: Context):
        return state
