"""State container: a JAX pytree of field arrays.

JAX equivalent of the reference `StateVariables`
(`src/state_variables.jl:16-54`). Where the reference holds mutable
Oceananigans `Field`s partitioned into prognostic/tendencies/auxiliary/inputs
(+ namespaces) and mutates them in place, here the state is an **immutable
registered pytree** of ``jnp`` arrays; every step is a pure function
``state -> state``. This makes the Heun stage copy
(`src/timesteppers/heun.jl:22-25`) and Enzyme `Duplicated` shadow states
unnecessary — functional updates and `jax.grad` replace both.

Attribute access forwards across groups like the reference's property
forwarding: ``state.temperature`` finds the array whichever group it lives in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from .variables import Variables, XY, XYZ

__all__ = ["Clock", "State", "build_state", "reset_tendencies"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Clock:
    """Simulation clock (reference: Oceananigans `Clock` used in
    `src/timesteppers/model_integrator.jl`)."""

    time: Any  # scalar array, seconds since start
    iteration: Any  # scalar int array

    @staticmethod
    def zero(nf=jnp.float64):
        return Clock(jnp.zeros((), dtype=nf), jnp.zeros((), dtype=jnp.int64 if nf == jnp.float64 else jnp.int32))

    def tick(self, dt) -> "Clock":
        return Clock(self.time + dt, self.iteration + 1)


_GROUPS = ("prognostic", "tendencies", "auxiliary", "inputs")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class State:
    """Immutable state pytree (see module docstring)."""

    prognostic: Dict[str, Any]
    tendencies: Dict[str, Any]
    auxiliary: Dict[str, Any]
    inputs: Dict[str, Any]
    namespaces: Dict[str, "State"]
    clock: Clock

    # -- access -----------------------------------------------------------
    def __getattr__(self, name):
        # only called when normal attribute lookup fails
        for g in ("prognostic", "auxiliary", "inputs"):
            d = object.__getattribute__(self, g)
            if name in d:
                return d[name]
        ns = object.__getattribute__(self, "namespaces")
        if name in ns:
            return ns[name]
        raise AttributeError(f"state has no variable {name!r}")

    def __getitem__(self, name):
        return self.__getattr__(name)

    def __contains__(self, name):
        return any(name in getattr(self, g) for g in ("prognostic", "auxiliary", "inputs"))

    def group_of(self, name) -> str:
        for g in _GROUPS:
            if name in getattr(self, g):
                return g
        raise KeyError(name)

    # -- functional updates ----------------------------------------------
    def update(self, updates: Dict[str, Any] = None, /, **kw) -> "State":
        """Return a new state with the named variables replaced. Each name is
        routed to the group it was declared in (prognostic/auxiliary/inputs).

        Same-size values are canonicalized (reshaped) to the existing leaf's
        shape, so shape-polymorphic physics keeps the state layout stable —
        e.g. a ``(cells,)`` reduction written to a ``(1, cells)`` leaf, or a
        ``(1, cells)`` row slice written to a ``(cells,)`` leaf."""
        updates = {**(updates or {}), **kw}
        new = {g: dict(getattr(self, g)) for g in _GROUPS}
        for name, val in updates.items():
            for g in ("prognostic", "auxiliary", "inputs"):
                if name in new[g]:
                    cur = new[g][name]
                    cshape = getattr(cur, "shape", None)
                    vshape = getattr(val, "shape", None)
                    if (cshape is not None and vshape is not None
                            and vshape != cshape):
                        # only the documented row cases may be reshaped: one
                        # shape is the other with a prepended leading 1. Any
                        # other same-size mismatch (e.g. a transposed array)
                        # would be silently row-major-scrambled — raise.
                        longer, shorter = ((vshape, cshape)
                                           if len(vshape) > len(cshape)
                                           else (cshape, vshape))
                        if (len(longer) == len(shorter) + 1
                                and longer[0] == 1
                                and tuple(longer[1:]) == tuple(shorter)):
                            val = jnp.reshape(val, cshape)
                        else:
                            raise ValueError(
                                f"update for {name!r} has shape {vshape}, "
                                f"incompatible with the state leaf's "
                                f"{cshape} (only a leading length-1 axis "
                                f"may differ)")
                    new[g][name] = val
                    break
            else:
                raise KeyError(f"unknown state variable {name!r}")
        return dataclasses.replace(self, **new)

    def add_tendencies(self, incs: Dict[str, Any] = None, /, **kw) -> "State":
        """Accumulate tendency increments (``+=`` semantics so multiple
        processes can contribute, reference `soil_energy.jl:107`)."""
        incs = {**(incs or {}), **kw}
        tend = dict(self.tendencies)
        for name, inc in incs.items():
            tend[name] = tend[name] + inc
        return dataclasses.replace(self, tendencies=tend)

    def replace_namespace(self, name, ns_state: "State") -> "State":
        ns = dict(self.namespaces)
        ns[name] = ns_state
        return dataclasses.replace(self, namespaces=ns)

    def with_clock(self, clock: Clock) -> "State":
        return dataclasses.replace(self, clock=clock)

    def tick(self, dt) -> "State":
        out = self.with_clock(self.clock.tick(dt))
        if out.namespaces:
            out = dataclasses.replace(
                out, namespaces={k: v.tick(dt) for k, v in out.namespaces.items()})
        return out

    def __repr__(self):
        def keys(d):
            return ", ".join(d)
        return (f"State(prognostic=[{keys(self.prognostic)}], "
                f"auxiliary=[{keys(self.auxiliary)}], inputs=[{keys(self.inputs)}], "
                f"namespaces=[{keys(self.namespaces)}], t={self.clock.time})")


def build_state(variables: Variables, grid, clock: Clock = None) -> State:
    """Allocate a :class:`State` for the given variable declarations.

    Mirrors the reference allocation cascade
    (`src/state_variables.jl:303-381`): groups are materialised in the order
    inputs -> tendencies -> prognostic -> auxiliary (auxiliaries may have
    custom ``ctor``s reading previously-allocated arrays), then namespaces
    recursively.
    """
    clock = clock if clock is not None else Clock.zero(jnp.dtype(grid.nf))

    arrays: Dict[str, Any] = {}

    def alloc(var):
        return grid.allocate(var.dims, fill=var.default)

    inputs = {}
    for v in variables.inputs.values():
        inputs[v.name] = arrays[v.name] = alloc(v)
    tendencies = {}
    for v in variables.tendencies.values():
        tendencies[v.name] = grid.allocate(v.dims, fill=0.0)
    prognostic = {}
    for v in variables.prognostic.values():
        prognostic[v.name] = arrays[v.name] = alloc(v)
    auxiliary = {}
    for v in variables.auxiliary.values():
        if v.ctor is not None:
            auxiliary[v.name] = arrays[v.name] = jnp.asarray(v.ctor(grid, arrays), dtype=grid.nf)
        else:
            auxiliary[v.name] = arrays[v.name] = alloc(v)

    namespaces = {
        name: build_state(ns_vars, grid, clock)
        for name, ns_vars in variables.namespaces.items()
    }
    return State(prognostic, tendencies, auxiliary, inputs, namespaces, clock)


def reset_tendencies(state: State) -> State:
    """Zero all tendency arrays (reference `state_variables.jl:127-136`)."""
    tend = {k: jnp.zeros_like(v) for k, v in state.tendencies.items()}
    ns = {k: reset_tendencies(v) for k, v in state.namespaces.items()}
    return dataclasses.replace(state, tendencies=tend, namespaces=ns)
