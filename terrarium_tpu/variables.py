"""Symbolic state-variable declarations.

JAX equivalent of the reference variable/metadata system
(`src/abstract_variables.jl`). Processes declare their state symbolically as
:class:`Variable` specs; the framework collates them (:class:`Variables`),
auto-derives tendency slots for prognostic variables, attaches closure
variables, and materialises everything as a :class:`~terrarium_tpu.state.State`
pytree of arrays.

Spatial layout convention:

* ``XYZ`` (center) variables -> arrays of shape ``(Nz, cells)``
* ``XYZ`` (face)   variables -> arrays of shape ``(Nz + 1, cells)``
* ``XY``           variables -> arrays of shape ``(cells,)``

``cells`` is the packed lateral (column) dimension, the trailing
(contiguous) axis; it is the axis sharded across devices. ``k = 0`` is the **bottom** layer
and ``k = Nz - 1`` the **top** (surface) layer, matching the reference's
positive-up convention (`docs/src/introduction/numerical_core.md:21-22`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

__all__ = [
    "XY",
    "XYZ",
    "Variable",
    "Variables",
    "prognostic",
    "auxiliary",
    "input",
    "tendency",
    "namespace",
    "Namespace",
]


# ---------------------------------------------------------------------------
# Dimension tags
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class XYZ:
    """Cell-centered (or z-face) 3D variable (reference `VarDims` XYZ)."""

    face: bool = False  # True -> located on vertical faces (Nz+1 levels)


@dataclasses.dataclass(frozen=True)
class XY:
    """Lateral-only 2D variable (one value per column)."""


VarDims = Any  # XY | XYZ


# ---------------------------------------------------------------------------
# Variable specs
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Variable:
    """Symbolic declaration of a state variable.

    Mirrors the reference `Variable`/`PrognosticVariable`/`AuxiliaryVariable`/
    `InputVariable` types (`src/abstract_variables.jl:137-218`).

    Attributes:
        name: variable name (key in the state pytree).
        dims: :class:`XY` or :class:`XYZ`.
        kind: one of ``"prognostic" | "auxiliary" | "input" | "tendency"``.
        units: unit string (metadata only).
        desc: human-readable description.
        default: default fill value used at allocation.
        domain: optional ``(lo, hi)`` bounds (metadata; e.g. unit interval).
        closure: optional closure-relation process attached to a prognostic
            variable (provides `closure`/`invclosure` and extra variables).
        ctor: optional custom field constructor ``ctor(grid, state_arrays) ->
            array`` for derived auxiliary fields (e.g. the top-layer
            ``ground_temperature`` view, reference `soil_energy.jl:52-57`).
    """

    name: str
    dims: VarDims
    kind: str
    units: str = ""
    desc: str = ""
    default: float = 0.0
    domain: Optional[Tuple[float, float]] = None
    closure: Any = None
    ctor: Optional[Callable] = None

    def key(self):
        return (self.name, self.dims, self.units)


def prognostic(name, dims, *, units="", desc="", default=0.0, domain=None, closure=None):
    """Declare a prognostic variable (auto-creates its tendency slot)."""
    return Variable(name, dims, "prognostic", units=units, desc=desc, default=default,
                    domain=domain, closure=closure)


def auxiliary(name, dims, ctor=None, *, units="", desc="", default=0.0, domain=None):
    """Declare an auxiliary (diagnostic) variable."""
    return Variable(name, dims, "auxiliary", units=units, desc=desc, default=default,
                    domain=domain, ctor=ctor)


def input(name, dims, *, units="", desc="", default=0.0, domain=None):
    """Declare an input (forcing/boundary) variable."""
    return Variable(name, dims, "input", units=units, desc=desc, default=default,
                    domain=domain)


def tendency(name, dims, *, units="", desc=""):
    """Declare an explicit tendency variable (rarely needed directly)."""
    return Variable(name, dims, "tendency", units=units, desc=desc)


@dataclasses.dataclass(frozen=True)
class Namespace:
    """A nested variable namespace, typically a submodel
    (reference `abstract_variables.jl:243-247`)."""

    name: str
    vars: "Variables"

    def key(self):
        return self.name


def namespace(name, vars_or_process):
    if isinstance(vars_or_process, Variables):
        return Namespace(name, vars_or_process)
    return Namespace(name, Variables.of(vars_or_process))


# ---------------------------------------------------------------------------
# Collation
# ---------------------------------------------------------------------------
class Variables:
    """Collated, deduplicated variable groups.

    Reproduces the merge semantics of the reference `Variables` constructor
    (`src/abstract_variables.jl:253-288`):

    * duplicates within each group are merged (first occurrence wins);
    * every prognostic variable contributes a tendency slot;
    * closure variables of prognostic vars are *prepended* to auxiliaries;
    * inputs whose names collide with prognostic/auxiliary vars are dropped;
    * a name may only appear in one group (error otherwise).
    """

    def __init__(self, vars: Sequence[Any]):
        prog, aux, inp, ns = [], [], [], []
        for v in vars:
            if isinstance(v, Namespace):
                ns.append(v)
            elif v.kind == "prognostic":
                prog.append(v)
            elif v.kind == "auxiliary":
                aux.append(v)
            elif v.kind == "input":
                inp.append(v)
            else:
                raise ValueError(f"unexpected variable kind {v.kind!r} for {v.name!r}")

        from .utils.utils import deduplicate

        # dedup by name, first occurrence wins — model declarations precede
        # input-source declarations (which may carry bare metadata), matching
        # the reference's merge order (`model_integrator.jl:154-155`)
        prog = deduplicate(prog, key=lambda v: v.name)
        aux = deduplicate(aux, key=lambda v: v.name)
        inp = deduplicate(inp, key=lambda v: v.name)
        ns = deduplicate(ns, key=Namespace.key)

        # closure variables prepended to auxiliaries
        closure_vars = []
        for v in prog:
            if v.closure is not None:
                closure_vars.extend(variables_of(v.closure))
        aux = deduplicate(list(closure_vars) + aux, key=Variable.key)

        # drop inputs shadowed by prognostic/auxiliary variables
        taken = {v.name for v in prog} | {v.name for v in aux}
        inp = [v for v in inp if v.name not in taken]

        # error on residual cross-group duplicates
        names = [v.name for v in prog] + [v.name for v in aux] + [v.name for v in inp] \
            + [n.name for n in ns]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate variable declarations: {sorted(dupes)}")

        self.prognostic = {v.name: v for v in prog}
        self.auxiliary = {v.name: v for v in aux}
        self.inputs = {v.name: v for v in inp}
        self.namespaces = {n.name: n.vars for n in ns}
        # tendencies derive from prognostic variables
        self.tendencies = {
            v.name: Variable(v.name, v.dims, "tendency", units=v.units + "/s")
            for v in prog
        }

    @staticmethod
    def of(*objs) -> "Variables":
        """Collate variables from processes/variable-sequences/Variables."""
        flat: list = []
        for obj in objs:
            flat.extend(variables_of(obj))
        return Variables(flat)

    def all_names(self):
        return (list(self.prognostic) + list(self.auxiliary) + list(self.inputs))

    def __repr__(self):
        return (f"Variables(prognostic={list(self.prognostic)}, "
                f"auxiliary={list(self.auxiliary)}, inputs={list(self.inputs)}, "
                f"namespaces={list(self.namespaces)})")


def variables_of(obj) -> Tuple[Any, ...]:
    """Extract the variable declarations from an object.

    Accepts: a Variable/Namespace, a sequence of them, or any object with a
    ``variables()`` method (process/model). Mirrors the reference's generic
    `variables` auto-collection (`src/abstract_model.jl:109-130`).
    """
    if obj is None:
        return ()
    if isinstance(obj, (Variable, Namespace)):
        return (obj,)
    if isinstance(obj, Variables):
        out = (list(obj.prognostic.values()) + list(obj.auxiliary.values())
               + list(obj.inputs.values())
               + [Namespace(k, v) for k, v in obj.namespaces.items()])
        return tuple(out)
    if isinstance(obj, (tuple, list)):
        out: list = []
        for o in obj:
            out.extend(variables_of(o))
        return tuple(out)
    if hasattr(obj, "variables"):
        return tuple(variables_of(obj.variables()))
    raise TypeError(f"cannot extract variables from {obj!r}")
