"""Explicit timesteppers and the step-function factory.

JAX equivalent of reference `src/timesteppers/`
(`abstract_timestepper.jl`, `forward_euler.jl`, `heun.jl`). Each stepper is a
pure function ``state -> state``; the whole step is traced once under
``jax.jit`` and the rollout runs as a `lax.scan` (see
:mod:`terrarium_tpu.timesteppers.integrator`). The Heun stage copy of the
reference (`heun.jl:22-25`) is unnecessary: immutability gives stages for free.
"""
from __future__ import annotations

import dataclasses

from ..ops.vertical_ops import apply_flux_bcs
from ..state import State, reset_tendencies

__all__ = ["ForwardEuler", "Heun", "apply_forcings", "explicit_step",
           "prog_xy_map", "update_state"]


def prog_xy_map(model):
    """Map each prognostic name to its declared rank (True = XY), nested per
    namespace: ``{"vars": {name: bool}, "ns": {ns_name: <same>}}``. Threads
    the variable specs into `ops.vertical_ops.apply_flux_bcs` so Flux-BC
    routing never relies on the ambiguous array-shape heuristic (wrong for
    single-layer grids / broadcast XYZ tendencies). Trace-time only."""
    from ..variables import Variables, XY, variables_of

    def of_vars(v):
        return {"vars": {n: isinstance(s.dims, XY)
                         for n, s in v.prognostic.items()},
                "ns": {k: of_vars(nv) for k, nv in v.namespaces.items()}}

    try:
        return of_vars(Variables(list(variables_of(model))))
    except Exception:  # exotic duck-typed models: keep the heuristic
        return None


def apply_forcings(state: State, grid, forcings) -> State:
    """Add generic user source/sink terms to prognostic tendencies
    (reference `src/forcings.jl:13-19`, target-generic dispatch). Each entry
    ``name -> fn(state, grid)`` contributes ``fn``'s value (the prognostic's
    own units per second, shaped like the variable: XY or XYZ) with ``+=``
    semantics, so forcings stack with process tendencies. Dotted names
    (``"ns.var"``) address namespaced prognostics. Runs inside
    :func:`update_state`, i.e. re-evaluated per Heun stage like the
    reference's per-kernel forcing calls."""
    if not forcings:
        return state
    for name, fn in forcings.items():
        if "." in name:
            ns_name, var = name.split(".", 1)
            ns = state.namespaces[ns_name]
            state = state.replace_namespace(
                ns_name, apply_forcings(ns, grid, {var: fn}))
        else:
            state = state.add_tendencies(**{name: fn(state, grid)})
    return state


def explicit_step(state: State, grid, bcs, dt, xy=None) -> State:
    """``u += du/dt * dt`` for every prognostic variable, after adding
    Flux-BC contributions to the tendencies (reference
    `abstract_timestepper.jl:65-141`, `compute_z_bcs!`). Recurses into
    namespaces. ``xy`` is an optional :func:`prog_xy_map` (declared variable
    ranks for Flux-BC routing)."""
    tend = dict(state.tendencies)
    prog = dict(state.prognostic)
    for name in prog:
        var_bcs = (bcs or {}).get(name)
        if var_bcs:
            tend[name] = apply_flux_bcs(
                tend[name], var_bcs, state, grid.dz,
                xy=None if xy is None else xy["vars"].get(name))
        prog[name] = prog[name] + tend[name] * dt
    state = dataclasses.replace(state, prognostic=prog, tendencies=tend)
    if state.namespaces:
        ns = {k: explicit_step(v, grid, bcs, dt,
                               xy=None if xy is None else xy["ns"].get(k))
              for k, v in state.namespaces.items()}
        state = dataclasses.replace(state, namespaces=ns)
    return state


def update_state(model, state: State, ctx, input_sources=()) -> State:
    """reset tendencies -> update inputs -> compute auxiliary -> compute
    tendencies (reference `state_variables.jl:72-80`). Halo fills are implicit
    in the BC-aware operators."""
    state = reset_tendencies(state)
    for src in input_sources:
        state = src.update_inputs(state)
    state = model.compute_auxiliary(state, ctx)
    state = model.compute_tendencies(state, ctx)
    return apply_forcings(state, model.grid, getattr(ctx, "forcings", None))


@dataclasses.dataclass(frozen=True)
class ForwardEuler:
    """First-order explicit Euler (reference `forward_euler.jl:6-31`)."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, input_sources, dt) -> State:
        grid = model.grid
        xy = prog_xy_map(model)
        state = update_state(model, state, ctx, input_sources)
        state = explicit_step(state, grid, ctx.bcs, dt, xy=xy)
        state = model.timestep(state, ctx, dt)
        state = model.closure(state, ctx)
        return state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, input_sources, dt) -> State:
        """Closure-rotated step for lean rollouts: ``closure`` runs at the
        *start* instead of the end, so closure variables (temperature,
        liquid fraction, pressure head) are recomputed from prognostics each
        iteration rather than carried through the scan. Since ``step`` ends
        with ``closure`` and closure is idempotent on a closure-consistent
        state, ``closure ∘ (pre_closure_step)^n ∘ …`` equals ``step^n``
        exactly (see `utils/scan_dce.lean_rollout`)."""
        grid = model.grid
        xy = prog_xy_map(model)
        state = model.closure(state, ctx)
        state = update_state(model, state, ctx, input_sources)
        state = explicit_step(state, grid, ctx.bcs, dt, xy=xy)
        state = model.timestep(state, ctx, dt)
        return state.tick(dt)


@dataclasses.dataclass(frozen=True)
class Heun:
    """Second-order Heun / improved Euler (reference `heun.jl:37-71`):
    predictor step, tendency recomputation at the predicted state, tendency
    averaging, corrector step."""

    dt: float = 300.0

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, input_sources, dt) -> State:
        grid = model.grid
        xy = prog_xy_map(model)
        state = update_state(model, state, ctx, input_sources)

        # predictor stage (functional: no explicit stage copy needed)
        stage = explicit_step(state, grid, ctx.bcs, dt, xy=xy)
        stage = model.timestep(stage, ctx, dt)
        stage = model.closure(stage, ctx)
        stage = stage.tick(dt)
        stage = update_state(model, stage, ctx, input_sources)

        # average tendencies (reference `heun.jl:24-35`)
        avg = {k: 0.5 * (state.tendencies[k] + stage.tendencies[k])
               for k in state.tendencies}
        state = dataclasses.replace(state, tendencies=avg)

        # corrector
        state = explicit_step(state, grid, ctx.bcs, dt, xy=xy)
        state = model.timestep(state, ctx, dt)
        state = model.closure(state, ctx)
        return state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, input_sources, dt) -> State:
        """Closure-rotated Heun step (see `ForwardEuler.pre_closure_step`):
        the trailing closure of `step` moves to the front; the predictor
        stage's internal closure stays in place."""
        grid = model.grid
        xy = prog_xy_map(model)
        state = model.closure(state, ctx)
        state = update_state(model, state, ctx, input_sources)

        stage = explicit_step(state, grid, ctx.bcs, dt, xy=xy)
        stage = model.timestep(stage, ctx, dt)
        stage = model.closure(stage, ctx)
        stage = stage.tick(dt)
        stage = update_state(model, stage, ctx, input_sources)

        avg = {k: 0.5 * (state.tendencies[k] + stage.tendencies[k])
               for k in state.tendencies}
        state = dataclasses.replace(state, tendencies=avg)

        state = explicit_step(state, grid, ctx.bcs, dt, xy=xy)
        state = model.timestep(state, ctx, dt)
        return state.tick(dt)
