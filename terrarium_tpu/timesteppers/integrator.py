"""Simulation driver.

JAX equivalent of the reference `ModelIntegrator`
(`src/timesteppers/model_integrator.jl`). The hot loop is a single jitted
step function; multi-step rollouts run under `jax.lax.scan`, so the whole
simulation executes on-device without host round-trips
(replacing the reference's per-step kernel-launch loop, `run!` at
`model_integrator.jl:72-88`).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp

from .stepping import ForwardEuler, update_state
from ..state import State, build_state
from ..utils.utils import convert_dt
from ..variables import Variables, variables_of
from ..io.input_sources import collect_input_variables

__all__ = ["Simulation", "initialize"]


def _split_sources(sources):
    """Partition sources into jit-argument (registered pytrees) vs opaque
    closure-captured (duck-typed user objects that are not registered
    pytrees). Returns (dyn: {index: src}, static: {index: src})."""
    dyn, static = {}, {}
    for i, src in enumerate(sources):
        (static if jax.tree_util.all_leaves([src]) else dyn)[i] = src
    return dyn, static


def _merge_sources(dyn, static):
    """Reassemble the original source tuple from the two partitions."""
    n = len(dyn) + len(static)
    return tuple(dyn[i] if i in dyn else static[i] for i in range(n))


class Simulation:
    """Holds the model, state, forcing, timestepper, and compiled step.

    Unlike the reference's mutable integrator, the state is an immutable
    pytree; `step`/`run` replace it functionally. I/O-observing runs use
    chunked scans with host callbacks between chunks.
    """

    def __init__(self, model, timestepper, state: State, input_sources=(),
                 bcs=None, initializers=None, forcings=None):
        self.model = model
        self.timestepper = timestepper
        self.state = state
        # device-resident source leaves: sources are passed as jit arguments
        # every step/rollout call, so host numpy leaves would re-transfer the
        # full forcing each call. (Built-in sources are registered pytrees —
        # see io/input_sources.py; duck-typed user sources that are NOT
        # registered pytrees pass through untouched and remain opaque
        # closure captures inside their own methods.)
        self.input_sources = tuple(
            src if jax.tree_util.all_leaves([src])
            else jax.tree.map(jnp.asarray, src)
            for src in input_sources)
        self.bcs = bcs or {}
        self.initializers = initializers or {}
        self.forcings = dict(forcings or {})
        self.ctx = model.make_context(bcs=self.bcs)
        if self.forcings:
            # generic per-variable forcing hooks (reference
            # `src/forcings.jl:13-19`); applied in `stepping.update_state`
            self.ctx = self.ctx.with_forcings(self.forcings)
        self._step_fn = None
        self._rollout_fns = {}
        #: `lax.scan` unroll factor for multi-step rollouts (perf knob;
        #: equal results up to multiply-add contraction for any value).
        self.scan_unroll = 1

    # -- compiled step ----------------------------------------------------
    @property
    def step_fn(self):
        if self._step_fn is None:
            model, ts, ctx = self.model, self.timestepper, self.ctx

            # registered-pytree sources enter as a pytree ARGUMENT (see
            # io/input_sources.py): closure-captured forcing arrays would be
            # baked into the HLO as literal constants (170 MB+ at N145
            # coupled scale). Duck-typed user sources that are NOT registered
            # pytrees cannot be jit arguments; they fall back to closure
            # capture. The wrapper detects a swapped-out opaque source (by
            # identity) and rebuilds the compiled step so the new closure is
            # traced in — without this, the first compile's sources would be
            # silently reused forever.
            static = _split_sources(self.input_sources)[1]
            static_ids = {i: id(s) for i, s in static.items()}

            @jax.jit
            def step(state, dt, dyn_sources):
                return ts.step(model, state, ctx,
                               _merge_sources(dyn_sources, static), dt)

            def wrapper(state, dt):
                dyn, stat_now = _split_sources(self.input_sources)
                if {i: id(s) for i, s in stat_now.items()} != static_ids:
                    self._step_fn = None  # opaque sources changed: rebuild
                    return self.step_fn(state, dt)
                return step(state, dt, dyn)

            # expose the inner jit for cache introspection (retrace tests,
            # `jax.jit` cache stability): the wrapper is a plain function,
            # so forward the jit's cache accessors.
            wrapper._jit = step
            wrapper._cache_size = step._cache_size
            self._step_fn = wrapper
        return self._step_fn

    def _rollout_fn(self, n_inner: int):
        key = (n_inner, int(self.scan_unroll))
        if key not in self._rollout_fns:
            model, ts, ctx = self.model, self.timestepper, self.ctx

            # NOTE: no buffer donation — aux updates may alias input buffers
            # (e.g. rainfall_ground = rainfall with NoCanopyInterception), and
            # donation rejects duplicated buffers in the argument pytree.
            from ..utils.scan_dce import lean_rollout

            unroll = int(self.scan_unroll)

            # registered sources are a pytree ARGUMENT (loop-invariant scan
            # inputs), not a closure capture — captured forcing arrays would
            # be embedded in the HLO as literal constants (see
            # io/input_sources.py). Opaque user sources fall back to closure
            # capture with the same swap detection as step_fn.
            static = _split_sources(self.input_sources)[1]
            static_ids = {i: id(s) for i, s in static.items()}

            @partial(jax.jit, static_argnames=("n",))
            def rollout(state, dt, dyn_sources, n):
                sources = _merge_sources(dyn_sources, static)
                if hasattr(ts, "pre_closure_step"):
                    # closure-rotated cycle: closure ∘ (pre_closure_step)^n
                    # == step^n, but the scan carry shrinks to prognostics
                    # (+ clock/inputs) — closure vars are recomputed on-chip
                    # each iteration instead of round-tripping through HBM.
                    state = lean_rollout(
                        lambda s, d: ts.pre_closure_step(model, s, ctx,
                                                         sources, d),
                        state, dt, n, unroll=unroll)
                    return model.closure(state, ctx)
                return lean_rollout(
                    lambda s, d: ts.step(model, s, ctx, sources, d),
                    state, dt, n, unroll=unroll)

            fn = partial(rollout, n=n_inner)

            def wrapper(state, dt, _fn=fn, _key=key):
                dyn, stat_now = _split_sources(self.input_sources)
                if {i: id(s) for i, s in stat_now.items()} != static_ids:
                    del self._rollout_fns[_key]  # opaque sources changed
                    return self._rollout_fn(_key[0])(state, dt)
                return _fn(state, dt, dyn)

            wrapper._jit = rollout
            wrapper._cache_size = rollout._cache_size
            self._rollout_fns[key] = wrapper
        return self._rollout_fns[key]

    # -- public API (mirrors `model_integrator.jl`) -----------------------
    @property
    def current_time(self):
        return float(self.state.clock.time)

    @property
    def iteration(self):
        return int(self.state.clock.iteration)

    def timestep(self, dt=None, finalize=True):
        """Advance one step (reference `timestep!`, `model_integrator.jl:125-131`)."""
        dt = convert_dt(dt) if dt is not None else self.timestepper.default_dt()
        self.state = self.step_fn(self.state, dt)
        if finalize:
            self.compute_auxiliary()
        return self

    def compute_auxiliary(self):
        self.state = jax.jit(
            lambda s: self.model.compute_auxiliary(s, self.ctx))(self.state)
        return self

    def run(self, steps: Optional[int] = None, period=None, dt=None,
            callbacks: Sequence = (), callback_interval: int = 0):
        """Run for ``steps`` or a time ``period`` (reference `run!`,
        `model_integrator.jl:72-88`). Without callbacks the whole rollout is
        one on-device `lax.scan`; with callbacks the scan is chunked at the
        callback interval and each callback receives ``(sim)`` on host."""
        dt = convert_dt(dt) if dt is not None else self.timestepper.default_dt()
        if steps is None:
            if period is None:
                raise ValueError("either `steps` or `period` must be specified")
            steps = int(convert_dt(period) // dt)
        if callbacks and callback_interval > 0:
            done = 0
            while done < steps:
                n = min(callback_interval, steps - done)
                self.state = self._rollout_fn(n)(self.state, dt)
                done += n
                self.compute_auxiliary()
                for cb in callbacks:
                    cb(self)
        else:
            self.state = self._rollout_fn(int(steps))(self.state, dt)
            self.compute_auxiliary()
        return self

    def reinitialize(self):
        """Reset state to initial conditions (reference `initialize!`,
        `model_integrator.jl:96-109`)."""
        self.state = _initial_state(self.model, self.input_sources,
                                    self.initializers, self.ctx)
        return self

    def __repr__(self):
        # concise summary (the reference pretty-prints every model type,
        # `abstract_model.jl:225-261`)
        return (f"Simulation({type(self.model).__name__} on "
                f"{getattr(self.model, 'grid', None)!r}, "
                f"{type(self.timestepper).__name__}, "
                f"t={self.current_time:g}s, iter={self.iteration})")


def _initial_state(model, input_sources, initializers, ctx) -> State:
    from ..models.initializers import apply_field_initializers

    variables = Variables.of(model, collect_input_variables(input_sources))
    state = build_state(variables, model.grid)
    # seed inputs (reference `model_integrator.jl:101-103`)
    for src in input_sources:
        state = src.initialize_inputs(state)
    # user field initializers (reference `model_integrator.jl:106`)
    state = apply_field_initializers(state, model.grid, initializers)
    # model + process initializers (reference `model_integrator.jl:108`)
    state = model.initialize(state, ctx)
    return state


def initialize(model, timestepper=None, input_sources=(), *, initializers=None,
               boundary_conditions=None, forcings=None) -> Simulation:
    """Create and initialize a :class:`Simulation`
    (reference `initialize`, `model_integrator.jl:145-161`).

    ``forcings`` attaches generic source/sink terms to any prognostic
    variable (reference `src/forcings.jl:13-19`): a dict
    ``name -> fn(state, grid)`` whose values are added to the named tendency
    every step (the prognostic's own units per second; dotted ``"ns.var"``
    names address namespaced prognostics)."""
    timestepper = timestepper if timestepper is not None else ForwardEuler()
    sim = Simulation(model, timestepper, state=None,
                     input_sources=input_sources, bcs=boundary_conditions,
                     initializers=initializers, forcings=forcings)
    sim.state = _initial_state(model, sim.input_sources, sim.initializers, sim.ctx)
    # fail fast on forcings targeting unknown/non-prognostic variables
    for name in sim.forcings:
        st, var = sim.state, name
        if "." in name:
            ns_name, var = name.split(".", 1)
            if ns_name not in st.namespaces:
                raise KeyError(f"forcing target namespace {ns_name!r} not found")
            st = st.namespaces[ns_name]
        if var not in st.prognostic:
            raise KeyError(
                f"forcing target {name!r} is not a prognostic variable "
                f"(prognostics: {sorted(st.prognostic)})")
    return sim
