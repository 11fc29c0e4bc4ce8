"""Differentiable stepping / rollout helpers.

JAX replacement for the reference's Enzyme + Checkpointing.jl AD path
(`ext/TerrariumCheckpointingExt`, `examples/autodiff/differentiating_terrarium.jl`):
pure step functions differentiate with `jax.grad`; long rollouts control
reverse-mode memory with `jax.checkpoint` (rematerialisation) — the
functional analogue of Revolve checkpointing schemes.

Remat policy space (not yet measured on the GPU; ROADMAP A7):

* ``remat=False`` — store every step's residuals: fastest backward, O(N)
  memory. Viable surprisingly far (device memory is large relative to this
  model family's state).
* ``remat=True`` — per-step `jax.checkpoint`: O(1) residual memory per
  step + one forward recompute per step (the reference's
  ``@ad_checkpoint`` per-step wrapping).
* ``segment=k`` — two-level scan: outer scan over N/k checkpointed
  segments, inner scan of k plain steps. Memory O(k + N/k) states with ONE
  extra forward pass total — the sqrt-N schedule; strictly dominates
  per-step remat in recompute count at equal asymptotic memory when
  k ~ sqrt(N).
* ``policy=...`` — `jax.checkpoint` with a `jax.checkpoint_policies``
  predicate (e.g. ``dots_saveable`` keeps the matmul cumsum products).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import jax

__all__ = ["make_step_fn", "make_rollout_fn"]


def make_step_fn(model, timestepper, ctx, input_sources=()) -> Callable:
    """A pure ``step(state, dt) -> state`` closure over static config."""

    def step(state, dt):
        return timestepper.step(model, state, ctx, input_sources, dt)

    return step


def make_rollout_fn(model, timestepper, ctx, input_sources=(), *,
                    steps: int, remat: bool = False,
                    segment: Optional[int] = None,
                    policy: Any = None, lean: bool = False) -> Callable:
    """A pure ``rollout(state, dt) -> state`` over ``steps`` steps.

    See the module docstring for the remat policy space. ``lean=True`` uses
    the closure-rotated ``pre_closure_step`` cycle (`utils/scan_dce`), so
    the scanned carry — and therefore the per-boundary residuals the
    backward pass stores — shrinks to the live prognostics; the trailing
    ``closure`` restores exact equality with ``step^n`` on the prognostics.
    """
    ckpt_kwargs = {} if policy is None else {"policy": policy}

    if lean and segment is not None:
        raise ValueError("lean=True composes with per-step remat/policies, "
                         "not with segment= (the lean carry already "
                         "minimizes per-boundary residuals)")

    if lean and not hasattr(timestepper, "pre_closure_step"):
        raise ValueError(
            f"lean=True requires a timestepper with pre_closure_step; "
            f"{type(timestepper).__name__} has none (a silent fall-through "
            f"would carry O(full-state) backward residuals)")

    if lean:
        from ..utils.scan_dce import lean_rollout

        def step(state, dt):
            return timestepper.pre_closure_step(model, state, ctx,
                                                input_sources, dt)

        wrap = partial(jax.checkpoint, **ckpt_kwargs) \
            if (remat or policy is not None) else None

        def rollout(state, dt):
            out = lean_rollout(step, state, dt, steps, wrap=wrap)
            return model.closure(out, ctx)

        return rollout

    step = make_step_fn(model, timestepper, ctx, input_sources)

    if segment is not None:
        if steps % segment != 0:
            raise ValueError(f"steps={steps} not divisible by segment={segment}")

        @partial(jax.checkpoint, **ckpt_kwargs)
        def chunk(state, dt):
            def body(s, _):
                return step(s, dt), None

            out, _ = jax.lax.scan(body, state, None, length=segment)
            return out

        def rollout(state, dt):
            def body(s, _):
                return chunk(s, dt), None

            out, _ = jax.lax.scan(body, state, None, length=steps // segment)
            return out

        return rollout

    if remat or policy is not None:
        step = jax.checkpoint(step, **ckpt_kwargs)

    def rollout(state, dt):
        def body(s, _):
            return step(s, dt), None

        out, _ = jax.lax.scan(body, state, None, length=steps)
        return out

    return rollout
