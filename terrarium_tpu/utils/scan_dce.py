"""Lean scan rollouts: automatic dead-carry elimination.

A timestep is a pure function ``state -> state``, and a rollout is a
``lax.scan`` carrying the whole state pytree. Several state groups are
*scratch within a step* — tendencies are zeroed on entry
(`stepping.update_state`), transient auxiliaries (e.g. face hydraulic
conductivities, the water table) are recomputed before they are read. XLA
cannot drop them from the loop carry because they are also loop *outputs*,
so every scan iteration pays an HBM write + read for values nothing consumes.

Which leaves are dead is model-dependent (``ground_temperature`` is dead in
a bare ``SoilModel`` but read by the surface energy balance in a
``LandModel``), so instead of manual declarations we ask JAX: trace the step
once to a jaxpr, run dead-code elimination with all outputs live, and carry
only the inputs the step actually consumes. Dead leaves are reconstructed as
zeros inside the loop body. The final step runs *outside* the scan on the
full state, so the post-rollout state (tendencies, transient auxiliaries) is
bit-identical to stepping sequentially.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["lean_rollout"]


def _dead_input_mask(flat_step, leaves, dt):
    """Trace ``flat_step(leaves, dt)`` and return the used-input mask from
    jaxpr-level DCE (True = consumed). Falls back to all-live if the internal
    DCE API is unavailable."""
    try:
        from jax.interpreters import partial_eval as pe

        closed = jax.make_jaxpr(flat_step)(leaves, dt)
        _, used = pe.dce_jaxpr(closed.jaxpr,
                               [True] * len(closed.jaxpr.outvars))
        return list(used)
    except Exception:  # pragma: no cover - defensive: internal API drift
        return [True] * (len(leaves) + 1)


def lean_rollout(step, state, dt, n: int, unroll: int = 1, wrap=None):
    """Apply ``state = step(state, dt)`` ``n`` times; the first ``n - 1``
    applications run under a `lax.scan` whose carry holds only the live state
    leaves, the last one runs on the full state. Bit-identical to a
    sequential loop of ``step``. ``unroll`` is forwarded to ``lax.scan``
    (XLA replicates the body per unrolled iteration, amortizing loop
    bookkeeping and enabling cross-step fusion).

    ``wrap`` (e.g. ``jax.checkpoint``) is applied to the scan body AFTER the
    dead-carry analysis, so a rematerialised body still carries — and its
    backward pass still stores residuals for — only the live leaves
    (per-step remat over the lean carry; see timesteppers/autodiff.py)."""
    if n <= 0:
        return state
    leaves, treedef = jax.tree.flatten(state)

    def flat_step(lv, d):
        out = step(jax.tree.unflatten(treedef, lv), d)
        out_leaves = jax.tree.leaves(out)
        if len(out_leaves) != len(lv):
            raise ValueError("step must preserve the state pytree structure")
        return out_leaves

    used = _dead_input_mask(flat_step, leaves, dt)
    used_leaves = used[:len(leaves)]  # trailing entries cover dt
    live = [i for i, u in enumerate(used_leaves) if u]

    if n > 1 and len(live) < len(leaves):
        shapes = [(x.shape, x.dtype) for x in leaves]

        def rebuild(live_vals):
            it = iter(live_vals)
            return [next(it) if u else jnp.zeros(*shapes[i])
                    for i, u in enumerate(used_leaves)]

        def body_core(carry):
            out = flat_step(rebuild(carry), dt)
            return [out[i] for i in live]

        if wrap is not None:
            body_core = wrap(body_core)

        def body(carry, _):
            return body_core(carry), None

        carry, _ = jax.lax.scan(body, [leaves[i] for i in live], None,
                                length=n - 1, unroll=min(unroll, n - 1))
        state = jax.tree.unflatten(treedef, rebuild(carry))
    elif n > 1:
        def body_core_full(lv):
            return flat_step(lv, dt)

        if wrap is not None:
            body_core_full = wrap(body_core_full)

        def body_full(lv, _):
            return body_core_full(lv), None

        leaves, _ = jax.lax.scan(body_full, leaves, None, length=n - 1,
                                 unroll=min(unroll, n - 1))
        state = jax.tree.unflatten(treedef, leaves)

    return step(state, dt)
