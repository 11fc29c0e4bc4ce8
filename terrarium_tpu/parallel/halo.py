"""Lateral (cell-axis) halo exchange — the north-star extension point.

The reference explicitly defers lateral coupling ("2D/3D flow",
`README.md:123`); every shipped process is laterally independent. This
module provides the machinery a lateral operator needs (SURVEY §2.11:
"any future lateral coupling becomes a halo exchange" between devices),
plus a reference lateral-diffusion operator wired through the
generic forcing hooks:

* :func:`neighbor_shift` — value of the left/right neighbor column along
  the packed cells axis, edge-replicated (zero-flux ends). Outside
  `shard_map` it is a plain pad-shift: under jit with cells-sharded
  operands XLA's SPMD partitioner inserts the boundary
  `collective-permute` automatically (verified in tests). Inside
  `shard_map` pass ``axis_name``: the single edge column is exchanged
  explicitly with `lax.ppermute` and everything else stays local — the
  halo traffic is one column per shard boundary per step.
* :func:`lateral_diffusion_forcing` — `d(var)/dt += c*(x_{i-1} - 2 x_i +
  x_{i+1})/dx^2`, attachable to ANY prognostic via
  ``initialize(..., forcings={var: fn})`` with no model changes.

Two adjacency levels:

* **index adjacency** (:func:`neighbor_shift`,
  :func:`lateral_diffusion_forcing`) — neighbors along the packed axis;
  physical for `ColumnGrid` transects, the minimal comms pattern.
* **ring-topology adjacency** (:func:`lateral_diffusion_forcing_ring`,
  r5 item 6) — the PHYSICAL (E, W, N, S) neighborhood of a masked
  `ColumnRingGrid` via its precomputed ``neighbor_maps()`` (coast/cap
  links drop symmetrically -> the 5-point Laplacian conserves the global
  sum exactly on the real N72/N145 masks; tests/test_lateral_ring.py).
  Unsharded it is a single 4-wide take along the cells axis; under
  `jax.shard_map` the neighbor gather is decomposed into a fixed-width
  halo exchange (ONE `lax.ppermute` per side per step) plus purely local
  gathers with per-shard index slabs.

With lateral coupling the sharded rollout stays collective-free EXCEPT the
boundary permutes this operator asks for.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["neighbor_shift", "lateral_diffusion_forcing",
           "lateral_diffusion_forcing_ring"]


def neighbor_shift(x, shift: int, axis_name: Optional[str] = None):
    """Neighbor values along the trailing (cells) axis: ``out[..., i] =
    x[..., i - shift]`` with edge replication at the global ends
    (``shift`` is +1 for the left neighbor, -1 for the right).

    With ``axis_name`` (inside `jax.shard_map`), the edge column crossing
    the shard boundary is fetched with `lax.ppermute`; the global ends
    still replicate their own edge (zero-flux)."""
    if shift not in (1, -1):
        raise ValueError("neighbor_shift supports shift = +-1")
    if axis_name is None:
        if shift == 1:
            return jnp.concatenate([x[..., :1], x[..., :-1]], axis=-1)
        return jnp.concatenate([x[..., 1:], x[..., -1:]], axis=-1)

    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    if shift == 1:
        # local right-shift; first local column <- previous shard's last
        halo = jax.lax.ppermute(x[..., -1:], axis_name,
                                [(i, i + 1) for i in range(n - 1)])
        edge = jnp.where(idx == 0, x[..., :1], halo)
        return jnp.concatenate([edge, x[..., :-1]], axis=-1)
    halo = jax.lax.ppermute(x[..., :1], axis_name,
                            [(i + 1, i) for i in range(n - 1)])
    edge = jnp.where(idx == n - 1, x[..., -1:], halo)
    return jnp.concatenate([x[..., 1:], edge], axis=-1)


def lateral_diffusion_forcing(coeff: float, dx: float,
                              variable: str = "internal_energy",
                              axis_name: Optional[str] = None):
    """A forcing ``fn(state, grid)`` adding lateral diffusion of the named
    prognostic along the cell axis: ``c * (x_l - 2x + x_r) / dx**2`` with
    zero-flux global ends. Attach via ``initialize(..., forcings=
    {variable: fn})`` (reference forcing hooks, `src/forcings.jl:13-19`).
    Explicit-diffusion stability requires ``coeff * dt / dx**2 <= 0.5``."""

    def fn(state, grid):
        x = state[variable]
        left = neighbor_shift(x, 1, axis_name)
        right = neighbor_shift(x, -1, axis_name)
        return coeff * (left - 2.0 * x + right) / (dx * dx)

    return fn


def lateral_diffusion_forcing_ring(coeff: float, dx: float, grid,
                                   variable: str = "internal_energy",
                                   axis_name: Optional[str] = None,
                                   n_shards: Optional[int] = None):
    """Physical lateral diffusion on a masked `ColumnRingGrid`:
    ``d(var)/dt += c * sum_n (x_n - x_i) / dx**2`` over the cell's real
    (E, W, N, S) land neighbors (``grid.neighbor_maps()``; coast and polar
    links drop symmetrically, so ``sum_i dx_i/dt == 0`` exactly — the
    conservation test runs on the real N72 mask).

    Attach via ``initialize(..., forcings={variable: fn})``. Explicit
    stability: ``4 * coeff * dt / dx**2 <= 1``. ``dx`` is a uniform nominal
    cell spacing (metric-weighted stencils can reuse the same adjacency).

    With ``axis_name`` (+ ``n_shards``) the returned forcing is the
    `jax.shard_map` form: the packed axis is sharded contiguously; each
    step exchanges a fixed-width edge halo (the global maximum packed
    neighbor offset, precomputed) with one `lax.ppermute` per side, then
    gathers neighbors LOCALLY from the halo-extended shard using this
    shard's index slab — no all-gather, halo traffic = 2 * H columns per
    shard boundary per step.
    """
    nbr = np.asarray(grid.neighbor_maps(), dtype=np.int64)  # (cells, 4)
    cells = nbr.shape[0]

    if axis_name is None:
        nbr_j = jnp.asarray(nbr, dtype=jnp.int32)

        def fn(state, _grid):
            x = state[variable]
            xs = jnp.take(x, nbr_j, axis=-1)  # (..., cells, 4)
            # explicit left-to-right adds: the same association as the
            # sharded form (a 4-way reduce may reassociate by 1 ulp)
            lap = ((xs[..., 0] + xs[..., 1]) + (xs[..., 2] + xs[..., 3])
                   - 4.0 * x)
            return coeff * lap / (dx * dx)

        return fn

    if n_shards is None or cells % n_shards != 0:
        raise ValueError(f"cells={cells} must divide over n_shards="
                         f"{n_shards} (pad the grid with pad_multiple)")
    local = cells // n_shards
    # fixed halo width: the worst packed-index offset any neighbor link
    # crosses (E/W are ~+-1; ring wraps / N-S links span up to ~one ring
    # plus coast gaps)
    offs = nbr - np.arange(cells)[:, None]
    H = int(np.max(np.abs(offs)))
    H = min(H, local)  # a halo can't exceed the neighbor shard's width
    if int(np.max(np.abs(offs))) > local:
        raise ValueError(
            f"neighbor links span {int(np.max(np.abs(offs)))} packed cells "
            f"> shard width {local}; use fewer shards")
    # per-shard LOCAL gather indices into the halo-extended array
    starts = np.arange(n_shards)[:, None, None] * local
    local_idx = nbr.reshape(n_shards, local, 4) - starts + H
    local_idx_j = jnp.asarray(local_idx, dtype=jnp.int32)

    def fn(state, _grid):
        x = state[variable]  # (..., local) shard
        i = jax.lax.axis_index(axis_name)
        fwd = [(k, k + 1) for k in range(n_shards - 1)]
        bwd = [(k + 1, k) for k in range(n_shards - 1)]
        halo_l = jax.lax.ppermute(x[..., -H:], axis_name, fwd)
        halo_r = jax.lax.ppermute(x[..., :H], axis_name, bwd)
        # global packed ends never wrap (E/W wrap stays within a ring's
        # contiguous span), so the unused end halos may be anything
        x_ext = jnp.concatenate([halo_l, x, halo_r], axis=-1)
        idx = jax.lax.dynamic_index_in_dim(local_idx_j, i, axis=0,
                                           keepdims=False)
        xs = jnp.take(x_ext, idx, axis=-1)  # (..., local, 4)
        lap = ((xs[..., 0] + xs[..., 1]) + (xs[..., 2] + xs[..., 3])
               - 4.0 * x)
        return coeff * lap / (dx * dx)

    return fn
