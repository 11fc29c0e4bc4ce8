"""Vertical finite-volume stencil operators.

Replacement for the Oceananigans stencil operators used by the reference
(`∂zᵃᵃᶜ`, `∂zᵃᵃᶠ`, `ℑzᵃᵃᶠ`, `Δzᵃᵃᶜ`; see SURVEY §3.3). All operators are
vectorised over the whole ``(Nz, cells)`` block — XLA fuses the shifted
adds/multiplies into elementwise passes over the array (z leading, cells
contiguous). ``k = 0`` is the bottom layer, ``k = Nz - 1`` the top
(surface).

Face arrays have shape ``(Nz + 1, cells)``; face ``f`` sits between centers
``f - 1`` and ``f`` (face 0 = bottom boundary, face Nz = top boundary).
"""
from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp

from .bcs import Dirichlet, Flux, Neumann, resolve_bc_value

__all__ = [
    "ghosts",
    "grad_faces",
    "interp_faces_mid",
    "interp_faces_min",
    "div_faces",
    "apply_flux_bcs",
    "cumsum_z",
    "cummin_z",
    "cumsum_cummin_z",
    "pad_z",
    "shift_z",
]

#: How z-axis shifts (row concatenations) lower. ``"pad"`` expresses each
#: shift as ONE `lax.pad` with negative padding on one side (trim) and
#: positive on the other (fill), which XLA can fold into the consuming
#: fusion; ``"concat"`` keeps the slice + concatenate lowering. The choice
#: has not been measured on the GPU yet.
#:
#: The pad lowering is only used when the default backend is NOT the CPU:
#: the EAGER `lax.pad` thunk heap-corrupted on an earlier jaxlib CPU build
#: (repeated eager pads of a (20, 4) f64 array aborted with glibc
#: "free(): invalid next size"; the jitted form was clean over 2000
#: iterations). A tracer check alone is not sufficient — JVP/batch tracers
#: from unjitted `jax.grad`/`jax.vmap` still dispatch their primal pads
#: through the eager thunk — so on CPU every call takes the concat form,
#: which is bit-identical. The choice keys on `jax.default_backend()`, not
#: on the device a computation is placed on: code that runs on the CPU
#: device of a GPU process takes the pad form, and must run under `jit`.
SHIFT_IMPL = "pad"


def pad_z(x, lo: int, hi: int, fill=0.0):
    """Grow/trim ``x`` along the z axis: ``lo``/``hi`` rows added at the
    bottom/top (negative = trimmed), vacated rows take ``fill``. Lowered as a
    single `lax.pad`; see ``SHIFT_IMPL`` for the CPU fallback."""
    import jax

    if SHIFT_IMPL != "concat" and jax.default_backend() != "cpu":
        zero = (0, 0, 0)
        return jax.lax.pad(x, jnp.asarray(fill, x.dtype),
                           ((lo, hi, 0),) + (zero,) * (x.ndim - 1))
    if lo < 0:
        x = x[-lo:]
    if hi < 0:
        x = x[:hi]
    parts = []
    if lo > 0:
        parts.append(jnp.full((lo,) + x.shape[1:], fill, x.dtype))
    parts.append(x)
    if hi > 0:
        parts.append(jnp.full((hi,) + x.shape[1:], fill, x.dtype))
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else x


def shift_z(x, d: int, fill=0.0):
    """Shift ``x`` by ``d`` rows toward higher k (same length): row ``k``
    of the result is ``x[k - d]``; vacated rows take ``fill``."""
    return pad_z(x, d, -d, fill)


def _row_mask(shape, row, dtype=None):
    """One-hot mask for a z-row: a trace-time ``(Nz, 1, ...)`` boolean
    CONSTANT (broadcasts against ``shape`` in the consumer). Iota-built
    masks are loop-*variant* to XLA's invariant-code sinking, which
    materialized them as extra tiny kernels per scan iteration in the N145
    rollout HLO."""
    import numpy as np

    m = np.zeros((shape[0],) + (1,) * (len(shape) - 1), dtype=bool)
    m[row] = True
    return jnp.asarray(m)


#: Lowering of :func:`cumsum_z`:
#: * ``"dot"`` — one triangular ``(Nz, Nz) @ (Nz, cells)`` matmul at
#:   ``Precision.HIGHEST``, so float32 sums are exact and never run in TF32;
#:   a dot cannot fuse with neighboring elementwise work.
#: * ``"pad"`` — radix-``CUMSUM_RADIX`` Hillis-Steele doubling: each stage
#:   adds ``radix - 1`` pad-shifted copies of the same stage input (one
#:   fusion per stage, like ``cummin_z``), and the first/last stages fuse
#:   into producers/consumers. Different float summation ORDER than "dot"
#:   (tree vs row-sequential), so results differ by rounding — pick per
#:   deployment and regenerate goldens on a switch.
#: Neither has been measured on the GPU yet (ROADMAP A5).
CUMSUM_IMPL = "dot"
CUMSUM_RADIX = 4


def _radix_scan_z(x, combine, identity, radix: int, reverse: bool):
    """Radix-``r`` Hillis-Steele parallel prefix along z: each stage combines
    ``radix - 1`` pad-shifted copies of the SAME stage input (one fusion per
    stage; shifts route through :func:`shift_z`, see the SHIFT_IMPL note on
    the eager-pad CPU bug). Exact for associative ``combine`` whose
    ``identity`` fills the vacated rows."""
    n = x.shape[0]
    d = 1
    while d < n:
        acc = x
        for s in range(1, radix):
            sd = s * d
            if sd >= n:
                break
            acc = combine(acc, shift_z(x, -sd if reverse else sd, identity))
        x = acc
        d *= radix
    return x


def cumsum_z(x, reverse: bool = False):
    """Cumulative sum over the (tiny) z axis (see ``CUMSUM_IMPL``); both
    forms avoid a sequential ``lax.scan`` over z."""
    import jax

    n = x.shape[0]
    if CUMSUM_IMPL == "pad":
        return _radix_scan_z(x, jnp.add, 0.0, CUMSUM_RADIX, reverse)
    tri = jnp.tri(n, dtype=x.dtype)  # lower-triangular ones
    if reverse:
        tri = tri.T
    return jax.lax.dot_general(
        tri, x, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST)


#: Implementation used by :func:`cummin_z` (all exact and bit-identical):
#: * ``"pad"`` — each Hillis-Steele shift as ONE `lax.pad` with negative
#:   high-padding (trim d rows) + positive low-padding (d fill rows), which
#:   can fold into the stage's minimum fusion.
#: * ``"hs"`` — plain shifted-concatenate stages.
#: * ``"dot"`` — shifts as (Nz, Nz) permutation matmuls at
#:   ``Precision.HIGHEST``.
CUMMIN_IMPL = "pad"

#: Radix of the doubling recursion under ``CUMMIN_IMPL == "pad"``: each stage
#: mins ``radix - 1`` shifted copies (all folded into one fusion by XLA), so
#: stages = ceil(log_radix Nz). Radix 2 = classic Hillis-Steele.
CUMMIN_RADIX = 4


def _shift_min_stage_dot(x, d: int, reverse: bool):
    """One Hillis-Steele stage ``x = min(x, shift_d(x))`` with the shift done
    as a permutation matmul (trace-time-constant 0/1 matrix): the vacated
    rows are masked back to ``x`` (identity for min would be +inf)."""
    import jax

    n = x.shape[0]
    i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    P = ((j == i + d) if reverse else (j == i - d)).astype(x.dtype)
    y = jax.lax.dot_general(P, x, (((1,), (0,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST)
    k = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    valid = (k < n - d) if reverse else (k >= d)
    return jnp.where(valid, jnp.minimum(x, y), x)


def cummin_z(x, reverse: bool = False):
    """Cumulative minimum over the z axis via Hillis-Steele doubling:
    ``ceil(log2 Nz)`` shifted-min passes, all vectorised over cells (min is
    associative and order-independent, so this is exact). Stage shifts run
    as permutation matmuls when ``CUMMIN_IMPL == "dot"`` (see above)."""
    import jax

    n = x.shape[0]
    if CUMMIN_IMPL == "pad":
        # pure radix-r parallel-prefix stages: min of (r-1) shifted copies
        # of the SAME stage input -> one fusion per stage
        return _radix_scan_z(x, jnp.minimum, jnp.inf, CUMMIN_RADIX, reverse)
    d = 1
    while d < n:
        if CUMMIN_IMPL == "dot" and x.ndim == 2:
            x = _shift_min_stage_dot(x, d, reverse)
        elif reverse:
            pad = jnp.full((d,) + x.shape[1:], jnp.inf, x.dtype)
            x = jnp.minimum(x, jnp.concatenate([x[d:], pad], axis=0))
        else:
            pad = jnp.full((d,) + x.shape[1:], jnp.inf, x.dtype)
            x = jnp.minimum(x, jnp.concatenate([pad, x[:-d]], axis=0))
        d *= 2
    return x


def cumsum_cummin_z(a, radix: int = 4):
    """Joint ``(S, M) = (cumsum_z(a), cummin_z(cumsum_z(a)))`` in ONE
    radix-``radix`` doubling pass over two channels — no matmul at all.

    The pair ``(s, m)`` = (segment sum, min prefix-sum within the segment) is
    closed under ordered segment concatenation::

        combine(L, R) = (s_L + s_R, min(m_L, s_L + m_R))

    (min-plus algebra), so Hillis-Steele doubling applies. Identity segment:
    ``s = 0``, ``m = +inf`` — the shift fill values. Exact up to float
    summation order (tree order, like the ``"pad"`` cumsum lowering).
    """
    s = m = a
    n = a.shape[0]
    d = 1
    while d < n:
        s0, m0 = s, m
        for i in range(1, radix):
            sd = i * d
            if sd >= n:
                break
            sL = shift_z(s0, sd, 0.0)
            mL = shift_z(m0, sd, jnp.inf)
            m = jnp.minimum(mL, sL + m)
            s = sL + s
        d *= radix
    return s, m


def ghosts(c, bc_bottom, bc_top, state, dz_faces):
    """Compute ghost-cell values below/above the column for variable ``c``.

    Replicates Oceananigans halo-fill semantics
    (`fill_halo_regions!`, reference `state_variables.jl:85-100`):

    * Dirichlet: ``ghost = 2*value - c_boundary`` (linear interpolation puts
      ``value`` exactly on the boundary face).
    * Neumann: ``ghost = c_boundary -/+ gradient * dz_face_boundary``.
    * Flux / None: zero gradient (``ghost = c_boundary``); the physical flux
      enters through the tendency instead.

    Returns ``(ghost_bottom, ghost_top)``, each of shape ``(1, cells)``.
    ``dz_faces`` is the ``(Nz + 1, 1)`` face-spacing array.
    """
    c_bot, c_top = c[:1], c[-1:]
    dzf_bot, dzf_top = dz_faces[:1], dz_faces[-1:]

    def one(bc, c_bnd, sign, dzf):
        if isinstance(bc, Dirichlet):
            v = resolve_bc_value(bc.value, state)
            return 2.0 * v - c_bnd
        if isinstance(bc, Neumann):
            g = resolve_bc_value(bc.gradient, state)
            return c_bnd + sign * g * dzf
        return c_bnd  # Flux BC or no BC: zero-gradient halo

    ghost_bot = one(bc_bottom, c_bot, -1.0, dzf_bot)
    ghost_top = one(bc_top, c_top, +1.0, dzf_top)
    return ghost_bot, ghost_top


def _face_operands(c, ghost_bottom, ghost_top):
    """Build the two ``(Nz + 1, cells)`` face operands ``upper[f] = ce[f]``
    and ``lower[f] = ce[f-1]`` of the padded center column
    ``ce = [ghost_bottom, c, ghost_top]`` — as pads + one-row masked selects
    instead of a concatenate (each lowers into the consumer fusion; no copy
    kernel)."""
    if ghost_bottom is None:
        ghost_bottom = c[:1]
    if ghost_top is None:
        ghost_top = c[-1:]
    n = c.shape[0]
    shape = (n + 1,) + c.shape[1:]
    upper = jnp.where(_row_mask(shape, -1), jnp.broadcast_to(ghost_top, shape),
                      pad_z(c, 0, 1))
    lower = jnp.where(_row_mask(shape, 0), jnp.broadcast_to(ghost_bottom, shape),
                      pad_z(c, 1, 0))
    return upper, lower


#: Strength-reduce the hot divisions by grid-coordinate arrays into
#: multiplies by their (tiny, (Nz,1)-shaped) reciprocals. Changes results by
#: ~1 ulp (x * (1/c) vs x / c) — goldens regenerate on a default flip. Off;
#: not measured on the GPU.
RECIP_COORD_DIV = False


def _div_coord(x, d):
    """``x / d`` for a small coordinate-array denominator (see
    ``RECIP_COORD_DIV``)."""
    if RECIP_COORD_DIV:
        return x * (1.0 / d)
    return x / d


def grad_faces(c, dz_faces, ghost_bottom=None, ghost_top=None):
    """``∂c/∂z`` at all faces: ``(c[f] - c[f-1]) / dz_faces[f]``
    (Oceananigans `∂zᵃᵃᶠ`). Ghosts default to zero-gradient."""
    upper, lower = _face_operands(c, ghost_bottom, ghost_top)
    return _div_coord(upper - lower, dz_faces)


def interp_faces_mid(c, ghost_bottom=None, ghost_top=None):
    """Arithmetic-mean interpolation of a center field to all faces
    (Oceananigans `ℑzᵃᵃᶠ`). Ghosts default to zero-gradient."""
    upper, lower = _face_operands(c, ghost_bottom, ghost_top)
    return 0.5 * (upper + lower)


def interp_faces_min(c, ghost_bottom=None, ghost_top=None):
    """Neighbor-minimum interpolation to faces (reference `min_zᵃᵃᶠ`,
    `src/utils/kernel_utils.jl:24-25`). Ghosts default to zero-gradient."""
    upper, lower = _face_operands(c, ghost_bottom, ghost_top)
    return jnp.minimum(upper, lower)


def div_faces(q, dz):
    """Center divergence of a face flux: ``(q[k+1] - q[k]) / dz[k]``
    (Oceananigans `∂zᵃᵃᶜ` of a face quantity)."""
    return _div_coord(q[1:] - q[:-1], dz)


def apply_flux_bcs(tend, var_bcs, state, dz, xy=None):
    """Add Flux-BC contributions to a tendency array.

    Replicates `compute_z_bcs!` (reference
    `src/timesteppers/abstract_timestepper.jl:70-72`, Oceananigans
    `apply_z_top/bottom_bc!`): for an XYZ tendency,
    ``tend[top] -= q_top / dz[top]`` and ``tend[bottom] += q_bot / dz[bottom]``
    with fluxes positive in +z. For XY tendencies (1D arrays) only a 'top'
    Flux BC applies and ``dz`` is ignored (the quantity is per-area already).

    ``xy``: the variable's *declared* rank (True = XY, False = XYZ), passed
    by callers that know it (the timesteppers thread it from the model's
    variable specs). When ``None``, falls back to a shape heuristic that is
    ambiguous on single-layer grids and on broadcast ``(1, cells)`` XYZ
    tendencies — prefer passing it explicitly.
    """
    if not var_bcs:
        return tend
    top = var_bcs.get("top")
    bot = var_bcs.get("bottom")
    dz2 = dz if dz.ndim == 2 else dz[:, None]
    if xy is None:
        # XY tendencies: rank-1, or a single-row rank-2 leaf on a multi-layer
        # grid
        xy = tend.ndim == 1 or (tend.ndim == 2 and tend.shape[0] == 1
                                and dz2.shape[0] != 1)
    is_xy = xy
    if is_xy:
        if isinstance(top, Flux):
            tend = tend - resolve_bc_value(top.value, state)
        if isinstance(bot, Flux):
            tend = tend + resolve_bc_value(bot.value, state)
        return tend
    if isinstance(top, Flux):
        q = resolve_bc_value(top.value, state)
        tend = jnp.where(_row_mask(tend.shape, -1), tend - q / dz2[-1:], tend)
    if isinstance(bot, Flux):
        q = resolve_bc_value(bot.value, state)
        tend = jnp.where(_row_mask(tend.shape, 0), tend + q / dz2[:1], tend)
    return tend
