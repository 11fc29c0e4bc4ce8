"""Batched tridiagonal solvers (Thomas scan + parallel cyclic reduction).

New capability relative to the reference (which has only explicit steppers;
see SURVEY §2.3): per-column implicit solves batched over the packed cell
axis. Arrays are ``(Nz, cells)``.

* :func:`tridiag_solve` — the classic Thomas algorithm as a `lax.scan` over
  z with ``(cells,)`` carries (one vectorised forward sweep + back
  substitution per column batch). Differentiable; used by the jax.grad
  test battery.
* :func:`tridiag_solve_pcr` — parallel cyclic reduction: ``ceil(log2 Nz)``
  fully-vectorised elimination rounds with no sequential z dependence
  (stable for the diagonally-dominant systems produced by the implicit
  heat/Richards discretizations).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["tridiag_solve", "tridiag_solve_pcr"]

#: `lax.scan` unroll of the Thomas sweeps (not yet measured on the GPU).
THOMAS_UNROLL = 2


def tridiag_solve(a, b, c, d):
    """Solve ``a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k]`` per column.

    Args:
        a: sub-diagonal ``(Nz, cells)``; ``a[0]`` is ignored.
        b: diagonal ``(Nz, cells)``.
        c: super-diagonal ``(Nz, cells)``; ``c[-1]`` is ignored.
        d: right-hand side ``(Nz, cells)``.

    Returns:
        x of shape ``(Nz, cells)``.
    """
    # forward elimination: c'_k = c_k / (b_k - a_k c'_{k-1}),
    #                      d'_k = (d_k - a_k d'_{k-1}) / (b_k - a_k c'_{k-1})
    def fwd(carry, xs):
        c_prev, d_prev = carry
        a_k, b_k, c_k, d_k = xs
        denom = b_k - a_k * c_prev
        c_new = c_k / denom
        d_new = (d_k - a_k * d_prev) / denom
        return (c_new, d_new), (c_new, d_new)

    zeros = jnp.zeros_like(b[0])
    u = int(THOMAS_UNROLL)
    idx = jax.lax.broadcasted_iota(jnp.int32, a.shape, 0)
    a0 = jnp.where(idx == 0, 0.0, a)
    (_, _), (c_prime, d_prime) = jax.lax.scan(fwd, (zeros, zeros), (a0, b, c, d),
                                              unroll=u)

    # back substitution: x_k = d'_k - c'_k x_{k+1}
    def bwd(x_next, xs):
        c_k, d_k = xs
        x_k = d_k - c_k * x_next
        return x_k, x_k

    _, x = jax.lax.scan(bwd, zeros, (c_prime, d_prime), unroll=u, reverse=True)
    return x


def _shift_down(x, s, pad):
    """x_{k-s} with constant padding (single `lax.pad` under trace on
    non-CPU backends, concat otherwise — see `vertical_ops.pad_z`)."""
    from .vertical_ops import shift_z

    return shift_z(x, s, pad)


def _shift_up(x, s, pad):
    """x_{k+s} with constant padding."""
    from .vertical_ops import shift_z

    return shift_z(x, -s, pad)


def tridiag_solve_pcr(a, b, c, d):
    """Parallel-cyclic-reduction solve of the same system as
    :func:`tridiag_solve`. Out-of-range neighbor rows act as the identity
    (a=c=0, b=1, d=0), so boundary handling is pure padding."""
    n = a.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, a.shape, 0)
    a = jnp.where(idx == 0, 0.0, a)  # a[0], c[-1] are ignored by contract
    c = jnp.where(idx == n - 1, 0.0, c)

    s = 1
    while s < n:
        alpha = -a / _shift_down(b, s, 1.0)
        gamma = -c / _shift_up(b, s, 1.0)
        b = (b + alpha * _shift_down(c, s, 0.0)
             + gamma * _shift_up(a, s, 0.0))
        d = (d + alpha * _shift_down(d, s, 0.0)
             + gamma * _shift_up(d, s, 0.0))
        a = alpha * _shift_down(a, s, 0.0)
        c = gamma * _shift_up(c, s, 0.0)
        s *= 2
    return d / b


def tridiag_solve_pair_rows(sys_a, sys_b):
    """Solve TWO independent tridiagonal systems of identical shape with
    one fully-unrolled Thomas sweep whose row operations are ``(2, cells)``
    pairs — both systems' row k packed into one op.

    Packing the two systems the implicit stepper solves per step (heat +
    Richards) halves the number of row operations of the sweep. Arithmetic
    per element is identical to two independent solves (row-wise
    vectorization), so results match `tridiag_solve` bitwise up to FMA
    contraction. Not yet measured on the GPU.

    Args: two ``(a, b, c, d)`` tuples of ``(Nz, cells)`` arrays.
    Returns: ``(x_a, x_b)``.
    """
    (a1, b1, c1, d1), (a2, b2, c2, d2) = sys_a, sys_b
    n = b1.shape[0]

    def row(x1, x2, k):
        return jnp.concatenate([x1[k:k + 1], x2[k:k + 1]], axis=0)

    zeros = jnp.zeros_like(row(b1, b2, 0))
    c_prev = d_prev = zeros
    cs, ds = [], []
    for k in range(n):
        a_k = row(a1, a2, k) if k > 0 else zeros
        denom = row(b1, b2, k) - a_k * c_prev
        c_prev = row(c1, c2, k) / denom
        d_prev = (row(d1, d2, k) - a_k * d_prev) / denom
        cs.append(c_prev)
        ds.append(d_prev)
    x_next = zeros
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        x_next = ds[k] - cs[k] * x_next
        xs[k] = x_next
    x_a = jnp.concatenate([xs[k][0:1] for k in range(n)], axis=0)
    x_b = jnp.concatenate([xs[k][1:2] for k in range(n)], axis=0)
    return x_a, x_b
