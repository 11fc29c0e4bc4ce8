"""Static-exponent power shortcuts.

``x ** p`` with a traced base lowers to ``exp(p * log(x))`` — two
transcendentals per element. The Van Genuchten / Mualem / Brooks-Corey chains
evaluate 6-10 such pows per element per step. Their exponents are STATIC
(trace-time python floats derived from the retention-curve parameters), and
for the common parameter choices (integer / half-integer / third-integer n)
they reduce to multiplies, `sqrt`, and `cbrt` — exact up to float rounding
order.

``fast_pow(x, p)`` applies the shortcut when ``p`` is a small rational with
denominator 1, 2, or 3 and falls back to ``x ** p`` otherwise, so arbitrary
parameters keep working. Toggle ``FAST_POW = False`` to force the pow
lowering everywhere.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["fast_pow"]

FAST_POW = True

_MAX_NUM = 12  # largest numerator expanded into multiplies


def _ipow(x, k: int):
    """x**k for integer k by binary powering (k != 0)."""
    if k < 0:
        return 1.0 / _ipow(x, -k)
    y = None
    base = x
    while k:
        if k & 1:
            y = base if y is None else y * base
        k >>= 1
        if k:
            base = base * base
    return y


def fast_pow(x, p):
    """``x ** p`` for non-negative ``x`` and a STATIC exponent ``p`` (see
    module docstring). Exact zero/one exponents short-circuit."""
    p = float(p)
    if p == 0.0:
        return jnp.ones_like(x)
    if p == 1.0:
        return x
    if FAST_POW:
        for denom in (1, 2, 3):
            num = p * denom
            if abs(num - round(num)) < 1e-12 and abs(round(num)) <= _MAX_NUM:
                num = int(round(num))
                root = (x if denom == 1 else
                        jnp.sqrt(x) if denom == 2 else jnp.cbrt(x))
                return _ipow(root, num)
    return x ** p
