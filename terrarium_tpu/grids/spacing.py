"""Vertical discretizations.

JAX equivalent of reference `src/grids/vertical_discretization.jl`.
Each spacing produces a vector of layer thicknesses (top-down order: index 0 is
the *surface* layer) which the :class:`~terrarium_tpu.grids.vertical.VerticalGrid`
turns into face/center coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["UniformSpacing", "ExponentialSpacing", "PrescribedSpacing", "get_spacing"]


def _round_sig(x: float, sig: int) -> float:
    if x == 0.0:
        return 0.0
    from math import floor, log10

    return round(x, -int(floor(log10(abs(x)))) + (sig - 1))


@dataclasses.dataclass(frozen=True)
class UniformSpacing:
    """N layers of constant thickness dz (reference `vertical_discretization.jl:30-35`)."""

    dz: float = 0.1
    N: int = 100

    def thicknesses(self) -> np.ndarray:
        return np.full(self.N, self.dz, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ExponentialSpacing:
    """Quasi-exponential spacing from ``dz_min`` (surface) to ``dz_max`` (bottom).

    Thickness of layer i (1-based, top-down) is log2-interpolated between
    ``dz_min`` and ``dz_max`` and rounded to ``sig`` significant digits,
    exactly as reference `vertical_discretization.jl:47-76`.
    """

    dz_min: float = 0.05
    dz_max: float = 100.0
    N: int = 50
    sig: Optional[int] = 3

    def __post_init__(self):
        if self.N <= 1:
            raise ValueError("number of grid points for exponential spacing must be > 1")

    def thicknesses(self) -> np.ndarray:
        log_min = np.log2(self.dz_min)
        log_max = np.log2(self.dz_max)
        i = np.arange(self.N, dtype=np.float64)
        dz = np.exp2(log_min + i * (log_max - log_min) / (self.N - 1))
        if self.sig is not None:
            dz = np.array([_round_sig(v, self.sig) for v in dz])
        return dz


@dataclasses.dataclass(frozen=True)
class PrescribedSpacing:
    """Explicit per-layer thicknesses, top-down (reference `vertical_discretization.jl:87-93`)."""

    dz: Sequence[float]

    @property
    def N(self):
        return len(self.dz)

    def thicknesses(self) -> np.ndarray:
        return np.asarray(self.dz, dtype=np.float64)


def get_spacing(spacing) -> np.ndarray:
    """Return the (top-down) thickness vector of a spacing object."""
    return spacing.thicknesses()
