"""Column grids: batches of laterally-independent soil columns.

JAX equivalent of the reference `ColumnGrid`
(`src/grids/column_grid.jl:20-38`). A grid is a static (hashable) description
of shapes + vertical coordinates; fields are materialised as JAX arrays of
shape ``(Nz, cells)`` (cell-centered), ``(Nz + 1, cells)`` (faces) or
``(cells,)`` (lateral-only). The ``cells`` axis is the trailing (contiguous)
dimension and is the axis sharded across devices (replacing the reference's x-axis work
domain, `src/grids/grid_utils.jl:2-19`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .spacing import ExponentialSpacing
from .vertical import VerticalGrid
from ..variables import XY, XYZ

__all__ = ["ColumnGrid"]


@dataclasses.dataclass(frozen=True)
class ColumnGrid:
    """``cells`` laterally-independent columns over a shared vertical grid.

    Args:
        cells: number of columns (>= 1).
        vertical: the :class:`VerticalGrid`.
        nf: number format (dtype policy), default float32. Mirrors the
            reference's NF type parameter.
    """

    cells: int
    vertical: VerticalGrid
    nf: np.dtype = dataclasses.field(default=np.dtype(np.float32))

    def __post_init__(self):
        object.__setattr__(self, "nf", np.dtype(self.nf))

    @staticmethod
    def of(cells: int = 1, spacing=None, nf=np.float32) -> "ColumnGrid":
        spacing = spacing if spacing is not None else ExponentialSpacing()
        return ColumnGrid(cells, VerticalGrid.from_spacing(spacing), np.dtype(nf))

    # -- shape helpers ----------------------------------------------------
    @property
    def nz(self) -> int:
        return self.vertical.nz

    def shape(self, dims) -> tuple:
        if isinstance(dims, XY):
            return (self.cells,)
        if isinstance(dims, XYZ):
            nz = self.nz + 1 if dims.face else self.nz
            return (nz, self.cells)
        raise TypeError(f"unknown dims {dims!r}")

    def allocate(self, dims, fill=0.0):
        return jnp.full(self.shape(dims), fill, dtype=self.nf)

    # -- coordinates as device constants ---------------------------------
    @property
    def z_centers(self):
        """(Nz, 1) cell-center elevations, broadcastable against (Nz, cells)."""
        return jnp.asarray(self.vertical.z_centers, dtype=self.nf)[:, None]

    @property
    def z_faces(self):
        return jnp.asarray(self.vertical.z_faces, dtype=self.nf)[:, None]

    @property
    def dz(self):
        return jnp.asarray(self.vertical.dz, dtype=self.nf)[:, None]

    @property
    def dz_faces(self):
        return jnp.asarray(self.vertical.dz_faces, dtype=self.nf)[:, None]

    def __hash__(self):
        return hash((self.cells, self.vertical, str(self.nf)))

    def __repr__(self):
        return f"ColumnGrid(cells={self.cells}, nz={self.nz}, nf={self.nf})"
