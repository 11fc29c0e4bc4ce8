"""Global ring grids with land-mask packing.

JAX equivalent of the reference `ColumnRingGrid`
(`src/grids/column_ring_grid.jl`): a global Gaussian (or HEALPix-latitude)
lat-lon grid plus a Boolean land mask; only the ``Nh = sum(mask)`` land cells
are simulated, packed densely into the cells axis. ``idx`` maps packed cells
back to raster positions (the reference's `findall(mask)` idxmap;
`column_ring_grid.jl:37-59`), and `gather`/`scatter` convert between rasters
and packed arrays with a fill value (`column_ring_grid.jl:102-149`).

Addition: the packed axis is padded to a multiple of ``pad_multiple`` so
it divides evenly over a device mesh; padded cells run the same physics on
dummy data and are excluded from scatter/diagnostics via ``land_mask_packed``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .column import ColumnGrid
from .vertical import VerticalGrid

__all__ = ["RingGrid", "full_gaussian_grid", "full_healpix_grid", "ColumnRingGrid"]


@dataclasses.dataclass(frozen=True)
class RingGrid:
    """A full (constant nlon per ring) global lat-lon ring grid.

    Attributes:
        lats: ``(nlat,)`` ring latitudes in degrees, north to south.
        nlon: number of longitudes per ring (lons start at 0, spacing 360/nlon).
        kind: "gaussian" | "healpix" | "latlon".
    """

    lats: np.ndarray
    nlon: int
    kind: str = "latlon"

    @property
    def nlat(self) -> int:
        return self.lats.shape[0]

    @property
    def lons(self) -> np.ndarray:
        return np.arange(self.nlon) * (360.0 / self.nlon)

    @property
    def shape(self):
        return (self.nlat, self.nlon)

    def __hash__(self):
        return hash((self.lats.tobytes(), self.nlon, self.kind))

    def __eq__(self, other):
        return (isinstance(other, RingGrid) and self.nlon == other.nlon
                and np.array_equal(self.lats, other.lats))


def full_gaussian_grid(nlat_half: int) -> RingGrid:
    """Full Gaussian grid with ``2 * nlat_half`` Gaussian-latitude rings and
    ``4 * nlat_half`` longitudes (matches RingGrids `FullGaussianGrid`; the
    ERA5-land masks are N72 -> 144x288 and N145 -> 290x580)."""
    nodes, _ = np.polynomial.legendre.leggauss(2 * nlat_half)
    lats = np.degrees(np.arcsin(nodes))[::-1]  # north to south
    return RingGrid(lats=lats, nlon=4 * nlat_half, kind="gaussian")


def full_healpix_grid(nside: int) -> RingGrid:
    """Full HEALPix grid: HEALPix ring latitudes (4*nside - 1 rings) with a
    constant 4*nside longitudes per ring (matches RingGrids
    `FullHEALPixGrid`, used by the reference integration tests)."""
    rings = []
    # polar cap rings: z = 1 - i^2 / (3 nside^2), i = 1..nside-1
    for i in range(1, nside):
        rings.append(1.0 - i**2 / (3.0 * nside**2))
    # equatorial rings: z = 4/3 - 2i/(3 nside), i = nside..3*nside
    for i in range(nside, 3 * nside + 1):
        rings.append(4.0 / 3.0 - 2.0 * i / (3.0 * nside))
    # southern cap mirrors northern
    for i in range(nside - 1, 0, -1):
        rings.append(-(1.0 - i**2 / (3.0 * nside**2)))
    lats = np.degrees(np.arcsin(np.asarray(rings)))
    return RingGrid(lats=lats, nlon=4 * nside, kind="healpix")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnRingGrid(ColumnGrid):
    """Masked global ring grid: dense packed land columns + scatter map.

    Inherits the :class:`ColumnGrid` field interface (``cells`` includes
    padding). Mirrors reference `column_ring_grid.jl:37-59` + converters
    102-149.
    """

    ring: RingGrid = None
    mask: np.ndarray = None  # (nlat, nlon) bool land mask
    idx: np.ndarray = None  # (n_land,) flat raster indices of land cells
    n_land: int = 0

    @staticmethod
    def create(ring: RingGrid, mask: np.ndarray, spacing=None, nf=np.float32,
               pad_multiple: int = 1) -> "ColumnRingGrid":
        from .spacing import ExponentialSpacing

        mask = np.asarray(mask, dtype=bool)
        if mask.shape != ring.shape:
            raise ValueError(f"mask shape {mask.shape} != grid shape {ring.shape}")
        idx = np.flatnonzero(mask.ravel())
        n_land = idx.shape[0]
        cells = _round_up(max(n_land, 1), pad_multiple)
        spacing = spacing if spacing is not None else ExponentialSpacing()
        return ColumnRingGrid(
            cells=cells, vertical=VerticalGrid.from_spacing(spacing),
            nf=np.dtype(nf), ring=ring, mask=mask, idx=idx, n_land=n_land)

    # -- packing ----------------------------------------------------------
    @property
    def land_mask_packed(self) -> np.ndarray:
        """(cells,) bool: True for real land cells, False for padding."""
        out = np.zeros(self.cells, dtype=bool)
        out[: self.n_land] = True
        return out

    def gather(self, raster, fill=0.0):
        """Raster ``(..., nlat, nlon)`` -> packed ``(..., cells)``
        (reference `column_ring_grid.jl:102-123`). Padded cells get ``fill``."""
        raster = np.asarray(raster)
        flat = raster.reshape(raster.shape[:-2] + (-1,))
        packed = np.full(raster.shape[:-2] + (self.cells,), fill,
                         dtype=raster.dtype)
        packed[..., : self.n_land] = flat[..., self.idx]
        return packed

    def scatter(self, packed, fill=np.nan):
        """Packed ``(..., cells)`` -> raster ``(..., nlat, nlon)`` with
        ``fill`` on ocean/padding (reference `column_ring_grid.jl:125-149`)."""
        packed = np.asarray(packed)
        flat = np.full(packed.shape[:-1] + (self.ring.nlat * self.ring.nlon,),
                       fill, dtype=packed.dtype)
        flat[..., self.idx] = packed[..., : self.n_land]
        return flat.reshape(packed.shape[:-1] + self.ring.shape)

    # -- lateral topology --------------------------------------------------
    def neighbor_maps(self) -> np.ndarray:
        """Physical 4-neighborhood of every packed cell: ``(cells, 4)``
        int32 packed indices of the (E, W, N, S) raster neighbors
        (east/west wrap around the ring; north/south use the same
        longitude column one ring up/down).

        A neighbor that is ocean, off the poles, or grid padding maps to
        the cell ITSELF — zero-flux coasts/caps by construction, which
        makes any symmetric-stencil lateral operator exactly conservative
        on the masked grid (the adjacency is symmetric: j is E-neighbor of
        i iff i is W-neighbor of j, and invalid links drop on both sides).

        Within a ring the packed axis is contiguous by construction
        (row-major mask packing), so E/W entries are mostly ``i +- 1``;
        ring wraps and coast gaps are what this index map encodes. This is
        the production lateral adjacency the r4 halo extension lacked
        (`parallel/halo.py` neighbor_shift is index-adjacency, physical
        only for `ColumnGrid` transects)."""
        nlat, nlon = self.ring.shape
        r2p = np.full(nlat * nlon, -1, dtype=np.int64)
        r2p[self.idx] = np.arange(self.n_land)
        ii, jj = np.divmod(self.idx, nlon)
        self_p = np.arange(self.n_land)

        def pack(i, j, valid):
            flat = i * nlon + j
            p = r2p[np.where(valid, flat, 0)]
            return np.where(valid & (p >= 0), p, self_p)

        east = pack(ii, (jj + 1) % nlon, np.ones_like(ii, bool))
        west = pack(ii, (jj - 1) % nlon, np.ones_like(ii, bool))
        north = pack(ii - 1, jj, ii - 1 >= 0)
        south = pack(ii + 1, jj, ii + 1 < nlat)
        out = np.tile(np.arange(self.cells, dtype=np.int64)[:, None], (1, 4))
        out[: self.n_land] = np.stack([east, west, north, south], axis=1)
        return out.astype(np.int32)

    # -- per-cell coordinates ---------------------------------------------
    @property
    def cell_lats(self) -> np.ndarray:
        """(cells,) latitude of each packed cell (padding repeats the last)."""
        lat_r = np.repeat(self.ring.lats, self.ring.nlon)
        out = np.zeros(self.cells)
        out[: self.n_land] = lat_r[self.idx]
        if self.cells > self.n_land and self.n_land > 0:
            out[self.n_land:] = out[self.n_land - 1]
        return out

    @property
    def cell_lons(self) -> np.ndarray:
        lon_r = np.tile(self.ring.lons, self.ring.nlat)
        out = np.zeros(self.cells)
        out[: self.n_land] = lon_r[self.idx]
        return out

    def __hash__(self):
        return hash((self.cells, self.vertical, str(self.nf), self.ring,
                     self.mask.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, ColumnRingGrid) and self.cells == other.cells
                and self.vertical == other.vertical and self.ring == other.ring
                and np.array_equal(self.mask, other.mask))

    def __repr__(self):
        return (f"ColumnRingGrid({self.ring.kind} {self.ring.nlat}x{self.ring.nlon}, "
                f"land={self.n_land}/{self.cells} cells, nz={self.nz}, nf={self.nf})")
