"""Physical lateral adjacency on masked ring grids (r5 item 6).

`ColumnRingGrid.neighbor_maps()` + `lateral_diffusion_forcing_ring`: the
real (E, W, N, S) neighborhood on the REAL N72 ERA5-land mask — symmetric
adjacency, exact conservation, geographic correctness (heat spreads to true
map neighbors, not packed-index neighbors), and shard_map bit-identity with
the fixed-width halo exchange (one ppermute per side).
"""
import numpy as np
import pytest

import terrarium_tpu as tt
from terrarium_tpu.parallel.halo import lateral_diffusion_forcing_ring

MASK = "/root/reference/inputs/era5-land_land_sea_mask_N72.nc"


def _grid(pad_multiple=8):
    mask, _, _ = tt.load_land_mask(MASK)
    ring = tt.full_gaussian_grid(72)
    return tt.ColumnRingGrid.create(ring, mask,
                                    spacing=tt.ExponentialSpacing(N=6),
                                    nf=np.float64, pad_multiple=pad_multiple)


def test_neighbor_maps_symmetric_on_n72():
    grid = _grid()
    nbr = grid.neighbor_maps()
    n = grid.n_land
    # pair (E, W) and (N, S): j = E(i) and j != i implies W(j) = i
    for d, dr in ((0, 1), (1, 0), (2, 3), (3, 2)):
        i = np.arange(n)
        j = nbr[:n, d]
        real = j != i
        assert np.all(nbr[j[real], dr] == i[real]), f"asymmetric dir {d}"
    # padding cells are self-linked
    assert np.all(nbr[n:] == np.arange(n, grid.cells)[:, None])


def test_neighbor_maps_geographically_correct():
    """E/W neighbors share the ring (same latitude, adjacent longitude with
    wrap); N/S neighbors share the longitude column one ring away."""
    grid = _grid()
    nbr = grid.neighbor_maps()
    nlat, nlon = grid.ring.shape
    ii, jj = np.divmod(grid.idx, nlon)
    n = grid.n_land
    e = nbr[:n, 0]
    real = e != np.arange(n)
    assert np.all(ii[e[real]] == ii[real])
    assert np.all(jj[e[real]] == (jj[real] + 1) % nlon)
    s = nbr[:n, 3]
    real = s != np.arange(n)
    assert np.all(ii[s[real]] == ii[real] + 1)
    assert np.all(jj[s[real]] == jj[real])


def test_lateral_ring_conserves_on_n72():
    grid = _grid()
    fn = lateral_diffusion_forcing_ring(1.0e8, 1.0e5, grid)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 5, (grid.nz, grid.cells))

    class FakeState(dict):
        def __getitem__(self, k):
            return dict.__getitem__(self, k)

    tend = np.asarray(fn(FakeState(internal_energy=x), grid))
    # symmetric stencil: the global sum of the tendency vanishes exactly
    # (up to f64 roundoff of ~23k-term sums)
    scale = np.abs(tend).sum()
    assert abs(tend.sum()) < 1e-9 * scale
    # and padded cells (self-linked) receive nothing
    assert np.all(tend[:, grid.n_land:] == 0.0)


def test_lateral_ring_spreads_to_map_neighbors():
    """A point anomaly diffuses to its geographic neighbors — including a
    packed-index-DISTANT north/south neighbor — and nowhere else."""
    grid = _grid()
    nbr = grid.neighbor_maps()
    # pick a land cell whose 4 neighbors are all land and all distinct
    n = grid.n_land
    cand = np.where((nbr[:n] != np.arange(n)[:, None]).all(axis=1))[0]
    c = int(cand[len(cand) // 2])
    fn = lateral_diffusion_forcing_ring(1.0, 1.0, grid)
    x = np.zeros((1, grid.cells))
    x[0, c] = 1.0

    class S(dict):
        def __getitem__(self, k):
            return dict.__getitem__(self, k)

    tend = np.asarray(fn(S(internal_energy=x), grid))[0]
    assert tend[c] == -4.0
    got = set(np.where(tend > 0)[0].tolist())
    assert got == set(int(v) for v in nbr[c]), (got, nbr[c])
    # the N/S neighbors are far away in packed order (different rings)
    assert max(abs(int(v) - c) for v in nbr[c]) > 2


def test_lateral_ring_integration_conserves_energy():
    """Full SoilModel integration on the masked N72 grid with lateral
    diffusion as the ONLY energy exchange (no vertical BCs): the global
    energy inventory is invariant."""
    grid = _grid()
    model = tt.SoilModel(grid=grid)
    rng = np.random.default_rng(9)
    T0 = rng.normal(2.0, 8.0, (1, grid.cells)) * np.ones((grid.nz, 1))
    sim = tt.initialize(
        model, tt.ForwardEuler(dt=600.0),
        initializers={"temperature": T0, "saturation_water_ice": 0.4},
        forcings={"internal_energy":
                  lateral_diffusion_forcing_ring(1.0e6, 1.0e5, grid)})
    U0 = np.asarray(sim.state.prognostic["internal_energy"])
    E0 = float((U0 * np.asarray(grid.dz)).sum())
    sim.run(steps=50, dt=600.0)
    U1 = np.asarray(sim.state.prognostic["internal_energy"])
    assert np.all(np.isfinite(U1))
    E1 = float((U1 * np.asarray(grid.dz)).sum())
    assert abs(E1 - E0) < 1e-9 * abs(E0)
    # it actually mixed laterally
    assert float(np.std(U1[0, : grid.n_land])) < float(np.std(U0[0, : grid.n_land]))


def test_lateral_ring_sharded_bit_identical():
    """The shard_map form (fixed-width halo exchange + local gathers)
    matches the unsharded gather on an 8-device mesh to 1 ulp (the two
    separately-compiled programs may contract the final coeff*lap/dx^2
    multiply-add chain differently; the gathered VALUES are identical)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    grid = _grid(pad_multiple=8 * 128)
    fn_ref = lateral_diffusion_forcing_ring(1.0e8, 1.0e5, grid)
    fn_sh = lateral_diffusion_forcing_ring(1.0e8, 1.0e5, grid,
                                           axis_name="cells", n_shards=8)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 5, (grid.nz, grid.cells))

    class S(dict):
        def __getitem__(self, k):
            return dict.__getitem__(self, k)

    ref = np.asarray(fn_ref(S(internal_energy=x), grid))

    mesh = Mesh(np.array(jax.devices()[:8]), ("cells",))

    @jax.jit
    def sharded(xx):
        def inner(xl):
            return fn_sh(S(internal_energy=xl), grid)

        return jax.shard_map(inner, mesh=mesh, in_specs=P(None, "cells"),
                             out_specs=P(None, "cells"))(xx)

    out = np.asarray(sharded(x))
    np.testing.assert_allclose(out, ref, rtol=1e-14, atol=0.0)


def test_lateral_ring_sharded_hlo_collectives():
    """The shard_map lateral step's compiled HLO contains the halo
    `collective-permute`s and NO all-gather — the one-permute-per-side
    contract that keeps halo traffic to the shard edges (SURVEY
    §2.11)."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    grid = _grid(pad_multiple=8 * 128)
    fn_sh = lateral_diffusion_forcing_ring(1.0e6, 1.0e5, grid,
                                           axis_name="cells", n_shards=8)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 5, (grid.nz, grid.cells))

    class S(dict):
        def __getitem__(self, k):
            return dict.__getitem__(self, k)

    mesh = Mesh(np.array(jax.devices()[:8]), ("cells",))

    @jax.jit
    def sharded(xx):
        def inner(xl):
            return fn_sh(S(internal_energy=xl), grid)

        return jax.shard_map(inner, mesh=mesh, in_specs=P(None, "cells"),
                             out_specs=P(None, "cells"))(xx)

    hlo = sharded.lower(x).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo
    assert "all-to-all" not in hlo
