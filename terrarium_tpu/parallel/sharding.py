"""Sharding of the packed cell dimension over a device mesh.

The reference has no distributed execution (SURVEY §2.11); its only
parallelism is per-cell data parallelism on a single device. Here the packed
``cells`` axis (the trailing axis of every field) is domain-decomposed over
devices with `jax.sharding.NamedSharding` and XLA's SPMD partitioner.
Per-column physics has no lateral dependencies, so the step runs
collective-free; collectives appear only in global diagnostics
(means/integrals) and at I/O boundaries (gather for output, scatter for
forcing).

``z`` (the leading axis) stays whole on every device — vertical stencils and
tridiagonal solves remain local, so no step needs communication.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["cell_mesh", "shard_state", "shard_sources", "state_shardings",
           "replicate", "initialize_distributed"]

CELL_AXIS = "cells"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Initialize multi-host execution (`jax.distributed.initialize`).

    Call once per host before building grids; afterwards `jax.devices()`
    spans every host's devices and `cell_mesh()` / `shard_state` work
    unchanged — the cell axis is decomposed across all hosts' devices.
    Arguments default to cluster auto-detection; where the cluster cannot
    be detected, pass ``coordinator_address`` (``host:port``),
    ``num_processes`` and ``process_id``. Returns the process index.
    No-ops gracefully in single-process environments.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (ValueError, RuntimeError):
        pass  # already initialized or single-process
    return jax.process_index()


def cell_mesh(devices=None, axis_name: str = CELL_AXIS) -> Mesh:
    """Build a 1D mesh over all (or the given) devices for the cell axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis_name,))


def _spec_for(leaf, axis_name: str) -> P:
    """Shard the trailing axis (cells) of any field array; replicate scalars."""
    ndim = getattr(leaf, "ndim", 0)
    if ndim == 0:
        return P()
    return P(*([None] * (ndim - 1) + [axis_name]))


def state_shardings(state, mesh: Mesh, axis_name: str = CELL_AXIS):
    """A pytree of NamedShardings matching ``state``: every field sharded on
    its trailing (cells) axis, clock scalars replicated."""
    return jax.tree_util.tree_map(
        lambda leaf: NamedSharding(mesh, _spec_for(leaf, axis_name)), state)


def shard_state(state, mesh: Optional[Mesh] = None, axis_name: str = CELL_AXIS):
    """Place a state pytree on the mesh, cells-sharded.

    Note: for uneven ``cells % n_devices`` remainders, pad the packed cell
    array at grid construction (``ColumnRingGrid`` pads to a multiple of the
    requested shard count; padded cells are masked out of diagnostics).
    """
    mesh = mesh if mesh is not None else cell_mesh()
    return jax.device_put(state, state_shardings(state, mesh, axis_name))


def shard_sources(sources, cells: int, mesh: Optional[Mesh] = None,
                  axis_name: str = CELL_AXIS):
    """Place input-source pytrees on the mesh: field/series leaves (whose
    trailing axis is the packed cell dimension) shard on it; time
    coordinates and scalars replicate. The per-step time interpolation is
    elementwise over cells, so sharded forcing keeps the step
    collective-free (SURVEY §2.11 'forcing ingestion sharded').

    The built-in source types are placed by STRUCTURE (a
    ``TimeSeriesInputSource``'s ``times`` vector always replicates — never
    by a shape coincidence with ``cells``, which would shard the time axis
    and put gathers in every step's interpolation). Unknown pytree sources
    fall back to the trailing-axis-equals-``cells`` shape heuristic."""
    from ..io.input_sources import FieldInputSource, TimeSeriesInputSource

    mesh = mesh if mesh is not None else cell_mesh()
    rep = NamedSharding(mesh, P())

    def cellwise(leaf):
        leaf = jax.numpy.asarray(leaf)
        return jax.device_put(leaf, NamedSharding(mesh, _spec_for(leaf, axis_name)))

    def place(src):
        if isinstance(src, TimeSeriesInputSource):
            # (T, cells) series shard on cells; (T,) scalar series have NO
            # cell axis — their trailing axis is TIME and must replicate
            def series_leaf(v):
                v = jax.numpy.asarray(v)
                return cellwise(v) if v.ndim >= 2 else jax.device_put(v, rep)

            return TimeSeriesInputSource(
                times=jax.device_put(jax.numpy.asarray(src.times), rep),
                series={k: series_leaf(v) for k, v in src.series.items()},
                dims=src.dims)
        if isinstance(src, FieldInputSource):
            return FieldInputSource(
                fields={k: cellwise(v) for k, v in src.fields.items()},
                dims=src.dims)

        def spec(leaf):
            ndim = getattr(leaf, "ndim", 0)
            if ndim >= 1 and leaf.shape[-1] == cells:
                return NamedSharding(mesh, _spec_for(leaf, axis_name))
            return rep

        return jax.tree_util.tree_map(
            lambda leaf: jax.device_put(leaf, spec(leaf)), src)

    is_src = lambda x: isinstance(x, (FieldInputSource, TimeSeriesInputSource))
    if is_src(sources):
        return place(sources)
    return type(sources)(place(s) for s in sources) if isinstance(
        sources, (tuple, list)) else place(sources)


def replicate(tree, mesh: Optional[Mesh] = None):
    mesh = mesh if mesh is not None else cell_mesh()
    return jax.device_put(tree, NamedSharding(mesh, P()))
