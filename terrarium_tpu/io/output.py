"""Simulation output writers and schedules.

JAX equivalent of the reference's delegation to Oceananigans
`Simulation` output machinery (SURVEY §2.10): `JLD2Writer`-style field
time-series output with `TimeInterval` / `IterationInterval` /
`AveragedTimeInterval` schedules and progress callbacks
(`docs/src/running/time_stepping.md:97-175`). Snapshots are written as HDF5
(h5py) so they are NetCDF4-toolchain-readable; a reader loads them back as
time series. Writers plug into `Simulation.run(callbacks=...)`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "TimeInterval",
    "IterationInterval",
    "AveragedTimeInterval",
    "FieldTimeSeriesWriter",
    "NetCDFRasterWriter",
    "ProgressLogger",
    "load_field_time_series",
]


# ---------------------------------------------------------------------------
# Schedules (reference: Oceananigans schedules used in
# `docs/src/running/time_stepping.md:101-175`)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TimeInterval:
    """Actuates at every multiple of ``interval`` seconds of simulation time
    (first actuation at ``t = interval``, like Oceananigans)."""

    interval: float
    _next: float = 0.0

    def actuates(self, sim) -> bool:
        if self._next == 0.0:
            self._next = self.interval
        if sim.current_time + 1e-9 >= self._next:
            # align to multiples so frequent callbacks don't drift the phase
            k = int((sim.current_time + 1e-9) // self.interval) + 1
            self._next = k * self.interval
            return True
        return False

    def steps_hint(self, dt) -> int:
        return max(1, int(round(self.interval / dt)))


@dataclasses.dataclass
class IterationInterval:
    """Actuates every ``interval`` iterations."""

    interval: int

    def actuates(self, sim) -> bool:
        return sim.iteration % self.interval == 0

    def steps_hint(self, dt) -> int:
        return self.interval


@dataclasses.dataclass
class AveragedTimeInterval(TimeInterval):
    """Like :class:`TimeInterval` but the writer stores the time mean of the
    snapshots accumulated since the last actuation (run with a small
    ``callback_interval`` so several snapshots land in each window)."""


# ---------------------------------------------------------------------------
# Writers
# ---------------------------------------------------------------------------
class FieldTimeSeriesWriter:
    """Accumulates named state fields at scheduled times and writes HDF5.

    Use as a callback: ``sim.run(steps, callbacks=[writer],
    callback_interval=writer.schedule.steps_hint(dt))``. For
    :class:`ColumnRingGrid` outputs, pass ``scatter=True`` to store full
    lat-lon rasters instead of packed cells (the reference's scatter-back,
    `column_ring_grid.jl:125-149`).
    """

    def __init__(self, path: str, fields: Sequence[str], schedule=None,
                 scatter: bool = False):
        self.path = str(path)
        self.fields = list(fields)
        self.schedule = schedule or IterationInterval(1)
        self.scatter = scatter
        self.times: List[float] = []
        self.buffers: Dict[str, List[np.ndarray]] = {f: [] for f in fields}
        self._avg_acc: Dict[str, List[np.ndarray]] = {f: [] for f in fields}

    def __call__(self, sim):
        averaged = isinstance(self.schedule, AveragedTimeInterval)
        snap = {}
        for f in self.fields:
            arr = np.asarray(sim.state[f])
            if self.scatter and hasattr(sim.model.grid, "scatter"):
                arr = sim.model.grid.scatter(arr)
            snap[f] = arr
        if averaged:
            for f in self.fields:
                self._avg_acc[f].append(snap[f])
        if self.schedule.actuates(sim):
            self.times.append(sim.current_time)
            for f in self.fields:
                if averaged and self._avg_acc[f]:
                    self.buffers[f].append(
                        np.mean(np.stack(self._avg_acc[f]), axis=0))
                    self._avg_acc[f] = []
                else:
                    self.buffers[f].append(snap[f])
            self.flush(sim)

    def flush(self, sim=None):
        import h5py

        with h5py.File(self.path, "w") as h:
            h.create_dataset("time", data=np.asarray(self.times))
            for f in self.fields:
                if self.buffers[f]:
                    h.create_dataset(f, data=np.stack(self.buffers[f]))
            h.attrs["fields"] = json.dumps(self.fields)
            if sim is not None and hasattr(sim.model.grid, "vertical"):
                h.create_dataset("z_centers",
                                 data=sim.model.grid.vertical.z_centers)


def load_field_time_series(path: str) -> Dict[str, np.ndarray]:
    """Read back a :class:`FieldTimeSeriesWriter` file -> dict of arrays
    (``time`` plus one ``(T, ...)`` array per field)."""
    import h5py

    out = {}
    with h5py.File(path, "r") as h:
        for k in h.keys():
            out[k] = np.asarray(h[k])
    return out


class NetCDFRasterWriter:
    """Scheduled writer producing a CF-style NetCDF4 raster file.

    For :class:`ColumnRingGrid` simulations: packed cell fields are
    scattered back to the full lat-lon raster (the reference's
    `column_ring_grid.jl:125-149` scatter + Oceananigans NetCDF writer
    combination). XY fields are written as ``(time, lat, lon)``, XYZ fields
    as ``(time, z, lat, lon)``; sea points hold ``fill``.

    Use as a callback exactly like :class:`FieldTimeSeriesWriter`.
    """

    def __init__(self, path: str, fields: Sequence[str], schedule=None,
                 fill=np.nan, units: Optional[Dict[str, str]] = None):
        self.path = str(path)
        self.fields = list(fields)
        self.schedule = schedule or IterationInterval(1)
        self.fill = fill
        self.units = units or {}
        self.times: List[float] = []
        self.buffers: Dict[str, List[np.ndarray]] = {f: [] for f in fields}

    def __call__(self, sim):
        grid = sim.model.grid
        if not hasattr(grid, "scatter"):
            raise TypeError("NetCDFRasterWriter requires a ColumnRingGrid "
                            "(use FieldTimeSeriesWriter for ColumnGrid runs)")
        if not self.schedule.actuates(sim):
            return
        self.times.append(sim.current_time)
        for f in self.fields:
            arr = grid.scatter(np.asarray(sim.state[f]), fill=self.fill)
            self.buffers[f].append(arr)
        self.flush(sim)

    def flush(self, sim=None):
        from .netcdf import NCVariable, write_netcdf

        if sim is None:
            return
        grid = sim.model.grid
        coords = {
            "time": np.asarray(self.times),
            "lat": np.asarray(grid.ring.lats),
            "lon": np.asarray(grid.ring.lons),
        }
        if hasattr(grid, "vertical"):
            coords["z"] = np.asarray(grid.vertical.z_centers).reshape(-1)
            coords["z_face"] = np.asarray(grid.vertical.z_faces).reshape(-1)
        variables = {}
        for f in self.fields:
            if not self.buffers[f]:
                continue
            data = np.stack(self.buffers[f])
            if data.ndim == 4:
                # center fields on "z", face fields (Nz+1) on "z_face"
                zdim = "z" if data.shape[1] == len(coords.get("z", ())) \
                    else "z_face"
                dims = ["time", zdim, "lat", "lon"]
            else:
                dims = ["time", "lat", "lon"]
            # always record the fill sentinel, dtype-matched to the data, so
            # CF tooling masks sea points whatever the fill value is
            attrs = {"_FillValue": np.asarray(self.fill, dtype=data.dtype)}
            if f in self.units:
                attrs["units"] = self.units[f]
            variables[f] = NCVariable(name=f, data=data, dims=dims, attrs=attrs)
        write_netcdf(self.path, variables, coords=coords,
                     global_attrs={"source": "terrarium_tpu",
                                   "Conventions": "CF-1.8"})


@dataclasses.dataclass
class ProgressLogger:
    """Progress callback printing time/iteration (the reference's Callback +
    IterationInterval progress logging pattern)."""

    log = staticmethod(print)

    def __call__(self, sim):
        self.log(f"[terrarium_tpu] t={sim.current_time:.1f}s "
                 f"iter={sim.iteration}")
