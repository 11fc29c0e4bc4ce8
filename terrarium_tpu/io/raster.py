"""Raster-backed input sources for masked global grids.

JAX equivalent of the reference `RasterInputSource`
(`ext/TerrariumRastersExt/TerrariumRastersExt.jl:21-147`): NetCDF rasters are
gathered through the grid's land-mask ``idx`` map into packed ``(T, cells)``
arrays once on host, then time-interpolated on device each step (linear, flat
extrapolation at the ends — `TerrariumRastersExt.jl:96-121`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .input_sources import FieldInputSource, TimeSeriesInputSource
from .netcdf import read_netcdf
from ..variables import XY

__all__ = ["RasterInputSource", "raster_input_source"]


def _time_axis_seconds(ncvar, data) -> Optional[np.ndarray]:
    """Convert a time coordinate to seconds relative to the first slice."""
    for dim in ncvar.dims:
        short = dim.split("/")[-1]
        if short in data and short in ("time", "t", "valid_time"):
            t = np.asarray(data[short].data, dtype=np.float64)
            units = str(data[short].attrs.get("units", b""))
            if "hour" in units:
                t = t * 3600.0
            elif "day" in units:
                t = t * 86400.0
            elif "minute" in units:
                t = t * 60.0
            return t - t[0]
    return None


def raster_input_source(grid, path: str, variables: Dict[str, str],
                        time_offset: float = 0.0, fill=0.0):
    """Build an input source from a NetCDF raster file.

    Args:
        grid: a :class:`~terrarium_tpu.grids.ring.ColumnRingGrid`.
        path: NetCDF file path.
        variables: maps input-variable name -> NetCDF variable name.
        time_offset: seconds added to the file's (relative) time axis to align
            it with simulation time (reference `reftime` handling).
        fill: value for padded cells.

    Returns a :class:`FieldInputSource` (static rasters) or
    :class:`TimeSeriesInputSource` (time-varying).
    """
    data = read_netcdf(path)
    packed: Dict[str, np.ndarray] = {}
    times: Optional[np.ndarray] = None
    for in_name, nc_name in variables.items():
        var = data[nc_name]
        arr = np.nan_to_num(var.data, nan=fill)
        t = _time_axis_seconds(var, data)
        if arr.ndim == 3 and t is not None and arr.shape[0] == t.shape[0]:
            if arr.shape[0] == 1:
                packed[in_name] = grid.gather(arr[0], fill=fill)
            else:
                packed[in_name] = grid.gather(arr, fill=fill)
                times = t + time_offset
        elif arr.ndim == 3 and arr.shape[0] == 1:
            packed[in_name] = grid.gather(arr[0], fill=fill)
        elif arr.ndim == 2:
            packed[in_name] = grid.gather(arr, fill=fill)
        else:
            raise ValueError(f"unsupported raster shape {arr.shape} for {nc_name}")

    static = {k: v for k, v in packed.items() if v.ndim == 1}
    dynamic = {k: v for k, v in packed.items() if v.ndim == 2}
    if dynamic:
        if static:
            # split into two sources
            return (TimeSeriesInputSource(times=times, series=dynamic),
                    FieldInputSource(fields=static))
        return TimeSeriesInputSource(times=times, series=dynamic)
    return FieldInputSource(fields=static)


RasterInputSource = raster_input_source  # reference-compatible alias
