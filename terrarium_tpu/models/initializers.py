"""Model/state initializers.

JAX equivalent of reference `src/initializers.jl` and
`src/models/soil/soil_model_init.jl`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils.utils import piecewise_linear

__all__ = [
    "DefaultInitializer",
    "SoilInitializer",
    "ConstantSoilTemperature",
    "QuasiThermalSteadyState",
    "PiecewiseLinearInitialSoilTemperature",
    "ConstantSaturation",
    "SaturationWaterTable",
    "apply_field_initializers",
]


def _eval_field_init(spec, grid, shape):
    """Evaluate a field-initializer spec into an array of ``shape``.

    Specs may be scalars, arrays, or callables: ``f(x, z)`` for XYZ fields /
    ``f(x)`` for XY fields, where ``x`` is the normalized column coordinate in
    [0, 1) (the reference's periodic x axis, `column_grid.jl:20-38`) and ``z``
    the (negative) cell-center elevation.
    """
    x = (np.arange(grid.cells) + 0.5) / grid.cells
    if callable(spec):
        if len(shape) == 2:  # XYZ: (Nz, cells)
            z = grid.vertical.z_centers[:, None]
            val = spec(x[None, :], z)
        else:
            val = spec(x)
        return jnp.broadcast_to(jnp.asarray(val, dtype=grid.nf), shape)
    return jnp.broadcast_to(jnp.asarray(spec, dtype=grid.nf), shape)


def apply_field_initializers(state, grid, inits: dict):
    """Apply user field initializers (reference `initializers.jl:23-27`)."""
    updates = {}
    for name, spec in (inits or {}).items():
        cur = state[name]
        updates[name] = _eval_field_init(spec, grid, cur.shape).astype(cur.dtype)
    return state.update(updates) if updates else state


@dataclasses.dataclass(frozen=True)
class DefaultInitializer:
    """No-op initializer (reference `initializers.jl:36-40`)."""

    def initialize(self, state, model):
        return state


@dataclasses.dataclass(frozen=True)
class ConstantSoilTemperature:
    """T(z) = T0 (reference `soil_model_init.jl:42-57`)."""

    T0: float = 0.0

    def initialize(self, state, model):
        return state.update(temperature=jnp.full_like(state.temperature, self.T0))


@dataclasses.dataclass(frozen=True)
class QuasiThermalSteadyState:
    """T(z) = T0 - Qgeo/k_eff * z (reference `soil_model_init.jl:67-86`)."""

    T0: float = 0.0
    Qgeo: float = 0.02
    k_eff: float = 1.0

    def initialize(self, state, model):
        z = model.grid.z_centers  # (Nz, 1), negative below surface
        T = self.T0 - self.Qgeo / self.k_eff * z
        return state.update(temperature=jnp.broadcast_to(
            T, state.temperature.shape).astype(state.temperature.dtype))


@dataclasses.dataclass(frozen=True)
class PiecewiseLinearInitialSoilTemperature:
    """Piecewise-linear T from (depth, value) knots, flat extrapolation
    (reference `soil_model_init.jl:96-120`). Depths are positive-down [m]."""

    knots: Tuple[Tuple[float, float], ...] = ((0.0, 0.0),)

    def initialize(self, state, model):
        f = piecewise_linear(*self.knots)
        depth = -model.grid.z_centers  # positive down
        T = f(depth)
        return state.update(temperature=jnp.broadcast_to(
            T, state.temperature.shape).astype(state.temperature.dtype))


@dataclasses.dataclass(frozen=True)
class ConstantSaturation:
    """sat(z) = const (reference `soil_model_init.jl:128-136`)."""

    sat: float = 1.0

    def initialize(self, state, model):
        return state.update(saturation_water_ice=jnp.full_like(
            state.saturation_water_ice, self.sat))


@dataclasses.dataclass(frozen=True)
class SaturationWaterTable:
    """Saturated below the water table depth, constant vadose saturation above
    (reference `soil_model_init.jl:144-161`). NOTE the reference compares
    ``z <= water_table_depth`` with z *negative*-up and depth positive, which
    saturates everything below ``-water_table_depth`` only if depth is negated;
    we interpret ``water_table_depth`` as positive-down depth."""

    vadose_zone_saturation: float = 0.5
    water_table_depth: float = 5.0

    def initialize(self, state, model):
        z = model.grid.z_centers  # negative below surface
        sat = jnp.where(z <= -self.water_table_depth, 1.0, self.vadose_zone_saturation)
        return state.update(saturation_water_ice=jnp.broadcast_to(
            sat, state.saturation_water_ice.shape).astype(state.saturation_water_ice.dtype))


@dataclasses.dataclass(frozen=True)
class SoilInitializer:
    """Coupled soil initializer; order hydrology -> biogeochem -> energy
    (reference `soil_model_init.jl:6-40`)."""

    energy: Any = dataclasses.field(default_factory=QuasiThermalSteadyState)
    hydrology: Any = dataclasses.field(default_factory=SaturationWaterTable)
    biogeochem: Any = dataclasses.field(default_factory=DefaultInitializer)

    def initialize(self, state, model):
        state = self.hydrology.initialize(state, model)
        state = self.biogeochem.initialize(state, model)
        state = self.energy.initialize(state, model)
        return state
