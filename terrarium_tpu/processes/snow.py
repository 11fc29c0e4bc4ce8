"""Snowpack: degree-day snow cover with albedo feedback.

**Extension beyond the reference** (documented in README "beyond the
reference"): Terrarium.jl has no snow process — its `snowfall` input
(`prescribed_atmosphere.jl:185-196`) only exists as a precipitation
component, and snow appears solely in the degree-day *tutorial*
(`examples/extending/simple_snow_ddm.jl`, ported at
`examples/extending_snow_ddm.py`). This module promotes that scheme to a
coupled process:

* prognostic ``snow_water_equivalent`` (SWE, m) accumulates the ``snowfall``
  input;
* melt is degree-day (Kavetski & Kuczera 2007): ``dSWE/dt = P - M`` with
  ``M = k_dd * max(T_air - T_melt, 0)`` gated on SWE > 0, exactly the
  tutorial's tendency (`simple_snow_ddm.jl:17-31`), with the tutorial's
  post-step clip SWE >= 0 in the `timestep` hook (`simple_snow_ddm.jl:128-131`);
* the melt flux ``snow_melt`` joins ``rainfall_ground`` in the
  runoff/infiltration partition (`DirectSurfaceRunoff` reads it when
  present), so melt water infiltrates or runs off exactly like rain —
  conservative except on the single step where the pack empties (the
  tutorial's clip semantics). It is NOT routed through the
  ``surface_excess_water`` pool: that pool's reference tendency
  ``+= min(S/tau, S)`` grows the pool by its own drainage
  (`soil_hydrology.jl:274-283`, replicated here for parity), which would
  double-count any water injected into it;
* ``snow_cover_fraction`` = SWE/(SWE + swe_half) feeds an optional albedo
  feedback (:class:`SnowCoverAlbedo`), installed automatically by
  ``LandModel`` when a snowpack is present and the SEB albedo is the
  default (the reference's conditional-defaults idiom,
  `land_model.jl:111-125`).

Everything is elementwise over ``(cells,)`` — one fused elementwise pass.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .surface_energy.seb import ConstantAlbedo
from ..variables import XY, auxiliary, prognostic

__all__ = ["Snowpack", "SnowCoverAlbedo"]


@dataclasses.dataclass(frozen=True)
class SnowCoverAlbedo:
    """Albedo/emissivity blended with the snow cover fraction:
    ``alpha = f*alpha_snow + (1-f)*alpha_base``."""

    base: Any = ConstantAlbedo()
    albedo_snow: float = 0.8
    emissivity_snow: float = 0.99

    def variables(self):
        return tuple(self.base.variables())

    def albedo(self, state):
        f = state.snow_cover_fraction
        return f * self.albedo_snow + (1.0 - f) * self.base.albedo(state)

    def emissivity(self, state):
        f = state.snow_cover_fraction
        return f * self.emissivity_snow + (1.0 - f) * self.base.emissivity(state)


@dataclasses.dataclass(frozen=True)
class Snowpack:
    """Degree-day snowpack (see module docstring)."""

    #: degree-day melt factor [m/(K s)] (0.005 m/K/day)
    degree_day_factor: float = 5.0e-3 / 86400.0
    #: melt threshold air temperature [degC]
    T_melt: float = 0.0
    #: SWE at 50% snow cover [m]
    swe_half: float = 0.01

    def variables(self):
        return (
            prognostic("snow_water_equivalent", XY(), units="m",
                       domain=(0.0, float("inf")),
                       desc="Snow water equivalent of the snowpack"),
            auxiliary("snow_cover_fraction", XY(), domain=(0.0, 1.0),
                      desc="Fractional snow cover of the surface"),
            auxiliary("snow_melt", XY(), units="m/s",
                      desc="Melt water flux released by the snowpack"),
        )

    def compute_auxiliary(self, state, grid, atmos, ctx):
        """Snow cover fraction + melt flux from the current SWE (before the
        surface hydrology and SEB, which consume both)."""
        swe = jnp.maximum(state.snow_water_equivalent, 0.0)
        f = swe / (swe + self.swe_half)
        Ta = atmos.air_temperature(state)
        melt = jnp.where(swe > 0.0,
                         self.degree_day_factor
                         * jnp.maximum(Ta - self.T_melt, 0.0), 0.0)
        return state.update(snow_cover_fraction=f, snow_melt=melt)

    def compute_tendencies(self, state, grid, atmos, ctx):
        """dSWE/dt += snowfall - melt (tutorial tendency,
        `simple_snow_ddm.jl:114-122`)."""
        return state.add_tendencies(
            snow_water_equivalent=atmos.snowfall(state) - state.snow_melt)

    def timestep(self, state, grid, atmos, ctx, dt):
        """Post-step clip SWE >= 0 (tutorial hook, `simple_snow_ddm.jl:128-131`)."""
        return state.update(snow_water_equivalent=jnp.maximum(
            state.snow_water_equivalent, 0.0))
