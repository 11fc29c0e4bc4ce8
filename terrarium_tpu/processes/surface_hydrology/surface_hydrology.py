"""Surface hydrology: canopy interception, evapotranspiration, runoff.

JAX equivalent of reference `src/processes/surface_hydrology/`
(`surface_hydrology.jl`, `canopy_interception/`, `evapotranspiration/`,
`runoff/`). All schemes operate on whole ``(cells,)`` arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp

from ..soil.stratigraphy import volumetric_fractions
from ...variables import XY, auxiliary, input as input_var, prognostic

__all__ = [
    "NoCanopyInterception",
    "PALADYNCanopyInterception",
    "ConstantEvaporationResistanceFactor",
    "SoilMoistureResistanceFactor",
    "BareGroundEvaporation",
    "PALADYNCanopyEvapotranspiration",
    "DirectSurfaceRunoff",
    "SurfaceHydrology",
]


# ---------------------------------------------------------------------------
# Canopy interception
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NoCanopyInterception:
    """All rainfall reaches the ground (reference `canopy_interception.jl:7-23`)."""

    def variables(self):
        # rainfall_ground is a lazy view of rainfall in the reference; here a
        # real aux refreshed each step
        return (auxiliary("rainfall_ground", XY(), units="m/s",
                          desc="Rainfall rate reaching the ground"),)

    def compute_auxiliary(self, state, grid, atmos, ctx):
        return state.update(rainfall_ground=atmos.rainfall(state))

    def compute_tendencies(self, state, grid, evtr, ctx):
        return state

    def canopy_water(self, state):
        return 0.0

    def saturation_canopy_water(self, state):
        return 0.0


@dataclasses.dataclass(frozen=True)
class PALADYNCanopyInterception:
    """PALADYN canopy interception/storage, liquid only (Willeit & Ganopolski
    2016 Eq. 41-44; reference `canopy_interception.jl:40-221`)."""

    alpha_int: float = 0.2  # interception factor
    k_ext: float = 0.5  # radiation extinction coefficient
    w_can_max: float = 2.0e-4  # interception capacity parameter [m]
    tau_w: float = 86400.0  # removal timescale [s]

    def variables(self):
        return (
            prognostic("canopy_water", XY(), units="m", desc="Canopy liquid water"),
            auxiliary("canopy_water_interception", XY(), units="m/s",
                      desc="Canopy rain interception rate"),
            auxiliary("canopy_water_removal", XY(), units="m/s",
                      desc="Canopy water removal rate"),
            auxiliary("saturation_canopy_water", XY(),
                      desc="Fraction of the canopy saturated with water"),
            auxiliary("rainfall_ground", XY(), units="m/s",
                      desc="Rainfall rate reaching the ground"),
            input_var("leaf_area_index", XY(), units="m^2/m^2", desc="Leaf Area Index"),
            input_var("SAI", XY(), units="m^2/m^2", desc="Stem Area Index"),
        )

    def canopy_water(self, state):
        return state.canopy_water

    def saturation_canopy_water(self, state):
        return state.saturation_canopy_water

    def compute_auxiliary(self, state, grid, atmos, ctx):
        """I_can = alpha*P*(1 - e^(-k(LAI+SAI))); R = max(w,0)/tau_w;
        f = w/(w_max*(LAI+SAI)); ground rain = P - I + R
        (reference `canopy_interception.jl:105-170, 262-300`)."""
        rain = atmos.rainfall(state)
        LAI = state.leaf_area_index
        SAI = state.SAI
        w = state.canopy_water
        w_max = self.w_can_max * (LAI + SAI)
        # clamped to [0, 1]: the canopy saturation *fraction* (PALADYN Eq. 43).
        # The reference leaves this unclamped (`canopy_interception.jl:117-122`),
        # which lets the marginally-stable explicit canopy-water ODE feed back
        # into the latent heat flux and blow up the skin temperature.
        f_can = jnp.where(w_max > 0.0,
                          jnp.clip(w / jnp.maximum(w_max, 1e-30), 0.0, 1.0), 0.0)
        I_can = self.alpha_int * rain * (1.0 - jnp.exp(-self.k_ext * (LAI + SAI)))
        R_can = jnp.maximum(w, 0.0) / self.tau_w
        return state.update(
            canopy_water_interception=I_can,
            canopy_water_removal=R_can,
            saturation_canopy_water=f_can,
            rainfall_ground=rain - I_can + R_can,
        )

    def compute_tendencies(self, state, grid, evtr, ctx):
        """dw/dt = I_can - E_can - R_can (reference `canopy_interception.jl:
        176-186, 303-320`). E_can uses the ET scheme's water-flux unit scale
        (see BareGroundEvaporation.water_flux_scale)."""
        E_can = state.evaporation_canopy if "evaporation_canopy" in state \
            else jnp.zeros_like(state.canopy_water)
        scale = getattr(evtr, "water_flux_scale", 1.0)
        dw = (state.canopy_water_interception - E_can * scale
              - state.canopy_water_removal)
        return state.add_tendencies(canopy_water=dw)


# ---------------------------------------------------------------------------
# Ground evaporation resistance
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConstantEvaporationResistanceFactor:
    """Constant beta (reference `ground_resistance_factor.jl:8-17`)."""

    factor: float = 1.0

    def __call__(self, state, grid, soil):
        return self.factor


@dataclasses.dataclass(frozen=True)
class SoilMoistureResistanceFactor:
    """Lee & Pielke (1992) soil-moisture limiter:
    beta = (1 - cos(pi theta_1/theta_fc))^2 / 4 below field capacity, else 1
    (reference `ground_resistance_factor.jl:26-57`)."""

    def __call__(self, state, grid, soil):
        if soil is None:
            return 1.0
        strat, bgc, hyd = soil.strat, soil.biogeochem, soil.hydrology
        vol = strat.soil_volume(bgc, state, grid)
        theta_w = volumetric_fractions(vol)["water"][-1]  # top layer
        fc = hyd.hydraulic_properties.field_capacity(strat.texture)
        beta = (1.0 - jnp.cos(jnp.pi * theta_w / fc)) ** 2 / 4.0
        return jnp.where(theta_w < fc, beta, 1.0)


# ---------------------------------------------------------------------------
# Evapotranspiration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BareGroundEvaporation:
    """E = beta * dq / r_a (reference `bare_ground_evaporation.jl:1-62`)."""

    ground_resistance: Any = ConstantEvaporationResistanceFactor()
    # The reference applies the specific-humidity flux Q_h [kg/kg * m/s]
    # directly as a *water volume* flux (`evapotranspiration_base.jl:9-15`),
    # overdrawing soil water by rho_w/rho_a ~ 773x. water_flux_scale = 1.0
    # reproduces that; `consistent_units()` applies rho_a/rho_w so the water
    # sink matches the latent heat flux H_l = L*rho_a*Q_h.
    water_flux_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "BareGroundEvaporation":
        return BareGroundEvaporation(water_flux_scale=1.293e-3, **kw)

    def variables(self):
        return (
            auxiliary("evaporation_ground", XY(), units="m/s",
                      desc="Ground evaporation contribution to humidity flux"),
            input_var("skin_temperature", XY(), units="degC",
                      desc="Skin temperature of the surface"),
        )

    def surface_humidity_flux(self, state):
        return state.evaporation_ground

    def compute_auxiliary(self, state, grid, canopy, constants, atmos, soil,
                          vegetation, ctx):
        Ts = state.skin_temperature
        r_a = atmos.aerodynamic_resistance(state, constants)
        beta = self.ground_resistance(state, grid, soil)
        dq = atmos.humidity_vpd(state, constants, Ts)
        return state.update(evaporation_ground=beta * dq / r_a)

    def soil_moisture_sink(self, state, grid, constants):
        """ET forcing for the top soil layer: -Q_h (divided by dz by the
        caller; reference `evapotranspiration_base.jl:9-15`), times the
        water-flux unit scale (see water_flux_scale)."""
        return -self.surface_humidity_flux(state) * self.water_flux_scale


@dataclasses.dataclass(frozen=True)
class PALADYNCanopyEvapotranspiration:
    """PALADYN ET: transpiration dq/(r_a + 1/g_can); ground evap
    beta*dq_g/(r_a + r_e) with canopy-ground resistance
    r_e = (1 - e^(-LAI-SAI))/(C_can*V); canopy evap f_can*dq/r_a
    (Willeit & Ganopolski 2016 Eq. 5; reference
    `canopy_evapotranspiration.jl:51-177`)."""

    C_can: float = 0.006
    ground_resistance: Any = ConstantEvaporationResistanceFactor()
    # see BareGroundEvaporation.water_flux_scale
    water_flux_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNCanopyEvapotranspiration":
        return PALADYNCanopyEvapotranspiration(water_flux_scale=1.293e-3, **kw)

    def variables(self):
        return (
            auxiliary("evaporation_canopy", XY(), units="m/s",
                      desc="Canopy evaporation contribution to humidity flux"),
            auxiliary("evaporation_ground", XY(), units="m/s",
                      desc="Ground evaporation contribution to humidity flux"),
            auxiliary("transpiration", XY(), units="m/s",
                      desc="Transpiration contribution to humidity flux"),
            input_var("skin_temperature", XY(), units="degC", desc="Skin temperature"),
            input_var("ground_temperature", XY(), default=1.0, units="degC",
                      desc="Ground surface temperature"),
        )

    def surface_humidity_flux(self, state):
        return (state.evaporation_ground + state.evaporation_canopy
                + state.transpiration)

    def canopy_ground_resistance(self, state, atmos):
        """r_e = (1 - e^(-LAI-SAI))/(C_can * V)
        (reference `canopy_evapotranspiration.jl:159-177`)."""
        LAI, SAI = state.leaf_area_index, state.SAI
        V = atmos.windspeed(state)
        return (1.0 - jnp.exp(-LAI - SAI)) / (self.C_can * V)

    def compute_auxiliary(self, state, grid, canopy, constants, atmos, soil,
                          vegetation, ctx):
        Ts = state.skin_temperature
        Tg = state.ground_temperature
        gw_can = state.canopy_water_conductance  # from vegetation
        dq_s = atmos.humidity_vpd(state, constants, Ts)
        dq_g = atmos.humidity_vpd(state, constants, Tg)
        r_a = atmos.aerodynamic_resistance(state, constants)
        r_e = self.canopy_ground_resistance(state, atmos)
        f_can = canopy.saturation_canopy_water(state)
        beta = self.ground_resistance(state, grid, soil)
        eps_nf = jnp.sqrt(jnp.finfo(dq_s.dtype).eps)
        r_s = 1.0 / jnp.maximum(gw_can, eps_nf)
        return state.update(
            transpiration=dq_s / (r_a + r_s),
            evaporation_ground=beta * dq_g / (r_a + r_e),
            evaporation_canopy=f_can * dq_s / r_a,
        )

    def soil_moisture_sink(self, state, grid, constants):
        """Total humidity flux as top-layer soil moisture sink
        (reference `evapotranspiration_base.jl:9-15`), times the water-flux
        unit scale (see BareGroundEvaporation.water_flux_scale)."""
        return -self.surface_humidity_flux(state) * self.water_flux_scale


# ---------------------------------------------------------------------------
# Surface runoff
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DirectSurfaceRunoff:
    """Runoff = P + drainage - infiltration
    (reference `direct_surface_runoff.jl:14-117`).

    ``consistent_drainage``: the reference's surface-excess tendency is
    ``+= min(S/tau, S)`` (`soil_hydrology.jl:274-283`) — the pool *grows* by
    its own drainage while infiltration separately adds the drained water to
    the soil (double-counting; its own docstring calls the drainage a
    "removal"). Parity mode reproduces that exactly; the consistent mode
    applies the drainage with the removal sign so pool + soil + runoff
    closes. See README "deviations"."""

    tau_r: float = 3600.0  # surface water removal timescale [s]
    consistent_drainage: bool = False

    @staticmethod
    def consistent(**kw) -> "DirectSurfaceRunoff":
        return DirectSurfaceRunoff(consistent_drainage=True, **kw)

    def variables(self):
        return (
            auxiliary("surface_runoff", XY(), units="m/s", desc="Total surface runoff"),
            auxiliary("infiltration", XY(), units="m/s", desc="Infiltration flux"),
        )

    def surface_drainage(self, S):
        """dS/dt = max(S, 0)/tau_r (reference `direct_surface_runoff.jl:27-37`)."""
        return jnp.maximum(S, 0.0) / self.tau_r

    def compute_auxiliary(self, state, grid, canopy, soil, ctx):
        rain = state.rainfall_ground
        if "snow_melt" in state:
            # snowpack melt water joins ground rain in the infiltration/
            # runoff partition (extension: processes/snow.py)
            rain = rain + state.snow_melt
        S = state.surface_excess_water if "surface_excess_water" in state else \
            jnp.zeros_like(rain)
        # static slices + squeeze (integer row indexing lowers to
        # dynamic_slice)
        k_unsat = jnp.squeeze(state.hydraulic_conductivity[-1:], 0)  # top face K
        sat_top = jnp.squeeze(state.saturation_water_ice[-1:], 0)
        unsaturated = sat_top < 1.0
        has_excess = S > 0.0
        drainage = jnp.where(has_excess, self.surface_drainage(S), 0.0)
        influx = jnp.where(has_excess, drainage, rain)
        infil = jnp.where(unsaturated, jnp.minimum(influx, k_unsat), 0.0)
        runoff = rain + drainage - infil
        return state.update(infiltration=infil, surface_runoff=runoff)


# ---------------------------------------------------------------------------
# Coupled container
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SurfaceHydrology:
    """{canopy interception, evapotranspiration, runoff} coupling; aux order
    interception -> ET -> runoff (reference `surface_hydrology.jl:10-60`)."""

    canopy_interception: Any = dataclasses.field(default_factory=PALADYNCanopyInterception)
    evapotranspiration: Any = dataclasses.field(default_factory=PALADYNCanopyEvapotranspiration)
    surface_runoff: Any = dataclasses.field(default_factory=DirectSurfaceRunoff)

    @staticmethod
    def bare_ground() -> "SurfaceHydrology":
        """Bare-ground configuration (no canopy), the LandModel default when
        vegetation is absent (reference `land_model.jl:119-125`)."""
        return SurfaceHydrology(canopy_interception=NoCanopyInterception(),
                                evapotranspiration=BareGroundEvaporation())

    def variables(self):
        out = tuple(self.canopy_interception.variables()) if hasattr(
            self.canopy_interception, "variables") else ()
        out += tuple(self.evapotranspiration.variables())
        out += tuple(self.surface_runoff.variables())
        return out

    def compute_auxiliary(self, state, grid, constants, atmos, soil=None,
                          vegetation=None, ctx=None):
        state = self.canopy_interception.compute_auxiliary(state, grid, atmos, ctx)
        state = self.evapotranspiration.compute_auxiliary(
            state, grid, self.canopy_interception, constants, atmos, soil,
            vegetation, ctx)
        state = self.surface_runoff.compute_auxiliary(
            state, grid, self.canopy_interception, soil, ctx)
        return state

    def compute_tendencies(self, state, grid, ctx=None):
        return self.canopy_interception.compute_tendencies(
            state, grid, self.evapotranspiration, ctx)
