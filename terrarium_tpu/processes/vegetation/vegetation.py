"""PALADYN vegetation carbon processes (single PFT, needleleaf defaults).

JAX equivalent of reference `src/processes/vegetation/`
(Willeit & Ganopolski 2016): LUE photosynthesis, Medlyn stomatal conductance,
autotrophic respiration, phenology (stub), carbon dynamics, Lotka-Volterra
vegetation dynamics, static exponential root distribution, and
field-capacity-limited plant-available water. All XY kernels become
vectorised ``(cells,)`` expressions; the PAW beta integral is a z-sum.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax.numpy as jnp
import numpy as np

from ..soil.stratigraphy import volumetric_fractions
from ...constants import (PhysicalConstants, partial_pressure_CO2,
                          partial_pressure_O2)
from ...variables import XY, XYZ, auxiliary, input as input_var, prognostic

__all__ = [
    "LUEPhotosynthesis",
    "MedlynStomatalConductance",
    "PALADYNAutotrophicRespiration",
    "PALADYNPhenology",
    "PALADYNCarbonDynamics",
    "PALADYNVegetationDynamics",
    "StaticExponentialRootDistribution",
    "FieldCapacityLimitedPAW",
    "VegetationCarbon",
]


# ---------------------------------------------------------------------------
# Photosynthesis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LUEPhotosynthesis:
    """PALADYN/BIOME3 C3 light-use-efficiency photosynthesis
    (reference `photosynthesis.jl:18-430`)."""

    tau25: float = 2600.0
    Kc25: float = 30.0
    Ko25: float = 3.0e4
    q10_tau: float = 0.57
    q10_Kc: float = 2.1
    q10_Ko: float = 1.2
    alpha_leaf: float = 0.17
    alpha_a: float = 0.5
    alpha_C3: float = 0.08
    cq: float = 4.6e-6
    k_ext: float = 0.5
    T_CO2_high: float = 42.0
    T_CO2_low: float = -4.0
    T_photos_high: float = 30.0
    T_photos_low: float = 15.0
    theta_r: float = 0.7

    def variables(self):
        return (
            auxiliary("net_assimilation", XY(), units="g/m^2/s"),
            auxiliary("leaf_respiration", XY(), units="g/m^2/s"),
            auxiliary("gross_primary_production", XY(), units="kg/m^2/s"),
            input_var("soil_moisture_limiting_factor", XY(), default=1.0),
            input_var("leaf_area_index", XY()),
        )

    # -- primitives (reference `photosynthesis.jl:95-250`) ----------------
    def kinetic_parameters(self, T_air):
        tau = self.tau25 * self.q10_tau ** ((T_air - 25.0) * 0.1)
        Kc = self.Kc25 * self.q10_Kc ** ((T_air - 25.0) * 0.1)
        Ko = self.Ko25 * self.q10_Ko ** ((T_air - 25.0) * 0.1)
        return tau, Kc, Ko

    def gamma_star(self, tau, pres_O2):
        return pres_O2 / (2.0 * tau)

    def PAR(self, swdown):
        return 0.5 * swdown * (1.0 - self.alpha_leaf) * self.cq

    def APAR(self, swdown, LAI):
        return self.alpha_a * self.PAR(swdown) * (1.0 - jnp.exp(-self.k_ext * LAI))

    def temperature_stress(self, T_air):
        """Double-sigmoid temperature response
        (reference `photosynthesis.jl:155-186`)."""
        # float() keeps the numpy log constants weakly typed (np.float64
        # scalars are strong under x64 and would promote the f32 chain)
        k1 = 2.0 * float(np.log(1.0 / 0.99 - 1.0)) / (self.T_CO2_low
                                                      - self.T_photos_low)
        k2 = 0.5 * (self.T_CO2_low + self.T_photos_low)
        k3 = float(np.log(0.99 / 0.01)) / (self.T_CO2_high - self.T_photos_high)
        low = 1.0 / (1.0 + jnp.exp(k1 * (k2 - T_air)))
        high = 1.0 - 0.01 * jnp.exp(k3 * (T_air - self.T_photos_high))
        in_range = (T_air > self.T_CO2_low) & (T_air < self.T_CO2_high)
        return jnp.where(in_range, low * high, 0.0)

    def compute(self, constants: PhysicalConstants, T_air, swdown, pres, co2,
                LAI, lam_c, beta):
        """Rd, An, GPP (reference `compute_respiration_assimilation`,
        `photosynthesis.jl:253-330`); gated on swdown > 0, T > -3 C, LAI > 0."""
        pres_O2 = partial_pressure_O2(pres)
        pres_a = partial_pressure_CO2(pres, co2)
        tau, Kc, Ko = self.kinetic_parameters(T_air)
        g_star = self.gamma_star(tau, pres_O2)
        APAR = self.APAR(swdown, LAI)
        PAR = self.PAR(swdown)
        pres_i = lam_c * pres_a
        T_stress = self.temperature_stress(T_air)
        c1 = self.alpha_C3 * T_stress * constants.C_mass * (pres_i - g_star) \
            / (pres_i + 2.0 * g_star)
        c2 = (pres_i - g_star) / (pres_i + Kc * (1.0 + pres_O2 / Ko))
        Vc_max = c1 * PAR * (pres_i + Kc * (1.0 + pres_O2 / Ko)) / (pres_i - g_star)
        Rd = self.alpha_C3 * Vc_max * beta
        JE = c1 * APAR
        JC = c2 * Vc_max
        disc = jnp.maximum((JE + JC) ** 2 - 4.0 * self.theta_r * JE * JC, 0.0)
        Ag = (JE + JC - jnp.sqrt(disc)) / (2.0 * self.theta_r) * beta
        An = Ag - Rd
        active = (swdown > 0.0) & (T_air > -3.0) & (LAI > 0.0)
        Rd = jnp.where(active, Rd, 0.0)
        An = jnp.where(active, An, 0.0)
        GPP = An * 1.0e-3  # gC -> kgC (reference `photosynthesis.jl:337-341`)
        return Rd, An, GPP

    def compute_auxiliary(self, state, grid, stomcond, constants, atmos, ctx=None):
        T_air = atmos.air_temperature(state)
        pres = atmos.air_pressure(state)
        swdown = atmos.shortwave_down(state)
        co2 = state.inputs["CO2"]
        beta = state.soil_moisture_limiting_factor
        LAI = state.leaf_area_index
        lam_c = state.leaf_to_air_co2_ratio
        Rd, An, GPP = self.compute(constants, T_air, swdown, pres, co2, LAI,
                                   lam_c, beta)
        return state.update(leaf_respiration=Rd, net_assimilation=An,
                            gross_primary_production=GPP)


# ---------------------------------------------------------------------------
# Stomatal conductance
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MedlynStomatalConductance:
    """Medlyn et al. (2011) optimal stomatal conductance
    (reference `stomatal_conductance.jl:17-143`)."""

    g1: float = 2.3
    g_min: float = 0.5  # [mm/s]

    def variables(self):
        return (
            auxiliary("canopy_water_conductance", XY(), units="m/s"),
            auxiliary("leaf_to_air_co2_ratio", XY()),
        )

    def gw_can(self, photo, vpd, An, co2, LAI, beta):
        """g0 + 1.6 (1 + g1/sqrt(vpd)) An/co2 * 1e6
        (reference `stomatal_conductance.jl:48-68`)."""
        g0 = (self.g_min / 1000.0) * (1.0 - jnp.exp(-photo.k_ext * LAI)) * beta
        return g0 + 1.6 * (1.0 + self.g1 / jnp.sqrt(vpd)) * An / co2 * 1.0e6

    def lambda_c(self, vpd):
        """1 - 1/(1 + g1/sqrt(vpd*1e-3)) (reference
        `stomatal_conductance.jl:80-86`)."""
        return 1.0 - 1.0 / (1.0 + self.g1 / jnp.sqrt(vpd * 1.0e-3))

    def compute_auxiliary(self, state, grid, photo, constants, atmos, ctx=None):
        An = state.net_assimilation
        co2 = state.inputs["CO2"]
        LAI = state.leaf_area_index
        beta = state.soil_moisture_limiting_factor
        vpd = atmos.compute_vpd(state, constants)
        return state.update(
            canopy_water_conductance=self.gw_can(photo, vpd, An, co2, LAI, beta),
            leaf_to_air_co2_ratio=self.lambda_c(vpd))


# ---------------------------------------------------------------------------
# Autotrophic respiration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PALADYNAutotrophicRespiration:
    """PALADYN maintenance + growth respiration
    (reference `autotrophic_respiration.jl:17-224`)."""

    cn_sapwood: float = 330.0
    cn_root: float = 29.0
    aws: float = 10.0
    resp10: float = 0.066
    # reference parity: resp10 terms are (probably) per-day rates mixed into
    # per-second tendencies; rate_scale = 1/86400 makes them per-second
    rate_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNAutotrophicRespiration":
        return PALADYNAutotrophicRespiration(rate_scale=1.0 / 86400.0, **kw)

    def variables(self):
        return (
            auxiliary("autotrophic_respiration", XY(), units="kg/m^2/s"),
            auxiliary("net_primary_production", XY(), units="kg/m^2/s"),
            input_var("gross_primary_production", XY(), units="kg/m^2/s"),
            input_var("daily_leaf_respiration", XY(), units="g/m^2/s"),
            input_var("phenology_factor", XY()),
            input_var("ground_temperature", XY(), default=10.0, units="degC"),
        )

    @staticmethod
    def f_temp(T):
        """exp(308.56 (1/56.02 - 1/(46.02 + T)))
        (reference `autotrophic_respiration.jl:54-60`)."""
        return jnp.exp(308.56 * (1.0 / 56.02 - 1.0 / (46.02 + T)))

    def Rm(self, cd, T_air, T_soil, Rd, phen, C_veg):
        """R_leaf + R_stem + R_root (reference `autotrophic_respiration.jl:
        89-126`)."""
        f_air = self.f_temp(T_air)
        f_soil = jnp.where(T_soil > 7.0, self.f_temp(T_soil), 0.0)
        R_leaf = Rd / 1000.0
        R_stem = self.resp10 * f_air * (cd.awl * ((2.0 / cd.SLA) + cd.awl)) \
            / (C_veg * self.aws * self.cn_sapwood)
        R_root = self.resp10 * f_soil * phen * (2.0 / cd.SLA) \
            / (cd.SLA * C_veg * self.cn_root)
        return R_leaf + (R_stem + R_root) * self.rate_scale

    def compute_auxiliary(self, state, grid, carbon_dynamics, atmos, ctx=None):
        T_air = atmos.air_temperature(state)
        T_soil = state.ground_temperature
        Rd = state.daily_leaf_respiration
        phen = state.phenology_factor
        C_veg = state.carbon_vegetation
        GPP = state.gross_primary_production
        Rm = self.Rm(carbon_dynamics, T_air, T_soil, Rd, phen, C_veg)
        Rg = 0.25 * (GPP - Rm)
        Ra = Rm + Rg
        NPP = GPP - Ra
        return state.update(autotrophic_respiration=Ra,
                            net_primary_production=NPP)


# ---------------------------------------------------------------------------
# Phenology (stub, evergreen)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PALADYNPhenology:
    """Phenology stub: phen = 1, f_deciduous = 0, LAI = LAI_b
    (reference `phenology.jl:16-119`)."""

    def variables(self):
        return (
            auxiliary("phenology_factor", XY()),
            auxiliary("leaf_area_index", XY()),
            input_var("balanced_leaf_area_index", XY()),
        )

    def compute_auxiliary(self, state, grid, ctx=None):
        LAI_b = state.balanced_leaf_area_index
        phen = jnp.ones_like(LAI_b)
        f_dec = 0.0
        LAI = (f_dec * phen + (1.0 - f_dec)) * LAI_b
        return state.update(phenology_factor=phen, leaf_area_index=LAI)


# ---------------------------------------------------------------------------
# Carbon dynamics
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PALADYNCarbonDynamics:
    """Vegetation carbon pool dynamics (reference `carbon_dynamics.jl:19-198`)."""

    SLA: float = 10.0
    awl: float = 2.0
    LAI_min: float = 1.0
    LAI_max: float = 6.0
    gammaL: float = 0.3
    gammaR: float = 0.3
    gammaS: float = 0.05
    # Unit handling for the turnover rates: the reference applies the
    # [1/year] rates directly in per-second tendencies (acknowledged TODO in
    # `carbon_dynamics.jl:36-44`), which blows up sub-daily integrations.
    # rate_scale = 1.0 reproduces the reference exactly; use
    # `consistent_units()` (rate_scale = 1/(365*86400)) for stable long runs.
    rate_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNCarbonDynamics":
        return PALADYNCarbonDynamics(rate_scale=1.0 / (365.0 * 86400.0), **kw)

    def variables(self):
        return (
            prognostic("carbon_vegetation", XY(), units="kg/m^2"),
            auxiliary("balanced_leaf_area_index", XY()),
            input_var("net_primary_production", XY(), units="kg/m^2/s"),
        )

    def LAI_b(self, C_veg):
        """C_veg / (2/SLA + awl) (reference `carbon_dynamics.jl:96-99`)."""
        return C_veg / ((2.0 / self.SLA) + self.awl)

    def lambda_NPP(self, LAI_b):
        """Ramp between LAI_min and LAI_max (reference `carbon_dynamics.jl:64-74`)."""
        ramp = (LAI_b - self.LAI_min) / (self.LAI_max - self.LAI_min)
        return jnp.clip(ramp, 0.0, 1.0)

    def litterfall(self, LAI_b):
        """(gL/SLA + gR/SLA + gS*awl) * LAI_b (reference `carbon_dynamics.jl:
        109-116`)."""
        return (self.gammaL / self.SLA + self.gammaR / self.SLA
                + self.gammaS * self.awl) * LAI_b * self.rate_scale

    def compute_auxiliary(self, state, grid, ctx=None):
        return state.update(
            balanced_leaf_area_index=self.LAI_b(state.carbon_vegetation))

    def compute_tendencies(self, state, grid, ctx=None):
        """dC/dt = (1 - lambda)NPP - litterfall (reference
        `carbon_dynamics.jl:126-138`)."""
        LAI_b = state.balanced_leaf_area_index
        NPP = state.net_primary_production
        dC = (1.0 - self.lambda_NPP(LAI_b)) * NPP - self.litterfall(LAI_b)
        return state.add_tendencies(carbon_vegetation=dC)


# ---------------------------------------------------------------------------
# Vegetation dynamics
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PALADYNVegetationDynamics:
    """Lotka-Volterra vegetation fraction dynamics
    (reference `vegetation_dynamics.jl:16-159`)."""

    nu_seed: float = 0.001
    gammav_min: float = 0.002
    # see PALADYNCarbonDynamics.rate_scale (same yearly-rate caveat)
    rate_scale: float = 1.0

    @staticmethod
    def consistent_units(**kw) -> "PALADYNVegetationDynamics":
        return PALADYNVegetationDynamics(rate_scale=1.0 / (365.0 * 86400.0), **kw)

    def variables(self):
        return (
            prognostic("vegetation_area_fraction", XY()),
            input_var("balanced_leaf_area_index", XY()),
            input_var("carbon_vegetation", XY(), units="kg/m^2"),
            input_var("net_primary_production", XY(), units="kg/m^2/s"),
        )

    def compute_auxiliary(self, state, grid, ctx=None):
        return state

    def compute_tendencies(self, state, grid, carbon_dynamics, ctx=None):
        """dnu/dt = (lambda NPP / C_veg) nu*(1 - nu) - gamma_v nu*
        with nu* = max(nu, nu_seed) (reference `vegetation_dynamics.jl:90-110`)."""
        LAI_b = state.balanced_leaf_area_index
        C_veg = state.carbon_vegetation
        NPP = state.net_primary_production
        nu = state.vegetation_area_fraction
        lam = carbon_dynamics.lambda_NPP(LAI_b)
        nu_star = jnp.maximum(nu, self.nu_seed)
        dnu = (lam * NPP / C_veg) * nu_star * (1.0 - nu) \
            - self.gammav_min * self.rate_scale * nu_star
        return state.add_tendencies(vegetation_area_fraction=dnu)


# ---------------------------------------------------------------------------
# Root distribution + plant available water
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StaticExponentialRootDistribution:
    """Root CDF as average of two exponentials (Zeng 2001; reference
    `root_distribution.jl:16-63`). Realized as a static auxiliary field:
    density * dz, normalized over the column."""

    a: float = 7.0
    b: float = 2.0

    def variables(self):
        return (auxiliary("root_fraction", XYZ(), ctor=self._make_field),)

    def _make_field(self, grid, arrays):
        z = grid.vertical.z_centers[:, None]  # negative below surface
        density = 0.5 * (self.a * np.exp(self.a * z) + self.b * np.exp(self.b * z))
        R = density * grid.vertical.dz[:, None]
        R = R / R.sum(axis=0, keepdims=True)
        return np.broadcast_to(R, (grid.nz, grid.cells))

    def compute_auxiliary(self, state, grid, ctx=None):
        return state  # static


@dataclasses.dataclass(frozen=True)
class FieldCapacityLimitedPAW:
    """Plant-available water W = clip((theta_w - wp)/(fc - wp), 0, 1) per
    layer; beta = sum_k W_k r_k (the reference's Integral of W*r/dz,
    `plant_available_water.jl:34-62`)."""

    def variables(self):
        return (
            auxiliary("plant_available_water", XYZ(),
                      desc="Fraction of soil water available for root uptake"),
            auxiliary("soil_moisture_limiting_factor", XY()),
            input_var("root_fraction", XYZ(),
                      desc="Fraction of roots in each soil layer"),
        )

    def compute_auxiliary(self, state, grid, soil, ctx=None):
        if soil is None:
            return state
        strat, bgc, hyd = soil.strat, soil.biogeochem, soil.hydrology
        vol = strat.soil_volume(bgc, state, grid)
        theta_w = volumetric_fractions(vol)["water"]
        fc = hyd.hydraulic_properties.field_capacity(strat.texture)
        wp = hyd.hydraulic_properties.wilting_point(strat.texture)
        W = jnp.clip((theta_w - wp) / (fc - wp), 0.0, 1.0)
        W = jnp.broadcast_to(W, (grid.nz, grid.cells))
        beta = jnp.sum(W * state.root_fraction, axis=0)
        return state.update(plant_available_water=W,
                            soil_moisture_limiting_factor=beta)


# ---------------------------------------------------------------------------
# Coupled container
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VegetationCarbon:
    """Coupled vegetation carbon processes with the documented aux dependency
    order (reference `vegetation_carbon.jl:72-119`): PAW -> carbon dynamics
    (LAI_b at t-1) -> phenology -> stomatal conductance -> photosynthesis ->
    autotrophic respiration."""

    photosynthesis: LUEPhotosynthesis = LUEPhotosynthesis()
    stomatal_conductance: MedlynStomatalConductance = MedlynStomatalConductance()
    autotrophic_respiration: PALADYNAutotrophicRespiration = PALADYNAutotrophicRespiration()
    phenology: PALADYNPhenology = PALADYNPhenology()
    carbon_dynamics: PALADYNCarbonDynamics = PALADYNCarbonDynamics()
    vegetation_dynamics: Optional[PALADYNVegetationDynamics] = PALADYNVegetationDynamics()
    root_distribution: Optional[StaticExponentialRootDistribution] = \
        StaticExponentialRootDistribution()
    plant_available_water: Optional[FieldCapacityLimitedPAW] = FieldCapacityLimitedPAW()

    @staticmethod
    def consistent_units(**kw) -> "VegetationCarbon":
        """Vegetation configuration with turnover/respiration rates converted
        to per-second, stable for sub-daily long integrations (extension
        beyond the reference, whose raw yearly rates diverge; see
        `PALADYNCarbonDynamics.rate_scale`)."""
        return VegetationCarbon(
            autotrophic_respiration=PALADYNAutotrophicRespiration.consistent_units(),
            carbon_dynamics=PALADYNCarbonDynamics.consistent_units(),
            vegetation_dynamics=PALADYNVegetationDynamics.consistent_units(),
            **kw)

    def variables(self):
        out = ()
        for p in (self.photosynthesis, self.stomatal_conductance,
                  self.autotrophic_respiration, self.phenology,
                  self.carbon_dynamics, self.vegetation_dynamics,
                  self.root_distribution, self.plant_available_water):
            if p is not None:
                out += tuple(p.variables())
        return out

    def initialize(self, state, grid, constants, atmos, ctx=None):
        return state

    def compute_auxiliary(self, state, grid, constants, atmos, soil=None, ctx=None):
        if self.plant_available_water is not None:
            state = self.plant_available_water.compute_auxiliary(state, grid,
                                                                 soil, ctx)
        state = self.carbon_dynamics.compute_auxiliary(state, grid, ctx)
        state = self.phenology.compute_auxiliary(state, grid, ctx)
        state = self.stomatal_conductance.compute_auxiliary(
            state, grid, self.photosynthesis, constants, atmos, ctx)
        state = self.photosynthesis.compute_auxiliary(
            state, grid, self.stomatal_conductance, constants, atmos, ctx)
        state = self.autotrophic_respiration.compute_auxiliary(
            state, grid, self.carbon_dynamics, atmos, ctx)
        return state

    def compute_tendencies(self, state, grid, constants=None, ctx=None):
        state = self.carbon_dynamics.compute_tendencies(state, grid, ctx)
        if self.vegetation_dynamics is not None:
            state = self.vegetation_dynamics.compute_tendencies(
                state, grid, self.carbon_dynamics, ctx)
        return state
