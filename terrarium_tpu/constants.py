"""Physical constants.

JAX equivalent of the reference `src/processes/physical_constants.jl:9-53`.
Constants are plain Python floats (weakly typed in JAX), so they adopt the dtype
of the array operands they combine with — this reproduces the reference's
"number format everywhere" (NF) policy without explicit casts.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

__all__ = ["PhysicalConstants", "stefan_boltzmann", "saturation_vapor_pressure", "compute_vpd"]


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    """Collection of general physical constants (reference `physical_constants.jl:9-53`)."""

    rho_w: float = 1000.0  # density of water [kg/m^3]
    rho_i: float = 916.2  # density of ice [kg/m^3]
    rho_a: float = 1.293  # density of air at STP [kg/m^3]
    c_a: float = 1005.7  # specific heat capacity of dry air [J/(kg*K)]
    L_sl: float = 3.34e5  # latent heat of fusion [J/kg]
    L_lg: float = 2.257e6  # latent heat of vaporization [J/kg]
    L_sg: float = 2.834e6  # latent heat of sublimation [J/kg]
    g: float = 9.80665  # gravitational acceleration [m/s^2]
    T_ref: float = 273.15  # 0 degC in Kelvin
    sigma: float = 5.6704e-8  # Stefan-Boltzmann constant [W/(m^2 K^4)]
    kappa: float = 0.4  # von Karman constant
    eps: float = 0.622  # molecular weight ratio water vapor / dry air
    R_a: float = 287.058  # specific gas constant of air [J/(kg*K)]
    C_mass: float = 12.0  # atomic mass of carbon [gC/mol]

    # Derived helpers -----------------------------------------------------
    def celsius_to_kelvin(self, T):
        return T + self.T_ref

    @property
    def latent_heat_volumetric(self):
        """Volumetric latent heat of fusion L = rho_w * L_sl [J/m^3]."""
        return self.rho_w * self.L_sl

    def psychrometric_constant(self, p):
        return self.c_a * p / (self.L_lg * self.eps)


def stefan_boltzmann(c: PhysicalConstants, T, emissivity):
    """M = eps * sigma * T^4 with T in Kelvin (reference `physical_constants.jl:68`)."""
    return emissivity * c.sigma * T**4


def saturation_vapor_pressure(T):
    """August-Roche-Magnus saturation vapor pressure [Pa] at temperature ``T`` [degC].

    Frozen/unfrozen coefficients from Alduchov & Eskridge (1996); mirrors
    reference `src/processes/physics_utils.jl:54-73`.
    """
    # clamp to a physical range: the Magnus form divides by zero at
    # T = -272.62 degC, so transient solver over/undershoots (e.g. during a
    # diverging skin-temperature iteration) would otherwise inject NaNs
    T = jnp.clip(jnp.asarray(T), -150.0, 150.0)
    e_frozen = 611.0 * jnp.exp(22.46 * T / (T + 272.62))
    e_liquid = 611.0 * jnp.exp(17.62 * T / (T + 243.12))
    return jnp.where(T <= 0.0, e_frozen, e_liquid)


def compute_vpd(c: PhysicalConstants, pres, q_air, T):
    """Vapor pressure deficit [Pa] over a surface at temperature ``T`` [degC]
    (reference `physical_constants.jl:83-97`). Clamped below at 0.1 Pa.
    """
    e_sat = saturation_vapor_pressure(T)
    e_air = q_air * pres / (c.eps + (1.0 - c.eps) * q_air)
    return jnp.maximum(e_sat - e_air, 0.1)


def vapor_pressure_to_specific_humidity(e, p, eps=0.622):
    """q = eps * e / p (reference `physics_utils.jl:40`)."""
    return eps * e / p


def partial_pressure_O2(pres):
    """Partial pressure of O2 from surface pressure (reference `physics_utils.jl:18-22`)."""
    return 0.209 * pres


def partial_pressure_CO2(pres, conc_co2_ppm):
    """Partial pressure of CO2 from surface pressure and ppm concentration
    (reference `physics_utils.jl:29-33`)."""
    return conc_co2_ppm * 1.0e-6 * pres
