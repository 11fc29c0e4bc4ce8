"""Soil hydraulic properties parameterizations.

JAX equivalent of reference
`src/processes/soil/hydrology/soil_hydraulic_properties.jl`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .stratigraphy import SoilTexture, SoilVolume, volumetric_fractions
from .swrc import BrooksCorey, VanGenuchten

__all__ = [
    "UnsatKLinear",
    "UnsatKVanGenuchten",
    "ConstantSoilHydraulics",
    "SoilHydraulicsSURFEX",
]


@dataclasses.dataclass(frozen=True)
class UnsatKLinear:
    """K = K_sat * theta_w / theta_sat (reference
    `soil_hydraulic_properties.jl:166-181`)."""

    def __call__(self, hydraulics, soil: SoilVolume):
        fracs = volumetric_fractions(soil)
        theta_w = fracs["water"]
        theta_sat = fracs["water"] + fracs["ice"] + fracs["air"]
        K_sat = hydraulics.saturated_hydraulic_conductivity(soil.texture)
        return K_sat * theta_w / theta_sat


@dataclasses.dataclass(frozen=True)
class UnsatKVanGenuchten:
    """Mualem-van Genuchten unsaturated conductivity with ice impedance
    ``10^(-Omega*(1 - liq))`` (van Genuchten 1980; Westermann et al. 2023;
    reference `soil_hydraulic_properties.jl:196-221`).

    The reference guards illegal states with complex arithmetic + ``abs``; in
    JAX we clamp the effective saturation to [0, 1] instead, which agrees for
    all legal states.
    """

    impedance: float = 7.0

    def __call__(self, hydraulics, soil: SoilVolume):
        n = hydraulics.swrc.n
        fracs = volumetric_fractions(soil)
        theta_w = fracs["water"]
        theta_sat = soil.porosity
        f = soil.liquid
        I_ice = 10.0 ** (-self.impedance * (1.0 - f))
        K_sat = hydraulics.saturated_hydraulic_conductivity(soil.texture)
        se = jnp.clip(theta_w / jnp.maximum(theta_sat, 1e-12), 0.0, 1.0)
        # NOTE: exponents n/(n+1) and (n-1)/n exactly as the reference
        # (`soil_hydraulic_properties.jl:218`). The unsaturated branch is
        # evaluated on se clamped strictly below 1 and the saturated case
        # selected exactly: dK/dse -> inf at se = 1 (Mualem-vG), which would
        # otherwise propagate NaN through reverse-mode AD (the masked-where
        # subgradient here is 0, matching the reference's Enzyme tests that
        # only probe unsaturated states).
        # dtype-aware eps: with the f32-blind 1e-9 literal, 1 - se**(n/(n+1))
        # evaluated to exactly 0 for saturated f32 cells, whose sqrt VJP is
        # Inf -> NaN gradients under scanned rollouts (see swrc.one_minus_eps)
        from .swrc import one_minus_eps
        se_safe = jnp.minimum(se, one_minus_eps(theta_w, 1e-9))
        from ...ops.fastpow import fast_pow

        # the LOW end needs the same double-where treatment: fully-frozen
        # cells have liquid water theta_w = 0, i.e. se = 0, where d(cbrt)/dse
        # and d(sqrt)/dse are Inf — scanned rollouts then produce 0*Inf NaN
        # cotangents (round-3 fix). K is returned as an exact 0 there (the
        # primal value of the unclamped expression to well below f32
        # resolution: K_unsat(eps) ~ eps^(11/6) K_sat).
        import numpy as np
        eps_lo = float(np.finfo(jnp.result_type(theta_w, 1.0)).eps)
        frozen = se <= eps_lo
        se_safe = jnp.where(frozen, eps_lo, se_safe)
        K_unsat = K_sat * I_ice * jnp.sqrt(se_safe) * (
            1.0 - fast_pow(1.0 - fast_pow(se_safe, n / (n + 1.0)),
                           (n - 1.0) / n)) ** 2
        K_unsat = jnp.where(frozen, 0.0, K_unsat)
        return jnp.where(se >= 1.0, K_sat * I_ice, K_unsat)


@dataclasses.dataclass(frozen=True)
class ConstantSoilHydraulics:
    """Prescribed hydraulic properties (reference
    `soil_hydraulic_properties.jl:66-97`)."""

    swrc: Any = dataclasses.field(default_factory=BrooksCorey)
    unsat_hydraulic_cond: Any = dataclasses.field(default_factory=UnsatKLinear)
    sat_hydraulic_cond: float = 1.0e-5
    field_capacity_value: float = 0.25
    wilting_point_value: float = 0.05

    def saturated_hydraulic_conductivity(self, texture=None):
        return self.sat_hydraulic_cond

    def field_capacity(self, texture=None):
        return self.field_capacity_value

    def wilting_point(self, texture=None):
        return self.wilting_point_value

    def hydraulic_conductivity(self, soil: SoilVolume):
        return self.unsat_hydraulic_cond(self, soil)


@dataclasses.dataclass(frozen=True)
class SoilHydraulicsSURFEX:
    """SURFEX (Noilhan & Mahfouf 1996, Eq. 28-29) field capacity / wilting
    point from clay content (reference `soil_hydraulic_properties.jl:112-156`):

    wp = 37.13e-3 * sqrt(clay * 100); fc = 89e-3 * (clay * 100)^0.35
    """

    swrc: Any = dataclasses.field(default_factory=BrooksCorey)
    unsat_hydraulic_cond: Any = dataclasses.field(default_factory=UnsatKLinear)
    sat_hydraulic_cond: float = 1.0e-5
    wilting_point_coef: float = 37.13e-3
    field_capacity_coef: float = 89.0e-3
    field_capacity_exp: float = 0.35

    def saturated_hydraulic_conductivity(self, texture=None):
        return self.sat_hydraulic_cond

    def wilting_point(self, texture: SoilTexture):
        # math.sqrt keeps the scalar weakly typed: jnp.sqrt of a python
        # float is a STRONG f64 array under x64 and would promote every
        # f32 field downstream (PAW -> beta -> ET -> saturation)
        import math

        clay100 = texture.clay * 100.0
        if isinstance(clay100, (int, float)):
            return self.wilting_point_coef * math.sqrt(clay100)
        return self.wilting_point_coef * jnp.sqrt(clay100)

    def field_capacity(self, texture: SoilTexture):
        return self.field_capacity_coef * (texture.clay * 100.0) ** self.field_capacity_exp

    def hydraulic_conductivity(self, soil: SoilVolume):
        return self.unsat_hydraulic_cond(self, soil)
