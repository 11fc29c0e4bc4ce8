"""Soil thermal properties and freeze characteristic.

JAX equivalent of reference
`src/processes/soil/energy/soil_thermal_properties.jl` and the `FreeWater`
freeze curve from FreezeCurves.jl used by the reference
(`soil_energy_closures.jl:131-159`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .stratigraphy import SoilVolume, volumetric_fractions
from ...utils.utils import safediv

__all__ = [
    "SoilThermalConductivities",
    "SoilHeatCapacities",
    "InverseQuadratic",
    "SoilThermalProperties",
    "FreeWater",
]


@dataclasses.dataclass(frozen=True)
class SoilThermalConductivities:
    """Constituent thermal conductivities [W/m/K]
    (reference `soil_thermal_properties.jl:14-25`, Hillel 1982)."""

    water: float = 0.57
    ice: float = 2.2
    air: float = 0.025
    mineral: float = 3.8
    organic: float = 0.25


@dataclasses.dataclass(frozen=True)
class SoilHeatCapacities:
    """Constituent volumetric heat capacities [J/m^3/K]
    (reference `soil_thermal_properties.jl:35-46`)."""

    water: float = 4.2e6
    ice: float = 1.9e6
    air: float = 0.00125e6
    mineral: float = 2.0e6
    organic: float = 2.5e6


@dataclasses.dataclass(frozen=True)
class InverseQuadratic:
    """Inverse-quadratic ("quadratic parallel") bulk conductivity weighting
    ``k = (sum_i theta_i sqrt(k_i))^2`` (Cosenza et al. 2003; reference
    `soil_thermal_properties.jl:110-123`)."""

    def __call__(self, ks: dict, fracs: dict):
        acc = 0.0
        for name, k in ks.items():
            acc = acc + jnp.sqrt(k) * fracs[name]
        return acc**2


@dataclasses.dataclass(frozen=True)
class FreeWater:
    """Free-water freezing characteristic (all phase change at 0 degC).

    Mirrors FreezeCurves.jl `FreeWater` as used by the reference energy
    closure (`soil_energy_closures.jl:131-159`).
    """

    def liquid_water_fraction(self, U, L_theta):
        """Unfrozen fraction from energy ``U`` and latent heat content
        ``L_theta = L * sat * por`` (reference `soil_energy_closures.jl:131-140`):
        U >= 0 -> 1; -L_theta <= U < 0 -> 1 - U / (-L_theta); else 0.

        The reference relies on Julia's strong-zero Bool product
        (``false * Inf == 0``); JAX follows IEEE (``0 * Inf == NaN``), so the
        masking uses ``jnp.where`` selections instead — same values on every
        branch."""
        phase = jnp.where(U >= -L_theta, 1.0 - safediv(U, -L_theta), 0.0)
        return jnp.where(U >= 0.0, 1.0, phase)

    def temperature(self, U, L_theta, C):
        """Inverse enthalpy (reference `soil_energy_closures.jl:146-159`):
        U < -L_theta -> (U + L_theta)/C; U >= 0 -> U/C; else 0 (phase plateau).

        The piecewise structure also fixes the subgradients dT/dU = 1/C or 0
        required by the differentiability tests
        (`test/differentiability/soil_energy_diff.jl:28-66`)."""
        frozen = (U + L_theta) / C
        thawed = U / C
        return jnp.where(U < -L_theta, frozen, jnp.where(U >= 0.0, thawed, 0.0))


@dataclasses.dataclass(frozen=True)
class SoilThermalProperties:
    """Bundle of constituent properties + bulk weighting + freeze curve
    (reference `soil_thermal_properties.jl:58-78`)."""

    conductivities: SoilThermalConductivities = SoilThermalConductivities()
    bulk_conductivity: Any = InverseQuadratic()
    heat_capacities: SoilHeatCapacities = SoilHeatCapacities()
    freezecurve: Any = FreeWater()

    def thermal_conductivity(self, soil: SoilVolume):
        """Bulk thermal conductivity (reference `soil_thermal_properties.jl:90-95`)."""
        fracs = volumetric_fractions(soil)
        ks = dataclasses.asdict(self.conductivities)
        return self.bulk_conductivity(ks, fracs)

    def heat_capacity(self, soil: SoilVolume):
        """Bulk volumetric heat capacity = linear mixture
        (reference `soil_thermal_properties.jl:102-107`)."""
        fracs = volumetric_fractions(soil)
        cs = dataclasses.asdict(self.heat_capacities)
        acc = 0.0
        for name, c in cs.items():
            acc = acc + c * fracs[name]
        return acc
