"""Soil energy balance: two-phase heat conduction + energy-temperature closure.

JAX equivalent of reference
`src/processes/soil/energy/soil_energy.jl` and
`soil_energy_closures.jl`. The per-point kernel stack (kernel -> kernel
function -> primitive) collapses into vectorised ``(Nz, cells)`` array
expressions which XLA fuses into elementwise passes; this is the hot loop of
the framework (SURVEY §3.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .stratigraphy import SoilVolume
from .thermal import FreeWater, SoilThermalProperties
from ...ops.bcs import get_bc
from ...ops.vertical_ops import div_faces, ghosts, grad_faces, interp_faces_mid
from ...variables import XY, XYZ, auxiliary, prognostic

__all__ = ["SoilEnergyTemperatureClosure", "SoilEnergyBalance"]


@dataclasses.dataclass(frozen=True)
class SoilEnergyTemperatureClosure:
    """Constitutive relation U(T) = T*C(T) - L*theta_wi*(1 - liq)
    (reference `soil_energy_closures.jl:1-17`). The closure maps conserved
    internal energy -> temperature; the inverse is used at initialization.
    """

    def variables(self):
        # reference `soil_energy_closures.jl:22-25`
        return (
            auxiliary("temperature", XYZ(), units="degC",
                      desc="Temperature of the soil volume"),
            auxiliary("liquid_water_fraction", XYZ(), domain=(0.0, 1.0),
                      desc="Fraction of unfrozen water in the pore space"),
        )

    def closure(self, state, grid, energy, soil, constants):
        """energy -> temperature (reference `energy_to_temperature!`,
        `soil_energy_closures.jl:99-126`)."""
        U = state.internal_energy
        L = constants.rho_w * constants.L_sl
        strat, bgc, hydrology = soil.strat, soil.biogeochem, soil.hydrology
        por = strat.bulk_porosity(bgc, state, grid)
        sat = state.saturation_water_ice
        L_theta = L * sat * por
        fc = energy.thermal_properties.freezecurve
        liq = fc.liquid_water_fraction(U, L_theta)
        vol = strat.soil_volume(bgc, state, grid, saturation=sat, liquid=liq)
        C = energy.thermal_properties.heat_capacity(vol)
        T = fc.temperature(U, L_theta, C)
        return state.update(
            temperature=T,
            liquid_water_fraction=liq,
            ground_temperature=jnp.reshape(T[-1:], (-1,)),
        )

    def invclosure(self, state, grid, energy, soil, constants):
        """temperature -> energy (reference `temperature_to_energy!`,
        `soil_energy_closures.jl:64-97`). For the free-water curve the
        liquid fraction is indeterminate at T == 0, so liq = 1 for T >= 0 and
        0 otherwise — initialization only."""
        T = state.temperature
        L = constants.rho_w * constants.L_sl
        strat, bgc = soil.strat, soil.biogeochem
        por = strat.bulk_porosity(bgc, state, grid)
        sat = state.saturation_water_ice
        liq = jnp.where(T >= 0.0, jnp.ones_like(T), jnp.zeros_like(T))
        vol = strat.soil_volume(bgc, state, grid, saturation=sat, liquid=liq)
        C = energy.thermal_properties.heat_capacity(vol)
        U = T * C - L * sat * por * (1.0 - liq)
        return state.update(
            internal_energy=U,
            liquid_water_fraction=liq,
            ground_temperature=jnp.reshape(T[-1:], (-1,)),
        )


@dataclasses.dataclass(frozen=True)
class ExplicitTwoPhaseHeatConduction:
    """Marker for the explicit two-phase heat conduction operator
    (reference `soil_energy.jl:11`)."""


@dataclasses.dataclass(frozen=True)
class SoilEnergyBalance:
    """Soil energy balance with freeze/thaw (reference `soil_energy.jl:23-44`)."""

    operator: Any = ExplicitTwoPhaseHeatConduction()
    closure_rel: SoilEnergyTemperatureClosure = SoilEnergyTemperatureClosure()
    thermal_properties: SoilThermalProperties = SoilThermalProperties()

    def variables(self):
        # reference `soil_energy.jl:46-49`; ground_temperature is a top-layer
        # view in the reference (`soil_energy.jl:52-57`) — here a real array
        # refreshed by the closure (pure-functional equivalent of the view).
        return (
            prognostic("internal_energy", XYZ(), units="J/m^3",
                       closure=self.closure_rel,
                       desc="Internal energy incl. latent and sensible components"),
            auxiliary("ground_temperature", XY(),
                      ctor=lambda grid, arrays: jnp.squeeze(
                          arrays["temperature"][-1:], axis=0),
                      units="degC", desc="Temperature of the uppermost soil cell"),
        )

    # -- interface --------------------------------------------------------
    def initialize(self, state, grid, soil, constants, ctx):
        """Evaluate the inverse closure T -> U (reference `soil_energy.jl:64-77`);
        assumes temperature has already been initialized."""
        return self.closure_rel.invclosure(state, grid, self, soil, constants)

    def compute_auxiliary(self, state, grid, soil, constants, ctx):
        return state  # reference `soil_energy.jl:80`

    def compute_tendencies(self, state, grid, soil, constants, ctx):
        """dU/dt += -d/dz(q), q = -kappa * dT/dz with kappa arithmetically
        interpolated to faces (reference `soil_energy.jl:102-149`)."""
        T = state.temperature
        kappa = self.thermal_conductivity(state, grid, soil)
        # Temperature ghost cells from Value/Gradient BCs (halo-fill semantics)
        bc_bot = get_bc(ctx.bcs, "temperature", "bottom")
        bc_top = get_bc(ctx.bcs, "temperature", "top")
        g_bot, g_top = ghosts(T, bc_bot, bc_top, state, grid.dz_faces)
        # kappa is independent of T and its closure-var halos are
        # zero-gradient, so the boundary-face kappa equals the boundary cell's
        kappa_f = interp_faces_mid(kappa)
        dTdz = grad_faces(T, grid.dz_faces, g_bot, g_top)
        q = -kappa_f * dTdz
        dUdt = -div_faces(q, grid.dz)
        return state.add_tendencies(internal_energy=dUdt)

    def thermal_conductivity(self, state, grid, soil):
        """Bulk kappa at cell centers (reference `soil_energy.jl:128-137`)."""
        vol = soil.strat.soil_volume(soil.biogeochem, state, grid)
        return self.thermal_properties.thermal_conductivity(vol)

    def implicit_diffusion_terms(self, state, grid, soil, constants, ctx):
        """Jacobian ingredients for the implicit heat solve: face kappa and
        D = dT/dU, which is 1/C outside the phase-change plateau and 0 inside
        it (the exact subgradient structure of the free-water closure)."""
        from ...timesteppers.implicit import ImplicitDiffusionTerms

        kappa = self.thermal_conductivity(state, grid, soil)
        kappa = jnp.broadcast_to(kappa, (grid.nz, grid.cells))
        kappa_f = interp_faces_mid(kappa)
        U = state.internal_energy
        L = constants.rho_w * constants.L_sl
        por = soil.strat.bulk_porosity(soil.biogeochem, state, grid)
        sat = state.saturation_water_ice
        L_theta = L * sat * por
        vol = soil.strat.soil_volume(soil.biogeochem, state, grid)
        C = self.thermal_properties.heat_capacity(vol)
        in_plateau = (U >= -L_theta) & (U < 0.0)
        D = jnp.where(in_plateau, 0.0, 1.0 / C)
        D = jnp.broadcast_to(D, (grid.nz, grid.cells))
        return ImplicitDiffusionTerms(
            var="internal_energy", K_faces=kappa_f, D=D,
            scale=jnp.ones((), dtype=grid.nf), phi_var="temperature")

    def closure(self, state, grid, soil, constants, ctx):
        return self.closure_rel.closure(state, grid, self, soil, constants)

    def invclosure(self, state, grid, soil, constants, ctx):
        return self.closure_rel.invclosure(state, grid, self, soil, constants)
