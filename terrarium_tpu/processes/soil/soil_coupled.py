"""Coupled soil energy-water-carbon container.

JAX equivalent of reference `src/processes/soil/soil_coupled.jl`.
Sequences the sub-process hooks in the reference's documented order:
auxiliary/tendencies hydrology -> biogeochem -> energy; initialization
hydrology -> biogeochem -> energy; closures hydrology then energy.
"""
from __future__ import annotations

import dataclasses

from .energy import SoilEnergyBalance
from .hydrology import SoilHydrology
from .stratigraphy import ConstantSoilCarbonDensity, HomogeneousStratigraphy
from ...variables import variables_of

__all__ = ["SoilEnergyWaterCarbon"]


@dataclasses.dataclass(frozen=True)
class SoilEnergyWaterCarbon:
    """{stratigraphy, energy, hydrology, biogeochem} coupling
    (reference `soil_coupled.jl:7-35`)."""

    strat: HomogeneousStratigraphy = HomogeneousStratigraphy()
    energy: SoilEnergyBalance = SoilEnergyBalance()
    hydrology: SoilHydrology = SoilHydrology()
    biogeochem: ConstantSoilCarbonDensity = ConstantSoilCarbonDensity()

    def variables(self):
        return (variables_of(self.strat) + variables_of(self.energy)
                + variables_of(self.hydrology) + variables_of(self.biogeochem))

    def initialize(self, state, grid, ctx):
        """hydrology -> biogeochem -> energy (reference `soil_coupled.jl:45-54`)."""
        c = ctx.constants
        state = self.hydrology.initialize(state, grid, self, c, ctx)
        state = self.energy.initialize(state, grid, self, c, ctx)
        return state

    def compute_auxiliary(self, state, grid, ctx):
        """reference `soil_coupled.jl:62-74`."""
        c = ctx.constants
        state = self.hydrology.compute_auxiliary(state, grid, self, c, ctx)
        state = self.energy.compute_auxiliary(state, grid, self, c, ctx)
        return state

    def compute_tendencies(self, state, grid, ctx):
        """reference `soil_coupled.jl:82-94`."""
        c = ctx.constants
        state = self.hydrology.compute_tendencies(state, grid, self, c, ctx)
        state = self.energy.compute_tendencies(state, grid, self, c, ctx)
        return state

    def closure(self, state, grid, ctx):
        """hydrology then energy (reference `soil_coupled.jl:102-112`)."""
        c = ctx.constants
        state = self.hydrology.closure(state, grid, self, c, ctx)
        state = self.energy.closure(state, grid, self, c, ctx)
        return state

    def implicit_terms(self, state, grid, ctx):
        """Collect implicit-diffusion Jacobian terms from sub-processes
        (energy heat conduction + Richards flow), for the ImplicitEuler
        stepper (new capability; reference has only explicit steppers)."""
        c = ctx.constants
        terms = []
        t = self.hydrology.implicit_diffusion_terms(state, grid, self, c, ctx)
        if t is not None:
            terms.append(t)
        terms.append(self.energy.implicit_diffusion_terms(state, grid, self, c, ctx))
        return tuple(terms)

    def invclosure(self, state, grid, ctx):
        """hydrology then energy (reference `soil_coupled.jl:120-130`)."""
        c = ctx.constants
        state = self.hydrology.invclosure(state, grid, self, c, ctx)
        state = self.energy.invclosure(state, grid, self, c, ctx)
        return state
