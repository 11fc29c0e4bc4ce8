"""Standalone vegetation and surface-energy models.

JAX equivalents of reference `src/models/vegetation/vegetation_model.jl`
and `src/models/surface/surface_energy_model.jl`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .initializers import DefaultInitializer
from ..constants import PhysicalConstants
from ..processes.base import Context
from ..processes.atmosphere import PrescribedAtmosphere
from ..processes.surface_energy.seb import SurfaceEnergyBalance
from ..processes.vegetation.vegetation import VegetationCarbon
from ..variables import Variables, variables_of

__all__ = ["VegetationModel", "SurfaceEnergyModel"]


@dataclasses.dataclass(frozen=True)
class VegetationModel:
    """Single-PFT vegetation model with prescribed atmosphere
    (reference `vegetation_model.jl:11-50`)."""

    grid: Any
    atmosphere: PrescribedAtmosphere = PrescribedAtmosphere()
    # standalone: no soil, so PAW/roots are disabled and the
    # soil_moisture_limiting_factor input keeps its default of 1
    # (reference `plant_available_water.jl:64-66`)
    vegetation: VegetationCarbon = dataclasses.field(
        default_factory=lambda: VegetationCarbon(plant_available_water=None,
                                                 root_distribution=None))
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()

    def variables(self):
        return variables_of(self.atmosphere) + variables_of(self.vegetation)

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        return Context(constants=self.constants, bcs=bcs)

    def initialize(self, state, ctx):
        state = self.initializer.initialize(state, self)
        state = self.vegetation.initialize(state, self.grid, self.constants,
                                           self.atmosphere, ctx)
        return self.compute_auxiliary(state, ctx)

    def compute_auxiliary(self, state, ctx):
        # standalone: no soil -> soil moisture/temperature stress ignored
        return self.vegetation.compute_auxiliary(state, self.grid,
                                                 self.constants,
                                                 self.atmosphere, None, ctx)

    def compute_tendencies(self, state, ctx):
        return self.vegetation.compute_tendencies(state, self.grid,
                                                  self.constants, ctx)

    def closure(self, state, ctx):
        return state

    def invclosure(self, state, ctx):
        return state

    def timestep(self, state, ctx, dt):
        return state


@dataclasses.dataclass(frozen=True)
class SurfaceEnergyModel:
    """Standalone SEB + atmosphere, mainly for testing
    (reference `surface_energy_model.jl:10-53`)."""

    grid: Any
    atmosphere: PrescribedAtmosphere = PrescribedAtmosphere()
    surface_energy_balance: SurfaceEnergyBalance = SurfaceEnergyBalance()
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()

    def variables(self):
        return (variables_of(self.atmosphere)
                + variables_of(self.surface_energy_balance))

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        return Context(constants=self.constants, bcs=bcs)

    def initialize(self, state, ctx):
        state = self.initializer.initialize(state, self)
        return self.compute_auxiliary(state, ctx)

    def compute_auxiliary(self, state, ctx):
        return self.surface_energy_balance.compute_auxiliary(
            state, self.grid, self.constants, self.atmosphere, None, ctx)

    def compute_tendencies(self, state, ctx):
        return state

    def closure(self, state, ctx):
        return state

    def invclosure(self, state, ctx):
        return state

    def timestep(self, state, ctx, dt):
        return state
