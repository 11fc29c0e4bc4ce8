"""SoilModel: 1D column model of soil energy/water/carbon transport.

JAX equivalent of reference `src/models/soil/soil_model.jl`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from .initializers import DefaultInitializer
from ..constants import PhysicalConstants
from ..processes.base import Context
from ..processes.soil.soil_coupled import SoilEnergyWaterCarbon
from ..variables import Variables, variables_of

__all__ = ["SoilModel"]


@dataclasses.dataclass(frozen=True)
class SoilModel:
    """Soil column model (reference `soil_model.jl:9-27`)."""

    grid: Any
    soil: SoilEnergyWaterCarbon = SoilEnergyWaterCarbon()
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()

    def variables(self) -> tuple:
        return variables_of(self.soil)

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        return Context(constants=self.constants, bcs=bcs)

    # -- model interface (reference `soil_model.jl:31-59`) ----------------
    def initialize(self, state, ctx):
        state = self.initializer.initialize(state, self)
        return self.soil.initialize(state, self.grid, ctx)

    def compute_auxiliary(self, state, ctx):
        return self.soil.compute_auxiliary(state, self.grid, ctx)

    def compute_tendencies(self, state, ctx):
        return self.soil.compute_tendencies(state, self.grid, ctx)

    def closure(self, state, ctx):
        return self.soil.closure(state, self.grid, ctx)

    def invclosure(self, state, ctx):
        return self.soil.invclosure(state, self.grid, ctx)

    def implicit_terms(self, state, ctx):
        return self.soil.implicit_terms(state, self.grid, ctx)

    def timestep(self, state, ctx, dt):
        """Post-step hook (clipping etc.); default no-op
        (reference `abstract_timestepper.jl:47`)."""
        return state
