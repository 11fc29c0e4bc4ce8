"""LandModel: fully-coupled land surface model.

JAX equivalent of reference `src/models/coupled/land_model.jl`:
atmosphere + soil + surface energy balance + surface hydrology (+ optional
vegetation). The surface <-> subsurface flux coupling replicates
`land_model.jl:46-66`: the SEB's `ground_heat_flux` is installed as the top
Flux BC on `internal_energy`, and the runoff scheme's `infiltration` (negated
— fluxes are positive up) as the top Flux BC on `saturation_water_ice`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .boundary_conditions import GroundHeatFlux, InfiltrationFlux
from .initializers import DefaultInitializer
from ..constants import PhysicalConstants
from ..ops.bcs import Flux, InputRef, merge_boundary_conditions
from ..processes.base import Context
from ..processes.atmosphere import PrescribedAtmosphere
from ..processes.soil.hydrology import RichardsEq, SoilHydrology
from ..processes.soil.soil_coupled import SoilEnergyWaterCarbon
from ..processes.surface_energy.seb import SurfaceEnergyBalance
from ..processes.surface_hydrology.surface_hydrology import SurfaceHydrology
from ..variables import Variables, variables_of

__all__ = ["LandModel"]


def default_soil(vegetation) -> SoilEnergyWaterCarbon:
    """Richards flow switched on when vegetation is present
    (reference `land_model.jl:111-114`)."""
    if vegetation is None:
        return SoilEnergyWaterCarbon()
    return SoilEnergyWaterCarbon(
        hydrology=SoilHydrology(vertical_flow=RichardsEq()))


def default_surface_hydrology(vegetation) -> SurfaceHydrology:
    """Bare-ground schemes when vegetation is absent
    (reference `land_model.jl:119-125`)."""
    if vegetation is None:
        return SurfaceHydrology.bare_ground()
    return SurfaceHydrology()


@dataclasses.dataclass(frozen=True)
class _LandExtras:
    """Cross-process handles passed via Context.extras."""

    evapotranspiration: Any = None
    runoff: Any = None


@dataclasses.dataclass(frozen=True)
class LandModel:
    """Coupled land model (reference `land_model.jl:9-44`)."""

    grid: Any
    vegetation: Optional[Any] = None
    soil: Optional[SoilEnergyWaterCarbon] = None
    surface_energy_balance: SurfaceEnergyBalance = SurfaceEnergyBalance()
    surface_hydrology: Optional[SurfaceHydrology] = None
    atmosphere: PrescribedAtmosphere = PrescribedAtmosphere()
    constants: PhysicalConstants = PhysicalConstants()
    initializer: Any = DefaultInitializer()
    #: optional snowpack (extension beyond the reference, processes/snow.py)
    snow: Optional[Any] = None

    def __post_init__(self):
        if self.soil is None:
            object.__setattr__(self, "soil", default_soil(self.vegetation))
        if self.surface_hydrology is None:
            object.__setattr__(self, "surface_hydrology",
                               default_surface_hydrology(self.vegetation))
        if self.snow is not None:
            # conditional default (the reference's idiom,
            # `land_model.jl:111-125`): a snowpack with the default constant
            # albedo gets the snow-cover albedo feedback automatically.
            from ..processes.snow import SnowCoverAlbedo
            from ..processes.surface_energy.seb import ConstantAlbedo
            seb = self.surface_energy_balance
            if type(seb.albedo) is ConstantAlbedo:
                object.__setattr__(
                    self, "surface_energy_balance",
                    dataclasses.replace(
                        seb, albedo=SnowCoverAlbedo(base=seb.albedo)))

    def variables(self) -> tuple:
        out = variables_of(self.atmosphere) + variables_of(self.soil)
        if self.vegetation is not None:
            out += variables_of(self.vegetation)
        if self.snow is not None:
            out += variables_of(self.snow)
        out += variables_of(self.surface_hydrology)
        out += variables_of(self.surface_energy_balance)
        return out

    def collated_variables(self) -> Variables:
        return Variables.of(self)

    def make_context(self, bcs=None) -> Context:
        """Merge the user BCs with the surface <-> subsurface coupling BCs
        (reference `land_model.jl:46-66`): ground_heat_flux as the energy top
        BC; -infiltration as the water top BC."""
        coupling = merge_boundary_conditions(
            GroundHeatFlux("ground_heat_flux"),
            {"saturation_water_ice": {"top": Flux(InputRef("infiltration", -1.0))}},
        )
        bcs = merge_boundary_conditions(bcs or {}, coupling)
        extras = _LandExtras(
            evapotranspiration=self.surface_hydrology.evapotranspiration,
            runoff=self.surface_hydrology.surface_runoff)
        return Context(constants=self.constants, bcs=bcs, extras=extras)

    # -- model interface (reference `land_model.jl:68-108`) ---------------
    def initialize(self, state, ctx):
        state = self.initializer.initialize(state, self)
        if self.vegetation is not None:
            state = self.vegetation.initialize(state, self.grid, self.constants,
                                               self.atmosphere, ctx)
        state = self.soil.initialize(state, self.grid, ctx)
        # seed the SEB diagnostics so the first step's BC values are sane
        state = self.compute_auxiliary(state, ctx)
        return state

    def compute_auxiliary(self, state, ctx):
        """Order: atmosphere -> soil -> vegetation -> surface hydrology ->
        SEB (+ a second fused flux sweep), reference `land_model.jl:79-88`."""
        c, grid = self.constants, self.grid
        state = self.atmosphere.compute_auxiliary(state, grid, ctx)
        if self.snow is not None:
            # cover fraction + melt before the surface hydrology and SEB
            state = self.snow.compute_auxiliary(state, grid, self.atmosphere, ctx)
        state = self.soil.compute_auxiliary(state, grid, ctx)
        if self.vegetation is not None:
            state = self.vegetation.compute_auxiliary(state, grid, c,
                                                      self.atmosphere, self.soil, ctx)
        state = self.surface_hydrology.compute_auxiliary(
            state, grid, c, self.atmosphere, self.soil, self.vegetation, ctx)
        evtr = self.surface_hydrology.evapotranspiration
        state = self.surface_energy_balance.compute_auxiliary(
            state, grid, c, self.atmosphere, evtr, ctx)
        state = self.surface_energy_balance.compute_surface_energy_fluxes(
            state, grid, c, self.atmosphere, evtr)
        return state

    def compute_tendencies(self, state, ctx):
        """Order: surface hydrology -> soil -> vegetation
        (reference `land_model.jl:90-96`)."""
        grid = self.grid
        state = self.surface_hydrology.compute_tendencies(state, grid, ctx)
        state = self.soil.compute_tendencies(state, grid, ctx)
        if self.vegetation is not None:
            state = self.vegetation.compute_tendencies(state, grid,
                                                       self.constants, ctx)
        if self.snow is not None:
            state = self.snow.compute_tendencies(state, grid, self.atmosphere,
                                                 ctx)
        return state

    def closure(self, state, ctx):
        return self.soil.closure(state, self.grid, ctx)

    def invclosure(self, state, ctx):
        return self.soil.invclosure(state, self.grid, ctx)

    def implicit_terms(self, state, ctx):
        return self.soil.implicit_terms(state, self.grid, ctx)

    def timestep(self, state, ctx, dt):
        if self.snow is not None:
            state = self.snow.timestep(state, self.grid, self.atmosphere,
                                       ctx, dt)
        return state
