"""Soil stratigraphy: texture, porosity, solid matrix, elementary soil volume.

JAX equivalent of reference `src/processes/soil/stratigraphy/`
(`soil_texture.jl`, `soil_porosity.jl`, `soil_volume.jl`,
`homogeneous_strat.jl`). The reference's per-point `SoilVolume` struct becomes
a NamedTuple of (broadcastable) arrays; all formulas operate elementwise over
``(Nz, cells)`` blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax.numpy as jnp

__all__ = [
    "SoilTexture",
    "ConstantSoilPorosity",
    "SoilPorositySURFEX",
    "ConstantSoilCarbonDensity",
    "SoilVolume",
    "volumetric_fractions",
    "HomogeneousStratigraphy",
]


# ---------------------------------------------------------------------------
# Texture
# ---------------------------------------------------------------------------
_TEXTURE_PRESETS = {
    # presets from reference `soil_texture.jl:43-54`
    "sand": (1.0, 0.0, 0.0),
    "silt": (0.0, 1.0, 0.0),
    "clay": (0.0, 0.0, 1.0),
    "sandyclay": (0.5, 0.0, 0.5),
    "siltyclay": (0.0, 0.5, 0.5),
    "loam": (0.4, 0.4, 0.2),
    "sandyloam": (0.8, 0.1, 0.1),
    "siltyloam": (0.1, 0.8, 0.1),
    "clayloam": (0.3, 0.3, 0.4),
}


@dataclasses.dataclass(frozen=True)
class SoilTexture:
    """Sand/silt/clay mass fractions summing to 1 (reference `soil_texture.jl:6-28`)."""

    sand: float = 1.0
    clay: float = 0.0
    silt: float = None  # default: 1 - sand - clay

    def __post_init__(self):
        if self.silt is None:
            object.__setattr__(self, "silt", 1.0 - self.sand - self.clay)
        for f in (self.sand, self.silt, self.clay):
            if isinstance(f, float) and not (0.0 <= f <= 1.0):
                raise ValueError("texture fractions must be in [0, 1]")
        if all(isinstance(f, float) for f in (self.sand, self.silt, self.clay)):
            if abs(self.sand + self.silt + self.clay - 1.0) > 1e-8:
                raise ValueError("sand, silt, and clay fractions must sum to unity")

    @staticmethod
    def preset(name: str) -> "SoilTexture":
        sand, silt, clay = _TEXTURE_PRESETS[name]
        return SoilTexture(sand=sand, clay=clay, silt=silt)


# ---------------------------------------------------------------------------
# Porosity parameterizations
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConstantSoilPorosity:
    """Constant mineral/organic porosity (reference `soil_porosity.jl:7-20`)."""

    mineral_porosity: float = 0.49
    organic_porosity: float = 0.9

    def mineral(self, texture: SoilTexture):
        return self.mineral_porosity

    def organic(self, texture: SoilTexture):
        return self.organic_porosity


@dataclasses.dataclass(frozen=True)
class SoilPorositySURFEX:
    """SURFEX mineral porosity ``por = 0.49 - 0.11 * sand``
    (Noilhan & Mahfouf 1996 Eq. 27; reference `soil_porosity.jl:29-50`)."""

    porosity_default: float = 0.49
    porosity_sand_coef: float = -0.11
    porosity_organic: float = 0.9

    def mineral(self, texture: SoilTexture):
        return self.porosity_default + self.porosity_sand_coef * texture.sand

    def organic(self, texture: SoilTexture):
        return self.porosity_organic


# ---------------------------------------------------------------------------
# Biogeochemistry (constant SOC)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConstantSoilCarbonDensity:
    """Constant soil-organic-carbon density
    (reference `biogeochem/constant_soil_carbon.jl:10-34`)."""

    rho_soc: float = 0.0  # SOC density [kg/m^3]
    rho_org: float = 1300.0  # pure organic matter density [kg/m^3]

    def variables(self):
        return ()

    def density_soc(self, state, grid):
        return self.rho_soc

    def density_pure_soc(self):
        return self.rho_org

    def initialize(self, state, grid, ctx):
        return state

    def compute_auxiliary(self, state, grid, ctx):
        return state

    def compute_tendencies(self, state, grid, ctx):
        return state


# ---------------------------------------------------------------------------
# Soil volume
# ---------------------------------------------------------------------------
class SoilVolume(NamedTuple):
    """Material composition of an elementary soil volume
    (reference `soil_volume.jl:11-31`). Fields are scalars or broadcastable
    arrays; ``organic`` is the organic fraction of the solid matrix and
    ``texture`` the mineral texture (MineralOrganic solid,
    `soil_volume.jl:77-88`)."""

    porosity: Any = 0.5
    saturation: Any = 1.0
    liquid: Any = 1.0
    organic: Any = 0.0
    texture: SoilTexture = SoilTexture()


def volumetric_fractions(soil: SoilVolume):
    """Volumetric fractions (water, ice, air, organic, mineral) of a soil
    volume (reference `soil_volume.jl:52-67`, `soil_volume.jl:103-107`)."""
    por, sat, liq = soil.porosity, soil.saturation, soil.liquid
    water_ice = sat * por
    water = water_ice * liq
    ice = water_ice * (1.0 - liq)
    air = (1.0 - sat) * por
    solid = 1.0 - por
    organic = solid * soil.organic
    mineral = solid * (1.0 - soil.organic)
    return dict(water=water, ice=ice, air=air, organic=organic, mineral=mineral)


# ---------------------------------------------------------------------------
# Stratigraphy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HomogeneousStratigraphy:
    """Well-mixed homogeneous stratigraphy (reference `homogeneous_strat.jl`).

    Supplies porosity / organic fraction / solid matrix given the
    biogeochemistry's SOC density.
    """

    texture: SoilTexture = SoilTexture()
    porosity: Any = ConstantSoilPorosity()

    def variables(self):
        return ()

    def organic_fraction(self, bgc: ConstantSoilCarbonDensity, state, grid):
        """organic = rho_soc / ((1 - por_o) * rho_org)
        (reference `homogeneous_strat.jl:34-44`)."""
        rho_soc = bgc.density_soc(state, grid)
        rho_org = bgc.density_pure_soc()
        por_o = self.porosity.organic(self.texture)
        return rho_soc / ((1.0 - por_o) * rho_org)

    def bulk_porosity(self, bgc, state, grid):
        """(1 - organic) * por_mineral + organic * por_organic
        (reference `homogeneous_strat.jl:51-61`)."""
        organic = self.organic_fraction(bgc, state, grid)
        por_m = self.porosity.mineral(self.texture)
        por_o = self.porosity.organic(self.texture)
        return (1.0 - organic) * por_m + organic * por_o

    def soil_volume(self, bgc, state, grid, saturation=None, liquid=None) -> SoilVolume:
        """Assemble the :class:`SoilVolume` from current state
        (reference `homogeneous_strat.jl:69-98`)."""
        sat = saturation if saturation is not None else state.saturation_water_ice
        liq = liquid if liquid is not None else state.liquid_water_fraction
        por = self.bulk_porosity(bgc, state, grid)
        organic = self.organic_fraction(bgc, state, grid)
        return SoilVolume(porosity=por, saturation=sat, liquid=liq,
                          organic=organic, texture=self.texture)

    def initialize(self, state, grid, ctx):
        return state

    def compute_auxiliary(self, state, grid, ctx):
        return state

    def compute_tendencies(self, state, grid, ctx):
        return state
