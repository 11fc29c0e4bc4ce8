"""Named boundary-condition builders for soil models.

JAX equivalent of reference `src/models/soil/soil_model_bcs.jl`.
Each helper returns a BC dict mergeable with
:func:`~terrarium_tpu.ops.bcs.merge_boundary_conditions`. Default values are
input-variable references (strings), matching the reference's `Variable`
placeholder BCs that read an input field each step.
"""
from __future__ import annotations

from ..ops.bcs import Dirichlet, Flux, Neumann, NoFlux

__all__ = [
    "GroundHeatFlux",
    "GeothermalHeatFlux",
    "PrescribedSurfaceTemperature",
    "PrescribedBottomTemperature",
    "InfiltrationFlux",
    "ImpermeableBoundary",
    "FreeDrainage",
]


def GroundHeatFlux(value="ground_heat_flux"):
    """Flux BC on top `internal_energy` (reference `soil_model_bcs.jl:6`)."""
    return {"internal_energy": {"top": Flux(value)}}


def GeothermalHeatFlux(value="geothermal_heat_flux"):
    """Flux BC on bottom `internal_energy` (reference `soil_model_bcs.jl:12`)."""
    return {"internal_energy": {"bottom": Flux(value)}}


def PrescribedSurfaceTemperature(value):
    """Value BC on top `temperature` [degC] (reference `soil_model_bcs.jl:17`).
    ``value`` may be a scalar, a ``(cells,)`` array, an input-variable name,
    or a callable ``f(t)``."""
    return {"temperature": {"top": Dirichlet(value)}}


def PrescribedBottomTemperature(value):
    """Value BC on bottom `temperature` [degC] (reference `soil_model_bcs.jl:22`)."""
    return {"temperature": {"bottom": Dirichlet(value)}}


def InfiltrationFlux(value="infiltration"):
    """Flux BC on top `saturation_water_ice` (reference `soil_model_bcs.jl:29`)."""
    return {"saturation_water_ice": {"top": Flux(value)}}


def ImpermeableBoundary():
    """No-flux bottom BC for water (reference `soil_model_bcs.jl:34`)."""
    return {"saturation_water_ice": {"bottom": NoFlux()}}


def FreeDrainage():
    """Zero pressure-head gradient at the bottom (reference `soil_model_bcs.jl:40`)."""
    return {"pressure_head": {"bottom": Neumann(0.0)}}
