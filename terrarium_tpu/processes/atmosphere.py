"""Prescribed near-surface atmosphere.

JAX equivalent of reference `src/processes/atmosphere/`
(`prescribed_atmosphere.jl`, `aerodynamics.jl`): a bundle of input variables
(air temperature/pressure, windspeed, humidity, precipitation, radiation,
tracer gases) plus accessor/derived-quantity helpers. All accessors operate on
whole ``(cells,)`` arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp

from .base import Context
from ..constants import PhysicalConstants, compute_vpd, vapor_pressure_to_specific_humidity
from ..variables import XY, input as input_var

__all__ = [
    "SpecificHumidity",
    "RainSnow",
    "LongShortWaveRadiation",
    "ConstantAerodynamics",
    "TracerGas",
    "AmbientCO2",
    "PrescribedAtmosphere",
]


@dataclasses.dataclass(frozen=True)
class SpecificHumidity:
    """Specific humidity [kg/kg] given directly as input
    (reference `prescribed_atmosphere.jl:139-147`)."""

    def variables(self):
        return (input_var("specific_humidity", XY(), default=1.0e-3, units="kg/kg",
                          desc="Near-surface specific humidity"),)

    def specific_humidity(self, state):
        return state.inputs["specific_humidity"]


@dataclasses.dataclass(frozen=True)
class RainSnow:
    """Separate liquid/frozen precipitation inputs [m/s]
    (reference `prescribed_atmosphere.jl:185-196`)."""

    def variables(self):
        return (
            input_var("rainfall", XY(), units="m/s", desc="Liquid precipitation rate"),
            input_var("snowfall", XY(), units="m/s", desc="Frozen precipitation rate"),
        )


@dataclasses.dataclass(frozen=True)
class LongShortWaveRadiation:
    """Downwelling SW/LW radiation + daytime length inputs
    (reference `prescribed_atmosphere.jl:215-231`)."""

    def variables(self):
        return (
            input_var("surface_shortwave_down", XY(), default=300.0, units="W/m^2",
                      desc="Incoming (downwelling) shortwave solar radiation"),
            input_var("surface_longwave_down", XY(), default=50.0, units="W/m^2",
                      desc="Incoming (downwelling) longwave thermal radiation"),
            input_var("daytime_length", XY(), default=12.0, units="hr",
                      desc="Number of daytime hours"),
        )


@dataclasses.dataclass(frozen=True)
class ConstantAerodynamics:
    """Constant bulk drag coefficient (reference `aerodynamics.jl:6-18`);
    NOT Monin-Obukhov — see :class:`MoninObukhovAerodynamics` for the
    stability-iteration extension."""

    C_h: float = 1.2e-3

    def variables(self):
        return ()

    def drag_coefficient(self, state, atmos, constants):
        return self.C_h


@dataclasses.dataclass(frozen=True)
class MoninObukhovAerodynamics:
    """Monin-Obukhov similarity drag with a fixed-point stability iteration.

    **Extension beyond the reference** (which only has constant bulk drag,
    `aerodynamics.jl:6-18`; the BASELINE north star requests an MO iteration).
    Uses Businger-Dyer stability functions: unstable psi_m/psi_h with
    x = (1 - 16 zeta)^(1/4), stable psi = -5 zeta. A fixed ``iterations``
    count keeps the loop XLA-compilable.
    """

    z: float = 10.0  # measurement height [m]
    z0m: float = 0.01  # momentum roughness length [m]
    z0h: float = 0.001  # scalar roughness length [m]
    iterations: int = 4

    def variables(self):
        return ()

    def _psi(self, zeta):
        # Businger-Dyer
        zeta_u = jnp.minimum(zeta, 0.0)
        x = (1.0 - 16.0 * zeta_u) ** 0.25
        psi_m_u = (2.0 * jnp.log((1.0 + x) / 2.0) + jnp.log((1.0 + x**2) / 2.0)
                   - 2.0 * jnp.arctan(x) + jnp.pi / 2.0)
        psi_h_u = 2.0 * jnp.log((1.0 + x**2) / 2.0)
        zeta_s = jnp.maximum(zeta, 0.0)
        psi_s = -5.0 * jnp.clip(zeta_s, 0.0, 1.0)
        unstable = zeta < 0.0
        return (jnp.where(unstable, psi_m_u, psi_s),
                jnp.where(unstable, psi_h_u, psi_s))

    def drag_coefficient(self, state, atmos, constants):
        c = constants if constants is not None else PhysicalConstants()
        Ta = atmos.air_temperature(state)
        # surface temperature: skin temperature when defined, else air T
        Ts = state.skin_temperature if "skin_temperature" in state else Ta
        V = jnp.maximum(atmos.windspeed(state), 1.0e-6)
        Tbar = c.celsius_to_kelvin(0.5 * (Ta + Ts))
        dtheta = Ta - Ts
        ln_m = jnp.log(self.z / self.z0m)
        ln_h = jnp.log(self.z / self.z0h)
        kappa = c.kappa
        inv_L = jnp.zeros_like(V)
        for _ in range(self.iterations):
            zeta = jnp.clip(self.z * inv_L, -10.0, 1.0)
            psi_m, psi_h = self._psi(zeta)
            u_star = kappa * V / jnp.maximum(ln_m - psi_m, 0.1)
            th_star = kappa * dtheta / jnp.maximum(ln_h - psi_h, 0.1)
            inv_L = kappa * c.g * th_star / jnp.maximum(u_star**2 * Tbar, 1e-12)
        zeta = jnp.clip(self.z * inv_L, -10.0, 1.0)
        psi_m, psi_h = self._psi(zeta)
        Ch = kappa**2 / (jnp.maximum(ln_m - psi_m, 0.1)
                         * jnp.maximum(ln_h - psi_h, 0.1))
        return Ch


@dataclasses.dataclass(frozen=True)
class TracerGas:
    """Ambient tracer-gas concentration input [ppm]
    (reference `prescribed_atmosphere.jl:1-23`)."""

    name: str
    default: float = 0.0

    def variables(self):
        return (input_var(self.name, XY(), default=self.default, units="ppm",
                          desc=f"Ambient atmospheric {self.name} concentration"),)


def AmbientCO2(name: str = "CO2"):
    return TracerGas(name, default=380.0)


@dataclasses.dataclass(frozen=True)
class PrescribedAtmosphere:
    """Prescribed atmospheric conditions
    (reference `prescribed_atmosphere.jl:45-99`)."""

    altitude: float = 10.0
    min_windspeed: float = 0.01
    precip: RainSnow = RainSnow()
    radiation: LongShortWaveRadiation = LongShortWaveRadiation()
    humidity: SpecificHumidity = SpecificHumidity()
    aerodynamics: ConstantAerodynamics = ConstantAerodynamics()
    tracers: Tuple[TracerGas, ...] = (TracerGas("CO2", 380.0),)

    def variables(self):
        out = (
            input_var("air_temperature", XY(), default=10.0, units="degC",
                      desc="Near-surface air temperature"),
            input_var("air_pressure", XY(), default=101325.0, units="Pa",
                      desc="Atmospheric pressure at the surface"),
            input_var("windspeed", XY(), default=0.1, units="m/s", desc="Wind speed"),
        )
        out += self.humidity.variables() + self.precip.variables() \
            + self.radiation.variables() + self.aerodynamics.variables()
        for tr in self.tracers:
            out += tr.variables()
        return out

    # -- accessors (reference `prescribed_atmosphere.jl:119-245`) ----------
    def air_temperature(self, state):
        return state.inputs["air_temperature"]

    def air_pressure(self, state):
        return state.inputs["air_pressure"]

    def windspeed(self, state):
        return jnp.maximum(state.inputs["windspeed"], self.min_windspeed)

    def rainfall(self, state):
        return state.inputs["rainfall"]

    def snowfall(self, state):
        return state.inputs["snowfall"]

    def shortwave_down(self, state):
        return state.inputs["surface_shortwave_down"]

    def longwave_down(self, state):
        return state.inputs["surface_longwave_down"]

    def daytime_length(self, state):
        return state.inputs["daytime_length"]

    def specific_humidity(self, state):
        return self.humidity.specific_humidity(state)

    def aerodynamic_resistance(self, state, constants=None):
        """r_a = 1 / (C * V) with windspeed clipped
        (reference `prescribed_atmosphere.jl:105-116`)."""
        C = self.aerodynamics.drag_coefficient(state, self, constants)
        V = jnp.maximum(self.windspeed(state), 1.0e-6)
        return 1.0 / (C * V)

    def compute_vpd(self, state, constants: PhysicalConstants, Ts=None):
        """VPD [Pa] over a surface at temperature Ts (air T by default)
        (reference `prescribed_atmosphere.jl:167-180`)."""
        Ts = Ts if Ts is not None else self.air_temperature(state)
        return compute_vpd(constants, self.air_pressure(state),
                           self.specific_humidity(state), Ts)

    def humidity_vpd(self, state, constants: PhysicalConstants, Ts=None):
        """Specific-humidity deficit Delta_q [kg/kg]
        (reference `prescribed_atmosphere.jl:152-161`)."""
        de = self.compute_vpd(state, constants, Ts)
        return vapor_pressure_to_specific_humidity(
            de, self.air_pressure(state), constants.eps)

    def compute_auxiliary(self, state, grid, ctx: Context):
        return state

    def compute_tendencies(self, state, grid, ctx: Context):
        return state
