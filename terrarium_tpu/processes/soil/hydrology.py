"""Soil hydrology: immobile water (NoFlow) and Richards-equation flow.

JAX equivalent of reference
`src/processes/soil/hydrology/soil_hydrology.jl`, `soil_hydrology_rre.jl`,
and `soil_hydraulic_closures.jl`. The reference's order-dependent
`adjust_saturation_profile!` z-sweeps become `lax.scan`s over the z axis with
``(cells,)`` carries (SURVEY §3.2 hard part #2); everything else is
vectorised ``(Nz, cells)`` arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .hydraulics import SoilHydraulicsSURFEX
from ...ops.bcs import get_bc
from ...ops.vertical_ops import (_row_mask, div_faces, ghosts, grad_faces,
                                 pad_z, shift_z)
from ...variables import XY, XYZ, auxiliary, input, prognostic

__all__ = ["NoFlow", "RichardsEq", "SoilSaturationPressureClosure", "SoilHydrology"]

#: Lowering of :meth:`SoilHydrology.adjust_saturation_profile` (all
#: mathematically equivalent; float rounding differs, goldens regenerated on
#: a switch; not yet measured on the GPU):
#: * ``"fused"`` — the telescoped form below with the forward prefix pair
#:   ``(S, cummin S)`` computed by :func:`ops.vertical_ops.cumsum_cummin_z`
#:   in one doubling pass: the closure runs with no matmul, only pad-shift
#:   elementwise fusions.
#: * ``"telescoped"`` — matmul cumsum for S, doubling cummin for M; the
#:   DOWN sweep's reverse cumsum is eliminated algebraically (see below).
#: * ``"twopass"`` — the round-2 form: two cumsum dots + two cummins.
ADJUST_IMPL = "fused"


@dataclasses.dataclass(frozen=True)
class NoFlow:
    """Immobile soil water (reference `soil_hydrology.jl:13`)."""


@dataclasses.dataclass(frozen=True)
class RichardsEq:
    """Mixed saturation-pressure Richardson-Richards flow operator
    (reference `soil_hydrology_rre.jl:18`)."""


@dataclasses.dataclass(frozen=True)
class SoilSaturationPressureClosure:
    """Saturation <-> pressure-head closure (reference
    `soil_hydraulic_closures.jl:12`). Total head Psi = psi_m + psi_z + psi_h."""

    def variables(self):
        return (
            auxiliary("pressure_head", XYZ(), units="m",
                      desc="Total hydraulic pressure head in m"),
        )

    # closure/invclosure are driven by SoilHydrology (needs flow-op dispatch)


@dataclasses.dataclass(frozen=True)
class SoilHydrology:
    """Soil water balance process (reference `soil_hydrology.jl:21-53`)."""

    vertical_flow: Any = NoFlow()
    closure_rel: SoilSaturationPressureClosure = SoilSaturationPressureClosure()
    hydraulic_properties: Any = dataclasses.field(default_factory=SoilHydraulicsSURFEX)
    vwc_forcing: Optional[Any] = None  # callable (state, grid) -> (Nz, cells)
    #: Opt-in conservative correction of the saturation-adjustment bottom
    #: clip. The reference clips a residual column deficit to zero with an
    #: acknowledged "mass balance violation" comment
    #: (`soil_hydrology.jl:214-218`) — water is CREATED (quantified at +2.2%
    #: of inventory/year on the N145 year protocol, YEAR_r04.json). With
    #: ``deficit_pool=True`` the clipped deficit is tracked in a prognostic
    #: ``soil_water_deficit`` pool (same column units as
    #: ``surface_excess_water``) and repaid from the surface-excess pool as
    #: water becomes available; the budget counts it as negative inventory,
    #: restoring exact closure (tests/test_budget.py, ExactBudget). Like
    #: every other deviation fix (`consistent_units()`, ``.consistent()``),
    #: the parity default is off.
    deficit_pool: bool = False

    # -- variables --------------------------------------------------------
    def variables(self):
        if isinstance(self.vertical_flow, RichardsEq):
            # reference `soil_hydrology_rre.jl:20-26`
            deficit = (prognostic(
                "soil_water_deficit", XY(), units="m",
                desc="Unmet column water deficit clipped at the bottom "
                     "(deficit_pool corrected mode)"),) \
                if self.deficit_pool else ()
            return (
                prognostic("saturation_water_ice", XYZ(), closure=self.closure_rel,
                           domain=(0.0, 1.0),
                           desc="Saturation level of water+ice in the pore space"),
                prognostic("surface_excess_water", XY(), units="m",
                           desc="Excess water at the soil surface in m^3/m^2"),
                *deficit,
                auxiliary("hydraulic_conductivity", XYZ(face=True), units="m/s",
                          desc="Hydraulic conductivity at cell faces"),
                auxiliary("water_table", XY(), units="m",
                          desc="Elevation of the water table"),
                input("liquid_water_fraction", XYZ(), default=1.0, domain=(0.0, 1.0),
                      desc="Fraction of unfrozen water in the pore space"),
            )
        # reference `soil_hydrology.jl:78-83`
        return (
            auxiliary("saturation_water_ice", XYZ(), domain=(0.0, 1.0),
                      desc="Saturation level of water+ice in the pore space"),
            auxiliary("water_table", XY(), units="m",
                      desc="Elevation of the water table"),
            auxiliary("hydraulic_conductivity", XYZ(face=True), units="m/s",
                      desc="Hydraulic conductivity at cell faces"),
            input("liquid_water_fraction", XYZ(), default=1.0, domain=(0.0, 1.0),
                  desc="Fraction of unfrozen water in the pore space"),
        )

    # -- hydraulics -------------------------------------------------------
    def center_hydraulic_conductivity(self, state, grid, soil):
        """Unsaturated K at cell centers (reference `soil_hydrology_rre.jl:138-146`)."""
        vol = soil.strat.soil_volume(soil.biogeochem, state, grid)
        return self.hydraulic_properties.hydraulic_conductivity(vol)

    def compute_hydraulics(self, state, grid, soil):
        """Fill the face K array replicating the reference kernel exactly
        (`soil_hydrology.jl:145-163`): bottom face = bottom-center K; interior
        faces = min of adjacent centers; the two top faces both take the
        top-center K (reference writes face Nz and Nz+1 from center Nz)."""
        Kc = self.center_hydraulic_conductivity(state, grid, soil)
        Kc = jnp.broadcast_to(Kc, (grid.nz, grid.cells))
        # pad-shift form of [Kc[0], min-pairs(1..Nz-2), Kc[-1], Kc[-1]]:
        # min(+inf-padded upper/lower neighbors) gives faces 0..Nz with
        # min-pairs everywhere; the reference quirk (face Nz-1 takes the
        # top-center K, not a min) is restored with a one-row masked select.
        # All pads/selects fold into one fusion (no concatenate copy kernel).
        inf = jnp.inf
        upper = pad_z(Kc, 0, 1, inf)   # face f -> Kc[f]   (f < Nz)
        lower = pad_z(Kc, 1, 0, inf)   # face f -> Kc[f-1] (f >= 1)
        K_face = jnp.minimum(upper, lower)
        top_quirk = jnp.broadcast_to(Kc[-1:], K_face.shape)
        K_face = jnp.where(_row_mask(K_face.shape, grid.nz - 1) |
                           _row_mask(K_face.shape, grid.nz),
                           top_quirk, K_face)
        return state.update(hydraulic_conductivity=K_face.astype(grid.nf))

    # -- water table ------------------------------------------------------
    def compute_water_table(self, state, grid):
        """Water table = face elevation below the first (bottom-up) cell with
        sat < 1; surface (z=0) if fully saturated (reference
        `soil_hydrology.jl:170-175`, `findfirst_z` in `kernel_utils.jl:7-18`)."""
        sat = state.saturation_water_ice
        mask = sat < 1.0
        zf = grid.z_faces  # (Nz+1, 1)
        # gather-free formulation: z_faces increases with k, so the face
        # below the first unsaturated cell (bottom-up) is the minimum masked
        # face elevation; surface face if fully saturated.
        top = jnp.reshape(zf[-1:], ())
        masked = jnp.where(mask, zf[:-1], top)
        wt = jnp.min(masked, axis=0)
        return state.update(water_table=wt)

    def _spill_scale(self, spill_row, por, sat):
        """Top-layer spill into the surface-excess pool. Parity default: the
        raw saturation*dz column (the reference's sweep bookkeeping — a
        documented unit quirk: soil water changes by spill*porosity while
        the pool gains the unscaled column). ``deficit_pool`` corrected
        mode scales by the top-layer porosity so the pool transfer is
        water-conserving (the pool and the budget count meters of water)."""
        if not self.deficit_pool or por is None:
            return spill_row
        por_t = jnp.broadcast_to(por, sat.shape)[-1:]
        return spill_row * por_t

    # -- saturation adjustment -------------------------------------------
    def adjust_saturation_profile(self, state, grid, por=None):
        """Mass-conserving redistribution of over/under-saturation
        (reference `soil_hydrology.jl:185-218`): an upward sweep pushes excess
        water up (rescaled by thickness ratio), a downward sweep pulls
        deficits from below; residual surface excess goes to the
        `surface_excess_water` pool; a residual bottom deficit is clipped.

        The reference's sequential per-column sweeps are max-plus linear
        recurrences ``c[k] = max(0, a[k] + c[k-1])`` on the water columns
        ``a[k] = (sat[k] - 1) * dz[k]`` (up) / ``-sat_up[k] * dz[k]`` (down),
        which have the closed form ``c = S - min(0, cummin(S))`` over prefix
        sums ``S`` — so both sweeps run as fully parallel cumulative ops
        instead of sequential z-scans (no `lax.scan` on the explicit hot path
        at all).

        With ``M = min(0, cummin(S))`` the up sweep telescopes::

            w_up[k] = w[k] + c[k-1] - c[k] = dz[k] + M[k] - M[k-1]

        so the DOWN sweep's suffix sums also come in closed form without a
        second cumsum::

            S2[k] = -sum_{j>=k} w_up[j] = (Z[k-1] + M[k-1]) - (Z_tot + M_top)

        with ``Z = cumsum(dz)`` a static grid constant (``z_faces`` offsets).
        The whole adjustment is then ONE forward prefix pair (sum + min),
        one reverse cummin, and elementwise arithmetic (``ADJUST_IMPL``)."""
        from ...ops.vertical_ops import cummin_z, cumsum_cummin_z, cumsum_z

        from ...ops.vertical_ops import RECIP_COORD_DIV

        sat = state.saturation_water_ice
        dz = grid.dz  # (Nz, 1)
        dz_col = jnp.broadcast_to(dz, sat.shape)
        # see vertical_ops.RECIP_COORD_DIV: the (Nz, 1) reciprocal takes
        # far fewer divisions than dividing the full (Nz, cells) field
        inv_dz_col = (jnp.broadcast_to(1.0 / dz, sat.shape)
                      if RECIP_COORD_DIV else None)

        # upward sweep (bottom -> top): carry c[k] = excess water [m] spilling
        # past layer k; layer k receives c[k-1] and clamps at saturation 1.
        a = (sat - 1.0) * dz_col
        if ADJUST_IMPL == "twopass":
            S = cumsum_z(a)
            c = S - jnp.minimum(cummin_z(S), 0.0)
            c_in = shift_z(c, 1)  # zero inflow at the bottom
            sat_up = jnp.minimum(
                sat + (c_in * inv_dz_col if inv_dz_col is not None
                       else c_in / dz_col), 1.0)

            surf = None
            if "surface_excess_water" in state:
                # static slice + squeeze (`c[-1]` would lower to
                # dynamic_slice)
                spill = jnp.squeeze(self._spill_scale(c[-1:], por, sat),
                                    axis=0)
                surf = state.surface_excess_water + spill

            # downward sweep (top -> bottom): carry = deficit water column
            # [m] pulled from below; same recurrence on reversed suffix sums.
            b = -sat_up * dz_col
            S2 = cumsum_z(b, reverse=True)
            c2 = S2 - jnp.minimum(cummin_z(S2, reverse=True), 0.0)
            c2_in = shift_z(c2, -1)  # zero demand from above the surface
        else:
            if ADJUST_IMPL == "fused":
                S, Mp = cumsum_cummin_z(a)
                M = jnp.minimum(Mp, 0.0)
            else:  # "telescoped": matmul cumsum + doubling cummin
                S = cumsum_z(a)
                M = jnp.minimum(cummin_z(S), 0.0)
            M_in = shift_z(M, 1)  # zero carry below the bottom
            # w_up = dz + M - M_in  =>  sat_up = 1 + (M - M_in)/dz, which is
            # exactly min(sat + c_in/dz, 1) of the sequential sweep
            sat_up = 1.0 + ((M - M_in) * inv_dz_col
                            if inv_dz_col is not None
                            else (M - M_in) / dz_col)

            surf = None
            if "surface_excess_water" in state:
                # spill past the top layer: c_top = S_top - M_top
                spill = jnp.squeeze(
                    self._spill_scale(S[-1:] - M[-1:], por, sat), axis=0)
                surf = state.surface_excess_water + spill

            # down sweep suffix sums in closed form (no reverse cumsum):
            # Z[k] = cumulative thickness from the bottom = z_faces offsets
            zf = grid.z_faces  # (Nz+1, 1), increasing with k
            bot = jnp.reshape(zf[:1], ())  # scalar bottom-face elevation
            ZM = (zf[1:] - bot) + M  # (Nz, cells): Z + M
            S2 = shift_z(ZM, 1) - ZM[-1:]  # row 0 = -(Z_tot + M_top), exact
            c2 = S2 - jnp.minimum(cummin_z(S2, reverse=True), 0.0)
            c2_in = shift_z(c2, -1)  # zero demand from above the surface

        # every adjusted layer is max(s - c_in/dz, 0), incl. the bottom clip
        # of a residual deficit (mass-balance violation warning case)
        sat_new = jnp.maximum(
            sat_up - (c2_in * inv_dz_col if inv_dz_col is not None
                      else c2_in / dz_col), 0.0)

        updates = {"saturation_water_ice": sat_new}
        if self.deficit_pool and "soil_water_deficit" in state:
            # corrected mode: the clipped residual deficit is c2 exiting the
            # bottom row (the recurrence cascades all interior deficits down,
            # so only the bottom exit carries unmet demand). The sweeps work
            # in saturation*dz units; the water the clip CREATES is that
            # times the bottom-layer porosity — store the debt in water
            # meters and repay it 1:1 from the surface-excess pool (which
            # the budget also counts in meters). The budget counts the debt
            # as negative inventory (diagnostics/budget.py), restoring
            # closure; repayment is an inventory-neutral pool transfer.
            if por is None:
                raise ValueError("deficit_pool=True requires the porosity "
                                 "(adjust_saturation_profile(por=...))")
            por_b = jnp.broadcast_to(por, sat.shape)[:1]
            deficit_new = jnp.squeeze(c2[:1] * por_b, axis=0)
            total = state.soil_water_deficit + deficit_new
            if surf is not None:
                repay = jnp.minimum(total, jnp.maximum(surf, 0.0))
                surf = surf - repay
                total = total - repay
            updates["soil_water_deficit"] = total
        if surf is not None:
            updates["surface_excess_water"] = surf
        return state.update(updates)

    # -- interface --------------------------------------------------------
    def initialize(self, state, grid, soil, constants, ctx):
        if isinstance(self.vertical_flow, RichardsEq):
            # reference `soil_hydrology_rre.jl:33-47`: closure from initial
            # saturation, then auxiliaries
            state = self.closure(state, grid, soil, constants, ctx)
            return self.compute_hydraulics(state, grid, soil)
        # NoFlow (reference `soil_hydrology.jl:113-117`)
        state = self.compute_hydraulics(state, grid, soil)
        return self.compute_water_table(state, grid)

    def compute_auxiliary(self, state, grid, soil, constants, ctx):
        return self.compute_hydraulics(state, grid, soil)

    def compute_tendencies(self, state, grid, soil, constants, ctx):
        if not isinstance(self.vertical_flow, RichardsEq):
            return state  # NoFlow: no tendencies (reference `soil_hydrology.jl:126`)
        evtr = getattr(ctx.extras, "evapotranspiration", None) if ctx.extras else None
        runoff = getattr(ctx.extras, "runoff", None) if ctx.extras else None

        # Darcy flux divergence (reference `soil_hydrology_rre.jl:95-131`)
        psi = state.pressure_head
        bc_bot = get_bc(ctx.bcs, "pressure_head", "bottom")
        bc_top = get_bc(ctx.bcs, "pressure_head", "top")
        g_bot, g_top = ghosts(psi, bc_bot, bc_top, state, grid.dz_faces)
        grad = grad_faces(psi, grid.dz_faces, g_bot, g_top)
        K = state.hydraulic_conductivity  # face array (Nz+1, cells)
        # min of conductivities in the direction of flow; +inf fill makes the
        # pad-shift exact at the clamped ends (min(inf, K_end) = K_end, same
        # as the reference's edge-clamped neighbor shift)
        K_eff = jnp.where(grad < 0.0,
                          jnp.minimum(shift_z(K, 1, jnp.inf), K),
                          jnp.minimum(K, shift_z(K, -1, jnp.inf)))
        q = -K_eff * grad
        dtheta_dt = -div_faces(q, grid.dz)

        # ET sink in the top layer (reference `evapotranspiration_base.jl:9-15`)
        if evtr is not None:
            from ...ops.vertical_ops import _row_mask
            sink = evtr.soil_moisture_sink(state, grid, constants) / grid.dz[-1:]
            dtheta_dt = jnp.where(_row_mask(dtheta_dt.shape, -1),
                                  dtheta_dt + sink, dtheta_dt)
        # generic user forcing (reference `soil_hydrology.jl:245-257`)
        if self.vwc_forcing is not None:
            dtheta_dt = dtheta_dt + self.vwc_forcing(state, grid)

        # rescale by porosity -> saturation tendency (reference
        # `soil_hydrology.jl:222-237`)
        por = soil.strat.bulk_porosity(soil.biogeochem, state, grid)
        state = state.add_tendencies(saturation_water_ice=dtheta_dt / por)

        # surface excess pool drainage (reference `soil_hydrology.jl:260-283`).
        # Parity default: the reference ADDS min(S/tau, S) — the pool grows by
        # its own drainage. DirectSurfaceRunoff.consistent() applies the
        # removal sign instead (see its docstring).
        S = state.surface_excess_water
        dSdt = runoff.surface_drainage(S) if runoff is not None else jnp.zeros_like(S)
        sign = -1.0 if getattr(runoff, "consistent_drainage", False) else 1.0
        state = state.add_tendencies(surface_excess_water=sign * jnp.minimum(dSdt, S))
        return state

    def implicit_diffusion_terms(self, state, grid, soil, constants, ctx):
        """Jacobian ingredients for the implicit Richards solve: upwinded
        face conductivities frozen at t^n (one Picard iteration) and
        D = d(Psi)/d(sat) = psi_m'(theta) * por; tendency scale 1/por."""
        if not isinstance(self.vertical_flow, RichardsEq):
            return None
        from ...timesteppers.implicit import ImplicitDiffusionTerms

        psi = state.pressure_head
        bc_bot = get_bc(ctx.bcs, "pressure_head", "bottom")
        bc_top = get_bc(ctx.bcs, "pressure_head", "top")
        g_bot, g_top = ghosts(psi, bc_bot, bc_top, state, grid.dz_faces)
        grad = grad_faces(psi, grid.dz_faces, g_bot, g_top)
        K = state.hydraulic_conductivity
        K_eff = jnp.where(grad < 0.0,
                          jnp.minimum(shift_z(K, 1, jnp.inf), K),
                          jnp.minimum(K, shift_z(K, -1, jnp.inf)))

        por = soil.strat.bulk_porosity(soil.biogeochem, state, grid)
        sat = state.saturation_water_ice
        swrc = self.hydraulic_properties.swrc
        theta = sat * por
        D = swrc.inverse_deriv(theta, por) * por
        D = jnp.broadcast_to(D, (grid.nz, grid.cells))
        scale = jnp.broadcast_to(jnp.asarray(1.0 / por, dtype=grid.nf),
                                 (grid.nz, grid.cells))
        return ImplicitDiffusionTerms(
            var="saturation_water_ice", K_faces=K_eff, D=D, scale=scale,
            phi_var="pressure_head")

    # -- closure ----------------------------------------------------------
    def _psi_components(self, state, grid):
        z = grid.z_centers  # (Nz, 1)
        # z_ref = surface face elevation = 0 (reference
        # `soil_hydraulic_closures.jl:86`)
        # float() keeps the surface elevation weakly typed (np.float64
        # scalars are strong under x64 and would promote f32 states)
        psi_z = z - float(grid.vertical.z_faces[-1])
        # (cells,) or (1, cells) — canonicalize to a row for the
        # (Nz, cells) broadcast
        z0 = jnp.reshape(state.water_table, (1, -1))
        psi_h = jnp.maximum(0.0, z0 - z)
        return psi_z, psi_h

    def closure(self, state, grid, soil, constants, ctx=None):
        """saturation -> pressure head (reference
        `soil_hydraulic_closures.jl:23-44`): adjust profile, update water
        table, then Psi = psi_h + psi_m + psi_z."""
        if not isinstance(self.vertical_flow, RichardsEq):
            return state  # closure only defined for Richards flow
        por = soil.strat.bulk_porosity(soil.biogeochem, state, grid)
        state = self.adjust_saturation_profile(state, grid, por=por)
        state = self.compute_water_table(state, grid)
        sat = state.saturation_water_ice
        swrc = self.hydraulic_properties.swrc
        psi_m = swrc.inverse(sat * por, por)
        psi_z, psi_h = self._psi_components(state, grid)
        return state.update(pressure_head=psi_h + psi_m + psi_z)

    def invclosure(self, state, grid, soil, constants, ctx=None):
        """pressure head -> saturation (reference
        `soil_hydraulic_closures.jl:51-100`), then adjust + water table."""
        if not isinstance(self.vertical_flow, RichardsEq):
            return state
        psi = state.pressure_head
        psi_z, psi_h = self._psi_components(state, grid)
        psi_m = psi - psi_h - psi_z
        por = soil.strat.bulk_porosity(soil.biogeochem, state, grid)
        swrc = self.hydraulic_properties.swrc
        theta = swrc(psi_m, por)
        state = state.update(saturation_water_ice=theta / por)
        state = self.adjust_saturation_profile(state, grid, por=por)
        return self.compute_water_table(state, grid)
