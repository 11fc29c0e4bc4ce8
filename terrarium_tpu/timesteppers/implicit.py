"""Implicit (linearized backward-Euler) timestepper with batched tridiagonal
solves.

**New capability relative to the reference**, which only ships explicit
steppers (SURVEY §2.3, BASELINE config #2). The diffusion operators (heat
conduction and Richards flow) are stepped implicitly per column:

    (I/dt - J) du = tend(u^n),   u^{n+1} = u^n + du

where ``tend`` is the full explicit tendency at t^n (so all couplings,
forcings, and Flux BCs enter through the right-hand side exactly as in the
explicit steppers) and ``J`` is the tridiagonal Jacobian of the diffusive
flux divergence, linearized via the chain factor ``D_k = d(phi)/d(u)``:

* heat:    u = internal_energy, phi = temperature, D = dT/dU in {1/C, 0}
  (the phase-change plateau has D = 0, so freezing cells absorb energy at
  fixed temperature — the apparent-heat-capacity treatment of the free-water
  freeze curve that the reference sidesteps by being explicit);
* Richards: u = saturation, phi = total head Psi, D = psi_m'(theta) * por,
  with the tendency scale 1/por and the face conductivities frozen at t^n
  (one Picard iteration).

A Dirichlet BC on phi contributes ``2 K D / (dzf dz)`` to the boundary-row
diagonal (ghost-cell linearization); Neumann/Flux BCs contribute nothing
implicit.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .stepping import explicit_step, prog_xy_map, update_state
from ..ops.bcs import Dirichlet, get_bc
from ..ops.tridiag import tridiag_solve, tridiag_solve_pcr
from ..ops.vertical_ops import apply_flux_bcs
from ..state import State

__all__ = ["ImplicitEuler", "ImplicitDiffusionTerms"]


@dataclasses.dataclass(frozen=True)
class ImplicitDiffusionTerms:
    """Jacobian ingredients for one prognostic variable's diffusion operator.

    Attributes:
        var: prognostic variable name.
        K_faces: ``(Nz+1, cells)`` face conductivities of the flux
            ``q = -K d(phi)/dz``.
        D: ``(Nz, cells)`` chain factor d(phi)/d(u) at cell centers.
        scale: tendency scale ``(Nz, cells)`` or scalar (e.g. 1/porosity).
        phi_var: name of the flux potential variable (for BC lookup).
    """

    var: str
    K_faces: jnp.ndarray
    D: jnp.ndarray
    scale: jnp.ndarray
    phi_var: str


_SOLVERS = {"thomas": tridiag_solve, "pcr": tridiag_solve_pcr}


def _assemble_implicit(terms: ImplicitDiffusionTerms, state, grid, bcs, dt):
    """Assemble the (a, b, c, rhs) rows of (I/dt - J) du = tend(u^n)."""
    from ..ops.vertical_ops import _row_mask, shift_z

    Kf, D, s = terms.K_faces, terms.D, terms.scale
    dz = grid.dz  # (Nz, 1)
    dzf = grid.dz_faces  # (Nz+1, 1)

    K_lo = Kf[:-1]  # face below cell k (f = k)
    K_hi = Kf[1:]  # face above cell k (f = k+1)
    dzf_lo = dzf[:-1]
    dzf_hi = dzf[1:]

    # off-diagonals (interior faces only; boundary rows get 0 there).
    # shift_z pads with 0 at the vacated boundary row, which also zeroes the
    # full off-diagonal product there (no separate masking of a[0]/c[-1]).
    a = -(s * K_lo * shift_z(D, 1) / (dzf_lo * dz))
    c = -(s * K_hi * shift_z(D, -1) / (dzf_hi * dz))

    # diagonal: interior-face terms (boundary faces excluded via row masks)
    zero = jnp.zeros((), dtype=D.dtype)
    diag_lo = jnp.where(_row_mask(D.shape, 0), zero,
                        s * K_lo * D / (dzf_lo * dz))
    diag_hi = jnp.where(_row_mask(D.shape, -1), zero,
                        s * K_hi * D / (dzf_hi * dz))
    b = 1.0 / dt + diag_lo + diag_hi

    # Dirichlet phi BCs: ghost = 2*value - interior => extra 2*K*D/(dzf*dz)
    bc_bot = get_bc(bcs, terms.phi_var, "bottom")
    bc_top = get_bc(bcs, terms.phi_var, "top")
    # static slices + reshape (integer indexing would emit `dynamic_slice`)
    if isinstance(bc_bot, Dirichlet):
        sb = s if jnp.ndim(s) == 0 else s[:1]
        dzf0 = jnp.reshape(dzf[:1, :1], ())
        dz0 = jnp.reshape(dz[:1, :1], ())
        b = b + jnp.where(_row_mask(b.shape, 0),
                          2.0 * sb * Kf[:1] * D[:1] / (dzf0 * dz0),
                          zero)
    if isinstance(bc_top, Dirichlet):
        st = s if jnp.ndim(s) == 0 else s[-1:]
        dzfN = jnp.reshape(dzf[-1:, :1], ())
        dzN = jnp.reshape(dz[-1:, :1], ())
        b = b + jnp.where(_row_mask(b.shape, -1),
                          2.0 * st * Kf[-1:] * D[-1:] / (dzfN * dzN),
                          zero)

    return a, b, c, state.tendencies[terms.var]


@dataclasses.dataclass(frozen=True)
class ImplicitEuler:
    """Linearized backward-Euler stepper (see module docstring).

    Variables without implicit terms fall back to the explicit Euler update,
    so the stepper is a drop-in replacement for :class:`ForwardEuler`.

    ``solver``: ``"thomas"`` (sequential scan, exact) or ``"pcr"`` (parallel
    cyclic reduction — no sequential z dependence; agrees with Thomas to
    ~1e-10 on the diagonally-dominant systems this stepper assembles).
    Which is faster on the GPU is not yet measured (ROADMAP A6).

    ``stack_solves``: ``True`` — solve all implicit systems (heat +
    Richards) as ONE batched solve concatenated along the cell axis.
    ``"rows"`` — pack the TWO systems' rows into ``(2, cells)`` Thomas
    sweeps (`ops.tridiag.tridiag_solve_pair_rows`). Defaults off (False).
    """

    dt: float = 900.0
    solver: str = "pcr"
    stack_solves: bool = False
    #: Picard (fixed-point) iterations of the linearized backward-Euler
    #: solve. 1 (default) freezes face conductivities and the chain factor
    #: D at t^n — the documented one-iteration limitation. With k > 1 the
    #: implicit variables are re-solved around the updated state:
    #: ``(I/dt - J(u_k)) du = tend(u_k) - (u_k - u^n)/dt``, which re-centers
    #: the linearization on the freeze plateau / moving infiltration front
    #: (explicit-variable updates keep their first-iteration values).
    #: Accuracy-vs-dt characterization: tests/test_implicit_stiff.py and
    #: docs/performance.md.
    picard_iters: int = 1

    def default_dt(self):
        return self.dt

    def step(self, model, state: State, ctx, input_sources, dt) -> State:
        state = self._body(model, state, ctx, input_sources, dt)
        state = model.closure(state, ctx)
        return state.tick(dt)

    def pre_closure_step(self, model, state: State, ctx, input_sources,
                         dt) -> State:
        """Closure-rotated step for lean rollouts (see
        `ForwardEuler.pre_closure_step`): ``closure ∘ (pre_closure_step)^n``
        equals ``step^n`` exactly, with the scan carry shrunk to
        prognostics (+ clock/inputs)."""
        state = model.closure(state, ctx)
        state = self._body(model, state, ctx, input_sources, dt)
        return state.tick(dt)

    def _body(self, model, state: State, ctx, input_sources, dt) -> State:
        grid = model.grid
        xy = prog_xy_map(model)
        state = update_state(model, state, ctx, input_sources)

        # collect implicit terms from the model's processes
        terms = model.implicit_terms(state, ctx) if hasattr(model, "implicit_terms") else ()
        implicit_vars = {t.var for t in terms}

        # flux BCs enter the RHS tendencies exactly as in the explicit path
        tend = dict(state.tendencies)
        for name in state.prognostic:
            var_bcs = (ctx.bcs or {}).get(name)
            if var_bcs:
                tend[name] = apply_flux_bcs(
                    tend[name], var_bcs, state, grid.dz,
                    xy=None if xy is None else xy["vars"].get(name))
        state = dataclasses.replace(state, tendencies=tend)

        prog = dict(state.prognostic)
        systems = [(t, _assemble_implicit(t, state, grid, ctx.bcs, dt))
                   for t in terms]
        if (self.stack_solves == "rows" and len(systems) == 2
                and systems[0][1][0].shape == systems[1][1][0].shape):
            # pack the two systems' rows into (2, cells) ops (see
            # `tridiag_solve_pair_rows`); solver choice is implied
            from ..ops.tridiag import tridiag_solve_pair_rows

            (t1, s1), (t2, s2) = systems
            x1, x2 = tridiag_solve_pair_rows(s1, s2)
            prog[t1.var] = prog[t1.var] + x1
            prog[t2.var] = prog[t2.var] + x2
        elif (self.stack_solves is True and len(systems) > 1 and len(
                {sys_[1][0].shape for sys_ in systems}) == 1):
            # one batched solve over all systems (independent columns:
            # concatenation along cells is exact)
            a, b, c, rhs = (jnp.concatenate([s[1][i] for s in systems], axis=1)
                            for i in range(4))
            du_all = _SOLVERS[self.solver](a, b, c, rhs)
            w = systems[0][1][0].shape[1]
            for j, (t, _) in enumerate(systems):
                prog[t.var] = prog[t.var] + du_all[:, j * w:(j + 1) * w]
        else:
            for t, (a, b, c, rhs) in systems:
                prog[t.var] = prog[t.var] + _SOLVERS[self.solver](a, b, c, rhs)
        for name in prog:
            if name not in implicit_vars:
                prog[name] = prog[name] + state.tendencies[name] * dt

        # further Picard sweeps re-center the linearization on the updated
        # state (see `picard_iters` docstring)
        prog_n = {v: state.prognostic[v] for v in implicit_vars}
        for _ in range(max(1, int(self.picard_iters)) - 1):
            st = dataclasses.replace(state, prognostic=dict(prog))
            st = model.closure(st, ctx)
            st = update_state(model, st, ctx, input_sources)
            tend_k = dict(st.tendencies)
            for name in st.prognostic:
                var_bcs = (ctx.bcs or {}).get(name)
                if var_bcs:
                    tend_k[name] = apply_flux_bcs(
                        tend_k[name], var_bcs, st, grid.dz,
                        xy=None if xy is None else xy["vars"].get(name))
            st = dataclasses.replace(st, tendencies=tend_k)
            for t in (model.implicit_terms(st, ctx)
                      if hasattr(model, "implicit_terms") else ()):
                a, b, c, _ = _assemble_implicit(t, st, grid, ctx.bcs, dt)
                rhs = (st.tendencies[t.var]
                       - (st.prognostic[t.var] - prog_n[t.var]) / dt)
                prog[t.var] = st.prognostic[t.var] + _SOLVERS[self.solver](
                    a, b, c, rhs)
        state = dataclasses.replace(state, prognostic=prog)

        if state.namespaces:
            ns = {k: explicit_step(
                v, grid, ctx.bcs, dt,
                xy=None if xy is None else xy["ns"].get(k))
                  for k, v in state.namespaces.items()}
            state = dataclasses.replace(state, namespaces=ns)

        return model.timestep(state, ctx, dt)
