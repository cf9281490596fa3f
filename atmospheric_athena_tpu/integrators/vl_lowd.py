"""1D/2D van Leer (MUSCL-Hancock) integrator — Newtonian and
special-relativistic hydrodynamics.

Reference: src/integrators/integrate_1d_vl.c, integrate_2d_vl.c and the
SR variants integrate_1d_vl_sr.c / integrate_2d_vl_sr.c (identical step
maps; SR differs only in the variable conversions, the solver family, and
the superluminal/positivity guards of :150-230).

Steps: (1) W = Cons->Prim; (2) first-order donor-cell fluxes at t^n per
axis; (3) half-dt conservative update -> Uhalf (+gravity half sources);
(4) Whalf with the SR guard (d<0, P<0 or v^2>1 reverts to W^n,
integrate_1d_vl_sr.c:158-183); (5) second-order primitive L/R states from
Whalf (lr_states non-CTU branch; SR guards superluminal traced states,
:210-224); (6) full fluxes; (7) full-dt update + gravity at n+1/2.
MHD in 1D/2D VL still pending (needs the reduced CT update).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, prim1d_to_cons1d
from ..eos_sr import sr_cons1d_to_prim1d, sr_prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .ctu3d import _phi_arrays, _sh, _shf
from .sweep import vperm_from_sweep, vperm_to_sweep


def step_mhd_1d(state: State, dt, sim: SimConfig, grid: GridConfig,
                problem=None, phi=None):
    """1D VL for MHD, Newtonian (integrate_1d_vl.c) and special-
    relativistic (integrate_1d_vl_sr.c, FOFC off).

    In 1D the normal field is constant (B1i untouched); By/Bz evolve as
    conserved variables through the solver's induction-equation fluxes, and
    the interface fields are set to the cell-centered values at the end
    (integrate_1d_vl_sr.c:350-356).  Sweep stacks are the
    (d, Mx, My, Mz, E, By, Bz, s...) layout with Bx passed separately.
    """
    sr = sim.special_relativity
    axes = [a for a in range(3) if grid.active(a)]
    assert len(axes) == 1, "VL MHD supported in 1D only (2D CT pending)"
    # SR passive scalars are an extension (reference SR solvers #error
    # on NSCALARS>0); the SR converters and flux dispatch carry s = D*r
    a = axes[0]
    a1, a2 = (a + 1) % 3, (a + 2) % 3
    dtodx = dt / grid.dx[a]
    hq = 0.5 * dtodx

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i]
    ib = 5 if sim.adiabatic else 4

    U1d0 = vperm_to_sweep(U, a, sim)
    U1d0 = jnp.concatenate([U1d0[:ib], Bcc[a1][None], Bcc[a2][None],
                            U1d0[ib:]], 0)
    Bxc = Bcc[a]
    Bxi = Bi[a]
    if sr:
        # step 1a-1b: W from U, then U regenerated from W for consistency
        # (integrate_1d_vl_sr.c:93-129)
        from ..eos_sr import (sr_mhd_cons1d_to_prim1d,
                              sr_mhd_prim1d_to_cons1d)

        def c2p(Ux, Bx):
            return sr_mhd_cons1d_to_prim1d(Ux, Bx, sim)

        def p2c(Wx, Bx):
            return sr_mhd_prim1d_to_cons1d(Wx, Bx, sim)

        W1d = c2p(U1d0, Bxc)
        U1d = p2c(W1d, Bxc)
    else:
        def c2p(Ux, Bx):
            return cons1d_to_prim1d(Ux, Bx, sim)

        def p2c(Wx, Bx):
            return prim1d_to_cons1d(Wx, Bx, sim)

        W1d = c2p(U1d0, Bxc)
        U1d = U1d0   # Newtonian path uses U as-is (integrate_1d_vl.c:105)

    # step 1d: first-order fluxes
    Wl = _sh(W1d, -1, a)
    Ul = _sh(U1d, -1, a)
    F1 = riemann.fluxes(Ul, U1d, Wl, W1d, Bxi, sim)

    # step 5a: half-dt update of the 7-var cell-centered state
    Uh = U1d - hq * (_sh(F1, 1, a) - F1)

    # step 6a: half-dt static gravity
    # the drivers pass phi in as a jit argument (a trace-time constant
    # of this size would be baked into the executable); fallback for
    # direct calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)
    if phic is not None:
        phir = _shf(phif[a], 1, a)
        phil = phif[a]
        Uh = Uh.at[1].add(-hq * U1d[0] * (phir - phil))
        Uh = Uh.at[4].add(-hq * (F1[0] * (phic - phil) +
                                 _shf(F1[0], 1, a) * (phir - phic)))

    # step 7: invert at n+1/2 (no FOFC guard in this build)
    Whalf = c2p(Uh, Bxc)

    # steps 8, 11: second-order primitive states + full fluxes
    Wm, Wp_ = reconstruct.lr_states(Whalf, Bxc, dtodx, sim, axis=2 - a)
    Wl2 = _sh(Wp_, -1, a)
    Wr2 = Wm
    Ul2 = p2c(Wl2, Bxi)
    Ur2 = p2c(Wr2, Bxi)
    F2 = riemann.fluxes(Ul2, Ur2, Wl2, Wr2, Bxi, sim)

    # steps 13-14: full-dt source + conservative update
    Un = U1d0 - dtodx * (_sh(F2, 1, a) - F2)
    if phic is not None:
        Un = Un.at[1].add(-dtodx * Uh[0] * (phir - phil))
        Un = Un.at[4].add(-dtodx * (F2[0] * (phic - phil) +
                                    _shf(F2[0], 1, a) * (phir - phic)))

    # scatter back: hydro rows into U, By/Bz rows into Bcc; interface
    # fields follow the cell centers (B2i/B3i = B2c/B3c)
    sl = (slice(None),) + grid.interior()
    hyd = vperm_from_sweep(jnp.concatenate([Un[:ib], Un[ib + 2:]], 0),
                           a, sim)
    Uout = U.at[sl].set(hyd[sl])
    ssl = grid.interior()
    Bcc_new = Bcc.at[(a1,) + ssl].set(Un[ib][ssl])
    Bcc_new = Bcc_new.at[(a2,) + ssl].set(Un[ib + 1][ssl])
    Bi_new = [Bi[0], Bi[1], Bi[2]]
    Bi_new[a1] = Bi[a1].at[ssl].set(Un[ib][ssl])
    Bi_new[a2] = Bi[a2].at[ssl].set(Un[ib + 1][ssl])
    return state.replace(U=Uout, Bcc=Bcc_new, B1i=Bi_new[0],
                         B2i=Bi_new[1], B3i=Bi_new[2])


def step_mhd_2d(state: State, dt, sim: SimConfig, grid: GridConfig,
                problem=None, phi=None):
    """2D VL for Newtonian MHD (integrate_2d_vl.c) with the reduced CT
    update: one corner emf3 (Gardiner-Stone upwinding, shared with the 2D
    CTU integrator) advances B1i/B2i at the half and full steps; B3c is a
    conserved variable updated by flux differencing."""
    from .ctu2d_mhd import _emf3_corner
    assert not sim.h_correction, "H-correction pending in 2D VL MHD"
    axes = [a for a in range(3) if grid.active(a)]
    assert axes == [0, 1], "2D VL MHD needs x1/x2 active"
    sr = sim.special_relativity
    if sr:
        # integrate_2d_vl_sr.c: same step map with the SR conversions;
        # SR passive scalars are an extension (see step_mhd_1d note)
        assert not sim.first_order_flux_correction, \
            "FOFC pending in 2D VL SR-MHD"
        from ..eos_sr import (sr_mhd_cons1d_to_prim1d,
                              sr_mhd_prim1d_to_cons1d)
    dtodx = {a: dt / grid.dx[a] for a in axes}
    hq = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i]
    ib = 5 if sim.adiabatic else 4
    # the drivers pass phi in as a jit argument (a trace-time constant
    # of this size would be baked into the executable); fallback for
    # direct calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)

    def sweep_U(Uphys, Bv, a):
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Us = vperm_to_sweep(Uphys, a, sim)
        return jnp.concatenate([Us[:ib], Bv[a1][None], Bv[a2][None],
                                Us[ib:]], 0)

    def split_hyd(F, a):
        """Sweep-order flux -> (physical hydro+scalar rows, (By,Bz))."""
        hyd = vperm_from_sweep(
            jnp.concatenate([F[:ib], F[ib + 2:]], 0), a, sim)
        return hyd, (F[ib], F[ib + 1])

    def sweep_W(Wphys5, Bv, a):
        """Per-axis 7-var primitive sweep stack from the ONCE-converted
        physical-order primitives (conversion in physical order like the
        reference's single Cons_to_Prim pass; per-axis conversion of the
        permuted stack differs in the |M|^2 summation order by ulps)."""
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Ws = vperm_to_sweep(Wphys5, a, sim)
        return jnp.concatenate([Ws, Bv[a1][None], Bv[a2][None]], 0)

    if sr:
        Wphys = sr_mhd_cons1d_to_prim1d(sweep_U(U, Bcc, 0), Bcc[0],
                                        sim)[:5]

    # === steps 1-2: first-order fluxes at t^n ==============================
    Fh, FB = {}, {}
    for a in axes:
        Bxc = Bcc[a]
        if sr:
            W = sweep_W(Wphys, Bcc, a)
        else:
            W = cons1d_to_prim1d(sweep_U(U, Bcc, a), Bxc, sim)
        p2c = sr_mhd_prim1d_to_cons1d if sr else prim1d_to_cons1d
        Wl = _sh(W, -1, a)
        # U regenerated from W per side with the donor cell's Bxc
        # (integrate_2d_vl.c:231-233, "in case Pfloor used")
        Ul = p2c(Wl, _shf(Bxc, -1, a), sim)
        Ur = p2c(W, Bxc, sim)
        F = riemann.fluxes(Ul, Ur, Wl, W, Bi[a], sim)
        Fh[a], FB[a] = split_hyd(F, a)

    # === step 4: half-dt CT ================================================
    d = U[ID]
    # SR: the cc reference EMF uses the PRIMITIVE velocity
    # (integrate_2d_vl_sr.c step 4a reads W)
    ecc = ((Bcc[0] * Wphys[2] - Bcc[1] * Wphys[1]) if sr else
           (Bcc[0] * U[IM1 + 1] - Bcc[1] * U[IM1]) / d)
    emf3 = _emf3_corner(Fh[0][ID], FB[0][0], Fh[1][ID], FB[1][1], ecc)
    B1ih = Bi[0] - hq[1] * (_shf(emf3, 1, 1) - emf3)
    B2ih = Bi[1] + hq[0] * (_shf(emf3, 1, 0) - emf3)
    B1ch = 0.5 * (B1ih + _shf(B1ih, 1, 0))
    B2ch = 0.5 * (B2ih + _shf(B2ih, 1, 1))

    # === steps 5-6: half-dt cell-centered update (+ gravity) ==============
    Uhalf = U
    for a in axes:   # sequential per axis, like steps 5a/5b
        Uhalf = Uhalf - hq[a] * (_sh(Fh[a], 1, a) - Fh[a])
    B3ch = (Bcc[2]
            - hq[0] * (_shf(FB[0][1], 1, 0) - FB[0][1])
            - hq[1] * (_shf(FB[1][0], 1, 1) - FB[1][0]))
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Uhalf = Uhalf.at[IM1 + a].add(-hq[a] * U[ID] * (phir - phil))
            if sim.adiabatic:
                Uhalf = Uhalf.at[IEN].add(
                    -hq[a] * (Fh[a][ID] * (phic - phil) +
                              _shf(Fh[a][ID], 1, a) * (phir - phic)))
    Bh = (B1ch, B2ch, B3ch)

    # === steps 7-10: second-order states + full fluxes =====================
    if sr:
        Whalf = sr_mhd_cons1d_to_prim1d(sweep_U(Uhalf, Bh, 0), Bh[0],
                                        sim)[:5]
    F2h, F2B = {}, {}
    for a in axes:
        if sr:
            W = sweep_W(Whalf, Bh, a)
        else:
            W = cons1d_to_prim1d(sweep_U(Uhalf, Bh, a), Bh[a], sim)
        p2c = sr_mhd_prim1d_to_cons1d if sr else prim1d_to_cons1d
        Wm, Wp_ = reconstruct.lr_states(W, Bh[a], dtodx[a], sim,
                                        axis=2 - a)
        Wl2 = _sh(Wp_, -1, a)
        Wr2 = Wm
        Bface = B1ih if a == 0 else B2ih
        Ul2 = p2c(Wl2, Bface, sim)
        Ur2 = p2c(Wr2, Bface, sim)
        F = riemann.fluxes(Ul2, Ur2, Wl2, Wr2, Bface, sim)
        F2h[a], F2B[a] = split_hyd(F, a)

    # === step 11: full-dt CT ===============================================
    ecc_h = ((B1ch * Whalf[2] - B2ch * Whalf[1]) if sr else
             (B1ch * Uhalf[IM1 + 1] - B2ch * Uhalf[IM1]) / Uhalf[ID])
    emf3F = _emf3_corner(F2h[0][ID], F2B[0][0], F2h[1][ID], F2B[1][1],
                         ecc_h)
    B1new = Bi[0] - dtodx[1] * (_shf(emf3F, 1, 1) - emf3F)
    B2new = Bi[1] + dtodx[0] * (_shf(emf3F, 1, 0) - emf3F)

    # === steps 12-13: full-dt sources + conservative update ================
    Unew = U
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew = Unew.at[IM1 + a].add(
                -dtodx[a] * Uhalf[ID] * (phir - phil))
            if sim.adiabatic:
                Unew = Unew.at[IEN].add(
                    -dtodx[a] * (F2h[a][ID] * (phic - phil) +
                                 _shf(F2h[a][ID], 1, a) * (phir - phic)))
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(F2h[a], 1, a) - F2h[a])
    B3new = (Bcc[2]
             - dtodx[0] * (_shf(F2B[0][1], 1, 0) - F2B[0][1])
             - dtodx[1] * (_shf(F2B[1][0], 1, 1) - F2B[1][0]))

    # === splice (active cells; interface fields incl. the +1 face) =========
    sl = (slice(None),) + grid.interior()
    Uout = U.at[sl].set(Unew[sl])
    Biout = []
    for a, Bn in ((0, B1new), (1, B2new)):
        idx = []
        for ax in (2, 1, 0):
            upper = grid.hi(ax) + 1 + (1 if ax == a else 0)
            idx.append(slice(grid.lo(ax), upper))
        Biout.append(state.B1i.at[tuple(idx)].set(Bn[tuple(idx)])
                     if a == 0 else
                     state.B2i.at[tuple(idx)].set(Bn[tuple(idx)]))
    Bcc_new = jnp.stack([0.5 * (Biout[0] + _shf(Biout[0], 1, 0)),
                         0.5 * (Biout[1] + _shf(Biout[1], 1, 1)),
                         B3new])
    Bcc_out = Bcc.at[sl].set(Bcc_new[sl])
    kw = {}
    if state.B3i is not None:
        kw["B3i"] = state.B3i.at[grid.interior()].set(
            B3new[grid.interior()])
    return state.replace(U=Uout, Bcc=Bcc_out, B1i=Biout[0], B2i=Biout[1],
                         **kw)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    if sim.mhd:
        axes = [a for a in range(3) if grid.active(a)]
        if len(axes) == 2:
            return step_mhd_2d(state, dt, sim, grid, problem, phi=phi)
        return step_mhd_1d(state, dt, sim, grid, problem, phi=phi)
    axes = [a for a in range(3) if grid.active(a)]
    dtodx = {a: dt / grid.dx[a] for a in axes}
    hq = {a: 0.5 * dtodx[a] for a in axes}
    sr = sim.special_relativity

    def c2p(U1d):
        return sr_cons1d_to_prim1d(U1d, sim) if sr else \
            cons1d_to_prim1d(U1d, None, sim)

    def p2c(W1d):
        return sr_prim1d_to_cons1d(W1d, sim) if sr else \
            prim1d_to_cons1d(W1d, None, sim)

    U = state.U
    # the drivers pass phi in as a jit argument (a trace-time constant
    # of this size would be baked into the executable); fallback for
    # direct calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)

    # === steps 1-3: first-order fluxes at t^n, half-dt update ==============
    Uhalf = U
    Fp = {}
    for a in axes:
        U1d = vperm_to_sweep(U, a, sim)
        W1d = c2p(U1d)
        Wl = _sh(W1d, -1, a)
        Ul = _sh(U1d, -1, a)
        F = riemann.fluxes(Ul, U1d, Wl, W1d, None, sim)
        Fp[a] = vperm_from_sweep(F, a, sim)
        Uhalf = Uhalf - hq[a] * (_sh(Fp[a], 1, a) - Fp[a])

    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Uhalf = Uhalf.at[IM1 + a].add(
                -hq[a] * U[ID] * (phir - phil))
            if sim.adiabatic:
                Uhalf = Uhalf.at[IEN].add(
                    -hq[a] * (Fp[a][ID] * (phic - phil) +
                              _shf(Fp[a][ID], 1, a) * (phir - phic)))

    # === step 4: Whalf with the SR positivity/causality guard ==============
    Whalf_s = {}
    for a in axes:
        Uh1d = vperm_to_sweep(Uhalf, a, sim)
        Wh = c2p(Uh1d)
        if sr:
            W0 = c2p(vperm_to_sweep(U, a, sim))
            vsq = Wh[1] ** 2 + Wh[2] ** 2 + Wh[3] ** 2
            bad = (Wh[0] < 0.0) | (Wh[4] < 0.0) | (vsq > 1.0)
            Wh = jnp.where(bad, W0, Wh)
        Whalf_s[a] = Wh

    # === steps 5-7: second-order states, full fluxes, final update =========
    Unew = U
    Fp2 = {}
    for a in axes:
        Wh = Whalf_s[a]
        Wm, Wp_ = reconstruct.lr_states(Wh, None, dtodx[a], sim,
                                        axis=2 - a)
        Wl = _sh(Wp_, -1, a)
        Wr = Wm
        if sr:  # superluminal traced states revert to cell values (:210-224)
            vl = Wl[1] ** 2 + Wl[2] ** 2 + Wl[3] ** 2
            vr = Wr[1] ** 2 + Wr[2] ** 2 + Wr[3] ** 2
            bad = (vl > 1.0) | (vr > 1.0)
            Wl = jnp.where(bad, _sh(Wh, -1, a), Wl)
            Wr = jnp.where(bad, Wh, Wr)
        Ul = p2c(Wl)
        Ur = p2c(Wr)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim)
        Fp2[a] = vperm_from_sweep(F, a, sim)
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    if phic is not None:
        dhalf = Uhalf[ID]
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew = Unew.at[IM1 + a].add(
                -dtodx[a] * dhalf * (phir - phil))
            if sim.adiabatic:
                Unew = Unew.at[IEN].add(
                    -dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic)))

    sl = (slice(None),) + grid.interior()
    Uout = U.at[sl].set(Unew[sl])
    return state.replace(U=Uout)
