"""Multidimensional (2D/3D) CTU integrator — hydrodynamics path.

Re-implementation of /root/reference/src/integrators/integrate_3d_ctu.c (and
the structurally identical integrate_2d_ctu.c) for gas=hydro, with passive
scalars, static-gravity source terms, and the H-correction.  The MHD
(constrained-transport) steps 1b-MHD/4/10 live in ctu3d_mhd.py.

Design: the reference's triple k/j/i pencil loops become whole-grid
stacked-array arithmetic; the 12-step *ordering* is preserved exactly, since
it is the correctness contract (SURVEY.md §7.3).  All interface-state and
flux arrays are kept in PHYSICAL variable order (d, M1, M2, M3, E, s...)
between steps, so the reference's per-sweep component permutation tables
(e.g. x2-flux (Mx,My,Mz)->(M2,M3,M1), integrate_3d_ctu.c:984-987) reduce to
a single gather before/after each Riemann solve.

Array/indexing conventions:
  - arrays [nvar, Nz, Ny, Nx]; Athena axis a is array dim 3-a.
  - interface index f along axis a == between cells f-1 and f;
    Ul[f] is the state from cell f-1, Ur[f] from cell f.
  - sh_a(q, k) shifts so sh_a(q,k)[..., f] = q[..., f+k] (wrap; edge cells
    are invalid and never used for interior updates — nghost=4 covers the
    deepest stencil: PLM(2) + transverse(1) + update(1)).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..eos import cons1d_to_prim1d, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .sweep import vperm_from_sweep, vperm_to_sweep


def _adim(axis: int) -> int:
    return 3 - axis  # dim within a [nvar, Nz, Ny, Nx] stacked array


def _sh(q, k, axis):
    """Shift along Athena axis `axis` of a stacked [nvar,...] array."""
    return jnp.roll(q, -k, axis=_adim(axis))


def _shf(q, k, axis):
    """Same for field arrays [Nz, Ny, Nx] (no leading variable axis)."""
    return jnp.roll(q, -k, axis=2 - axis)


def _eval_phi(phi_fn, grid: GridConfig, dtype):
    import numpy as np
    coords = [np.asarray(grid.cc_coords(a), dtype) for a in range(3)]
    # broadcastable [Nz,Ny,Nx] views: axis a varies along array dim 2-a
    def mesh(xs):
        return [jnp.asarray(x).reshape(
            [-1 if d == 2 - a else 1 for d in range(3)])
            for a, x in enumerate(xs)]
    x1, x2, x3 = mesh(coords)
    phic = phi_fn(x1, x2, x3)
    phif = []
    for a in range(3):
        xs = [x1, x2, x3]
        xs[a] = xs[a] - 0.5 * grid.dx[a]
        phif.append(phi_fn(*xs))
    return phic, phif


def _phi_arrays(problem, grid: GridConfig, dtype):
    """φ at cell centers and at the three left-face families, as full
    [Nz,Ny,Nx] arrays (cc_pos semantics, src/cc_pos.c:36-58).

    When the problem enrolls BOTH ``static_grav_pot`` (StaticGravPot)
    and ``shearing_box_pot`` (ShearingBoxPot — e.g. strat.c:362-363),
    the returned φ is their SUM: everywhere except the shearing-mode
    full-dt momentum update the reference applies the two potentials
    through identical gradient expressions back-to-back (sweeps
    :314-342/:371-391, half-step :2167-2227, energies), so the sum is
    equivalent.  The full-dt static-only part goes through
    _phi_static_arrays."""
    phi_fn = getattr(problem, "static_grav_pot", None) if problem else None
    shear_fn = getattr(problem, "shearing_box_pot", None) if problem \
        else None
    if phi_fn is None and shear_fn is None:
        return None, None
    if phi_fn is not None and shear_fn is not None:
        fn = lambda x1, x2, x3: (phi_fn(x1, x2, x3)
                                 + shear_fn(x1, x2, x3))
    else:
        fn = phi_fn if phi_fn is not None else shear_fn
    return _eval_phi(fn, grid, dtype)


def _phi_static_arrays(problem, grid: GridConfig, dtype):
    """StaticGravPot alone — needed by the shearing-box full-dt update,
    where the tidal (ShearingBoxPot) momentum source is replaced by the
    Crank-Nicolson scheme but the static potential still gets the
    standard dhalf-weighted gradient (integrate_3d_ctu.c:2741-2782
    applied independently of the SHEARING_BOX block)."""
    if problem is None:
        return None, None
    phi_fn = getattr(problem, "static_grav_pot", None)
    shear_fn = getattr(problem, "shearing_box_pot", None)
    if phi_fn is None or shear_fn is None:
        # single-potential problems: in shearing mode the lone
        # static_grav_pot plays ShearingBoxPot (hgb.c enrolls only it),
        # so there is no separate static part
        return None, None
    return _eval_phi(phi_fn, grid, dtype)


def _cfast_cons(Uc, axis, sim: SimConfig, Bx=None):
    """cfast() on a physical-order stacked conserved state, for the
    H-correction (integrate_3d_ctu.c:2299-2344; convert_var.c:466-508).
    Hydro-only here (Bx reserved for the MHD variant)."""
    d = Uc[ID]
    di = 1.0 / d
    if sim.adiabatic:
        p = sim.gamma_1 * (Uc[IEN] - 0.5 * (
            Uc[IM1] ** 2 + Uc[IM1 + 1] ** 2 + Uc[IM1 + 2] ** 2) * di)
        asq = sim.gamma * p * di
        return jnp.sqrt(asq)
    return jnp.sqrt(sim.iso_csound2) * jnp.ones_like(d)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi_sg=None, selfg_pars=None, return_fluxes=False, phi=None):
    """One CTU step over all active axes (2 or 3 of them).

    phi_sg: self-gravity potential (padded array) solved from rho at t^n;
    selfg_pars = (four_pi_G, grav_mean_rho).  Source terms follow the
    SELF_GRAVITY blocks of integrate_3d_ctu.c (:348-353, 1225-1273,
    2195-2207, 2790-2936), with the gravitational stress-tensor momentum
    fluxes at full dt.  The selfg_fc old/new-Phi correction is pending.
    """
    assert sim.gas == "hydro", "MHD CTU lives in ctu3d_mhd (pending)"
    axes = [a for a in range(3) if grid.active(a)]
    dtodx = {a: dt / grid.dx[a] for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    # the drivers pass phi in as a jit argument (a trace-time constant of
    # this size would be baked into the executable); fallback for direct
    # calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)

    # === STEPS 1-3: per-axis L/R states + first-pass fluxes =================
    # (sweep variable order via leading-axis permutation only; shifts act on
    # the sweep axis in place — no per-sweep transposes)
    Ulp, Urp, Fp = {}, {}, {}
    for a in axes:
        U1d = vperm_to_sweep(U, a, sim)
        W = cons1d_to_prim1d(U1d, None, sim)
        Wm, Wp_ = reconstruct.lr_states(W, None, dtodx[a], sim, axis=2 - a)
        Wl = _sh(Wp_, -1, a)   # Wl[f] = Wplus[f-1]
        Wr = Wm

        # Step 1c: static gravity for dt/2 (integrate_3d_ctu.c:318-342)
        if phic is not None:
            dVl = dtodx[a] * (phif[a] - _shf(phic, -1, a))
            dVr = dtodx[a] * (phic - phif[a])
            Wl = Wl.at[1].add(-dVl)
            Wr = Wr.at[1].add(-dVr)

        # Step 1c cont: self-gravity for dt/2 — same kick on both states
        # (integrate_3d_ctu.c:348-353)
        if phi_sg is not None:
            dphi = q[a] * (phi_sg - _shf(phi_sg, -1, a))
            Wl = Wl.at[1].add(-dphi)
            Wr = Wr.at[1].add(-dphi)

        Ul = prim1d_to_cons1d(Wl, None, sim)
        Ur = prim1d_to_cons1d(Wr, None, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim)

        Ulp[a] = vperm_from_sweep(Ul, a, sim)
        Urp[a] = vperm_from_sweep(Ur, a, sim)
        Fp[a] = vperm_from_sweep(F, a, sim)

    # === STEPS 5-7: transverse flux-gradient corrections ====================
    # (integrate_3d_ctu.c:971-1065 and cyclic counterparts; in physical
    # order each component receives its own transverse flux difference)
    Ulc, Urc = {}, {}
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    for a in axes:
        dUl = 0.0
        dUr = 0.0
        for b in axes:
            if b == a:
                continue
            dUl = dUl + q[b] * _sh(dF[b], -1, a)
            dUr = dUr + q[b] * dF[b]
        Ulc[a] = Ulp[a] - dUl
        Urc[a] = Urp[a] - dUr

        # Step 5d: gravity cross-terms (integrate_3d_ctu.c:1160-1222)
        if phic is not None:
            for b in axes:
                if b == a:
                    continue
                phir = _shf(phif[b], 1, b)
                phil = phif[b]
                dMb = q[b] * (phir - phil) * U[ID]
                dE = q[b] * (Fp[b][ID] * (phic - phil) +
                             _shf(Fp[b][ID], 1, b) * (phir - phic))
                Urc[a] = Urc[a].at[IM1 + b].add(-dMb)
                Ulc[a] = Ulc[a].at[IM1 + b].add(-_shf(dMb, -1, a))
                if sim.adiabatic:
                    Urc[a] = Urc[a].at[IEN].add(-dE)
                    Ulc[a] = Ulc[a].at[IEN].add(-_shf(dE, -1, a))

        # self-gravity cross terms (:1225-1273): phir/phil = Phi averages
        if phi_sg is not None:
            for b in axes:
                if b == a:
                    continue
                phirS = 0.5 * (phi_sg + _shf(phi_sg, 1, b))
                philS = 0.5 * (phi_sg + _shf(phi_sg, -1, b))
                dMb = q[b] * (phirS - philS) * U[ID]
                dE = q[b] * (Fp[b][ID] * (phi_sg - philS) +
                             _shf(Fp[b][ID], 1, b) * (phirS - phi_sg))
                Urc[a] = Urc[a].at[IM1 + b].add(-dMb)
                Ulc[a] = Ulc[a].at[IM1 + b].add(-_shf(dMb, -1, a))
                if sim.adiabatic:
                    Urc[a] = Urc[a].at[IEN].add(-dE)
                    Ulc[a] = Ulc[a].at[IEN].add(-_shf(dE, -1, a))

    # === STEP 8: cell-centered n+1/2 states (needed with gravity) ===========
    dhalf = None
    if phic is not None or phi_sg is not None:
        dhalf = U[ID]
        for a in axes:
            dhalf = dhalf - q[a] * dF[a][ID]

    # === STEP 9: H-correction etas + final fluxes ===========================
    Fp2 = {}
    etas = {}
    if sim.h_correction:
        for a in axes:
            cfl = _cfast_cons(Ulc[a], a, sim)
            cfr = _cfast_cons(Urc[a], a, sim)
            lam_r = Urc[a][IM1 + a] / Urc[a][ID] + cfr
            lam_l = Ulc[a][IM1 + a] / Ulc[a][ID] - cfl
            etas[a] = 0.5 * jnp.abs(lam_r - lam_l)

    for a in axes:
        etah = None
        if sim.h_correction:
            # (integrate_3d_ctu.c:2352-2365 pattern, generalized per axis)
            etah = etas[a]
            for b in axes:
                if b == a:
                    continue
                eb = etas[b]
                for cand in (eb, _shf(eb, -1, a), _shf(eb, 1, b),
                             _shf(_shf(eb, 1, b), -1, a)):
                    etah = jnp.maximum(etah, cand)
        Ul = vperm_to_sweep(Ulc[a], a, sim)
        Ur = vperm_to_sweep(Urc[a], a, sim)
        Wl = cons1d_to_prim1d(Ul, None, sim)
        Wr = cons1d_to_prim1d(Ur, None, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim, etah=etah)
        Fp2[a] = vperm_from_sweep(F, a, sim)

    # === STEP 11: full-dt source terms at n+1/2 =============================
    Unew = U
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            dMa = dtodx[a] * (phir - phil) * dhalf
            Unew = Unew.at[IM1 + a].add(-dMa)
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) *
                                 (phir - phic))
                Unew = Unew.at[IEN].add(-dE)

    # Step 11b: self-gravity stress-tensor momentum fluxes + mass-flux-
    # weighted energy source (integrate_3d_ctu.c:2790-2936)
    if phi_sg is not None:
        four_pi_G, grav_mean_rho = selfg_pars
        grad = {}
        for b in axes:
            # g_b at the LEFT b-face of each cell: (Phi[-1_b]-Phi)/dx_b
            grad[b] = (_shf(phi_sg, -1, b) - phi_sg) / grid.dx[b]
        for a in axes:
            phil = 0.5 * (_shf(phi_sg, -1, a) + phi_sg)
            phir = 0.5 * (phi_sg + _shf(phi_sg, 1, a))
            gl = {}
            gr = {}
            gl[a] = grad[a]
            gr[a] = _shf(grad[a], 1, a)
            for b in axes:
                if b == a:
                    continue
                # transverse gradient at the a-face: average of the
                # centered d/dx_b differences of the two adjacent cells
                cen = 0.5 * (_shf(phi_sg, -1, b) - _shf(phi_sg, 1, b))                     / grid.dx[b]
                gl[b] = 0.5 * (_shf(cen, -1, a) + cen)
                gr[b] = 0.5 * (cen + _shf(cen, 1, a))
            others = [b for b in axes if b != a]
            gsq_l = gl[a] ** 2
            gsq_r = gr[a] ** 2
            for b in others:
                gsq_l = gsq_l - gl[b] ** 2
                gsq_r = gsq_r - gr[b] ** 2
            flx_al = 0.5 * gsq_l / four_pi_G + grav_mean_rho * phil
            flx_ar = 0.5 * gsq_r / four_pi_G + grav_mean_rho * phir
            Unew = Unew.at[IM1 + a].add(-dtodx[a] * (flx_ar - flx_al))
            for b in others:
                fl = gl[a] * gl[b] / four_pi_G
                fr = gr[a] * gr[b] / four_pi_G
                Unew = Unew.at[IM1 + b].add(-dtodx[a] * (fr - fl))
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phi_sg - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phi_sg))
                Unew = Unew.at[IEN].add(-dE)

    # === STEP 12: conservative update =======================================
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    # splice: only active cells take the update (ghosts refreshed by bvals)
    sl = (slice(None),) + grid.interior()
    Uout = U.at[sl].set(Unew[sl])
    out = state.replace(U=Uout)
    return (out, Fp2) if return_fluxes else out
