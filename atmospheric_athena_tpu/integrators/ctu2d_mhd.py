"""2D CTU + constrained transport for MHD
(reference: src/integrators/integrate_2d_ctu.c).

2D MHD is structurally different from 3D: only emf3 exists; B1i/B2i evolve
by CT on emf3 corners (:605-626, :1291-1319), the out-of-plane B3c evolves
by plain flux differencing like a scalar (:1410-1436 step 12a/b), and the
W/interface MHD source terms use the plain ∂B1i/∂x1 (∂B2i/∂x2) divergence
pieces without the 3D min-mod splittings (:228-242, :497-505, :685-724).

x1/x2 are the active axes (grid Nx3 == 1).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .ctu3d import _phi_arrays, _sh, _shf
from .sweep import vperm_from_sweep, vperm_to_sweep


def _upwind(sel, lo, hi):
    avg = 0.5 * (lo + hi)
    return jnp.where(sel > 0.0, lo, jnp.where(sel < 0.0, hi, avg))


def _emf3_corner(F1d, F1By, F2d, F2Bz, ecc):
    """Gardiner-Stone emf3 corner integration, 2D variant
    (integrate_2d_ctu.c integrate_emf3_corner).  Signs: x1Flux.By = −E3,
    x2Flux.Bz = +E3.  Corner (i-1/2, j-1/2) at index [j][i]."""
    # emf_l2 / emf_r2 : anchored on −x1F.By at (j-1) and (j)
    l2 = -_shf(F1By, -1, 1) + _upwind(
        _shf(F1d, -1, 1),
        _shf(F2Bz, -1, 0) - _shf(_shf(ecc, -1, 0), -1, 1),
        F2Bz - _shf(ecc, -1, 1))
    r2 = -F1By + _upwind(
        F1d,
        _shf(F2Bz, -1, 0) - _shf(ecc, -1, 0),
        F2Bz - ecc)
    # emf_l1 / emf_r1 : anchored on x2F.Bz at (i-1) and (i)
    l1 = _shf(F2Bz, -1, 0) + _upwind(
        _shf(F2d, -1, 0),
        -_shf(F1By, -1, 1) - _shf(_shf(ecc, -1, 1), -1, 0),
        -F1By - _shf(ecc, -1, 0))
    r1 = F2Bz + _upwind(
        F2d,
        -_shf(F1By, -1, 1) - _shf(ecc, -1, 1),
        -F1By - ecc)
    return 0.25 * (l1 + r1 + l2 + r2)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None, return_fluxes=False):
    assert sim.mhd and grid.ndim == 2 and grid.active(0) and grid.active(1)
    axes = [0, 1]
    dtodx = {a: dt / grid.dx[a] for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}
    hdt = 0.5 * dt

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i]
    # the drivers pass phi in as a jit argument (a trace-time constant
    # of this size would be baked into the executable); fallback for
    # direct calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)
    ib = 5 if sim.adiabatic else 4
    d = U[ID]
    V = [U[IM1 + c] / d for c in range(3)]
    db = [(_shf(Bi[a], 1, a) - Bi[a]) / grid.dx[a] for a in axes]

    # === STEPS 1-2: L/R states + first-pass fluxes ==========================
    # Sweep slice for a=0: (d,M1,M2,M3,E,B2,B3,s); a=1: (d,M2,M3,M1,E,B3,B1,s)
    Ulp, Urp, Fp = {}, {}, {}
    Byzl, Byzr, FByz = {}, {}, {}
    for a in axes:
        b = 1 - a
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        U1d = vperm_to_sweep(U, a, sim)
        Bxc = Bcc[a]
        U1d = jnp.concatenate([U1d[:ib], Bcc[a1][None], Bcc[a2][None],
                               U1d[ib:]], 0)
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim, axis=2 - a)
        Wl = _sh(Wp_, -1, a)
        Wr = Wm

        # W MHD source: in-plane transverse field B_b += hdt·V_b·db_a
        # (x1: Wl.By i.e. B2, :228-242; x2: Wl.Bz i.e. B1, :497-505)
        slot = ib if a == 0 else ib + 1   # B2 is By of x1; B1 is Bz of x2
        src = V[b] * db[a] * hdt
        Wl = Wl.at[slot].add(_shf(src, -1, a))
        Wr = Wr.at[slot].add(src)

        if phic is not None:
            Wl = Wl.at[1].add(-dtodx[a] * (phif[a] - _shf(phic, -1, a)))
            Wr = Wr.at[1].add(-dtodx[a] * (phic - phif[a]))

        Bxi = Bi[a]
        Ul = prim1d_to_cons1d(Wl, Bxi, sim)
        Ur = prim1d_to_cons1d(Wr, Bxi, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)

        def split(X):
            return jnp.concatenate([X[:ib], X[ib + 2:]], 0), X[ib:ib + 2]
        Ulh, bl = split(Ul)
        Urh, br = split(Ur)
        Fh, fb = split(F)
        Ulp[a] = vperm_from_sweep(Ulh, a, sim)
        Urp[a] = vperm_from_sweep(Urh, a, sim)
        Fp[a] = vperm_from_sweep(Fh, a, sim)
        Byzl[a], Byzr[a], FByz[a] = bl, br, fb

    # === STEP 4: emf3 corners + half-dt CT ==================================
    emf3_cc = (Bcc[0] * V[1] - Bcc[1] * V[0])
    emf3P = _emf3_corner(Fp[0][ID], FByz[0][0], Fp[1][ID], FByz[1][1],
                         emf3_cc)
    B1f = Bi[0] - q[1] * (_shf(emf3P, 1, 1) - emf3P)
    B2f = Bi[1] + q[0] * (_shf(emf3P, 1, 0) - emf3P)
    Bf = [B1f, B2f]

    # === STEPS 5-6: transverse corrections ==================================
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    dFB3 = {0: _shf(FByz[0][1], 1, 0) - FByz[0][1],   # x1-flux of B3
            1: _shf(FByz[1][0], 1, 1) - FByz[1][0]}   # x2-flux of B3
    Ulc, Urc, Byzlc, Byzrc = {}, {}, {}, {}
    for a in axes:
        b = 1 - a
        dUl = q[b] * _sh(dF[b], -1, a)
        dUr = q[b] * dF[b]
        Ulc[a] = Ulp[a] - dUl
        Urc[a] = Urp[a] - dUr

        # out-of-plane B3 interface state corrected by the other axis' B3
        # flux (:649, :668, :817, :828); B3 is the Bz slot of the x1 sweep
        # and the By slot of the x2 sweep
        i3 = 1 if a == 0 else 0
        iip = 1 - i3  # in-plane slot
        b3l = Byzl[a][i3] - q[b] * _shf(dFB3[b], -1, a)
        b3r = Byzr[a][i3] - q[b] * dFB3[b]

        # 5c/6c MHD source terms: M_c += hdt·B_c·db_a; B3 += hdt·V3·db_a;
        # E += hdt·B3·V3·db_a (:685-724 and x2 analogue)
        srcM = [hdt * Bcc[c] * db[a] for c in range(3)]
        srcB3 = hdt * V[2] * db[a]
        srcE = hdt * Bcc[2] * V[2] * db[a]
        for c in range(3):
            Urc[a] = Urc[a].at[IM1 + c].add(srcM[c])
            Ulc[a] = Ulc[a].at[IM1 + c].add(_shf(srcM[c], -1, a))
        b3r = b3r + srcB3
        b3l = b3l + _shf(srcB3, -1, a)
        if sim.adiabatic:
            Urc[a] = Urc[a].at[IEN].add(srcE)
            Ulc[a] = Ulc[a].at[IEN].add(_shf(srcE, -1, a))

        # gravity cross terms (:726-760 pattern, same as 3D)
        if phic is not None:
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

        # in-plane transverse field keeps its traced value
        bil = Byzl[a][iip]
        bir = Byzr[a][iip]
        Byzlc[a] = (bil, b3l) if a == 0 else (b3l, bil)
        Byzrc[a] = (bir, b3r) if a == 0 else (b3r, bir)

    # === STEP 8: n+1/2 cell-centered EMF ====================================
    dhalf = U[ID] - q[0] * dF[0][ID] - q[1] * dF[1][ID]
    Mh = []
    for c in range(3):
        m = U[IM1 + c] - q[0] * dF[0][IM1 + c] - q[1] * dF[1][IM1 + c]
        Mh.append(m)
    if phic is not None:
        for c in axes:
            Mh[c] = Mh[c] - q[c] * (_shf(phif[c], 1, c) - phif[c]) * U[ID]
    B1ch = 0.5 * (B1f + _shf(B1f, 1, 0))
    B2ch = 0.5 * (B2f + _shf(B2f, 1, 1))
    emf3_cc_h = (B1ch * Mh[1] - B2ch * Mh[0]) / dhalf

    # === STEP 9: final fluxes ===============================================
    # H-correction etas (integrate_2d_ctu.c:1219-1245; same 5-point stencil
    # per axis as 3D — reuse the generic helper over the two active axes)
    if sim.h_correction:
        from .ctu3d_mhd import _hcorr_etas
        etah_all = _hcorr_etas(Ulc, Urc, Byzlc, Byzrc, Bf, axes, sim)
    else:
        etah_all = None

    Fp2, FByz2 = {}, {}
    for a in axes:
        Ulh = vperm_to_sweep(Ulc[a], a, sim)
        Urh = vperm_to_sweep(Urc[a], a, sim)
        Ul = jnp.concatenate([Ulh[:ib], Byzlc[a][0][None],
                              Byzlc[a][1][None], Ulh[ib:]], 0)
        Ur = jnp.concatenate([Urh[:ib], Byzrc[a][0][None],
                              Byzrc[a][1][None], Urh[ib:]], 0)
        Bxi = Bf[a]
        Wl = cons1d_to_prim1d(Ul, Bxi, sim)
        Wr = cons1d_to_prim1d(Ur, Bxi, sim)
        etah = etah_all[a] if etah_all is not None else None
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim, etah=etah)
        Fp2[a] = vperm_from_sweep(
            jnp.concatenate([F[:ib], F[ib + 2:]], 0), a, sim)
        FByz2[a] = F[ib:ib + 2]

    # === STEP 10: full-dt CT ================================================
    emf3C = _emf3_corner(Fp2[0][ID], FByz2[0][0], Fp2[1][ID], FByz2[1][1],
                         emf3_cc_h)
    B1new = Bi[0] - dtodx[1] * (_shf(emf3C, 1, 1) - emf3C)
    B2new = Bi[1] + dtodx[0] * (_shf(emf3C, 1, 0) - emf3C)

    # === STEP 11: full-dt source terms ======================================
    Unew = U
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew = Unew.at[IM1 + a].add(
                -dtodx[a] * (phir - phil) * dhalf)
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic))
                Unew = Unew.at[IEN].add(-dE)

    # === STEP 12: conservative update + B3c differencing + B averages ======
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])
    dFB3f = {0: _shf(FByz2[0][1], 1, 0) - FByz2[0][1],
             1: _shf(FByz2[1][0], 1, 1) - FByz2[1][0]}
    B3new = Bcc[2] - dtodx[0] * dFB3f[0] - dtodx[1] * dFB3f[1]

    sl = (slice(None),) + grid.interior()
    Uout = U.at[sl].set(Unew[sl])

    Biout = []
    for a, Bn in ((0, B1new), (1, B2new)):
        idx = []
        for dim, ax in enumerate((2, 1, 0)):
            upper = grid.hi(ax) + 1 + (1 if ax == a else 0)
            idx.append(slice(grid.lo(ax), upper))
        Biout.append(Bi[a].at[tuple(idx)].set(Bn[tuple(idx)]))

    Bcc_new = jnp.stack([0.5 * (Biout[0] + _shf(Biout[0], 1, 0)),
                         0.5 * (Biout[1] + _shf(Biout[1], 1, 1)),
                         B3new])
    Bcc_out = Bcc.at[sl].set(Bcc_new[sl])

    # B3i kept equal to B3c for consistency (1D/2D convention,
    # integrate_1d_ctu.c:548-550 analogue)
    kw = {}
    if state.B3i is not None:
        kw["B3i"] = state.B3i.at[grid.interior()].set(B3new[grid.interior()])
    out = state.replace(U=Uout, Bcc=Bcc_out, B1i=Biout[0], B2i=Biout[1],
                        **kw)
    if return_fluxes:
        return out, (Fp2, FByz2, [None, None, emf3C])
    return out
