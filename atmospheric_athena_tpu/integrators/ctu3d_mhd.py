"""3D CTU + constrained transport for MHD
(reference: src/integrators/integrate_3d_ctu.c, MHD paths).

Follows the same 12-step skeleton as ctu3d.py but carries, per sweep axis a:
  - interface hydro states in PHYSICAL order [ncons, ...],
  - interface transverse fields (By, Bz) = (B[a+1], B[a+2]) in sweep order,
  - the face-centered normal field B_a (B{a+1}_x{a+1}Face), CT-updated at
    half-dt between the first and final Riemann solves.

Key MHD machinery, each citing its reference lines:
  - W L/R "MHD source terms" from ∇·B splittings (:250-312)
  - cell-centered EMFs + Gardiner–Stone corner upwinding (:899-970,
    integrate_emf*_corner :3555-3623, sign map :3558-3564)
  - half-dt face-B CT update (:931-968), EMF corrections of interface
    By/Bz (:993-995, 1037-1039 and cyclic), db/mdb source terms
    (:1067-1160 and cyclic)
  - n+1/2 cell-centered EMFs from dhalf/M*h/B*ch (:2102-2282)
  - full-dt CT update (:2439-2528) and B*c = face averages (:3055-3069)
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


def _minmod_pair(a, b):
    """min_mod(a, b): 0 unless same sign, else the smaller magnitude —
    via the reference's explicit branch structure (:1089-1106 uses
    mdb = min_mod(-db1, db2))."""
    same = a * b > 0.0
    return jnp.where(same, jnp.where(jnp.abs(a) < jnp.abs(b), a, b), 0.0)


def _l_clamped(db_a, db_c):
    """The l2/l3 factors of step 1b (:261-274): sign-gated on db_a."""
    pos = db_a >= 0.0
    lp = jnp.maximum(jnp.minimum(db_a, -db_c), 0.0)
    lm = jnp.minimum(jnp.maximum(db_a, -db_c), 0.0)
    return jnp.where(pos, lp, lm)


#: debug capture: set to a dict to record intermediates (testing only)
DEBUG = None


def _dbg(**kw):
    if DEBUG is not None:
        DEBUG.update(kw)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None, return_fluxes=False, phi_static=None):
    assert sim.mhd and grid.ndim == 3
    axes = [0, 1, 2]
    dtodx = {a: dt / grid.dx[a] for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}
    dxi = {a: 1.0 / grid.dx[a] for a in axes}
    hdt = 0.5 * dt

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i]
    # the drivers pass phi in as a jit argument (a trace-time constant
    # of this size would be baked into the executable); fallback for
    # direct calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)
    if phi_static is None and sim.shearing_box:
        from .ctu3d import _phi_static_arrays
        phi_static = _phi_static_arrays(problem, grid, U.dtype)
    phic_s, phif_s = phi_static if phi_static is not None else (None, None)

    d = U[ID]
    V = [U[IM1 + c] / d for c in range(3)]

    # face-B divergence pieces db_c[cell] = (B_ci[+1_c] - B_ci)/dx_c (:257-259)
    db = [(_shf(Bi[c], 1, c) - Bi[c]) * dxi[c] for c in axes]

    # === STEPS 1-3: per-axis L/R states + first-pass fluxes =================
    Ulp, Urp, Fp = {}, {}, {}          # physical-order hydro parts
    Byzl, Byzr, FByz = {}, {}, {}      # sweep-order (By, Bz) pairs
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        U1d = vperm_to_sweep(U, a, sim)
        Bxc = Bcc[a]
        ib = 5 if sim.adiabatic else 4
        U1d = jnp.concatenate([
            U1d[:ib], Bcc[a1][None], Bcc[a2][None], U1d[ib:]], 0)
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim, axis=2 - a)
        Wl = _sh(Wp_, -1, a)
        Wr = Wm

        # MHD W source terms for dt/2 (:250-312): By += hdt*V[a1]*l_{a1},
        # Bz += hdt*V[a2]*l_{a2}, with l_c sign-gated minmod of (db_a, -db_c)
        l1 = _l_clamped(db[a], db[a1])
        l2 = _l_clamped(db[a], db[a2])
        srcBy = V[a1] * l1 * hdt
        srcBz = V[a2] * l2 * hdt
        Wl = Wl.at[ib].add(_shf(srcBy, -1, a))
        Wl = Wl.at[ib + 1].add(_shf(srcBz, -1, a))
        Wr = Wr.at[ib].add(srcBy)
        Wr = Wr.at[ib + 1].add(srcBz)

        # static gravity dt/2 (:318-342); for shearing boxes phi holds
        # the tidal ShearingBoxPot (same discrete form)
        if phic is not None:
            Wl = Wl.at[1].add(-dtodx[a] * (phif[a] - _shf(phic, -1, a)))
            Wr = Wr.at[1].add(-dtodx[a] * (phic - phif[a]))

        # shearing-box Coriolis kick on the x1 interface states
        # (:379-403, non-FARGO, full dt, from the unreconstructed W)
        if sim.shearing_box and a == 0:
            om = sim.omega0
            Wl = Wl.at[1].add(dt * om * _sh(W, -1, a)[2])
            Wr = Wr.at[1].add(dt * om * W[2])
            if sim.fargo:
                # orbital advection handles the background shear; only
                # the epicyclic part remains (:395-397)
                cf = hdt * (sim.qshear - 2.0) * om
                Wl = Wl.at[2].add(cf * _sh(W, -1, a)[1])
                Wr = Wr.at[2].add(cf * W[1])
            else:
                Wl = Wl.at[2].add(-dt * om * _sh(W, -1, a)[1])
                Wr = Wr.at[2].add(-dt * om * W[1])

        Bxi = Bi[a]  # face field at interface f = t^n B_ai (:217-218)
        Ul = prim1d_to_cons1d(Wl, Bxi, sim)
        Ur = prim1d_to_cons1d(Wr, Bxi, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)

        def split(X):
            hyd = jnp.concatenate([X[:ib], X[ib + 2:]], 0)
            return hyd, X[ib:ib + 2]
        Ulh, bl = split(Ul)
        Urh, br = split(Ur)
        Fh, fb = split(F)
        Ulp[a] = vperm_from_sweep(Ulh, a, sim)
        Urp[a] = vperm_from_sweep(Urh, a, sim)
        Fp[a] = vperm_from_sweep(Fh, a, sim)
        Byzl[a], Byzr[a], FByz[a] = bl, br, fb

    # === STEP 4: cell-centered EMFs at t^n + corner EMFs + half-dt CT =======
    emf_cc = _emf_cc(Bcc, U[IM1] / d, U[IM1 + 1] / d, U[IM1 + 2] / d)
    emf = [_corner_emf(e, Fp, FByz, emf_cc) for e in axes]
    Bf = []
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Bf.append(Bi[a]
                  + q[a2] * (_shf(emf[a1], 1, a2) - emf[a1])
                  - q[a1] * (_shf(emf[a2], 1, a1) - emf[a2]))

    # === STEPS 5-7: transverse corrections ==================================
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    Ulc, Urc = {}, {}
    Byzlc, Byzrc = {}, {}
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        dUl = 0.0
        dUr = 0.0
        for b in axes:
            if b == a:
                continue
            dUl = dUl + q[b] * _sh(dF[b], -1, a)
            dUr = dUr + q[b] * dF[b]
        Ulc[a] = Ulp[a] - dUl
        Urc[a] = Urp[a] - dUr

        # EMF-gradient corrections of interface By/Bz (:993-995, 1037-1039):
        #   By(=B[a1]) -= q_{a2}·avg over a1-pair of d_{a2} emf_a
        #   Bz(=B[a2]) += q_{a1}·avg over a2-pair of d_{a1} emf_a
        dby = 0.5 * q[a2] * ((_shf(emf[a], 1, a2) - emf[a]) +
                             _shf(_shf(emf[a], 1, a2) - emf[a], 1, a1))
        dbz = 0.5 * q[a1] * ((_shf(emf[a], 1, a1) - emf[a]) +
                             _shf(_shf(emf[a], 1, a1) - emf[a], 1, a2))
        byr = Byzr[a][0] - dby
        bzr = Byzr[a][1] + dbz
        byl = Byzl[a][0] - _shf(dby, -1, a)
        bzl = Byzl[a][1] + _shf(dbz, -1, a)

        # db/mdb source terms (:1067-1160 and cyclic analogues)
        mdb1 = _minmod_pair(-db[a], db[a1])
        mdb2 = _minmod_pair(-db[a], db[a2])
        srcM = [hdt * Bcc[c] * db[a] for c in range(3)]
        srcBy = hdt * V[a1] * (-mdb2)
        srcBz = hdt * V[a2] * (-mdb1)
        srcE = hdt * (Bcc[a1] * V[a1] * (-mdb2) +
                      Bcc[a2] * V[a2] * (-mdb1))
        for c in range(3):
            Urc[a] = Urc[a].at[IM1 + c].add(srcM[c])
            Ulc[a] = Ulc[a].at[IM1 + c].add(_shf(srcM[c], -1, a))
        byr = byr + srcBy
        bzr = bzr + srcBz
        byl = byl + _shf(srcBy, -1, a)
        bzl = bzl + _shf(srcBz, -1, a)
        if sim.adiabatic:
            Urc[a] = Urc[a].at[IEN].add(srcE)
            Ulc[a] = Ulc[a].at[IEN].add(_shf(srcE, -1, a))

        # gravity cross terms (:1160-1222); with a shearing box phi is
        # the tidal potential and the same form applies (:1588-1636)
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

        # shearing-box Coriolis on the x2/x3 face states
        # (:1638-1651, :2053-2064, non-FARGO; physical components)
        if sim.shearing_box and a != 0:
            om = sim.omega0
            Urc[a] = Urc[a].at[IM1].add(dt * om * U[IM1 + 1])
            Ulc[a] = Ulc[a].at[IM1].add(
                dt * om * _shf(U[IM1 + 1], -1, a))
            cf = hdt * (sim.qshear - 2.0) * om if sim.fargo else -dt * om
            Urc[a] = Urc[a].at[IM1 + 1].add(cf * U[IM1])
            Ulc[a] = Ulc[a].at[IM1 + 1].add(
                cf * _shf(U[IM1], -1, a))

        Byzlc[a] = (byl, bzl)
        Byzrc[a] = (byr, bzr)

    # === STEP 8: n+1/2 cell-centered states and EMFs ========================
    dhalf = U[ID]
    for a in axes:
        dhalf = dhalf - q[a] * dF[a][ID]
    Mh = []
    for c in range(3):
        m = U[IM1 + c]
        for a in axes:
            m = m - q[a] * dF[a][IM1 + c]
        Mh.append(m)
    if phic is not None:
        for c in range(3):
            Mh[c] = Mh[c] - q[c] * (_shf(phif[c], 1, c) - phif[c]) * U[ID]
    if sim.shearing_box:
        # (:2222-2227)
        Mh[0] = Mh[0] + dt * sim.omega0 * U[IM1 + 1]
        if sim.fargo:
            Mh[1] = Mh[1] + hdt * (sim.qshear - 2.0) * sim.omega0 * \
                U[IM1]
        else:
            Mh[1] = Mh[1] - dt * sim.omega0 * U[IM1]
    Bch = [0.5 * (Bf[a] + _shf(Bf[a], 1, a)) for a in axes]
    emf_cc_h = _emf_cc(Bch, Mh[0] / dhalf, Mh[1] / dhalf, Mh[2] / dhalf)

    # === STEP 9: final fluxes from corrected states =========================
    etah_all = _hcorr_etas(Ulc, Urc, Byzlc, Byzrc, Bf, axes, sim) \
        if sim.h_correction else None

    Fp2, FByz2 = {}, {}
    for a in axes:
        ib = 5 if sim.adiabatic else 4
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
        hyd = jnp.concatenate([F[:ib], F[ib + 2:]], 0)
        Fp2[a] = vperm_from_sweep(hyd, a, sim)
        FByz2[a] = F[ib:ib + 2]

    _dbg(Fp2=Fp2, FByz2=FByz2, emf_cc_h=emf_cc_h, Bf=Bf, dhalf=dhalf,
         Mh=Mh, Bch=Bch, emf_n=emf, Fp=Fp, FByz=FByz,
         Ulc=Ulc, Urc=Urc, Byzlc=Byzlc, Byzrc=Byzrc)

    # === STEP 10: full-dt CT ================================================
    emf2_ = [_corner_emf(e, Fp2, FByz2, emf_cc_h) for e in axes]
    if sim.shearing_box:
        # average the y-EMF on the two x1 boundary faces with the
        # remapped opposite face so net Bz is conserved (:2451-2480)
        from ..shearing import remap_ey
        emf2_[1] = remap_ey(emf2_[1], sim, grid, state.time)
    _dbg(emf_h=emf2_)
    Binew = []
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Binew.append(Bi[a]
                     + dtodx[a2] * (_shf(emf2_[a1], 1, a2) - emf2_[a1])
                     - dtodx[a1] * (_shf(emf2_[a2], 1, a1) - emf2_[a2]))

    # === STEP 11: full-dt source terms ======================================
    Unew = U
    if sim.shearing_box:
        # Crank-Nicolson Coriolis + tidal momentum update on the
        # y-momentum FLUCTUATION dM2 = M2 + q*Omega*x1*d (:2653-2710,
        # non-FARGO), plus the fixed-potential energy update (identical
        # in form to the static-gravity one)
        import numpy as np
        om = sim.omega0
        qsh = sim.qshear
        om_dt = om * dt
        fact = om_dt / (2.0 + (2.0 - qsh) * om_dt * om_dt)
        qom = qsh * om
        x1c = jnp.asarray(np.asarray(grid.cc_coords(0), U.dtype)
                          ).reshape(1, 1, -1)
        x1l = x1c - 0.5 * grid.dx[0]
        x1r = x1c + 0.5 * grid.dx[0]

        M1n = U[IM1]
        if sim.fargo:
            # with orbital advection the evolved M2 IS the fluctuation
            # (:2664-2685 FARGO branches)
            dM2n = U[IM1 + 1]
            fl1 = Fp2[0][IM1 + 1]
            fr1 = _sh(Fp2[0], 1, 0)[IM1 + 1]
            fl2 = Fp2[1][IM1 + 1]
            fr2 = _sh(Fp2[1], 1, 1)[IM1 + 1]
            fl3 = Fp2[2][IM1 + 1]
            fr3 = _sh(Fp2[2], 1, 2)[IM1 + 1]
        else:
            dM2n = U[IM1 + 1] + qom * x1c * U[ID]
            fl1 = Fp2[0][IM1 + 1] + qom * x1l * Fp2[0][ID]
            fr1 = _sh(Fp2[0], 1, 0)[IM1 + 1] + qom * x1r * \
                _sh(Fp2[0], 1, 0)[ID]
            fl2 = Fp2[1][IM1 + 1] + qom * x1c * Fp2[1][ID]
            fr2 = _sh(Fp2[1], 1, 1)[IM1 + 1] + qom * x1c * \
                _sh(Fp2[1], 1, 1)[ID]
            fl3 = Fp2[2][IM1 + 1] + qom * x1c * Fp2[2][ID]
            fr3 = _sh(Fp2[2], 1, 2)[IM1 + 1] + qom * x1c * \
                _sh(Fp2[2], 1, 2)[ID]
        M1e = (M1n
               - q[0] * (_sh(Fp2[0], 1, 0)[IM1] - Fp2[0][IM1])
               - q[1] * (_sh(Fp2[1], 1, 1)[IM1] - Fp2[1][IM1])
               - q[2] * (_sh(Fp2[2], 1, 2)[IM1] - Fp2[2][IM1]))
        dM2e = dM2n - q[0] * (fr1 - fl1) - q[1] * (fr2 - fl2)             - q[2] * (fr3 - fl3)
        Unew = Unew.at[IM1].add(
            (4.0 * dM2e + 2.0 * (qsh - 2.0) * om_dt * M1e) * fact)
        Unew = Unew.at[IM1 + 1].add(
            2.0 * (qsh - 2.0) * (M1e + om_dt * dM2e) * fact)
        if not sim.fargo:
            Unew = Unew.at[IM1 + 1].add(
                -0.5 * qsh * om_dt *
                (Fp2[0][ID] + _sh(Fp2[0], 1, 0)[ID]))
        # StaticGravPot full-dt momentum (strat.c's VertGrav): applied
        # with dhalf independently of the CN tidal update
        # (integrate_3d_ctu.c:2741-2782 runs for any enrolled
        # StaticGravPot; the CN block only replaces ShearingBoxPot)
        if phic_s is not None:
            for a in axes:
                phir = _shf(phif_s[a], 1, a)
                phil = phif_s[a]
                Unew = Unew.at[IM1 + a].add(
                    -dtodx[a] * (phir - phil) * dhalf)
        if phic is not None and sim.adiabatic:
            for a in axes:
                phir = _shf(phif[a], 1, a)
                phil = phif[a]
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic))
                Unew = Unew.at[IEN].add(-dE)
    elif phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew = Unew.at[IM1 + a].add(
                -dtodx[a] * (phir - phil) * dhalf)
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic))
                Unew = Unew.at[IEN].add(-dE)

    # === STEP 12: conservative update + B*c from faces ======================
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    sl = (slice(None),) + grid.interior()
    Uout = U.at[sl].set(Unew[sl])

    # splice face fields over active faces (is..ie+1 along own axis,
    # :2461-2480 boundary rows included)
    Biout = []
    for a in axes:
        lo = [grid.lo(ax) for ax in (2, 1, 0)]
        hi = [grid.hi(ax) for ax in (2, 1, 0)]
        idx = []
        for dim, ax in enumerate((2, 1, 0)):
            upper = hi[dim] + 1 + (1 if ax == a else 0)
            idx.append(slice(lo[dim], upper))
        Biout.append(Bi[a].at[tuple(idx)].set(Binew[a][tuple(idx)]))

    Bcc_new = jnp.stack([0.5 * (Biout[a] + _shf(Biout[a], 1, a))
                         for a in axes])
    Bcc_out = Bcc.at[sl].set(Bcc_new[sl])

    out = state.replace(U=Uout, Bcc=Bcc_out, B1i=Biout[0], B2i=Biout[1],
                        B3i=Biout[2])
    if return_fluxes:
        # (hydro fluxes, transverse-B fluxes in sweep order, final
        # corner EMFs [E1,E2,E3]) for the SMR RestrictCorrect
        # (smr.c:3071-3220 myFlx/myEMF storage)
        return out, (Fp2, FByz2, emf2_)
    return out


def _emf_cc(B, V1, V2, V3):
    """Cell-centered EMFs (B×v components; :911-919)."""
    return [B[1] * V3 - B[2] * V2,
            B[2] * V1 - B[0] * V3,
            B[0] * V2 - B[1] * V1]


def _corner_emf(e, Fp, FByz, emf_cc):
    """Gardiner–Stone corner EMF for component e
    (integrate_emf1_corner and cyclic siblings, :3566-3623).

    b=(e+1)%3, c=(e+2)%3.  The b-sweep's By flux = −EMF_e; the c-sweep's Bz
    flux = +EMF_e (sign map :3558-3564).  Face-to-corner gradients are
    upwinded on the transverse mass-flux sign, ties averaged.
    """
    b, c = (e + 1) % 3, (e + 2) % 3
    Fb_d = Fp[b][ID]
    Fc_d = Fp[c][ID]
    Fb_By = FByz[b][0]        # flux along b of B[(b+1)%3]=B_c ... = -EMF_e
    Fc_Bz = FByz[c][1]        # flux along c of B[(c+2)%3]=B_e?  = +EMF_e
    ecc = emf_cc[e]

    def upwind(sel, lo, hi):
        avg = 0.5 * (lo + hi)
        return jnp.where(sel > 0.0, lo, jnp.where(sel < 0.0, hi, avg))

    # de_l3 / de_r3 : gradients along b, upwinded on Fb_d sign
    de_l3 = upwind(_shf(Fb_d, -1, c),
                   _shf(Fc_Bz, -1, b) - _shf(_shf(ecc, -1, c), -1, b),
                   Fc_Bz - _shf(ecc, -1, c))
    de_r3 = upwind(Fb_d,
                   _shf(Fc_Bz, -1, b) - _shf(ecc, -1, b),
                   Fc_Bz - ecc)
    # de_l2 / de_r2 : gradients along c, upwinded on Fc_d sign
    de_l2 = upwind(_shf(Fc_d, -1, b),
                   -_shf(Fb_By, -1, c) - _shf(_shf(ecc, -1, b), -1, c),
                   -Fb_By - _shf(ecc, -1, b))
    de_r2 = upwind(Fc_d,
                   -_shf(Fb_By, -1, c) - _shf(ecc, -1, c),
                   -Fb_By - ecc)

    return 0.25 * (Fc_Bz + _shf(Fc_Bz, -1, b)
                   - Fb_By - _shf(Fb_By, -1, c)
                   + de_l2 + de_r2 + de_l3 + de_r3)


def _hcorr_etas(Ulc, Urc, Byzlc, Byzrc, Bf, axes, sim):
    """H-correction eta arrays from MHD cfast of the corrected interface
    states (:2299-2344), then the 9-point max per axis as in ctu3d."""
    from ..eos import cfast as cfast1d

    etas = {}
    for a in axes:
        ib = 5 if sim.adiabatic else 4

        def pack(Uh, byz):
            Us = vperm_to_sweep(Uh, a, sim)
            return jnp.concatenate([Us[:ib], byz[0][None],
                                    byz[1][None], Us[ib:]], 0)
        Ul = pack(Ulc[a], Byzlc[a])
        Ur = pack(Urc[a], Byzrc[a])
        Bxi = Bf[a]
        cfl = cfast1d(Ul, Bxi, sim)
        cfr = cfast1d(Ur, Bxi, sim)
        lam_r = Ur[1] / Ur[0] + cfr
        lam_l = Ul[1] / Ul[0] - cfl
        etas[a] = 0.5 * jnp.abs(lam_r - lam_l)

    out = {}
    for a in axes:
        etah = etas[a]
        for b in axes:
            if b == a:
                continue
            eb = etas[b]
            for cand in (eb, _shf(eb, -1, a), _shf(eb, 1, b),
                         _shf(_shf(eb, 1, b), -1, a)):
                etah = jnp.maximum(etah, cand)
        out[a] = etah
    return out
