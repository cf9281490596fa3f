"""3D van Leer (MUSCL-Hancock) predictor-corrector integrator
(reference: src/integrators/integrate_3d_vl.c, step map :145-1436).

Steps: (1-3) first-order donor-cell fluxes at t^n; (4) half-dt CT [MHD];
(5) half-dt conservative update -> Uhalf; (6) half-dt source terms;
(7-9) second-order L/R states from Uhalf (no characteristic tracing —
lr_states' non-CTU branch); (10) full fluxes; (11) full-dt CT [MHD];
(12) full-dt source terms using Uhalf; (13) conservative update;
(14) first-order flux correction (FOFC) of cells with negative d or P.

The vectorized FOFC is the divergence-form equivalent of the reference's
FixCell (integrate_3d_vl.c:1995-2190): every face (and corner EMF) adjacent
to a bad cell reverts to the saved predictor flux/EMF, applied as a masked
flux-difference correction — conservation-preserving, including the
neighbor adjustments.  (The reference's x3FD_kp1 reads x2Flux — a
transcription bug not reproduced here.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .ctu3d import _phi_arrays, _sh, _shf
from .ctu3d_mhd import _corner_emf, _emf_cc
from .sweep import vperm_from_sweep, vperm_to_sweep

#: debug capture (testing only)
DEBUG = None


def _dbg(**kw):
    if DEBUG is not None:
        DEBUG.update(kw)


def _sweep_pack(U, Bcc, a, sim):
    """Stacked 1D-slice array for axis a, MHD-aware (variable permutation
    only — spatial axes untouched)."""
    U1d = vperm_to_sweep(U, a, sim)
    if not sim.mhd:
        return U1d, None
    ib = 5 if sim.adiabatic else 4
    a1, a2 = (a + 1) % 3, (a + 2) % 3
    U1d = jnp.concatenate([U1d[:ib], Bcc[a1][None], Bcc[a2][None],
                           U1d[ib:]], 0)
    return U1d, Bcc[a]


def _sweep_unpack_flux(F, a, sim):
    """(physical hydro flux, sweep (By,Bz) flux or None)."""
    if not sim.mhd:
        return vperm_from_sweep(F, a, sim), None
    ib = 5 if sim.adiabatic else 4
    hyd = jnp.concatenate([F[:ib], F[ib + 2:]], 0)
    return vperm_from_sweep(hyd, a, sim), F[ib:ib + 2]


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    axes = [a for a in range(3) if grid.active(a)]
    assert len(axes) == 3, "vl3d handles 3D; 1D/2D VL pending"
    sr = sim.special_relativity
    if sr:
        # SR hydro (integrate_3d_vl_sr.c) / SR MHD (same file, MHD
        # sections: Noble NR inversion + the identical CT machinery):
        # same step map with the SR variable conversions.  Passive
        # scalars are an EXTENSION: the reference's SR solvers #error on
        # NSCALARS>0 (hlle_sr.c:30-32); here they advect as s = D*r with
        # mass-flux-upwinded fluxes like the Newtonian solvers
        from ..eos_sr import sr_cons1d_to_prim1d, sr_prim1d_to_cons1d
        from .sweep import var_perm
        # convert ONCE in physical order (the reference computes W per
        # cell with Cons_to_Prim before the sweeps,
        # integrate_3d_vl_sr.c:152-157 — per-axis conversion of the
        # permuted stack differs in the |M|^2 summation order by ulps)
        if sim.mhd:
            from ..eos_sr import (sr_mhd_cons1d_to_prim1d,
                                  sr_mhd_prim1d_to_cons1d)
            U7x, _Bx0 = _sweep_pack(state.U, state.Bcc, 0, sim)
            _Wf = sr_mhd_cons1d_to_prim1d(U7x, _Bx0, sim)
            Wphys, rphys = _Wf[:5], _Wf[7:]
        else:
            Wphys = sr_cons1d_to_prim1d(state.U, sim)
        # USE_ENTROPY_FIX (auto-on for SR-MHD, integrate_3d_vl_sr.c:44-46):
        # advect the lab-frame entropy density S = D·p·rho^-Γ alongside U
        # as the fallback inversion target for cells whose Noble NR fails
        use_entropy = sim.mhd
        if use_entropy:
            # S = W.P * W.d^(1-Γ) * (U.d / W.d)   (:157-159)
            Sent = (Wphys[4] * Wphys[0] ** (1.0 - sim.gamma)
                    * (state.U[ID] / Wphys[0]))
    # exact_div: XLA folds division by a constant dx into multiplication by
    # its reciprocal; dx values that are not powers of two (e.g. 0.046875)
    # then differ from the reference's true division by an ulp, which is
    # enough to flip corner-EMF tie branches (see eos_sr.exact_div).
    from ..eos_sr import exact_div
    dtodx = {a: exact_div(dt, grid.dx[a]) for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i] if sim.mhd else None
    # the drivers pass phi in as a jit argument (a trace-time constant
    # of this size would be baked into the executable); fallback for
    # direct calls
    phic, phif = phi if phi is not None else _phi_arrays(problem, grid,
                                                         U.dtype)

    # === STEPS 1-3: first-order (donor cell) fluxes at t^n ==================
    Fp, FByz, FS = {}, {}, {}
    for a in axes:
        U1d, Bxc = _sweep_pack(U, Bcc, a, sim)
        if sr:
            if sim.mhd:
                W = Wphys[var_perm(a, sim)[:5], ...]
                a1, a2 = (a + 1) % 3, (a + 2) % 3
                W = jnp.concatenate([W, Bcc[a1][None], Bcc[a2][None]], 0)
                if sim.nscalars:
                    W = jnp.concatenate([W, rphys], 0)
            else:
                W = Wphys[var_perm(a, sim), ...]
            Wl = _sh(W, -1, a)
            Wr = W
            if sim.mhd:
                # U regenerated from W with the DONOR cell's Bxc
                # (integrate_3d_vl_sr.c:203-210)
                Ul = sr_mhd_prim1d_to_cons1d(Wl, _shf(Bxc, -1, a), sim)
                Ur = sr_mhd_prim1d_to_cons1d(Wr, Bxc, sim)
                F = riemann.fluxes(Ul, Ur, Wl, Wr, Bi[a], sim)
                if use_entropy:
                    from ..ops.riemann_sr import entropy_flux_mhd
                    FS[a] = entropy_flux_mhd(Ul, Ur, Wl, Wr, Bi[a], sim)
            else:
                Ul = sr_prim1d_to_cons1d(Wl, sim)
                Ur = sr_prim1d_to_cons1d(Wr, sim)
                F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim)
            Fp[a], FByz[a] = _sweep_unpack_flux(F, a, sim)
            continue
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        Wl = _sh(W, -1, a)
        Wr = W
        Bxl = _shf(Bxc, -1, a) if sim.mhd else None
        Ul = prim1d_to_cons1d(Wl, Bxl, sim)
        Ur = prim1d_to_cons1d(Wr, Bxc, sim)
        Bxi = Bi[a] if sim.mhd else None
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)
        Fp[a], FByz[a] = _sweep_unpack_flux(F, a, sim)

    # === STEP 4: half-dt CT [MHD] ===========================================
    if sim.mhd:
        d = U[ID]
        # SR: the cc reference EMF uses the PRIMITIVE velocity (M/d is
        # not v in SR; integrate_3d_vl_sr.c:348-358 reads W)
        vel = ((Wphys[1], Wphys[2], Wphys[3]) if sr else
               (U[IM1] / d, U[IM1 + 1] / d, U[IM1 + 2] / d))
        emf_cc = _emf_cc(Bcc, *vel)
        emfP = [_corner_emf(e, Fp, FByz, emf_cc) for e in axes]
        Bf = []
        for a in axes:
            a1, a2 = (a + 1) % 3, (a + 2) % 3
            Bf.append(Bi[a]
                      + q[a2] * (_shf(emfP[a1], 1, a2) - emfP[a1])
                      - q[a1] * (_shf(emfP[a2], 1, a1) - emfP[a2]))
        Bcch = jnp.stack([0.5 * (Bf[a] + _shf(Bf[a], 1, a)) for a in axes])
    else:
        Bf = Bcch = None

    if sim.mhd:
        _dbg(Fp=Fp, FByz=FByz, emfP=emfP, Bf=Bf)

    # === STEP 5: half-dt conservative update ================================
    Uhalf = U
    for a in axes:
        Uhalf = Uhalf - q[a] * (_sh(Fp[a], 1, a) - Fp[a])

    # === STEP 6: half-dt source terms =======================================
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Uhalf = Uhalf.at[IM1 + a].add(-q[a] * (phir - phil) * U[ID])
            if sim.adiabatic:
                dE = q[a] * (Fp[a][ID] * (phic - phil) +
                             _shf(Fp[a][ID], 1, a) * (phir - phic))
                Uhalf = Uhalf.at[IEN].add(-dE)

    # === STEPS 7-10: second-order states from Uhalf + full fluxes ===========
    if sr:
        if sim.mhd:
            U7h, _Bxh0 = _sweep_pack(Uhalf, Bcch, 0, sim)
            _Wfh = sr_mhd_cons1d_to_prim1d(U7h, _Bxh0, sim)
            Whalf_phys, rhalf = _Wfh[:5], _Wfh[7:]
            if use_entropy:
                # Shalf = S - hdt·div(F_S)  (:276, 333)
                Shalf = Sent
                for a in axes:
                    Shalf = Shalf - q[a] * (_shf(FS[a], 1, a) - FS[a])
                # Step 7: where the t_half inversion is unphysical, try
                # the entropy inversion; else carry the t^n primitives
                # (:652-686).  A no-op on healthy steps.
                from ..eos_sr import sr_mhd_entropy_fix1d
                dh_, vxh, vyh, vzh, Ph_ = (Whalf_phys[0], Whalf_phys[1],
                                           Whalf_phys[2], Whalf_phys[3],
                                           Whalf_phys[4])
                vsqh = vxh ** 2 + vyh ** 2 + vzh ** 2
                badh = (~(dh_ > 0.0)) | (~(Ph_ > 0.0)) | (vsqh > 1.0)

                def _half_fix(Wh):
                    Wfix = sr_mhd_entropy_fix1d(U7h, _Bxh0, Shalf, sim)
                    vsqf = Wfix[1] ** 2 + Wfix[2] ** 2 + Wfix[3] ** 2
                    okf = (Wfix[0] > 0.0) & (Wfix[4] > 0.0) & (vsqf < 1.0)
                    use_fix = badh & okf
                    use_n = badh & ~okf
                    out = jnp.where(use_fix[None], Wfix[:5], Wh)
                    return jnp.where(use_n[None], Wphys, out)

                Whalf_phys = jax.lax.cond(jnp.any(badh), _half_fix,
                                          lambda W: W, Whalf_phys)
        else:
            Whalf_phys = sr_cons1d_to_prim1d(Uhalf, sim)
    Fp2, FByz2, FS2 = {}, {}, {}
    for a in axes:
        U1d, Bxc = _sweep_pack(Uhalf, Bcch, a, sim)
        if sr:
            if sim.mhd:
                W = Whalf_phys[var_perm(a, sim)[:5], ...]
                a1, a2 = (a + 1) % 3, (a + 2) % 3
                W = jnp.concatenate([W, Bcch[a1][None], Bcch[a2][None]], 0)
                if sim.nscalars:
                    W = jnp.concatenate([W, rhalf], 0)
            else:
                W = Whalf_phys[var_perm(a, sim), ...]
            Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim,
                                            axis=2 - a)
            Wl = _sh(Wp_, -1, a)
            Wr = Wm
            if sim.mhd:
                Bxi = Bf[a]
                Ul = sr_mhd_prim1d_to_cons1d(Wl, Bxi, sim)
                Ur = sr_mhd_prim1d_to_cons1d(Wr, Bxi, sim)
                F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)
                if use_entropy:
                    from ..ops.riemann_sr import entropy_flux_mhd
                    FS2[a] = entropy_flux_mhd(Ul, Ur, Wl, Wr, Bxi, sim)
            else:
                Ul = sr_prim1d_to_cons1d(Wl, sim)
                Ur = sr_prim1d_to_cons1d(Wr, sim)
                F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim)
            Fp2[a], FByz2[a] = _sweep_unpack_flux(F, a, sim)
            continue
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim, axis=2 - a)
        Wl = _sh(Wp_, -1, a)
        Wr = Wm
        Bxi = Bf[a] if sim.mhd else None
        Ul = prim1d_to_cons1d(Wl, Bxi, sim)
        Ur = prim1d_to_cons1d(Wr, Bxi, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)
        Fp2[a], FByz2[a] = _sweep_unpack_flux(F, a, sim)

    # === STEP 11: full-dt CT [MHD] ==========================================
    if sim.mhd:
        dh = Uhalf[ID]
        velh = ((Whalf_phys[1], Whalf_phys[2], Whalf_phys[3]) if sr else
                (Uhalf[IM1] / dh, Uhalf[IM1 + 1] / dh,
                 Uhalf[IM1 + 2] / dh))
        emf_cc_h = _emf_cc(Bcch, *velh)
        emfC = [_corner_emf(e, Fp2, FByz2, emf_cc_h) for e in axes]

    if sim.mhd:
        _dbg(Fp2=Fp2, FByz2=FByz2, emfC=emfC, emf_cc_h=emf_cc_h)

    # === STEP 12: full-dt source terms ======================================
    Unew = U
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew = Unew.at[IM1 + a].add(
                -dtodx[a] * (phir - phil) * Uhalf[ID])
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic))
                Unew = Unew.at[IEN].add(-dE)

    # === STEP 13: conservative update =======================================
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    def face_update(emfs):
        out = []
        for a in axes:
            a1, a2 = (a + 1) % 3, (a + 2) % 3
            out.append(Bi[a]
                       + dtodx[a2] * (_shf(emfs[a1], 1, a2) - emfs[a1])
                       - dtodx[a1] * (_shf(emfs[a2], 1, a1) - emfs[a2]))
        return out

    if sim.mhd:
        emf_use = list(emfC)

    # === STEP 14: first-order flux correction ===============================
    if sim.first_order_flux_correction:
        if sr and sim.mhd:
            # SR-MHD failure test via check_Prim with the post-CT
            # cell-centered B (integrate_3d_vl_sr.c Step 15a)
            from ..eos_sr import sr_mhd_check_prim1d
            Bt = face_update(emfC)
            Bcc_test = jnp.stack([0.5 * (Bt[a] + _shf(Bt[a], 1, a))
                                  for a in axes])
            U7t = jnp.concatenate([Unew[:5], Bcc_test[1][None],
                                   Bcc_test[2][None]], 0)
            Wch = sr_mhd_check_prim1d(U7t, Bcc_test[0], sim)
            vsqch = Wch[1] ** 2 + Wch[2] ** 2 + Wch[3] ** 2
            bad = (~(Wch[0] > 0.0)) | (~(Wch[4] > 0.0)) | (vsqch > 1.0)
        elif sr:
            # SR failure test via check_Prim: unphysical inversion
            # (d<=0, P<=0 or v>=1), integrate_3d_vl_sr.c Step 15
            from ..eos_sr import sr_check_prim1d
            dch, vsqch, Pch = sr_check_prim1d(Unew, sim)
            bad = (~(dch > 0.0)) | (~(Pch > 0.0)) | (vsqch >= 1.0)
        else:
            if sim.mhd:
                Bt = face_update(emfC)
                Bcc_test = jnp.stack([0.5 * (Bt[a] + _shf(Bt[a], 1, a))
                                      for a in axes])
            dn = Unew[ID]
            ke = 0.5 * (Unew[IM1] ** 2 + Unew[IM1 + 1] ** 2 +
                        Unew[IM1 + 2] ** 2) / dn
            if sim.adiabatic:
                P = Unew[IEN] - ke
                if sim.mhd:
                    P = P - 0.5 * (Bcc_test ** 2).sum(0)
                bad = (dn < 0.0) | (P < 0.0)
            else:
                bad = dn < 0.0

        ent_fofc = sr and sim.mhd
        FS2u = tuple(FS2[a] for a in axes) if ent_fofc else ()

        def fix(args):
            Unew, emf_use, FS2u = args
            Uc = Unew
            FS2u = list(FS2u)
            for a in axes:
                bad_face = bad | _shf(bad, -1, a)
                FD = jnp.where(bad_face, Fp2[a] - Fp[a], 0.0)
                Uc = Uc + dtodx[a] * (_sh(FD, 1, a) - FD)
                if ent_fofc:
                    # the entropy fluxes get the same first-order redo
                    # (x1FluxS -> x1FluxSP analogue)
                    FSD = jnp.where(bad_face, FS2[a] - FS[a], 0.0)
                    FS2u[a] = FS2u[a] - FSD
            if sim.mhd:
                new_emf = []
                for e in axes:
                    b, c = (e + 1) % 3, (e + 2) % 3
                    mask = bad | _shf(bad, -1, b) | _shf(bad, -1, c) | \
                        _shf(_shf(bad, -1, b), -1, c)
                    new_emf.append(jnp.where(mask, emfP[e], emf_use[e]))
            else:
                new_emf = emf_use
            return Uc, new_emf, tuple(FS2u)

        if sim.mhd:
            Unew, emf_use, FS2u = jax.lax.cond(
                jnp.any(bad), fix, lambda x: x, (Unew, emf_use, FS2u))
        else:
            Unew = jax.lax.cond(jnp.any(bad),
                                lambda x: fix((x, None, ()))[0],
                                lambda x: x, Unew)

        if sr and sim.mhd:
            # Step 15b, SR-MHD: still-unphysical cells first try the
            # ENTROPY inversion with the advected S^{n+1}, then the vsq
            # fix, both with the final cell-centered B
            # (integrate_3d_vl_sr.c:1398-1433)
            from ..eos_sr import (sr_mhd_check_prim1d,
                                  sr_mhd_entropy_fix1d, sr_mhd_vsq1d_fix,
                                  sr_mhd_prim1d_to_cons1d as _w2u7)
            Btf = face_update(emf_use)
            Bccf = jnp.stack([0.5 * (Btf[a] + _shf(Btf[a], 1, a))
                              for a in axes])
            # S^{n+1} from the (possibly FOFC-redone) corrector entropy
            # fluxes (:1258-1310 update + :1856-1944 corrections)
            Sfull = Sent
            for i, a in enumerate(axes):
                Sfull = Sfull - dtodx[a] * (_shf(FS2u[i], 1, a) - FS2u[i])

            def vfix_mhd(Uin):
                U7f = jnp.concatenate([Uin[:5], Bccf[1][None],
                                       Bccf[2][None]], 0)
                Wc = sr_mhd_check_prim1d(U7f, Bccf[0], sim)
                vsq2 = Wc[1] ** 2 + Wc[2] ** 2 + Wc[3] ** 2
                bad2 = (~(Wc[0] > 0.0)) | (~(Wc[4] > 0.0)) | (vsq2 > 1.0)

                def apply(Uin):
                    U7f_ = jnp.concatenate([Uin[:5], Bccf[1][None],
                                            Bccf[2][None]], 0)
                    # entropy stage: accept only round-trip-physical
                    # results (:1400-1414)
                    We = sr_mhd_entropy_fix1d(U7f_, Bccf[0], Sfull, sim)
                    Ue = _w2u7(We, Bccf[0], sim)
                    Wec = sr_mhd_check_prim1d(Ue, Bccf[0], sim)
                    vsqe = Wec[1] ** 2 + Wec[2] ** 2 + Wec[3] ** 2
                    ok_e = (Wec[0] > 0.0) & (Wec[4] > 0.0) & (vsqe < 1.0)
                    take_e = bad2 & ok_e
                    still = bad2 & ~ok_e
                    # final stage: vsq fix (:1416-1433)
                    Wv = sr_mhd_vsq1d_fix(U7f_, Bccf[0], sim)
                    Uv = _w2u7(Wv, Bccf[0], sim)
                    out = jnp.where(take_e[None], Ue[:5], Uin[:5])
                    out = jnp.where(still[None], Uv[:5], out)
                    return jnp.concatenate([out, Uin[5:]], 0)

                return jax.lax.cond(jnp.any(bad2), apply,
                                    lambda x: x, Uin)

            Unew = vfix_mhd(Unew)
        elif sr:
            # Step 15b: cells still unphysical after the first-order
            # redo get the vsq fix (floor state + secant closure on v^2;
            # fix_vsq/vsq1D_fix with B = 0 for hydro)
            from ..eos_sr import (sr_check_prim1d, sr_mhd_vsq1d_fix,
                                  sr_prim1d_to_cons1d as _w2u)

            def vfix(Uin):
                dch2, vsq2, Pch2 = sr_check_prim1d(Uin, sim)
                bad2 = (~(dch2 > 0.0)) | (~(Pch2 > 0.0)) | (vsq2 >= 1.0)

                def apply(Uin):
                    z = jnp.zeros_like(Uin[0])
                    U7 = jnp.concatenate([Uin[:5], z[None], z[None]], 0)
                    Wf = sr_mhd_vsq1d_fix(U7, z, sim)
                    Uf = _w2u(Wf[:5], sim)
                    # the vsq fix rewrites only d,M,E; scalars pass through
                    Uf = jnp.concatenate([Uf[:5], Uin[5:]], 0)
                    return jnp.where(bad2[None], Uf, Uin)

                return jax.lax.cond(jnp.any(bad2), apply,
                                    lambda x: x, Uin)

            Unew = vfix(Unew)

    sl = (slice(None),) + grid.interior()
    Uout = U.at[sl].set(Unew[sl])

    kw = {}
    if sim.mhd:
        Binew = face_update(emf_use)
        Biout = []
        for a in axes:
            idx = []
            for dim, ax in enumerate((2, 1, 0)):
                upper = grid.hi(ax) + 1 + (1 if ax == a else 0)
                idx.append(slice(grid.lo(ax), upper))
            Biout.append(Bi[a].at[tuple(idx)].set(Binew[a][tuple(idx)]))
        Bcc_new = jnp.stack([0.5 * (Biout[a] + _shf(Biout[a], 1, a))
                             for a in axes])
        Bcc_out = Bcc.at[sl].set(Bcc_new[sl])
        kw = dict(Bcc=Bcc_out, B1i=Biout[0], B2i=Biout[1], B3i=Biout[2])

    return state.replace(U=Uout, **kw)
