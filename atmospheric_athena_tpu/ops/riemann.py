"""Riemann solvers on stacked interface states.

Vectorized re-implementation of /root/reference/src/rsolvers/:
  - ``roe``  — Roe's linearization with per-interface HLLE fallback on
               non-positive intermediate states (roe.c:59-336)
  - ``hlle`` — Einfeldt HLLE (hlle.c:62-260)

All solvers share the uniform reference signature fluxes(Ul,Ur,Wl,Wr,Bxi)
(rsolvers/prototypes.h:36-38), here over stacked arrays [nvar1d, ...] with
nvar1d = NWAVE + nscalars, so one call computes every interface of a sweep.
Where the reference early-returns per interface (supersonic short-circuit,
HLLE fallback), we compute all candidate fluxes and select with jnp.where —
branch-free, identical results.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SimConfig
from . import eigen


def _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig):
    """Roe-averaged state (roe.c:106-133; identical in hlle.c:93-120)."""
    sqrtdl = jnp.sqrt(Wl[0])
    sqrtdr = jnp.sqrt(Wr[0])
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    out = dict(
        droe=sqrtdl * sqrtdr,
        v1=(sqrtdl * Wl[1] + sqrtdr * Wr[1]) * isdlpdr,
        v2=(sqrtdl * Wl[2] + sqrtdr * Wr[2]) * isdlpdr,
        v3=(sqrtdl * Wl[3] + sqrtdr * Wr[3]) * isdlpdr,
        pbl=0.0, pbr=0.0,
    )
    if sim.mhd:
        ib = 5 if sim.adiabatic else 4
        # NB swapped sqrt-weights for B (roe.c:118-119)
        out["b2roe"] = (sqrtdr * Wl[ib] + sqrtdl * Wr[ib]) * isdlpdr
        out["b3roe"] = (sqrtdr * Wl[ib + 1] + sqrtdl * Wr[ib + 1]) * isdlpdr
        out["x"] = 0.5 * ((Wl[ib] - Wr[ib]) ** 2 +
                          (Wl[ib + 1] - Wr[ib + 1]) ** 2) \
            / (sqrtdl + sqrtdr) ** 2
        out["y"] = 0.5 * (Wl[0] + Wr[0]) / out["droe"]
        out["pbl"] = 0.5 * (Bxi ** 2 + Wl[ib] ** 2 + Wl[ib + 1] ** 2)
        out["pbr"] = 0.5 * (Bxi ** 2 + Wr[ib] ** 2 + Wr[ib + 1] ** 2)
    if sim.adiabatic:
        out["hroe"] = ((Ul[4] + Wl[4] + out["pbl"]) / sqrtdl +
                       (Ur[4] + Wr[4] + out["pbr"]) / sqrtdr) * isdlpdr
    return out


def _esys_roe(avg, Bxi, sim: SimConfig, vectors=True):
    """Eigen-dispatch on Roe averages (roe.c:139-153)."""
    if sim.gas == "hydro":
        if sim.adiabatic:
            return eigen.esys_roe_adb_hyd(avg["v1"], avg["v2"], avg["v3"],
                                          avg["hroe"], sim, vectors)
        return eigen.esys_roe_iso_hyd(avg["v1"], avg["v2"], avg["v3"],
                                      sim, vectors)
    from . import eigen_mhd_roe
    if sim.adiabatic:
        return eigen_mhd_roe.esys_roe_adb_mhd(
            avg["droe"], avg["v1"], avg["v2"], avg["v3"], avg["hroe"], Bxi,
            avg["b2roe"], avg["b3roe"], avg["x"], avg["y"], sim, vectors)
    return eigen_mhd_roe.esys_roe_iso_mhd(
        avg["droe"], avg["v1"], avg["v2"], avg["v3"], Bxi,
        avg["b2roe"], avg["b3roe"], avg["x"], avg["y"], sim, vectors)


def _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, pbl, pbr, sim: SimConfig,
               bm=0.0, bp=0.0):
    """Physical L/R fluxes F(U) − b·U (roe.c:159-209 with b=0;
    hlle.c:185-245 with the HLLE wave-speed shifts baked in)."""
    def one(U, W, pb, b):
        F = [U[1] - b * U[0],
             U[1] * (W[1] - b),
             U[2] * (W[1] - b),
             U[3] * (W[1] - b)]
        if sim.adiabatic:
            F[1] = F[1] + W[4]
            F.append(U[4] * (W[1] - b) + W[4] * W[1])
        else:
            F[1] = F[1] + W[0] * sim.iso_csound2
        if sim.mhd:
            ib = 5 if sim.adiabatic else 4
            F[1] = F[1] - 0.5 * (Bxi ** 2 - W[ib] ** 2 - W[ib + 1] ** 2)
            F[2] = F[2] - Bxi * W[ib]
            F[3] = F[3] - Bxi * W[ib + 1]
            if sim.adiabatic:
                F[4] = F[4] + (pb * W[1] - Bxi * (
                    Bxi * W[1] + W[ib] * W[2] + W[ib + 1] * W[3]))
            F.append(W[ib] * (W[1] - b) - Bxi * W[2])
            F.append(W[ib + 1] * (W[1] - b) - Bxi * W[3])
        iw = sim.nwave
        for n in range(sim.nscalars):
            F.append(F[0] * W[iw + n])
        return F
    # NB: the Roe solver's L/R fluxes use Mx*Vx (+P), algebraically equal to
    # the b=0 case here; Mx*(Vx-0) == Mx*Vx bit-for-bit.
    return one(Ul, Wl, pbl, bm), one(Ur, Wr, pbr, bp)


def hlle(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """HLLE flux (hlle.c:62-260)."""
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)
    return _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev)


def _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, avg, ev,
               return_pflux=False):
    """HLLE body with the Roe averages/eigenvalues passed in, so the
    branchless Roe fallback reuses them instead of recomputing (hlle.c's
    own computation is value-identical — the eigenvalues do not depend on
    the vectors flag)."""

    def cf_side(U, W):
        if sim.adiabatic:
            asq = sim.gamma * W[4] / W[0]
        else:
            asq = sim.iso_csound2
        if not sim.mhd:
            return jnp.sqrt(asq * jnp.ones_like(W[0]))
        ib = 5 if sim.adiabatic else 4
        vaxsq = Bxi * Bxi / W[0]
        ct2 = (U[ib] ** 2 + U[ib + 1] ** 2) / W[0]
        qsq = vaxsq + ct2 + asq
        tmp = vaxsq + ct2 - asq
        cfsq = 0.5 * (qsq + jnp.sqrt(tmp * tmp + 4.0 * asq * ct2))
        return jnp.sqrt(cfsq)

    cfl = cf_side(Ul, Wl)
    cfr = cf_side(Ur, Wr)
    ar = jnp.maximum(ev[sim.nwave - 1], Wr[1] + cfr)
    al = jnp.minimum(ev[0], Wl[1] - cfl)
    bp = jnp.maximum(ar, 0.0)
    bm = jnp.minimum(al, 0.0)

    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim,
                        bm=bm, bp=bp)
    tmp = 0.5 * (bp + bm) / (bp - bm)
    F = [0.5 * (fl + fr) + (fl - fr) * tmp for fl, fr in zip(Fl, Fr)]
    if return_pflux:
        # cylindrical interface pressure, blended like any component
        # (hlle.c:241-246, 262-265)
        Pl = Wl[4] + (avg["pbl"] if sim.mhd else 0.0)
        Pr = Wr[4] + (avg["pbr"] if sim.mhd else 0.0)
        pflux = 0.5 * (Pl + Pr) + (Pl - Pr) * tmp
        return jnp.stack(F), pflux
    return jnp.stack(F)


def roe(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None, branchless=False,
        return_pflux=False):
    """Roe flux with supersonic short-circuit (roe.c:215-235), intermediate-
    state positivity test and per-interface HLLE fallback (roe.c:256-284),
    and H-correction via `etah` (roe.c:295-300).

    branchless=True always evaluates the HLLE fallback and blends with
    jnp.where (identical values) — free when the computation is
    memory-bound.

    return_pflux: also return the cylindrical interface pressure
    (roe.c:326-332 star-state average; supersonic branches return Wl.P
    plus the SIDE magnetic pressure — note the reference uses Wl.P in
    BOTH supersonic branches, roe.c:218,229, reproduced faithfully)."""
    nw = sim.nwave
    if etah is None:
        etah = 0.0

    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, rem, lem = _esys_roe(avg, Bxi, sim, vectors=True)

    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim)

    # Step 6: wave strengths a = L·dU (roe.c:241-248)
    dU = [Ur[n] - Ul[n] for n in range(nw)]
    a = eigen.lmul(lem, dU)

    # Step 7: intermediate-state positivity scan (roe.c:256-284)
    u_inter = [Ul[n] for n in range(nw)]
    bad = jnp.zeros_like(Ul[0], dtype=bool)
    for n in range(nw - 1):
        rcol = eigen.column(rem, n)
        u_inter = [ui + a[n] * c if not (isinstance(c, float) and c == 0.0)
                   else ui for ui, c in zip(u_inter, rcol)]
        expanding = ev[n + 1] > ev[n]
        bad = bad | (expanding & (u_inter[0] <= 0.0))
        if sim.adiabatic:
            p_inter = u_inter[4] - 0.5 * (
                u_inter[1] ** 2 + u_inter[2] ** 2 + u_inter[3] ** 2) \
                / u_inter[0]
            if sim.mhd:
                p_inter = p_inter - 0.5 * (
                    u_inter[nw - 2] ** 2 + u_inter[nw - 1] ** 2 + Bxi ** 2)
            bad = bad | (expanding & (p_inter < 0.0))

    # Step 8: Roe flux (roe.c:295-312); with return_pflux also the
    # star-state average u_inter (roe.c:297-313 coeff2 terms)
    coeff = [0.5 * jnp.maximum(jnp.abs(ev[m]), etah) * a[m]
             for m in range(nw)]
    if return_pflux:
        sgn = [jnp.where(ev[m] < 0.0, -1.0, 1.0) for m in range(nw)]
        coeff2 = [0.5 * sgn[m] * a[m] for m in range(nw)]
        u2 = [0.5 * (Ul[n] + Ur[n]) for n in range(nw)]
    F = []
    for n in range(nw):
        f = 0.5 * (Fl[n] + Fr[n])
        for m in range(nw):
            c = rem[n][m]
            if isinstance(c, float) and c == 0.0:
                continue
            f = f - coeff[m] if isinstance(c, float) and c == 1.0 \
                else f - coeff[m] * c
            if return_pflux:
                u2[n] = u2[n] - coeff2[m] if isinstance(c, float) \
                    and c == 1.0 else u2[n] - coeff2[m] * c
        F.append(f)

    # Supersonic short-circuit (roe.c:215-235) — overrides the fallback too,
    # since the reference returns before the intermediate-state test.
    sup_l = ev[0] >= 0.0
    sup_r = ev[nw - 1] <= 0.0
    F = [jnp.where(sup_l, fl, jnp.where(sup_r, fr, f))
         for f, fl, fr in zip(F, Fl, Fr)]
    pflux = None
    if return_pflux:
        # star-state pressure (roe.c:326-332)
        Emag = 0.0
        if sim.mhd:
            Emag = 0.5 * (u2[nw - 2] ** 2 + u2[nw - 1] ** 2 + Bxi ** 2)
        Ekin = 0.5 * (u2[1] ** 2 + u2[2] ** 2 + u2[3] ** 2) / u2[0]
        Eint = u2[4] - Emag - Ekin
        p_roe = sim.gamma_1 * Eint + Emag
        p_supl = Wl[4] + (avg["pbl"] if sim.mhd else 0.0)
        p_supr = Wl[4] + (avg["pbr"] if sim.mhd else 0.0)   # Wl.P: r.c:229
        pflux = jnp.where(sup_l, p_supl, jnp.where(sup_r, p_supr, p_roe))

    # Scalar fluxes upwinded on the density flux sign (roe.c:315-321)
    iw = nw
    for n in range(sim.nscalars):
        F.append(jnp.where(F[0] >= 0.0, F[0] * Wl[iw + n], F[0] * Wr[iw + n]))

    F = jnp.stack(F)

    # HLLE fallback where an intermediate state went non-positive.  The
    # reference computes HLLE only per failing interface (roe.c:281-284);
    # here a lax.cond skips the whole HLLE evaluation on the (typical)
    # steps with no failures at all.
    use_hlle = bad & ~(sup_l | sup_r)

    if return_pflux:
        F_hlle, p_hlle = _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev,
                                    return_pflux=True)
        return (jnp.where(use_hlle, F_hlle, F),
                jnp.where(use_hlle, p_hlle, pflux))

    def with_fallback(_):
        F_hlle = _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev)
        return jnp.where(use_hlle, F_hlle, F)

    if branchless:
        return with_fallback(None)
    return jax.lax.cond(jnp.any(use_hlle), with_fallback, lambda _: F, None)


def hllc(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None,
         return_pflux=False):
    """HLLC flux, hydro only (hllc.c:32-254): HLLE bounds + restored
    contact wave with pressure cp and speed am.

    return_pflux: also return the interface pressure Pflux the
    cylindrical geometric source terms need (hllc.c:219-246)."""
    assert not sim.mhd, "HLLC is hydro-only (hllc.c:36-37)"
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)

    if sim.adiabatic:
        cfl = jnp.sqrt(sim.gamma * Wl[4] / Wl[0])
        cfr = jnp.sqrt(sim.gamma * Wr[4] / Wr[0])
    else:
        cfl = cfr = sim.iso_csound
    ar = jnp.maximum(ev[sim.nwave - 1], Wr[1] + cfr)
    al = jnp.minimum(ev[0], Wl[1] - cfl)
    bp = jnp.maximum(ar, 0.0)
    bm = jnp.minimum(al, 0.0)

    # contact speed and pressure (hllc.c:127-146)
    if sim.adiabatic:
        tl = Wl[4] + (Wl[1] - al) * Ul[1]
        tr = Wr[4] + (Wr[1] - ar) * Ur[1]
    else:
        tl = Wl[0] * sim.iso_csound2 + (Wl[1] - al) * Ul[1]
        tr = Wr[0] * sim.iso_csound2 + (Wr[1] - ar) * Ur[1]
    dl = Ul[1] - Ul[0] * al
    dr = -(Ur[1] - Ur[0] * ar)
    tmp = 1.0 / (dl + dr)
    am = (tl - tr) * tmp
    cp = jnp.maximum((dl * tr + dr * tl) * tmp, 0.0)

    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, 0.0, 0.0, sim, bm=bm, bp=bp)

    # flux weights (hllc.c:183-196)
    pos = am >= 0.0
    sl = jnp.where(pos, am / (am - bm), 0.0)
    sr = jnp.where(pos, 0.0, -am / (bp - am))
    sm = jnp.where(pos, -bm / (am - bm), bp / (bp - am))

    nw = sim.nwave
    F = [sl * Fl[n] + sr * Fr[n] for n in range(nw)]
    F[1] = F[1] + sm * cp
    if sim.adiabatic:
        F[4] = F[4] + sm * cp * am
    for n in range(sim.nscalars):
        F.append(jnp.where(F[0] >= 0.0, F[0] * Wl[nw + n], F[0] * Wr[nw + n]))
    if not return_pflux:
        return jnp.stack(F)
    # interface pressure for cylindrical geometric sources (hllc.c:219-246)
    if sim.adiabatic:
        pmid = cp
        pl_, pr_ = Wl[4], Wr[4]
    else:
        pmid = jnp.where(am >= 0.0,
                         Wl[0] * (al - Wl[1]) / (al - am),
                         Wr[0] * (ar - Wr[1]) / (ar - am))
        pl_, pr_ = Wl[0] * sim.iso_csound2, Wr[0] * sim.iso_csound2
    pflux = jnp.where(al > 0.0, pl_, jnp.where(ar < 0.0, pr_, pmid))
    return jnp.stack(F), pflux


def hlld(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None,
         return_pflux=False):
    """HLLD flux, adiabatic MHD only (hlld.c:40-397; Miyoshi & Kusano 2005).
    Branch-free formulation: all four candidate fluxes (Fl*, Fl**, Fr**,
    Fr*) are formed and selected by the signal-speed signs, with the
    reference's degenerate-case guards (SMALL_NUMBER = 1e-8, hlld.c:37).

    return_pflux: also return the cylindrical interface total pressure
    (hlld.c:154-163 supersonic ptl/ptr, :393 star-region ptst)."""
    assert sim.mhd and sim.adiabatic, "HLLD is adiabatic-MHD only"
    SMALL = 1e-8
    ib = 5
    nw = sim.nwave
    Bxsq = Bxi ** 2

    pbl = 0.5 * (Bxsq + Wl[ib] ** 2 + Wl[ib + 1] ** 2)
    pbr = 0.5 * (Bxsq + Wr[ib] ** 2 + Wr[ib + 1] ** 2)
    gpl = sim.gamma * Wl[4]
    gpr = sim.gamma * Wr[4]
    gpbl = gpl + 2.0 * pbl
    gpbr = gpr + 2.0 * pbr
    cfl = jnp.sqrt((gpbl + jnp.sqrt(gpbl ** 2 - 4 * gpl * Bxsq))
                   / (2.0 * Wl[0]))
    cfr = jnp.sqrt((gpbr + jnp.sqrt(gpbr ** 2 - 4 * gpr * Bxsq))
                   / (2.0 * Wr[0]))
    cfmax = jnp.maximum(cfl, cfr)
    lle = Wl[1] <= Wr[1]
    spd0 = jnp.where(lle, Wl[1] - cfmax, Wr[1] - cfmax)
    spd4 = jnp.where(lle, Wr[1] + cfmax, Wl[1] + cfmax)

    ptl = Wl[4] + pbl
    ptr = Wr[4] + pbr

    def lrflux(U, W, pt):
        return [U[1],
                U[1] * W[1] + pt - Bxsq,
                U[0] * W[1] * W[2] - Bxi * U[ib],
                U[0] * W[1] * W[3] - Bxi * U[ib + 1],
                W[1] * (U[4] + pt - Bxsq) - Bxi * (W[2] * U[ib] +
                                                   W[3] * U[ib + 1]),
                U[ib] * W[1] - Bxi * W[2],
                U[ib + 1] * W[1] - Bxi * W[3]]
    Fl = lrflux(Ul, Wl, ptl)
    Fr = lrflux(Ur, Wr, ptr)

    sdl = spd0 - Wl[1]
    sdr = spd4 - Wr[1]
    spd2 = (sdr * Wr[0] * Wr[1] - sdl * Wl[0] * Wl[1] - ptr + ptl) / \
        (sdr * Wr[0] - sdl * Wl[0])
    sdml = spd0 - spd2
    sdmr = spd4 - spd2
    dlst = Ul[0] * sdl / sdml
    drst = Ur[0] * sdr / sdmr
    sqrtdl = jnp.sqrt(dlst)
    sqrtdr = jnp.sqrt(drst)
    spd1 = spd2 - jnp.abs(Bxi) / sqrtdl
    spd3 = spd2 + jnp.abs(Bxi) / sqrtdr

    ptst = ptl + Ul[0] * sdl * (sdl - sdml)

    def star(U, W, sd, sdm, dst, pt):
        """U* state (M&K eqns 39-48) as a 7-list + v*·B*."""
        Mx = dst * spd2
        denom = U[0] * sd * sdm - Bxsq
        deg = jnp.abs(U[0] * sd * sdm / Bxsq - 1.0) < SMALL
        safe = jnp.where(deg, 1.0, denom)
        tmp = Bxi * (sd - sdm) / safe
        My = jnp.where(deg, dst * W[2], dst * (W[2] - U[ib] * tmp))
        Mz = jnp.where(deg, dst * W[3], dst * (W[3] - U[ib + 1] * tmp))
        tmp2 = (U[0] * sd ** 2 - Bxsq) / safe
        By = jnp.where(deg, U[ib], U[ib] * tmp2)
        Bz = jnp.where(deg, U[ib + 1], U[ib + 1] * tmp2)
        vbst = (Mx * Bxi + My * By + Mz * Bz) / dst
        E = (sd * U[4] - pt * W[1] + ptst * spd2 +
             Bxi * (W[1] * Bxi + W[2] * U[ib] + W[3] * U[ib + 1]
                    - vbst)) / sdm
        return [dst, Mx, My, Mz, E, By, Bz], vbst

    Ulst, vbstl = star(Ul, Wl, sdl, sdml, dlst, ptl)
    Urst, vbstr = star(Ur, Wr, sdr, sdmr, drst, ptr)
    Wlst_v = [Ulst[2] / dlst, Ulst[3] / dlst]
    Wrst_v = [Urst[2] / drst, Urst[3] / drst]

    # ** states (M&K eqns 59-63); collapse to * states when Bx ~ 0
    nobx = 0.5 * Bxsq / jnp.minimum(pbl, pbr) < SMALL ** 2
    invsumd = 1.0 / (sqrtdl + sqrtdr)
    Bxsig = jnp.where(Bxi > 0, 1.0, -1.0)
    vydst = invsumd * (sqrtdl * Wlst_v[0] + sqrtdr * Wrst_v[0] +
                       Bxsig * (Urst[5] - Ulst[5]))
    vzdst = invsumd * (sqrtdl * Wlst_v[1] + sqrtdr * Wrst_v[1] +
                       Bxsig * (Urst[6] - Ulst[6]))
    Bydst = invsumd * (sqrtdl * Urst[5] + sqrtdr * Ulst[5] +
                       Bxsig * sqrtdl * sqrtdr * (Wrst_v[0] - Wlst_v[0]))
    Bzdst = invsumd * (sqrtdl * Urst[6] + sqrtdr * Ulst[6] +
                       Bxsig * sqrtdl * sqrtdr * (Wrst_v[1] - Wlst_v[1]))
    tmp = spd2 * Bxi + vydst * Bydst + vzdst * Bzdst
    Eldst = Ulst[4] - sqrtdl * Bxsig * (vbstl - tmp)
    Erdst = Urst[4] + sqrtdr * Bxsig * (vbstr - tmp)

    def pick(st, dst_val):
        return jnp.where(nobx, st, dst_val)
    Uldst = [Ulst[0], Ulst[1],
             pick(Ulst[2], Ulst[0] * vydst), pick(Ulst[3], Ulst[0] * vzdst),
             pick(Ulst[4], Eldst), pick(Ulst[5], Bydst),
             pick(Ulst[6], Bzdst)]
    Urdst = [Urst[0], Urst[1],
             pick(Urst[2], Urst[0] * vydst), pick(Urst[3], Urst[0] * vzdst),
             pick(Urst[4], Erdst), pick(Urst[5], Bydst),
             pick(Urst[6], Bzdst)]

    # final flux selection (hlld.c:340-382 + supersonic at :151-168)
    F = []
    t1 = spd1 - spd0
    t3 = spd3 - spd4
    for n in range(7):
        fls = Fl[n] + spd0 * (Ulst[n] - Ul[n])
        fld = Fl[n] - spd0 * Ul[n] - t1 * Ulst[n] + spd1 * Uldst[n]
        frd = Fr[n] - spd4 * Ur[n] - t3 * Urst[n] + spd3 * Urdst[n]
        frs = Fr[n] + spd4 * (Urst[n] - Ur[n])
        f = jnp.where(spd1 >= 0, fls,
                      jnp.where(spd2 >= 0, fld,
                                jnp.where(spd3 > 0, frd, frs)))
        f = jnp.where(spd0 >= 0.0, Fl[n], jnp.where(spd4 <= 0.0, Fr[n], f))
        F.append(f)
    for n in range(sim.nscalars):
        F.append(jnp.where(F[0] >= 0.0, F[0] * Wl[nw + n],
                           F[0] * Wr[nw + n]))
    if return_pflux:
        pflux = jnp.where(spd0 >= 0.0, ptl,
                          jnp.where(spd4 <= 0.0, ptr, ptst))
        return jnp.stack(F), pflux
    return jnp.stack(F)


def force(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """FORCE flux: average of Lax-Wendroff (via the HLL mean state) and
    HLLE (force.c:62-300).  Faithful quirk: the LW energy flux's magnetic
    term uses pbl — the left state's magnetic pressure (force.c:273)."""
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)

    def cf_side(U, W):
        if sim.adiabatic:
            asq = sim.gamma * W[4] / W[0]
        else:
            asq = sim.iso_csound2
        if not sim.mhd:
            return jnp.sqrt(asq * jnp.ones_like(W[0]))
        ib = 5 if sim.adiabatic else 4
        vaxsq = Bxi * Bxi / W[0]
        ct2 = (U[ib] ** 2 + U[ib + 1] ** 2) / W[0]
        qsq = vaxsq + ct2 + asq
        tmp = vaxsq + ct2 - asq
        return jnp.sqrt(0.5 * (qsq + jnp.sqrt(tmp * tmp + 4 * asq * ct2)))

    ar = jnp.maximum(ev[sim.nwave - 1], Wr[1] + cf_side(Ur, Wr))
    al = jnp.minimum(ev[0], Wl[1] - cf_side(Ul, Wl))
    bp = jnp.maximum(ar, 0.0)
    bm = jnp.minimum(al, 0.0)

    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim,
                        bm=bm, bp=bp)
    nv = sim.nwave + sim.nscalars

    # HLL mean state -> LW flux along dx/dt=0 (force.c:239-285)
    safe = jnp.where(ar == al, 1.0, ar - al)
    Uc = jnp.stack([(Fl[n] - Fr[n]) / safe for n in range(nv)])
    Wc = cons1d_to_prim1d_lazy(Uc, Bxi, sim)
    Fc = _phys_flux(Uc, Wc, Bxi, avg["pbl"], sim)

    tmp = 0.25 * (bp + bm) / (bp - bm)
    F = [0.5 * Fc[n] + 0.25 * (Fl[n] + Fr[n]) + (Fl[n] - Fr[n]) * tmp
         for n in range(nv)]
    # supersonic short-circuit (force.c:228-236)
    F = [jnp.where(al >= 0.0, fl, jnp.where(ar <= 0.0, fr, f))
         for f, fl, fr in zip(F, Fl, Fr)]
    return jnp.stack(F)


def cons1d_to_prim1d_lazy(U, Bx, sim):
    from ..eos import cons1d_to_prim1d
    return cons1d_to_prim1d(U, Bx, sim)


def _phys_flux(U, W, Bxi, pb_e, sim):
    """Plain physical flux F(U) (force.c:253-285); pb_e is the magnetic
    pressure used in the energy flux (the reference passes pbl)."""
    F = [U[1], U[1] * W[1], U[2] * W[1], U[3] * W[1]]
    if sim.adiabatic:
        F[1] = F[1] + W[4]
        F.append(U[4] * W[1] + W[4] * W[1])
    else:
        F[1] = F[1] + W[0] * sim.iso_csound2
    if sim.mhd:
        ib = 5 if sim.adiabatic else 4
        F[1] = F[1] - 0.5 * (Bxi ** 2 - W[ib] ** 2 - W[ib + 1] ** 2)
        F[2] = F[2] - Bxi * W[ib]
        F[3] = F[3] - Bxi * W[ib + 1]
        if sim.adiabatic:
            F[4] = F[4] + (pb_e * W[1] - Bxi * (
                Bxi * W[1] + W[ib] * W[2] + W[ib + 1] * W[3]))
        F.append(W[ib] * W[1] - Bxi * W[2])
        F.append(W[ib + 1] * W[1] - Bxi * W[3])
    nw = sim.nwave
    for n in range(sim.nscalars):
        F.append(F[0] * W[nw + n])
    return F


def two_shock(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Two-shock approximate solver, isothermal hydro only
    (two_shock.c:53-129)."""
    assert sim.eos == "isothermal" and not sim.mhd and sim.nscalars == 0, \
        "two-shock is isothermal hydro only (two_shock.c:29-39)"
    cs = sim.iso_csound
    zl = jnp.sqrt(Wl[0])
    zr = jnp.sqrt(Wr[0])
    tmp = zl * zr * (Wl[1] - Wr[1]) / (2.0 * cs * (zl + zr))
    zc = tmp + jnp.sqrt(tmp * tmp + zl * zr)
    Vxc = (Wl[1] * zl + Wr[1] * zr) / (zl + zr) + cs * (zl - zr) / zc
    sl = Wl[1] - cs * zc / zl
    sr = Wr[1] + cs * zc / zr

    dc = zc * zc
    Fm = [dc * Vxc,
          dc * Vxc * Vxc + dc * sim.iso_csound2,
          dc * Vxc * jnp.where(Vxc >= 0.0, Wl[2], Wr[2]),
          dc * Vxc * jnp.where(Vxc >= 0.0, Wl[3], Wr[3])]
    Fls = [Ul[1], Ul[1] * Wl[1] + Wl[0] * sim.iso_csound2,
           Ul[2] * Wl[1], Ul[3] * Wl[1]]
    Frs = [Ur[1], Ur[1] * Wr[1] + Wr[0] * sim.iso_csound2,
           Ur[2] * Wr[1], Ur[3] * Wr[1]]
    F = [jnp.where(sr <= 0.0, fr, jnp.where(sl >= 0.0, fl, fm))
         for fm, fl, fr in zip(Fm, Fls, Frs)]
    return jnp.stack(F)


def _exact_adb(Ul, Ur, Wl, Wr, sim: SimConfig):
    """Exact (Godunov/Toro) adiabatic-hydro solver (exact.c:337-711).

    Center pressure by Newton-Raphson on the Toro pressure function with
    the two-shock initial guess (exact.c:347-480); the per-interface
    while-loop becomes a fixed-trip lax.fori_loop with a converged mask.
    The wave-position early returns (exact.c:545-680) become a nested
    jnp.where cascade in the same priority order."""
    g = sim.gamma
    g1 = g - 1.0
    TOL = 1.0e-6
    dl, vl, ul2, ul3, pl = Wl[0], Wl[1], Wl[2], Wl[3], Wl[4]
    dr, vr, ur2, ur3, pr = Wr[0], Wr[1], Wr[2], Wr[3], Wr[4]
    al = jnp.sqrt(g * pl / dl)
    ar = jnp.sqrt(g * pr / dr)

    def pfunc(d, p, a, pold):
        raref = 2.0 * a / g1 * ((pold / p) ** (g1 / (2.0 * g)) - 1.0)
        Ak = 2.0 / (d * (g + 1.0))
        Bk = p * g1 / (g + 1.0)
        shock = (pold - p) * jnp.sqrt(Ak / (pold + Bk))
        return jnp.where(pold <= p, raref, shock)

    def pfunc_deriv(d, p, a, pold):
        raref = 1.0 / (a * d) * (pold / p) ** (-(g + 1.0) / (2.0 * g))
        Ak = 2.0 / (d * (g + 1.0))
        Bk = p * g1 / (g + 1.0)
        shock = jnp.sqrt(Ak / (pold + Bk)) * (
            1.0 - 0.5 * (pold - p) / (Bk + pold))
        return jnp.where(pold <= p, raref, shock)

    # two-shock initial guess (exact.c:347-371)
    ppv = jnp.maximum(0.5 * (pl + pr)
                      - 0.125 * (vr - vl) * (dl + dr) * (al + ar), 0.0)
    gl = jnp.sqrt((2.0 / (dl * (g + 1.0))) / (g1 * pl / (g + 1.0) + ppv))
    gr = jnp.sqrt((2.0 / (dr * (g + 1.0))) / (g1 * pr / (g + 1.0) + ppv))
    p0 = (gl * pl + gr * pr - (vr - vl)) / (gr + gl)
    p0 = jnp.where(p0 < 0.0, TOL, p0)

    def newton(_, carry):
        pold, done = carry
        f = (pfunc(dl, pl, al, pold) + pfunc(dr, pr, ar, pold) + (vr - vl))
        fd = pfunc_deriv(dl, pl, al, pold) + pfunc_deriv(dr, pr, ar, pold)
        p = pold - f / fd
        change = 2.0 * jnp.abs((p - pold) / (p + pold))
        p = jnp.where(p < 0.0, TOL, p)
        newp = jnp.where(done, pold, p)
        return newp, done | (change <= TOL)

    pc, conv = jax.lax.fori_loop(
        0, 100, newton, (p0, jnp.zeros_like(p0, dtype=bool)))
    # the reference aborts on Newton divergence (exact.c:465 ath_error);
    # the jit-compatible analogue poisons the lane with NaN so the
    # failure is visible to the driver's NaN checks instead of silently
    # using the 100th iterate
    pc = jnp.where(conv, pc, jnp.nan)

    Vxc = 0.5 * (vl + vr) + 0.5 * (pfunc(dr, pr, ar, pc)
                                   - pfunc(dl, pl, al, pc))
    gtmp = g1 / (g + 1.0)
    dcl = jnp.where(pc > pl,
                    dl * (pc / pl + gtmp) / (gtmp * pc / pl + 1.0),
                    dl * (pc / pl) ** (1.0 / g))
    dcr = jnp.where(pc > pr,
                    dr * (pc / pr + gtmp) / (gtmp * pc / pr + 1.0),
                    dr * (pc / pr) ** (1.0 / g))

    def side_flux(d, vx, vy, vz, p):
        E = d * (0.5 * (vx * vx + vy * vy + vz * vz)) + p / g1
        return [d * vx, d * vx * vx + p, d * vx * vy, d * vx * vz,
                vx * (E + p)]

    # rarefaction-fan flux at x/t = 0 (exact.c:593-612, 661-680)
    def fan_flux(d, a, vx, vy, vz, p, sgn):
        t1 = 2.0 / (g + 1.0)
        t2 = g1 / (a * (g + 1.0))
        fac = t1 + sgn * t2 * vx
        dc = d * fac ** (2.0 / g1)
        vc = t1 * (sgn * a + vx * g1 / 2.0)
        pcf = p * fac ** (2.0 * g / g1)
        return side_flux(dc, vc, vy, vz, pcf)

    FL = side_flux(dl, vl, ul2, ul3, pl)
    FR = side_flux(dr, vr, ur2, ur3, pr)
    FfanL = fan_flux(dl, al, vl, ul2, ul3, pl, +1.0)
    FfanR = fan_flux(dr, ar, vr, ur2, ur3, pr, -1.0)
    FmidL = side_flux(dcl, Vxc, ul2, ul3, pc)
    FmidR = side_flux(dcr, Vxc, ur2, ur3, pc)

    sl = vl - al * jnp.sqrt(pc * (g + 1.0) / (2.0 * g * pl)
                            + g1 / (2.0 * g))
    sr = vr + ar * jnp.sqrt(pc * (g + 1.0) / (2.0 * g * pr)
                            + g1 / (2.0 * g))
    alc = al * (pc / pl) ** (g1 / (2.0 * g))
    arc = ar * (pc / pr) ** (g1 / (2.0 * g))
    hdl, tll = vl - al, Vxc - alc
    hdr, tlr = vr + ar, Vxc + arc

    left_outer = jnp.where(pc > pl, sl >= 0.0, hdl >= 0.0)
    left_fan = (pc <= pl) & (hdl < 0.0) & (tll >= 0.0)
    right_outer = jnp.where(pc > pr, sr <= 0.0, hdr <= 0.0)
    right_fan = (pc <= pr) & (hdr > 0.0) & (tlr <= 0.0)

    F = [jnp.where(left_outer, fl,
         jnp.where(left_fan, ffl,
         jnp.where(right_outer, fr,
         jnp.where(right_fan, ffr,
         jnp.where(Vxc >= 0.0, fml, fmr)))))
         for fl, ffl, fr, ffr, fml, fmr
         in zip(FL, FfanL, FR, FfanR, FmidL, FmidR)]
    return F


def _exact_iso(Ul, Ur, Wl, Wr, sim: SimConfig):
    """Exact isothermal-hydro solver (exact.c:68-334).  The Numerical
    Recipes rtsafe() bracketed Newton (exact.c:284-334) becomes a
    fixed-trip vectorized bisection/Newton hybrid."""
    cs = sim.iso_csound
    cs2 = sim.iso_csound2
    dl, vl, ul2, ul3 = Wl[0], Wl[1], Wl[2], Wl[3]
    dr, vr, ur2, ur3 = Wr[0], Wr[1], Wr[2], Wr[3]
    zl = jnp.sqrt(dl)
    zr = jnp.sqrt(dr)
    dmin = jnp.minimum(dl, dr)
    dmax = jnp.maximum(dl, dr)

    # 1-shock + 2-shock candidate (exact.c:90-99)
    tmp = zl * zr * (vl - vr) / (2.0 * cs * (zl + zr))
    zm = tmp + jnp.sqrt(tmp * tmp + zl * zr)
    dm_ss = zm * zm
    vxm_ss = vl - cs * (dm_ss - dl) / (zm * zl)

    # 1-raref + 2-raref candidate (exact.c:106-114)
    dm_rr = zl * zr * jnp.exp((vl - vr) / (2.0 * cs))
    vxm_rr = vl - cs * jnp.log(dm_rr / dl)

    # mixed shock/raref root of srder (exact.c:266-273) via rtsafe
    def srder(dm):
        y = (vr - vl) + cs * (jnp.log(dm / dmax)
                              + (dm - dmin) / jnp.sqrt(dm * dmin))
        dydx = cs / dm * (1.0 + 0.5 * (dm + dmin) / jnp.sqrt(dm * dmin))
        return y, dydx

    f_lo, _ = srder(dmin)
    f_hi, _ = srder(dmax)
    bracketed = ~((f_lo > 0.0) & (f_hi > 0.0)) & ~((f_lo < 0.0) & (f_hi < 0.0))
    xl0 = jnp.where(f_lo < 0.0, dmin, dmax)
    xh0 = jnp.where(f_lo < 0.0, dmax, dmin)

    def rt_body(_, carry):
        xl, xh, rts = carry
        f, df = srder(rts)
        newton_step = rts - f / df
        use_bisect = (((rts - xh) * df - f) * ((rts - xl) * df - f) > 0.0) \
            | (jnp.abs(2.0 * f) > jnp.abs((xh - xl) * df))
        nxt = jnp.where(use_bisect, xl + 0.5 * (xh - xl), newton_step)
        nxl = jnp.where(f < 0.0, rts, xl)
        nxh = jnp.where(f < 0.0, xh, rts)
        return nxl, nxh, nxt

    _, _, dm_mix = jax.lax.fori_loop(
        0, 100, rt_body, (xl0, xh0, 0.5 * (dmin + dmax)))
    # rtsafe endpoint cases (Numerical Recipes rtsafe; exact.c:282-340):
    # a root exactly AT an endpoint short-circuits the iteration
    dm_mix = jnp.where(f_lo == 0.0, dmin,
                       jnp.where(f_hi == 0.0, dmax, dm_mix))
    dm_mix = jnp.where(bracketed | (f_lo == 0.0) | (f_hi == 0.0),
                       dm_mix, 0.0)
    mix_ok = (dm_mix > dmin) & (dm_mix <= dmax)
    vxm_mix = jnp.where(dl > dr,
                        vl - cs * jnp.log(dm_mix / jnp.maximum(dl, 1e-300)),
                        vr + cs * jnp.log(dm_mix / jnp.maximum(dr, 1e-300)))

    both_shock = dm_ss >= dmax
    need_mix = ~both_shock & (dm_rr > dmin)
    use_mix = need_mix & mix_ok
    dm = jnp.where(both_shock, dm_ss, jnp.where(use_mix, dm_mix, dm_rr))
    vxm = jnp.where(both_shock, vxm_ss, jnp.where(use_mix, vxm_mix, vxm_rr))
    # soln bit 1 = right raref, bit 2 = left raref (exact.c:90-153)
    left_raref = ~both_shock & (~use_mix | (dl > dr))
    right_raref = ~both_shock & (~use_mix | (dr >= dl))

    def side_flux(d, vx, vy, vz):
        return [d * vx, d * vx * vx + d * cs2, d * vx * vy, d * vx * vz]

    FL = side_flux(dl, vl, ul2, ul3)
    FR = side_flux(dr, vr, ur2, ur3)

    # fan fluxes at x/t = 0 (exact.c:178-186, 222-230)
    hdl = vl - cs
    hdr = vr + cs
    tll = vxm - cs
    tlr = vxm + cs
    dfl = dl * jnp.exp(hdl / cs)
    mfl = dl * cs * jnp.exp(hdl / cs)
    FfanL = [mfl, mfl * cs + dfl * cs2, mfl * ul2, mfl * ul3]
    dfr = dm * jnp.exp(-tlr / cs)
    mfr = -dm * cs * jnp.exp(-tlr / cs)
    vfr = jnp.where(dfr == 0.0, 0.0, mfr / dfr)
    FfanR = [mfr, mfr * vfr + dfr * cs2, mfr * ur2, mfr * ur3]

    Fmid = [dm * vxm, dm * vxm * vxm + dm * cs2,
            dm * vxm * jnp.where(vxm >= 0.0, ul2, ur2),
            dm * vxm * jnp.where(vxm >= 0.0, ul3, ur3)]

    sl = vl - cs * jnp.sqrt(dm) / zl
    sr = vr + cs * jnp.sqrt(dm) / zr
    left_outer = jnp.where(left_raref, hdl >= 0.0, sl >= 0.0)
    left_fan = left_raref & (hdl < 0.0) & (tll >= 0.0)
    right_outer = jnp.where(right_raref, hdr <= 0.0, sr <= 0.0)
    right_fan = right_raref & (hdr > 0.0) & (tlr <= 0.0)

    F = [jnp.where(left_outer, fl,
         jnp.where(left_fan, ffl,
         jnp.where(right_outer, fr,
         jnp.where(right_fan, ffr, fm))))
         for fl, ffl, fr, ffr, fm in zip(FL, FfanL, FR, FfanR, Fmid)]
    return F


def exact(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Exact nonlinear Riemann solver, hydro only (exact.c:35-46 guards).

    Passive scalars are upwinded on the density flux like the other
    solvers (the reference's exact.c:43 simply #errors on NSCALARS>0 —
    supporting them here is a strict extension)."""
    assert not sim.mhd, "exact solver is hydro only (exact.c:38-40)"
    if sim.adiabatic:
        F = _exact_adb(Ul, Ur, Wl, Wr, sim)
    else:
        F = _exact_iso(Ul, Ur, Wl, Wr, sim)
    nw = sim.nwave
    for n in range(sim.nscalars):
        F.append(F[0] * jnp.where(F[0] >= 0.0, Wl[nw + n], Wr[nw + n]))
    return jnp.stack(F)


SOLVERS = {"roe": roe, "hlle": hlle, "hllc": hllc, "hlld": hlld,
           "force": force, "two-shock": two_shock, "two_shock": two_shock,
           "exact": exact}


def fluxes(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None, branchless=False):
    """Uniform dispatch like the reference's single compiled fluxes()."""
    if sim.special_relativity:
        from . import riemann_sr
        table = ({"hlle": riemann_sr.hlle_sr_mhd,
                  "hlld": riemann_sr.hlld_sr} if sim.mhd else
                 {"hlle": riemann_sr.hlle_sr,
                  "hllc": riemann_sr.hllc_sr,
                  "exact": riemann_sr.exact_sr})
        try:
            solver = table[sim.flux]
        except KeyError:
            raise NotImplementedError(f"SR flux={sim.flux} not implemented")
        nb = 7 if sim.mhd else 5
        F = solver(Ul[:nb], Ur[:nb], Wl[:nb], Wr[:nb], Bxi, sim, etah=etah)
        if sim.nscalars and Wl.shape[0] > nb:
            # passive-scalar fluxes upwinded on the mass-flux sign, the
            # Newtonian convention (roe.c:315-321).  The reference's SR
            # solvers #error on NSCALARS>0 (hlle_sr.c:30-32) — extension
            Fs = jnp.where(F[0] >= 0.0, F[0][None] * Wl[nb:],
                           F[0][None] * Wr[nb:])
            F = jnp.concatenate([F, Fs], 0)
        return F
    try:
        solver = SOLVERS[sim.flux]
    except KeyError:
        raise NotImplementedError(f"flux={sim.flux} not yet implemented")
    if branchless and sim.flux == "roe":
        return roe(Ul, Ur, Wl, Wr, Bxi, sim, etah=etah, branchless=True)
    return solver(Ul, Ur, Wl, Wr, Bxi, sim, etah=etah)
