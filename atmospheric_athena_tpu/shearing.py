"""Shearing-box boundary conditions + EMF remap (reference:
src/bvals_shear.c, 3D / 2D-xy orientation, non-FARGO).

The x1 boundaries of a shearing box are periodic-with-a-twist: after the
ordinary periodic fill, the ghost slabs are shifted in y by the shear
displacement yshear = q*Omega_0*Lx*t, decomposed into an integer cell
offset (a periodic roll over the active y range) and a fractional part
applied as a CONSERVATIVE second-order remap (RemapFlux,
bvals_shear.c:2493-2529, min-mod limited PLM).  The azimuthal momentum of
the wrapped data also jumps by -+ q*Omega_0*Lx (the shear velocity
difference across the box), with the kinetic-energy part of E adjusted so
internal energy is unchanged (bvals_shear.c:183-195).

RemapEy averages the y-EMF on the two x1 boundary faces with the remapped
opposite face so the CT update conserves net Bz exactly
(bvals_shear.c RemapEy_ix1/_ox1; applied by the integrator).

Design notes: joffset/eps are TRACED scalars (functions of t inside
the jitted step); the integer shift is a jnp.roll with a traced shift and
the fractional remap is branch-free PLM arithmetic, so the whole remap
jits into the step.  Serial (single-shard) x1 boundaries; the multichip
version composes with the halo machinery later.
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import GridConfig, SimConfig
from .defs import ID, IEN, IM1


def shear_pars(sim: SimConfig, grid: GridConfig, time):
    """(qomL, joffset, eps_i) from the current time
    (bvals_shear.c:140-171).  eps for ox1 is -eps_i."""
    Lx = grid.xmax[0] - grid.xmin[0]
    Ly = grid.xmax[1] - grid.xmin[1]
    qomL = sim.qshear * sim.omega0 * Lx
    yshear = qomL * time
    deltay = jnp.mod(yshear, Ly)
    joffset = jnp.floor(deltay / grid.dx[1]).astype(jnp.int32)
    eps = jnp.mod(deltay, grid.dx[1]) / grid.dx[1]
    return qomL, joffset, eps


def _dUm(q, ydim):
    """min-mod limited PLM slope along ydim (RemapFlux:2510-2519)."""
    qp = jnp.roll(q, -1, axis=ydim)
    qm = jnp.roll(q, 1, axis=ydim)
    dUc = qp - qm
    dUl = q - qm
    dUr = qp - q
    lim = jnp.minimum(jnp.abs(dUl), jnp.abs(dUr))
    return jnp.where(dUl * dUr > 0.0,
                     jnp.sign(dUc) * jnp.minimum(0.5 * jnp.abs(dUc),
                                                 2.0 * lim),
                     0.0)


def _remap_frac(q, eps, ydim, inner: bool):
    """Conservative fractional remap along y: q[j] - (F[j+1] - F[j]) with
    the upwind flux of RemapFlux (eps >= 0 at ix1, eps <= 0 at ox1)."""
    dUm = _dUm(q, ydim)
    if inner:
        # F[j] = eps*(q[j-1] + 0.5*(1-eps)*dUm[j-1])
        F = eps * (q + 0.5 * (1.0 - eps) * dUm)
        Fj = jnp.roll(F, 1, axis=ydim)          # F at face j
        Fj1 = F                                  # F at face j+1
    else:
        # F[j] = eps*(q[j] - 0.5*(1+eps)*dUm[j]), eps < 0
        F = eps * (q - 0.5 * (1.0 + eps) * dUm)
        Fj = F
        Fj1 = jnp.roll(F, -1, axis=ydim)
    return q - (Fj1 - Fj)


def _roll_active_y(q, shift, grid: GridConfig, ydim):
    """Periodic integer roll over the ACTIVE y range only (ghost rows
    untouched); out[j] = in[j - shift] wrapped."""
    jl, ju = grid.lo(1), grid.hi(1)
    sl = [slice(None)] * q.ndim
    sl[ydim] = slice(jl, ju + 1)
    act = q[tuple(sl)]
    act = jnp.roll(act, shift, axis=ydim)
    return q.at[tuple(sl)].set(act)


def _remap_slab(q, eps, joffset, grid: GridConfig, ydim, inner: bool):
    """Full remap of one x-ghost slab field: fractional (conservative PLM)
    then integer periodic shift, both over active y."""
    qf = _remap_frac(q, eps, ydim, inner)
    jl, ju = grid.lo(1), grid.hi(1)
    sl = [slice(None)] * q.ndim
    sl[ydim] = slice(jl, ju + 1)
    out = q.at[tuple(sl)].set(qf[tuple(sl)])
    shift = joffset if inner else -joffset
    return _roll_active_y(out, shift, grid, ydim)


def shearing_sheet(state, sim: SimConfig, grid: GridConfig, time):
    """Remap both x1 ghost slabs (called AFTER the periodic x1+x2 fills,
    like bvals_mhd.c:390-401; the slab's y ghosts are re-wrapped here as
    in ShearingSheet_ix1 step 8)."""
    ng = grid.nghost
    qomL, joffset, eps = shear_pars(sim, grid, time)
    U = state.U
    mhd = sim.mhd
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i] if mhd else None

    def do_side(U, Bcc, Bi, inner: bool):
        xs = slice(0, ng) if inner else slice(U.shape[-1] - ng, None)
        sgn = 1.0 if inner else -1.0
        e = eps if inner else -eps
        ydim_u, ydim_f = 2, 1    # y dim of [nv,Nz,Ny,Nx] / [Nz,Ny,Nx]

        slab = U[..., xs]
        if not sim.fargo:
            # with FARGO the remapped M2 is the fluctuation: no shear
            # jump across the box (bvals_shear.c:186-195 #ifndef FARGO)
            M2n = slab[IM1 + 1]
            M2s = M2n + sgn * qomL * slab[ID]
            slab = slab.at[IM1 + 1].set(M2s)
            if sim.adiabatic:
                slab = slab.at[IEN].add(
                    (0.5 / slab[ID]) * (M2s ** 2 - M2n ** 2))
        slab = _remap_slab(slab, e, joffset, grid, ydim_u, inner)
        # y-ghost wrap of the slab (step 8)
        Ny = slab.shape[ydim_u]
        jl, ju = grid.lo(1), grid.hi(1)
        idx = [slice(None)] * slab.ndim

        def wrap(sl_arr, ydim):
            lo = [slice(None)] * sl_arr.ndim
            hi = [slice(None)] * sl_arr.ndim
            lo[ydim] = slice(0, jl)
            hi[ydim] = slice(ju + 1, None)
            src_lo = [slice(None)] * sl_arr.ndim
            src_hi = [slice(None)] * sl_arr.ndim
            src_lo[ydim] = slice(ju + 1 - jl, ju + 1)
            src_hi[ydim] = slice(jl, jl + (sl_arr.shape[ydim] - ju - 1))
            sl_arr = sl_arr.at[tuple(lo)].set(sl_arr[tuple(src_lo)])
            sl_arr = sl_arr.at[tuple(hi)].set(sl_arr[tuple(src_hi)])
            return sl_arr

        slab = wrap(slab, ydim_u)
        U = U.at[..., xs].set(slab)

        if mhd:
            bslabs = []
            for arr in (Bcc[0], Bi[0], Bi[1], Bi[2]):
                b = _remap_slab(arr[..., xs], e, joffset, grid, ydim_f,
                                inner)
                b = wrap(b, ydim_f)
                bslabs.append(b)
            Bcc = Bcc.at[0, ..., xs].set(bslabs[0])
            # the ox1 copy-back skips the shared ACTIVE face B1i[ie+1]
            # ("except B1i[ie+1]", ShearingSheet_ox1 step 6) — it is
            # evolved by CT with RemapEy keeping the two boundary faces
            # consistent; overwriting it breaks div(B)
            if inner:
                B1new = Bi[0].at[..., xs].set(bslabs[1])
            else:
                B1new = Bi[0].at[..., U.shape[-1] - ng + 1:].set(
                    bslabs[1][..., 1:])
            Bi = [B1new,
                  Bi[1].at[..., xs].set(bslabs[2]),
                  Bi[2].at[..., xs].set(bslabs[3])]
            # ghost-slab cell-centered B2c/B3c from remapped face
            # averages: compute over active y (step 7), wrap the y
            # ghosts (step 8), then fix rows je and js-1 from the
            # wrapped B2i[je+1] (step 10) — a plain roll would pull the
            # wrong value into the outermost y-ghost row
            b2s, b3s = bslabs[2], bslabs[3]
            B2c = 0.5 * (b2s + jnp.roll(b2s, -1, axis=ydim_f))
            B3c = 0.5 * (b3s + jnp.roll(b3s, -1, axis=0))
            B2c = wrap(B2c, ydim_f)
            B3c = wrap(B3c, ydim_f)
            B2c = B2c.at[:, ju].set(0.5 * (b2s[:, ju + 1] + b2s[:, ju]))
            B2c = B2c.at[:, jl - 1].set(
                0.5 * (b2s[:, jl - 1] + b2s[:, jl]))
            Bcc = Bcc.at[1, ..., xs].set(B2c)
            Bcc = Bcc.at[2, ..., xs].set(B3c)
        return U, Bcc, Bi

    U, Bcc, Bi = do_side(U, Bcc, Bi, True)
    U, Bcc, Bi = do_side(U, Bcc, Bi, False)
    kw = {}
    if mhd:
        kw = dict(Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])
    return state.replace(U=U, **kw)


def remap_ey(emf2, sim: SimConfig, grid: GridConfig, time):
    """RemapEy_ix1/_ox1: average the y-EMF on each x1 boundary face with
    the remapped opposite face so net Bz is conserved (bvals_shear.c)."""
    qomL, joffset, eps = shear_pars(sim, grid, time)
    ilo, ihi = grid.lo(0), grid.hi(0) + 1   # boundary faces is, ie+1

    jl, ju = grid.lo(1), grid.hi(1)

    def one(face_idx, src_idx, inner: bool):
        tEy = emf2[..., src_idx]             # [Nz, Ny]
        # periodic y-ghost rebuild (RemapEy step 2)
        tEy = tEy.at[:, :jl].set(tEy[:, ju + 1 - jl:ju + 1])
        tEy = tEy.at[:, ju + 1:].set(
            tEy[:, jl:jl + (tEy.shape[1] - ju - 1)])
        e = eps if inner else -eps
        t2 = _remap_frac(tEy, e, 1, inner)
        shift = joffset if inner else -joffset
        act = jnp.roll(t2[:, jl:ju + 1], shift, axis=1)
        face = emf2[..., face_idx]
        return face.at[:, jl:ju + 1].set(
            0.5 * (face[:, jl:ju + 1] + act))

    new_lo = one(ilo, ihi, True)
    new_hi = one(ihi, ilo, False)
    emf2 = emf2.at[..., ilo].set(new_lo)
    emf2 = emf2.at[..., ihi].set(new_hi)
    return emf2


# ---------------------------------------------------------------------------
# FARGO orbital advection (bvals_shear.c Fargo():1966-2345)
# ---------------------------------------------------------------------------


def _remap_flux_signed(U, dUm, eps, ydim):
    """RemapFlux for per-column SIGNED eps (bvals_shear.c:2493-2529):
    flux at face f (below cell f):  eps>0 -> eps*(U[f-1]+0.5(1-eps)dUm[f-1]);
    eps<0 -> eps*(U[f]-0.5(1+eps)dUm[f]).  Periodic along ydim."""
    Fpos = eps * (jnp.roll(U, 1, axis=ydim) +
                  0.5 * (1.0 - eps) * jnp.roll(dUm, 1, axis=ydim))
    Fneg = eps * (U - 0.5 * (1.0 + eps) * dUm)
    return jnp.where(eps > 0.0, Fpos, Fneg)


def _fargo_flux(V, yshear, dy, ydim):
    """Total FARGO transport flux through each y-face for one variable
    array V (periodic along ydim): the fractional RemapFlux evaluated at
    the shifted face f-joffset plus the sum over the integer number of
    swept cells (bvals_shear.c:2133-2173).  yshear broadcasts against V
    with a size-1 ydim."""
    joff = jnp.trunc(yshear / dy).astype(jnp.int32)
    eps = jnp.fmod(yshear, dy) / dy
    dUm = _dUm(V, ydim)
    Ffrac = _remap_flux_signed(V, dUm, eps, ydim)
    n = V.shape[ydim]
    # gather the fractional flux at face f - joffset (periodic)
    f = jnp.arange(n)
    shp = [1] * V.ndim
    shp[ydim] = n
    idx = jnp.mod(f.reshape(shp) - joff, n)
    idx = jnp.broadcast_to(idx, V.shape)
    F = jnp.take_along_axis(Ffrac, idx, axis=ydim)
    # integer part: sum_{jj=1..joff} V[f-jj]  (negative joff subtracts)
    C = jnp.cumsum(V, axis=ydim)              # C[m] = sum_{0..m}
    tot = jnp.take(C, n - 1, axis=ydim)
    tot = jnp.expand_dims(tot, ydim)

    def S(m):
        """sum_{0..m} with periodic extension (m may be out of range)."""
        wrap = jnp.floor_divide(m + n, n) - 1     # how many full periods
        mm = jnp.mod(m + n, n)
        mmb = jnp.broadcast_to(mm, V.shape)
        return jnp.take_along_axis(C, mmb, axis=ydim) + \
            wrap.astype(V.dtype) * tot

    fm1 = f.reshape(shp) - 1
    W = S(fm1) - S(fm1 - joff)
    return F + W


def fargo_advect(state, sim: SimConfig, grid: GridConfig, dt):
    """Orbital advection: shift every x-column by the local orbital
    displacement -q*Omega_0*x1*dt in y with a conservative remap, done
    as flux differences; face B advected with the remap EMFs so div(B)
    is preserved (bvals_shear.c Fargo():1966-2345, applied after the
    integrator and before bvals, main.c:576-583)."""
    ng = grid.nghost
    jl, ju = grid.lo(1), grid.hi(1)
    dy = grid.dx[1]
    qom = sim.qshear * sim.omega0
    nd3 = grid.active(2)
    mhd = sim.mhd
    if mhd and not nd3:
        raise NotImplementedError("[Fargo] only works in 3D with MHD")
    U = state.U

    x1c = jnp.asarray(grid.cc_coords(0), U.dtype)
    x1f = x1c - 0.5 * grid.dx[0]
    ysh_c = (-qom * dt) * x1c.reshape(1, 1, -1)
    ysh_f = (-qom * dt) * x1f.reshape(1, 1, -1)

    # energy source for adiabatic MHD (bvals_shear.c:2009-2013), applied
    # before the remap so the advected E includes it
    if mhd and sim.adiabatic:
        qom_dt = qom * dt
        Bcc = state.Bcc
        U = U.at[IEN].add(-qom_dt * Bcc[0] *
                          (Bcc[1] - (qom_dt / 2.0) * Bcc[0]))

    ydim_u, ydim_f = 2, 1
    act_u = (slice(None), slice(None), slice(jl, ju + 1), slice(None))
    act_f = (slice(None), slice(jl, ju + 1), slice(None))

    # --- cell-centered variables -------------------------------------
    V = U[act_u]
    Fl = _fargo_flux(V, jnp.expand_dims(ysh_c, 0), dy, ydim_u + 1 - 1)
    dF = jnp.roll(Fl, -1, axis=2) - Fl
    Unew = U.at[act_u].add(-dF)
    sl_int = (slice(None),) + grid.interior()
    Uout = state.U if not (mhd and sim.adiabatic) else U
    Uout = Uout.at[sl_int].set(Unew[sl_int])
    kw = {}

    if mhd:
        B1i, B2i, B3i = state.B1i, state.B2i, state.B3i
        # emfx = -Vy*Bz at x-cell centers; emfz = Vy*Bx at x-faces
        emfx = -_fargo_flux(B3i[act_f], ysh_c, dy, ydim_f)
        emfz = _fargo_flux(B1i[act_f], ysh_f, dy, ydim_f)
        dx, dz = grid.dx[0], grid.dx[2]
        dEz_y = jnp.roll(emfz, -1, axis=ydim_f) - emfz
        dEx_y = jnp.roll(emfx, -1, axis=ydim_f) - emfx
        B1n = B1i[act_f] - dEz_y
        B2n = B2i[act_f] + (dy / dx) * (jnp.roll(emfz, -1, axis=2) -
                                        emfz) \
            - (dy / dz) * (jnp.roll(emfx, -1, axis=0) - emfx)
        B3n = B3i[act_f] + dEx_y
        # splice over active faces (is..ie+1 / js..je+1 / ks..ke+1,
        # bvals_shear.c:2268-2312: boundary faces via the periodic
        # images of the fluxes, which the rolls above reproduce)
        lo = [grid.lo(a) for a in (2, 1, 0)]
        hi = [grid.hi(a) for a in (2, 1, 0)]
        # rebuild a full-padded view carrying the new active values
        B1w = B1i.at[act_f].set(B1n)
        B2w = B2i.at[act_f].set(B2n)
        B3w = B3i.at[act_f].set(B3n)
        # B2i[je+1] is the periodic image of js (the jfe+1 flux row)
        B2w = B2w.at[:, ju + 1, :].set(B2w[:, jl, :])
        B1o = state.B1i.at[tuple(
            [slice(lo[0], hi[0] + 1), slice(lo[1], hi[1] + 1),
             slice(lo[2], hi[2] + 2)])].set(
                 B1w[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1,
                     lo[2]:hi[2] + 2])
        B2o = state.B2i.at[tuple(
            [slice(lo[0], hi[0] + 1), slice(lo[1], hi[1] + 2),
             slice(lo[2], hi[2] + 1)])].set(
                 B2w[lo[0]:hi[0] + 1, lo[1]:hi[1] + 2,
                     lo[2]:hi[2] + 1])
        B3o = state.B3i.at[tuple(
            [slice(lo[0], hi[0] + 2), slice(lo[1], hi[1] + 1),
             slice(lo[2], hi[2] + 1)])].set(
                 B3w[lo[0]:hi[0] + 2, lo[1]:hi[1] + 1,
                     lo[2]:hi[2] + 1])
        # cell-centered B from faces over active cells
        Bcc = state.Bcc
        intr = grid.interior()
        Bcc = Bcc.at[(0,) + intr].set(
            0.5 * (B1o + jnp.roll(B1o, -1, axis=2))[intr])
        Bcc = Bcc.at[(1,) + intr].set(
            0.5 * (B2o + jnp.roll(B2o, -1, axis=1))[intr])
        Bcc = Bcc.at[(2,) + intr].set(
            0.5 * (B3o + jnp.roll(B3o, -1, axis=0))[intr])
        kw = dict(Bcc=Bcc, B1i=B1o, B2i=B2o, B3i=B3o)

    return state.replace(U=Uout, **kw)
