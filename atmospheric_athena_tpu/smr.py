"""Static mesh refinement: restriction, flux correction, prolongation, and
the ionizing-radiation couplings (reference: src/smr.c, src/init_grid.c
overlap setup, src/ionradiation/ionrad_smr.c).

Array formulation: each level's Domain is a dense padded State; the
parent/child couplings are reshape-means (restriction), slice updates
(flux correction at the fine/coarse boundary), and vectorized monotonized
slope interpolation (prolongation) — no per-overlap message plumbing, the
arrays ARE the overlap (single-controller; under pjit the slice updates
lower to the same gather/scatter collectives the reference does with MPI).

Geometry: a child Domain at level l+1 covers the parent cell box
[disp/2, disp/2 + Nx/2) in parent active coordinates, where `disp` is the
<domainN> iDisp/jDisp/kDisp displacement measured in CHILD-level cells
(init_mesh.c reads Disp in own-level units; refinement ratio is 2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import GridConfig, SimConfig
from .defs import IEN


class ChildLink(NamedTuple):
    """Parent-side description of one child Domain overlap."""
    # parent ACTIVE-cell start/end (exclusive) of the overlap box, per axis
    start: Tuple[int, int, int]
    end: Tuple[int, int, int]


def child_link(parent: GridConfig, child: GridConfig,
               disp: Tuple[int, int, int],
               parent_disp: Tuple[int, int, int] = (0, 0, 0)) -> ChildLink:
    """Overlap of the child within its parent, in PARENT active cells.

    `disp`/`parent_disp` are root-origin displacements in each domain's
    OWN-level cells (init_mesh.c Disp[]); the child's start inside the
    parent is disp/2 - parent_disp."""
    start = []
    end = []
    for a in range(3):
        if parent.active(a):
            s = disp[a] // 2 - parent_disp[a]
            e = s + child.Nx[a] // 2
        else:
            s, e = 0, 1
        start.append(s)
        end.append(e)
    return ChildLink(tuple(start), tuple(end))


# ---------------------------------------------------------------------------
# restriction (smr.c RestrictCorrect step 1: conserved mean over 2^nDim)
# ---------------------------------------------------------------------------


def restrict_mean(q, active):
    """Mean over 2x2x2 fine cells (2 per ACTIVE axis).  q: [..., Nz, Ny, Nx]
    fine ACTIVE-cell array; active: per-axis bool.

    Implemented as strided-slice sums rather than a reshape+mean: the
    odd-split reshape of large stacked arrays made XLA assign a tiled
    layout to the leading (variable) axis at hires scales, materializing a
    21x-padded copy of the level-5 fine grid (15.6 GB for 750 MB of
    data)."""
    out = q
    for a in range(3):
        if not active[a]:
            continue
        adim = out.ndim - 1 - a
        sl0 = [slice(None)] * out.ndim
        sl1 = [slice(None)] * out.ndim
        sl0[adim] = slice(0, None, 2)
        sl1[adim] = slice(1, None, 2)
        # one axis at a time: a single triple-strided gather of the full
        # hires fine level made XLA materialize a lane-padded layout
        # copy (nv minor -> 21x expansion, 18 GB at 328^3)
        out = 0.5 * (out[tuple(sl0)] + out[tuple(sl1)])
    return out


def _overlap_slices(grid: GridConfig, link: ChildLink):
    """Padded-array slices (z, y, x order) of the parent overlap box."""
    return tuple(slice(grid.lo(a) + link.start[a],
                       grid.lo(a) + link.end[a]) for a in (2, 1, 0))


def restrict_to_parent(Up, Uf, pgrid: GridConfig, fgrid: GridConfig,
                       link: ChildLink, nvars=None):
    """Replace parent overlap cells with the restricted child actives
    (smr.c:1302-1325).  nvars: optional leading-index list (e.g. [IEN, s0]
    for ionradRestrictCorrect, smr.c:85-200) — default all."""
    act = tuple(fgrid.active(a) for a in range(3))
    fsl = (slice(None),) + fgrid.interior()
    rest = restrict_mean(Uf[fsl], act)
    psl = (slice(None),) + _overlap_slices(pgrid, link)
    if nvars is None:
        return Up.at[psl].set(rest.astype(Up.dtype))
    out = Up
    for n in nvars:
        out = out.at[(n,) + psl[1:]].set(rest[n].astype(Up.dtype))
    return out


# ---------------------------------------------------------------------------
# flux correction (smr.c:1489-1675): coarse cells ADJACENT to the overlap
# box get U -= ±dt/dx (coarse_face_flux − restricted_fine_face_flux)
# ---------------------------------------------------------------------------


def flux_correct(Up, coarse_flux, fine_flux, pgrid: GridConfig,
                 fgrid: GridConfig, link: ChildLink, dt):
    """coarse_flux / fine_flux: dicts axis -> padded interface-flux array
    [nv, ...] (flux at index f = interface between cells f-1 and f), from
    the respective integrators' final fluxes.  Corrects the parent cells
    one layer outside each fine/coarse boundary face."""
    U = Up
    for a in range(3):
        if not pgrid.active(a):
            continue
        adim = 2 - a
        dtodx = dt / pgrid.dx[a]
        act = [fgrid.active(x) for x in range(3)]
        act[a] = False  # restrict only transverse to the face
        # fine-face transverse slices (active cells of the other two axes)
        for dim, sgn in ((0, -1.0), (1, +1.0)):
            # parent cell layer index (padded): ics-1 or ice+1 along a
            if dim == 0:
                pc = pgrid.lo(a) + link.start[a] - 1
                fface = fgrid.lo(a)                       # child lower face
            else:
                pc = pgrid.lo(a) + link.end[a]
                fface = fgrid.lo(a) + fgrid.Nx[a]         # child upper face
            # skip faces flush with the parent's own boundary
            if pc < pgrid.lo(a) or pc > pgrid.hi(a):
                continue
            psl = list(_overlap_slices(pgrid, link))
            psl[adim] = pc
            cf_sl = list((slice(None),) + tuple(psl))
            # coarse flux at the boundary face: interface index = start (for
            # lower face) or end (upper face) of the box
            face_idx = (pgrid.lo(a) + link.start[a]) if dim == 0 else \
                (pgrid.lo(a) + link.end[a])
            csl = list((slice(None),) + _overlap_slices(pgrid, link))
            csl[1 + adim] = face_idx
            Fc = coarse_flux[a][tuple(csl)]
            # restricted fine flux on that face
            fsl = list((slice(None),) + fgrid.interior())
            fsl[1 + adim] = fface
            Ff = fine_flux[a][tuple(fsl)]
            Ff = restrict_mean(jnp.expand_dims(Ff, 1 + adim),
                               act).squeeze(1 + adim)
            corr = sgn * dtodx * (Fc - Ff.astype(Fc.dtype))
            U = U.at[tuple(cf_sl)].add(-corr)
    return U


# ---------------------------------------------------------------------------
# prolongation (smr.c Prolongate + ProCon): child ghost zones from parent
# ---------------------------------------------------------------------------


def _mcd_slope(vl, vc, vr):
    """Monotonized central-difference slope (smr.c:3718-3737)."""
    dvl = vc - vl
    dvr = vr - vc
    dvm = 0.5 * (dvl + dvr)
    same_pos = (dvl > 0.0) & (dvr > 0.0)
    same_neg = (dvl < 0.0) & (dvr < 0.0)
    dv_pos = 2.0 * jnp.minimum(dvl, dvr)
    dv_neg = 2.0 * jnp.maximum(dvl, dvr)
    return jnp.where(same_pos, jnp.minimum(dvm, dv_pos),
                     jnp.where(same_neg, jnp.maximum(dvm, dv_neg), 0.0))


def prolong_box(Uc, active):
    """ProCon over a whole coarse box: [nv, nz, ny, nx] -> fine
    [nv, 2nz, 2ny, 2nx] (per active axis) with mcd-limited slopes.  The
    outermost coarse cell on each active axis is slope-support only — the
    caller passes a box padded by 1 and trims 2 fine cells per side."""
    # ALL slopes are limited on the COARSE data, then applied together
    # (ProCon: PCon = Ui + (0.5i-0.25)dq1 + (0.5j-0.25)dq2 +
    # (0.5k-0.25)dq3) — interleaving axis-by-axis and re-limiting on the
    # half-refined values is NOT the same thing (the limiter is
    # nonlinear)
    dq = {}
    for a in range(3):
        if not active[a]:
            continue
        adim = Uc.ndim - 1 - a
        vl = jnp.roll(Uc, 1, axis=adim)
        vr = jnp.roll(Uc, -1, axis=adim)
        dq[a] = _mcd_slope(vl, Uc, vr)
    shp = list(Uc.shape)
    for a in range(3):
        if active[a]:
            shp[Uc.ndim - 1 - a] *= 2
    out = jnp.zeros(shp, Uc.dtype)
    offs = [((0, 1) if active[a] else (0,)) for a in range(3)]
    for oz in offs[2]:
        for oy in offs[1]:
            for ox in offs[0]:
                v = Uc
                for a, o in ((0, ox), (1, oy), (2, oz)):
                    if a in dq:
                        v = v + (0.5 * o - 0.25) * dq[a]
                idx = [slice(None)] * Uc.ndim
                for a, o in ((0, ox), (1, oy), (2, oz)):
                    if active[a]:
                        idx[Uc.ndim - 1 - a] = slice(o, None, 2)
                out = out.at[tuple(idx)].set(v)
    return out


def prolong_ghosts(Uc, Uf, pgrid: GridConfig, fgrid: GridConfig,
                   link: ChildLink, sim: Optional[SimConfig] = None,
                   Bccc=None):
    """Fill ALL child ghost zones from the parent (the hires-deck children
    are fully interior, so every face is a ProlongateLater face,
    bvals_mhd.c:560-575).  Prolongs the coarse box covering the child plus
    nghost/2 coarse ghost layers, then splices only the child's ghost
    cells (smr.c:2359-2700, second-order ProCon path).

    When `sim` is given and Newtonian-adiabatic, the energy is prolonged
    the reference way: ProCon slopes the GAS PRESSURE-like quantity
    P = E - ke - me ("Prolongate P not E. This is intentionally
    non-conservative", smr.c:3206-3240) and rebuilds E from the
    prolonged momenta (and the ProCon-prolonged Bcc, passed as `Bccc`
    for MHD).  SR prolongs E directly (smr.c:3191-3204)."""
    ng = fgrid.nghost
    ngc = ng // 2
    act = tuple(fgrid.active(a) for a in range(3))
    # coarse source box: overlap expanded by ngc+1 (slope support)
    src = []
    for a in (2, 1, 0):
        if pgrid.active(a):
            s = pgrid.lo(a) + link.start[a] - ngc - 1
            e = pgrid.lo(a) + link.end[a] + ngc + 1
        else:
            s, e = 0, 1
        src.append(slice(s, e))
    box = Uc[(slice(None),) + tuple(src)]
    pressure_e = (sim is not None and sim.adiabatic
                  and not sim.special_relativity)
    nbcc = 0
    if pressure_e:
        ke = 0.5 * (box[1] ** 2 + box[2] ** 2 + box[3] ** 2) / box[0]
        P = box[IEN] - ke
        if sim.mhd:
            assert Bccc is not None
            bb = Bccc[(slice(None),) + tuple(src)]
            P = P - 0.5 * (bb[0] ** 2 + bb[1] ** 2 + bb[2] ** 2)
            box = jnp.concatenate([box.at[IEN].set(P), bb], 0)
            nbcc = 3
        else:
            box = box.at[IEN].set(P)
    fine = prolong_box(box, act)
    if pressure_e:
        kef = 0.5 * (fine[1] ** 2 + fine[2] ** 2 + fine[3] ** 2) \
            / fine[0]
        Ef = fine[IEN] + kef
        if sim.mhd:
            Ef = Ef + 0.5 * (fine[-3] ** 2 + fine[-2] ** 2 +
                             fine[-1] ** 2)
            fine = fine[:-nbcc]
        fine = fine.at[IEN].set(Ef)
    # trim the slope-support cell (2 fine cells) per active axis
    trim = tuple(slice(2, -2) if act[2 - i] else slice(None)
                 for i in range(3))
    fine = fine[(slice(None),) + trim]
    # fine now covers the child padded array exactly (Nx + 2*ng per axis)
    mask_sl = (slice(None),) + fgrid.interior()
    return jnp.asarray(fine, Uf.dtype).at[mask_sl].set(Uf[mask_sl])


# ---------------------------------------------------------------------------
# ionizing radiation hand-off (ionrad_smr.c:34-80 + ionradplane_3d.c:270-272)
# ---------------------------------------------------------------------------


def child_inlet_flux(parent_eflux, pgrid: GridConfig, fgrid: GridConfig,
                     link: ChildLink, direction: int):
    """Parent EdgeFlux on the child's upstream face -> per-column inlet
    flux for the child sweep (piecewise-constant onto the 2x2 fine
    columns, matching the reference's direct copy of parent face fluxes).

    parent_eflux: [Nz, Ny, Nx+1]-style ACTIVE edge array along the sweep
    axis (as produced by the radiation driver).  Returns a fine 2D array
    broadcastable against the child's transverse shape."""
    assert abs(direction) == 1, "EdgeFlux hand-off implemented for the " \
        "production x-axis planes (ionradplane_3d.c dir=-1)"
    a = abs(direction) - 1
    adim = 2 - a
    # parent face index at the child's upstream face (in active edge coords)
    face = link.start[a] if direction < 0 else link.end[a]
    sl = [slice(link.start[2], link.end[2]),
          slice(link.start[1], link.end[1]),
          slice(link.start[0], link.end[0])]
    sl[adim] = face
    plane = parent_eflux[tuple(sl)]          # coarse transverse plane
    # upsample x2 along each remaining active axis
    for i in range(plane.ndim):
        plane = jnp.repeat(plane, 2, axis=i)
    # insert the sweep axis back as a trailing singleton for broadcasting
    return jnp.expand_dims(plane, adim if adim < plane.ndim else plane.ndim)


def boundary_flux_planes_fine(F, fgrid: GridConfig):
    """The child's own interface fluxes on its 6 boundary planes over the
    active transverse box — what the reference stores in pPO->myFlx
    (integrate_3d_ctu.c:3230-3300) instead of whole flux cubes."""
    out = {}
    for a in range(3):
        if not fgrid.active(a):
            continue
        adim = 2 - a
        for side in (0, 1):
            fs = list((slice(None),) + fgrid.interior())
            fs[1 + adim] = fgrid.lo(a) + (0 if side == 0 else fgrid.Nx[a])
            out[(a, side)] = F[a][tuple(fs)]
    return out


def boundary_flux_planes_coarse(F, pgrid: GridConfig, link: ChildLink):
    """The parent's fluxes on the child-overlap boundary planes
    (pCO->myFlx, integrate_3d_ctu.c:3080-3200)."""
    out = {}
    for a in range(3):
        if not pgrid.active(a):
            continue
        adim = 2 - a
        for side in (0, 1):
            face_idx = pgrid.lo(a) + (link.start[a] if side == 0
                                      else link.end[a])
            csl = list((slice(None),) + _overlap_slices(pgrid, link))
            csl[1 + adim] = face_idx
            out[(a, side)] = F[a][tuple(csl)]
    return out


def flux_correct_planes(Up, cplanes, fplanes, pgrid: GridConfig,
                        fgrid: GridConfig, link: ChildLink, dt):
    """flux_correct on pre-extracted boundary planes (the memory-correct
    form: per-level integrators return only these planes, never the full
    flux cubes — a 320^3 level's three flux cubes alone are 2.5 GB)."""
    U = Up
    for a in range(3):
        if not pgrid.active(a):
            continue
        adim = 2 - a
        dtodx = dt / pgrid.dx[a]
        act = [fgrid.active(x) for x in range(3)]
        act[a] = False
        for side, sgn in ((0, -1.0), (1, +1.0)):
            pc = pgrid.lo(a) + link.start[a] - 1 if side == 0 \
                else pgrid.lo(a) + link.end[a]
            if pc < pgrid.lo(a) or pc > pgrid.hi(a):
                continue
            psl = list(_overlap_slices(pgrid, link))
            psl[adim] = pc
            cf_sl = (slice(None),) + tuple(psl)
            Fc = cplanes[(a, side)]
            Ff = fplanes[(a, side)]
            Ff = restrict_mean(jnp.expand_dims(Ff, 1 + adim),
                               act).squeeze(1 + adim)
            corr = sgn * dtodx * (Fc - Ff.astype(Fc.dtype))
            U = U.at[cf_sl].add(-corr)
    return U
