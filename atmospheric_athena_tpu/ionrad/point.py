"""Point-source ionizing radiation (reference:
src/ionradiation/ionradpoint_3d.c + chealpix.h, the KSG07 adaptive ray
tracing module).

The reference builds ADAPTIVE ray trees: 12*4^l HEALPix rays per source,
each ray marched cell by cell with MPI-buffered hand-offs, rays split as
they leave the source so every cell is crossed by >= MINRAYNUMBER rays
(ionradpoint_3d.c:9-51).  The array redesign replaces the adaptive
tree + per-cell marching with a DENSE fixed-resolution ray fan evaluated
as three vectorized primitives:

  gather  — trilinear sampling of n_H at (nray, nsamp) points along all
            rays at once;
  scan    — cumulative optical depth along the sample axis
            (the per-ray analogue of the plane sweep's prefix product);
  scatter — photon-conserving deposition of the absorbed photons of
            every ray segment into its containing cell
            (ndot_ray*(e^{-tau_k} - e^{-tau_{k+1}}), scatter-add).

Fixed rays trade the reference's adaptivity for a fan dense enough that
every cell at the domain scale sees multiple rays (nside chosen from the
grid size); all three primitives are XLA-native (gather/cumsum/
scatter-add), so the whole source evaluation is one fused program per
sub-iteration — no sequential per-cell marching.

Photon conservation: sum_cells kph*n_H*V = ndot*(1 - e^{-tau_max})
by construction, like the reference's flux-differencing.

HEALPix RING pixel centers (chealpix.h pix2vec_ring) are generated
host-side in numpy.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..config import GridConfig
from .config import IonConfig


def healpix_ring_vectors(nside: int) -> np.ndarray:
    """Unit vectors of the 12*nside^2 HEALPix RING pixel centers
    (Gorski et al. 2005 eqs. 2-6; chealpix pix2vec_ring)."""
    npix = 12 * nside * nside
    p = np.arange(npix)
    ncap = 2 * nside * (nside - 1)
    z = np.empty(npix)
    phi = np.empty(npix)

    # north polar cap
    m = p < ncap
    ph = (p[m] + 1) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(int) + 1
    j = p[m] + 1 - 2 * i * (i - 1)
    z[m] = 1.0 - i * i / (3.0 * nside * nside)
    phi[m] = (j - 0.5) * np.pi / (2.0 * i)

    # equatorial belt
    m = (p >= ncap) & (p < npix - ncap)
    ip = p[m] - ncap
    i = ip // (4 * nside) + nside
    j = ip % (4 * nside) + 1
    s = (i - nside + 1) % 2      # phase shift per ring
    z[m] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
    phi[m] = (j - s / 2.0 - 0.5) * np.pi / (2.0 * nside)

    # south polar cap
    m = p >= npix - ncap
    ph = (npix - p[m]) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(int) + 1
    j = 4 * i + 1 - (npix - p[m] - 2 * i * (i - 1))
    z[m] = -1.0 + i * i / (3.0 * nside * nside)
    phi[m] = (j - 0.5) * np.pi / (2.0 * i)

    st = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), z], axis=1)


def point_source_kph(s0, src, ndot, grid: GridConfig, ion: IonConfig,
                     nside: int = 0, nsamp: int = 0):
    """Photoionization rate field kph [s^-1 per neutral] from one point
    source at `src` (x1,x2,x3) emitting `ndot` ionizing photons/s.

    s0: neutral density over ACTIVE cells [Nz, Ny, Nx]."""
    Nz, Ny, Nx = s0.shape
    dxs = np.array([grid.dx[0], grid.dx[1], grid.dx[2]])
    if nside == 0:
        # every cell at the domain scale crossed by >= ~4 rays
        # (the reference's MINRAYNUMBER refinement criterion)
        nside = max(4, int(2 ** np.ceil(np.log2(max(Nz, Ny, Nx) / 2))))
    dirs = healpix_ring_vectors(nside)              # (nray, 3) in x,y,z
    # fixed symmetry-breaking rotation: HEALPix's symmetry planes and
    # polar rays otherwise align exactly with the Cartesian cell lattice
    # and entire ray paths stack into single cell columns (the reference
    # randomly rotates its ray grid per rebuild for the same reason,
    # ionradpoint_3d.c / KSG07 sec. 2)
    def rot(axis, t):
        c, s = np.cos(t), np.sin(t)
        i, j = (axis + 1) % 3, (axis + 2) % 3
        R = np.eye(3)
        R[i, i] = c; R[j, j] = c; R[i, j] = -s; R[j, i] = s
        return R
    dirs = dirs @ (rot(2, 1.0) @ rot(1, 0.7) @ rot(0, 0.4)).T
    nray = dirs.shape[0]

    # sample step: half the smallest cell; march to the far corner
    ds = 0.5 * dxs.min()
    x0 = np.array([grid.xmin[0], grid.xmin[1], grid.xmin[2]])
    x1 = np.array([grid.xmax[0], grid.xmax[1], grid.xmax[2]])
    span = np.linalg.norm(np.maximum(np.abs(np.asarray(src) - x0),
                                     np.abs(x1 - np.asarray(src))))
    if nsamp == 0:
        nsamp = int(np.ceil(span / ds)) + 1
    r = (jnp.arange(nsamp, dtype=s0.dtype) + 0.5) * ds     # (nsamp,)

    # sample positions -> fractional ACTIVE-cell indices (cc_pos inverse)
    dirsj = jnp.asarray(dirs, s0.dtype)
    pos = (jnp.asarray(np.asarray(src), s0.dtype)[None, None, :]
           + dirsj[:, None, :] * r[None, :, None])         # (nray,ns,3)
    fi = [(pos[..., a] - grid.xmin[a]) / grid.dx[a] - 0.5 for a in
          range(3)]
    inside = ((pos[..., 0] > grid.xmin[0]) & (pos[..., 0] < grid.xmax[0])
              & (pos[..., 1] > grid.xmin[1]) & (pos[..., 1] < grid.xmax[1])
              & (pos[..., 2] > grid.xmin[2]) & (pos[..., 2] < grid.xmax[2]))

    # trilinear gather of n_H at the sample points
    n_H = s0 * (1.0 / ion.m_H)

    i0 = [jnp.clip(jnp.floor(x).astype(jnp.int32), 0, n - 2)
          for x, n in zip(fi, (Nx, Ny, Nz))]
    w = [jnp.clip(x - i.astype(x.dtype), 0.0, 1.0)
         for x, i in zip(fi, i0)]

    def _w8(cx, cy, cz):
        return ((w[0] if cx else 1 - w[0])
                * (w[1] if cy else 1 - w[1])
                * (w[2] if cz else 1 - w[2]))

    nH_s = 0.0
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                nH_s = nH_s + _w8(cx, cy, cz) * n_H[i0[2] + cz,
                                                    i0[1] + cy,
                                                    i0[0] + cx]
    nH_s = jnp.where(inside, nH_s, 0.0)                    # (nray,ns)

    # cumulative optical depth (exclusive) along each ray, then the
    # photons ABSORBED in each segment
    dtau = ion.sigma_ph * nH_s * ds
    tau_excl = jnp.cumsum(dtau, axis=1) - dtau
    # fold the cell-volume normalization into the per-ray luminosity as
    # a HOST double: in CGS the cell volume (and its reciprocal) can
    # overflow/underflow f32 on their own
    Vcell = float(np.prod([float(grid.dx[a]) for a in range(3)]))
    ndot_ray_per_V = ndot / (nray * Vcell)
    absorbed = ndot_ray_per_V * (jnp.exp(-tau_excl)
                                 - jnp.exp(-(tau_excl + dtau)))

    # cloud-in-cell scatter-add (ionizations/s/volume): spread each
    # segment's absorbed photons over the 8 surrounding cells with the
    # SAME trilinear weights used for the gather.  Weights sum to 1 so
    # photon conservation is exact; vs nearest-cell deposition this cuts
    # the per-cell ray-count noise by ~an order of magnitude (the
    # reference instead splits rays adaptively until every cell is
    # crossed by >= MINRAYNUMBER rays, ionradpoint_3d.c:9-51)
    dep = jnp.where(inside, absorbed, 0.0)
    photo = jnp.zeros(Nz * Ny * Nx, s0.dtype)
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                flat = ((i0[2] + cz) * (Ny * Nx) + (i0[1] + cy) * Nx
                        + (i0[0] + cx)).reshape(-1)
                photo = photo.at[flat].add(
                    (_w8(cx, cy, cz) * dep).reshape(-1))
    photo = photo.reshape(Nz, Ny, Nx)

    # rate per neutral atom: kph = photo/n_H
    kph = photo / jnp.maximum(n_H, jnp.finfo(s0.dtype).tiny)
    return kph