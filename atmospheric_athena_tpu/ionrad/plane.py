"""Plane-parallel radiation sweep (reference:
src/ionradiation/ionradplane_3d.c:88-407, get_ph_rate_plane).

The per-column attenuation recurrence F_{i+1} = F_i·exp(−τ_i)
(ionradplane_3d.c:278-307) is a prefix product — here it becomes a
cumulative product along the sweep axis (an associative scan, O(log N) depth
on hardware, and the building block for the distributed ppermute-carried
version in parallel/).  The MINFLUXFRAC early-exit that zeroes all downstream
faces of a column (ionradplane_3d.c:300-306) is *monotone* (flux never
grows), so it is an elementwise mask on the scanned flux — no sequential
dependence survives.

Faithful quirks preserved:
  - τ uses dx1 for every direction (ionradplane_3d.c:294,337,370) while kph
    divides by the true cell length of the sweep axis;
  - for dir=±1 the cutoff fraction divides by the column inlet + 1e-12
    (ionradplane_3d.c:299); for ±2/±3 it divides by the raw initflux
    (:342,:375) and the reference does not zero downstream faces there.
Deviations (documented): dir>0 descending sweeps use proper indexing (the
reference's EdgeFlux indexing is negative/out-of-range there); dir=±3 uses
dx3 as the cell length (uninitialized in the reference's ascending branch,
ionradplane_3d.c:137-144).  The production problems use dir=-1 where both
codes agree exactly.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import GridConfig
from .config import MINFLUXFRAC, IonConfig


def inlet_ramp(flux_i, time, ion: IonConfig):
    """Level-0 inlet flux with the hard-coded erf time ramp
    flux_i·(5·(erf((t−1.2e5)/8e4)+1)+0.1) (ionradplane_3d.c:263-272)."""
    if not ion.time_ramp:
        return flux_i * jnp.ones_like(time)
    from jax.scipy.special import erf
    return flux_i * (5.0 * (erf((time - 1.2e5) / 8.0e4) + 1.0) + 0.1)


def get_ph_rate_plane(s0, inflow, direction: int, grid: GridConfig,
                      ion: IonConfig):
    """Photoionization rate and edge fluxes for one radiation plane.

    s0:     neutral density over ACTIVE cells, [Nz, Ny, Nx].
    inflow: inlet flux entering the upstream domain face — a scalar (the
            ramped flux for dir=±1 at level 0) or a 2D per-column array
            (SMR/sharded hand-off).
    Returns (kph [Nz,Ny,Nx], edge_flux [... sweep axis +1 ...]).
    """
    axis = abs(direction) - 1
    ascending = direction < 0  # lr=+1 in the reference (ionradplane_3d.c:117)
    adim = 2 - axis

    s0s = jnp.moveaxis(s0, adim, -1)
    if not ascending:
        s0s = jnp.flip(s0s, axis=-1)

    n_H = s0s * (1.0 / ion.m_H)
    tau = ion.sigma_ph * n_H * grid.dx[0]          # dx1 always (see above)
    etau = jnp.exp(-tau)
    cell_len = grid.dx[axis]

    T_incl = jnp.cumprod(etau, axis=-1)
    ones = jnp.ones_like(T_incl[..., :1])
    T_faces = jnp.concatenate([ones, T_incl], axis=-1)   # faces 0..N

    F_in = jnp.asarray(inflow, s0s.dtype)
    if F_in.ndim > 0 and F_in.ndim != s0s.ndim:
        F_in = F_in[..., None]
    F_faces = F_in * T_faces

    if abs(direction) == 1:
        denom = F_in + 1e-12
    else:
        denom = jnp.asarray(inflow, s0s.dtype)
        if denom.ndim > 0 and denom.ndim != s0s.ndim:
            denom = denom[..., None]

    frac = F_faces / denom
    n = s0s.shape[-1]
    idx = jnp.arange(n + 1).reshape((1,) * (s0s.ndim - 1) + (n + 1,))
    alive = (idx == 0) | (frac >= MINFLUXFRAC)

    kph = alive[..., :n] * F_faces[..., :n] * (1.0 - etau) / (n_H * cell_len)
    edge = jnp.where(alive, F_faces, 0.0)

    if not ascending:
        kph = jnp.flip(kph, axis=-1)
        edge = jnp.flip(edge, axis=-1)
    kph = jnp.moveaxis(kph, -1, adim)
    edge = jnp.moveaxis(edge, -1, adim)
    return kph, edge


def get_ph_rate_plane_dist(s0, inflow, direction: int, grid: GridConfig,
                           ion: IonConfig, mesh):
    """Distributed dir=-1 sweep with the x (sweep) axis SHARDED.

    The reference parallelizes the attenuation recurrence as a rank
    pipeline along the radiation axis (ionradplane_3d.c:226-318); the
    array equivalent (SURVEY.md §5.7) is a blockwise two-pass scan:
    each x-shard computes its local cumulative transmittance, the per-shard
    totals are combined with a ppermute-carried exclusive scan (O(log P)
    collective steps), and the local faces are offset by the incoming
    prefix.  Reassociates the product — equal to the serial sweep to
    roundoff.

    Returns (kph [sharded like s0], edge_left [Nz,Ny,Nx sharded],
    edge_shard_exits [Nz,Ny,P]) — the global downstream face is
    edge_shard_exits[..., -1]; the full legacy (Nx+1)-face array is
    concat(edge_left, edge_shard_exits[..., -1:]).
    """
    import jax
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map as _shard_map

        def shard_map(f, mesh, in_specs, out_specs):
            return _shard_map(f, mesh=mesh, in_specs=in_specs,
                              out_specs=out_specs)
    except ImportError:
        from jax.experimental.shard_map import shard_map as _sm

        def shard_map(f, mesh, in_specs, out_specs):
            return _sm(f, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs)

    assert direction == -1, "distributed sweep: dir=-1 only"
    nP = mesh.shape["x"]

    def body(s0_blk, Fin):
        idxs = jax.lax.axis_index("x")
        n_H = s0_blk * (1.0 / ion.m_H)
        tau = ion.sigma_ph * n_H * grid.dx[0]
        etau = jnp.exp(-tau)
        T_incl = jnp.cumprod(etau, axis=-1)
        tot = T_incl[..., -1:]

        # exclusive product-scan of shard totals (Hillis-Steele over the
        # ring; non-receivers get ppermute zeros, masked back to 1)
        x_ = tot
        k = 1
        while k < nP:
            sh = jax.lax.ppermute(x_, "x",
                                  [(i, i + k) for i in range(nP - k)])
            x_ = x_ * jnp.where(idxs >= k, sh, jnp.ones_like(sh))
            k *= 2
        exc = jax.lax.ppermute(x_, "x", [(i, i + 1) for i in range(nP - 1)])
        exc = jnp.where(idxs == 0, jnp.ones_like(exc), exc)

        ones = jnp.ones_like(T_incl[..., :1])
        T_faces = jnp.concatenate([ones, T_incl], axis=-1) * exc
        F_faces = Fin * T_faces
        frac = F_faces / (Fin + 1e-12)
        n = s0_blk.shape[-1]
        iarr = jnp.arange(n + 1).reshape((1, 1, n + 1))
        alive = ((iarr == 0) & (idxs == 0)) | (frac >= MINFLUXFRAC)
        kph = alive[..., :n] * F_faces[..., :n] * (1.0 - etau) / \
            (n_H * grid.dx[0])
        edge = jnp.where(alive, F_faces, 0.0)
        return kph, edge[..., :n], edge[..., n:]

    Fin = jnp.asarray(inflow, s0.dtype)
    return shard_map(body, mesh,
                     in_specs=(P("z", "y", "x"), P()),
                     out_specs=(P("z", "y", "x"), P("z", "y", "x"),
                                P("z", "y", "x")))(s0, Fin)
