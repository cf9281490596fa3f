"""Multigrid self-gravity for ISOLATED (non-periodic) domains
(reference: src/gravity/selfg_multigrid.c).

The reference solves ∇²Φ = 4πGρ with Dirichlet boundary values from a
monopole expansion (selfg_multigrid.c:135-225: Φ_ghost = −G·M_tot/r),
then one recursive multigrid pass (multig_3d, :295-372): 11 Jacobi
sweeps per level on the way down, residual restriction to half
resolution until a dimension reaches 4 cells, prolongation + 11 more
sweeps on the way up.

Array mapping — every stage is a dense vectorized array op:

  Jacobi        —  one fused 7-point stencil update over the whole
                   level per iteration (lax.fori_loop of 11);
  Restriction   —  2×2×2 block mean via reshape (+ the residual as a
                   second fused stencil);
  Prolongation  —  the reference's 0.75·center + 0.25·diagonal-neighbor
                   scheme as two gathers with precomputed parity index
                   maps (selfg_multigrid.c:495-533).

The level hierarchy is a static Python recursion (shapes halve each
level), so the whole V-pass jits into one program.  Deviation from the
reference: the C code warm-starts each solve from the previous step's
Φ (pG->Phi).  Φ is not part of the State pytree here, so each solve
cold-starts from the monopole field and runs `n_cycles` passes (≥2
matches the warm-started single-pass accuracy in practice).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import GridConfig, SimConfig
from ..defs import ID

N_JACOBI = 11          # selfg_multigrid.c:398 "for (n=0; n<=10; n++)"


def _jacobi(phi, rhs, dx2s, active, n=N_JACOBI):
    """n Jacobi sweeps; phi padded by 1 with FIXED (Dirichlet) ghosts.
    2D decks drop the inactive axis's terms (selfg_multigrid.c:414/425)."""
    denom = sum(2.0 / dx2s[a] for a in range(3) if active[a])

    def nbsum(p):
        out = 0.0
        if active[0]:
            out = out + (p[1:-1, 1:-1, 2:] + p[1:-1, 1:-1, :-2]) / dx2s[0]
        if active[1]:
            out = out + (p[1:-1, 2:, 1:-1] + p[1:-1, :-2, 1:-1]) / dx2s[1]
        if active[2]:
            out = out + (p[2:, 1:-1, 1:-1] + p[:-2, 1:-1, 1:-1]) / dx2s[2]
        return out

    def body(_, p):
        return p.at[1:-1, 1:-1, 1:-1].set((nbsum(p) - rhs) / denom)

    return jax.lax.fori_loop(0, n, body, phi)


def _residual(phi, rhs, dx2s, active):
    """rhs − ∇²_discrete Φ on the interior (Restriction_3d:449-460)."""
    c = phi[1:-1, 1:-1, 1:-1]
    lap = 0.0
    if active[0]:
        lap = lap + (phi[1:-1, 1:-1, 2:] + phi[1:-1, 1:-1, :-2]
                     - 2.0 * c) / dx2s[0]
    if active[1]:
        lap = lap + (phi[1:-1, 2:, 1:-1] + phi[1:-1, :-2, 1:-1]
                     - 2.0 * c) / dx2s[1]
    if active[2]:
        lap = lap + (phi[2:, 1:-1, 1:-1] + phi[:-2, 1:-1, 1:-1]
                     - 2.0 * c) / dx2s[2]
    return rhs - lap


def _restrict(q, active):
    """2×2×2 block mean (2×2 in 2D; Restriction_3d:463-478)."""
    nz, ny, nx = q.shape
    sz, sy, sx = (2 if active[2] else 1, 2 if active[1] else 1,
                  2 if active[0] else 1)
    return q.reshape(nz // sz, sz, ny // sy, sy,
                     nx // sx, sx).mean(axis=(1, 3, 5))


def _parity_maps(n, halve):
    """(center, diagonal-neighbor) 1-indexed maps into a padded coarse
    axis for each fine cell: fine pair (2i−1, 2i) ← coarse i, with the
    diagonal at i−1 / i+1 respectively (Prolongation_3d:501-530)."""
    if not halve:
        i = np.arange(n) + 1
        return i, i
    f = np.arange(n)
    c = f // 2 + 1
    return c, c + np.where(f % 2 == 1, 1, -1)


def _prolong(phi_c, fine_shape, active):
    """0.75·center + 0.25·diagonal gather from the padded coarse level."""
    fz, fy, fx = fine_shape
    cz, dz = _parity_maps(fz, active[2])
    cy, dy = _parity_maps(fy, active[1])
    cx, dx = _parity_maps(fx, active[0])
    center = phi_c[cz[:, None, None], cy[None, :, None], cx[None, None, :]]
    diag = phi_c[dz[:, None, None], dy[None, :, None], dx[None, None, :]]
    return 0.75 * center + 0.25 * diag


def _multig(phi, rhs, dx2s, active):
    """One recursive multigrid pass (multig_3d:299-372)."""
    ns = [s - 2 if a else 1
          for s, a in zip(phi.shape, (active[2], active[1], active[0]))]
    phi = _jacobi(phi, rhs, dx2s, active)
    act = [n for n in ns if n > 1]
    if min(act) <= 4 or any(n % 2 for n in act):
        return phi

    res = _residual(phi, rhs, dx2s, active)
    rhs_c = _restrict(res, active)
    # deviation from the reference: it seeds the coarse level with the
    # RESTRICTED fine Phi (selfg_multigrid.c:345 Restriction_3d writes
    # Phi too), which leaves a truncated-Jacobi remnant of that seed in
    # the correction and stalls the cycle's residual at O(1e-2).  The
    # standard correction-scheme seed (zero) makes the exact discrete
    # solution a fixed point, so residuals contract every pass.
    phi_c = jnp.zeros([s + 2 for s in rhs_c.shape], phi.dtype)
    dx2s_c = tuple(4.0 * d if a else d
                   for d, a in zip(dx2s, active))
    phi_c = _multig(phi_c, rhs_c, dx2s_c, active)

    fine_shape = (phi.shape[0] - 2, phi.shape[1] - 2, phi.shape[2] - 2)
    phi = phi.at[1:-1, 1:-1, 1:-1].add(_prolong(phi_c, fine_shape, active))
    return _jacobi(phi, rhs, dx2s, active)


def _monopole_phi(grid: GridConfig, tmass, four_pi_G, dtype):
    """−G·M_tot/r on every padded cell (selfg_multig_3d:135-225)."""
    grav_const = four_pi_G / (4.0 * math.pi)
    r2 = 0.0
    for a in range(3):
        x = np.asarray(grid.cc_coords(a), dtype=np.float64)
        sh = [1, 1, 1]
        sh[2 - a] = x.size
        r2 = r2 + (x * x).reshape(sh)
    r = jnp.asarray(np.sqrt(np.broadcast_to(
        r2, grid.padded_shape()).copy()), dtype)
    # a cell exactly at the origin would divide by zero; cap at the
    # uniform-cube self-potential radius like the OBC kernel
    eps = 0.56 * min(grid.dx[a] for a in range(3) if grid.active(a))
    return -grav_const * tmass / jnp.maximum(r, eps)


def phi_padded_multigrid(state, sim: SimConfig, grid: GridConfig,
                         four_pi_G: float, grav_mean_rho: float = 0.0,
                         n_cycles: int = 3):
    """Solve ∇²Φ = 4πGρ with monopole Dirichlet boundaries; returns Φ on
    the full padded grid (ghosts = monopole, bvals_grav analogue).
    grav_mean_rho is ignored: the isolated-domain solve uses the full ρ
    (selfg_multig_3d:262 rhs = four_pi_G·d, no mean subtraction)."""
    if grid.cylindrical:
        raise NotImplementedError("multigrid self-gravity: Cartesian only")
    if not all(grid.active(a) for a in range(3)):
        # the reference is 3D-only too (selfg_multig_1d/2d ath_error,
        # selfg_multigrid.c:87-102)
        raise NotImplementedError("multigrid self-gravity: 3D only")
    sl = grid.interior()
    d = state.U[(ID,) + sl]
    dtype = d.dtype
    vol = 1.0
    for a in range(3):
        if grid.active(a):
            vol *= grid.dx[a]
    tmass = jnp.sum(d) * vol          # MPI_Allreduce analogue: one psum

    phi_mono = _monopole_phi(grid, tmass, four_pi_G, dtype)
    ng = grid.nghost
    # 1-ghost working arrays (multig uses a single ghost layer per
    # level, selfg_multig_3d:247)
    pad1 = tuple(slice(ng - 1, -(ng - 1)) if grid.active(a) else slice(None)
                 for a in (2, 1, 0))
    phi1 = phi_mono[pad1]
    rhs = four_pi_G * d
    dx2s = tuple(grid.dx[a] * grid.dx[a] for a in range(3))
    active = tuple(grid.active(a) for a in range(3))
    for _ in range(n_cycles):
        phi1 = _multig(phi1, rhs, dx2s, active)

    phi = phi_mono.at[sl].set(phi1[1:-1, 1:-1, 1:-1])
    return phi
