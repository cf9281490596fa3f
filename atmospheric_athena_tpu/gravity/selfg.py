"""Self-gravity: periodic FFT Poisson solver + source terms
(reference: src/gravity/selfg_fft.c, selfg.c).

The reference solves ∇²Φ = 4πG(ρ−ρ̄) with Plimpton's MPI block FFT
(fftsrc/); here this is jnp.fft.fftn — under pjit XLA shards the
transposes over the mesh (SURVEY.md §2.4 row 7).  The Green's function is
the DISCRETE Laplacian's, G(k) = 1/Σ_a (2cos(k_a·Δ_a... index form)−2)/Δa²
(selfg_fft.c:~154-200), so ∇²_discrete Φ = 4πG δρ holds to roundoff — the
property the verification test checks.

The momentum source terms use the divergence of the gravitational stress
tensor (selfg.c:selfg_fc docstring): exact momentum conservation; the
energy sources are mass-flux-weighted like the static-potential ones.
selfg_fc implements the 2nd-order old/new-Phi flux correction
(selfg.c:7-120) using the step's mass fluxes; solve_phi_obc adds the
open-boundary (isolated) FFT solve.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1


def solve_phi_periodic(d_active, grid: GridConfig, four_pi_G: float,
                       grav_mean_rho: float):
    """Φ on active cells from ρ (periodic BCs), discrete-Laplacian Green's
    function exactly as selfg_fft_3d (selfg_fft.c)."""
    rho = four_pi_G * (d_active - grav_mean_rho)
    axes = [a for a in range(3) if grid.Nx[a] > 1]
    fft_dims = [2 - a for a in axes]
    W = jnp.fft.fftn(rho, axes=fft_dims)

    denom = jnp.zeros(d_active.shape, rho.dtype)
    for a in axes:
        n = grid.Nx[a]
        k = np.arange(n)
        term = (2.0 * np.cos(2.0 * math.pi * k / n) - 2.0) / grid.dx[a] ** 2
        shape = [1, 1, 1]
        shape[2 - a] = n
        denom = denom + jnp.asarray(term.reshape(shape), rho.dtype)
    # zero mode: potential defined up to a constant; set to zero (:163-166)
    safe = jnp.where(denom == 0.0, 1.0, denom)
    What = jnp.where(denom == 0.0, 0.0, W / safe)
    phi = jnp.fft.ifftn(What, axes=fft_dims).real
    return phi


def phi_padded(state, sim: SimConfig, grid: GridConfig, four_pi_G: float,
               grav_mean_rho: float):
    """Solve Φ and place it in a padded array with ghost fill; dispatch
    on the configured solver (--with-gravity=fft|fft_obc|multigrid)."""
    solver = getattr(sim, "selfg_solver", "fft")
    if solver == "multigrid":
        from .multigrid import phi_padded_multigrid
        return phi_padded_multigrid(state, sim, grid, four_pi_G,
                                    grav_mean_rho)
    if solver == "fft_obc":
        return _phi_padded_obc(state, sim, grid, four_pi_G)
    sl = grid.interior()
    phi_a = solve_phi_periodic(state.U[(ID,) + sl], grid, four_pi_G,
                               grav_mean_rho)
    ng = grid.nghost
    phi = jnp.zeros(grid.padded_shape(), phi_a.dtype)
    phi = phi.at[sl].set(phi_a)
    # periodic ghosts (bvals_grav.c analogue) along active axes
    for a in range(3):
        if not grid.active(a):
            continue
        dim = 2 - a
        n = phi.shape[dim]

        def take(s):
            idx = [slice(None)] * 3
            idx[dim] = s
            return phi[tuple(idx)]

        lo = take(slice(n - 2 * ng, n - ng))
        hi = take(slice(ng, 2 * ng))
        idxl = [slice(None)] * 3
        idxl[dim] = slice(0, ng)
        idxh = [slice(None)] * 3
        idxh[dim] = slice(n - ng, None)
        phi = phi.at[tuple(idxl)].set(lo).at[tuple(idxh)].set(hi)
    return phi


def solve_phi_obc(d_active, grid: GridConfig, four_pi_G: float):
    """Open (isolated) boundary Poisson solve via the zero-padded FFT
    convolution (Hockney & Eastwood; reference selfg_fft_obc.c solves the
    disk-geometry variant with complex phase offsets — here the general
    3D James/Hockney doubling, as whole-array FFTs).

    Pads the density into a domain doubled along every active axis,
    convolves with the point-mass kernel G(r) = -four_pi_G/(4 pi r)
    (softened at r = 0 with the standard 0.56*dx-equivalent cell factor),
    and returns the open-boundary potential on the active cells."""
    axes = [a for a in range(3) if grid.Nx[a] > 1]
    shape = d_active.shape
    pad_shape = list(shape)
    for a in axes:
        pad_shape[2 - a] = 2 * shape[2 - a]
    rho = jnp.zeros(pad_shape, d_active.dtype)
    rho = rho.at[tuple(slice(0, s) for s in shape)].set(d_active)

    # point-mass kernel on the doubled, wrapped lattice
    r2 = jnp.zeros(pad_shape, d_active.dtype)
    for a in axes:
        n = pad_shape[2 - a]
        ix = np.arange(n)
        ix = np.minimum(ix, n - ix)            # wrapped distance
        x = ix * grid.dx[a]
        sh = [1, 1, 1]
        sh[2 - a] = n
        r2 = r2 + jnp.asarray((x * x).reshape(sh), d_active.dtype)
    cellvol = np.prod([grid.dx[a] for a in axes])
    # r=0 self-cell: the mean potential of a uniform cube ~ -G m/(0.56 dx)
    eps = 0.56 * min(grid.dx[a] for a in axes)
    r = jnp.sqrt(r2)
    kern = -four_pi_G / (4.0 * math.pi) * cellvol / jnp.maximum(r, eps)

    dims = [2 - a for a in axes]
    phi = jnp.fft.ifftn(jnp.fft.fftn(rho, axes=dims)
                        * jnp.fft.fftn(kern, axes=dims), axes=dims).real
    return phi[tuple(slice(0, s) for s in shape)]


def _phi_padded_obc(state, sim: SimConfig, grid: GridConfig,
                    four_pi_G: float):
    """Open-boundary FFT solve with monopole ghost fill (the multigrid
    module's boundary expansion doubles as the bvals_grav analogue for
    any isolated-domain solver)."""
    from .multigrid import _monopole_phi
    sl = grid.interior()
    d = state.U[(ID,) + sl]
    phi_a = solve_phi_obc(d, grid, four_pi_G)
    vol = 1.0
    for a in range(3):
        if grid.active(a):
            vol *= grid.dx[a]
    tmass = jnp.sum(d) * vol
    phi = _monopole_phi(grid, tmass, four_pi_G, d.dtype)
    return phi.at[sl].set(phi_a)


def selfg_fc(U, phi_new, phi_old, mass_flux, dt, sim: SimConfig,
             grid: GridConfig, four_pi_G: float, grav_mean_rho: float):
    """2nd-order flux correction (selfg.c:selfg_fc): after the new Phi is
    solved from the updated density, replace the predictor's
    gravity-stress fluxes (old Phi) by the time-centered average —
    i.e. subtract half the difference of the stress fluxes of new vs old
    Phi, and correct E with the mass-flux-weighted dPhi differences.

    phi_*: padded potentials; mass_flux: dict axis -> padded density-flux
    array from the integrator's final fluxes.  Returns the corrected U.
    """
    def sh(q, k, a):
        return jnp.roll(q, -k, axis=2 - a)

    axes = [a for a in range(3) if grid.active(a)]
    for a in axes:
        dtodx = dt / grid.dx[a]
        phl_n = 0.5 * (sh(phi_new, -1, a) + phi_new)
        phr_n = 0.5 * (phi_new + sh(phi_new, 1, a))
        phl_o = 0.5 * (sh(phi_old, -1, a) + phi_old)
        phr_o = 0.5 * (phi_old + sh(phi_old, 1, a))
        gl_n = (sh(phi_new, -1, a) - phi_new) / grid.dx[a]
        gr_n = (phi_new - sh(phi_new, 1, a)) / grid.dx[a]
        gl_o = (sh(phi_old, -1, a) - phi_old) / grid.dx[a]
        gr_o = (phi_old - sh(phi_old, 1, a)) / grid.dx[a]
        flx_l = (0.5 * (gl_n * gl_n - gl_o * gl_o) / four_pi_G
                 + grav_mean_rho * (phl_n - phl_o))
        flx_r = (0.5 * (gr_n * gr_n - gr_o * gr_o) / four_pi_G
                 + grav_mean_rho * (phr_n - phr_o))
        U = U.at[IM1 + a].add(-0.5 * dtodx * (flx_r - flx_l))
        if sim.adiabatic:
            dphic = phi_new - phi_old
            dphil = phl_n - phl_o
            dphir = phr_n - phr_o
            F = mass_flux[a]
            dE = 0.5 * dtodx * (F * (dphic - dphil) +
                                sh(F, 1, a) * (dphir - dphic))
            U = U.at[IEN].add(-dE)
    return U
