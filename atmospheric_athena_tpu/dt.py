"""CFL timestep (reference: src/new_dt.c:32-198).

max_dti = max over active cells and active axes of (|v_a| + cf_a)/dx_a, with
cf the per-axis fast magnetosonic speed built from the *maximum* of face- and
cell-centered B (new_dt.c:86-92) and a TINY_NUMBER pressure floor.  Then
dt = CourNo/max_dti, limited to 2× the previous dt except on step 0
(new_dt.c:167-171); the global MPI_Allreduce(MIN) (new_dt.c:175-179) becomes
a psum-free jnp.min under pjit (sharded reductions are handled by XLA) and
the tlim clip lives in the driver.
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import GridConfig, SimConfig
from .defs import ID, IEN, IM1, TINY_NUMBER
from .state import State


def max_dti(state: State, sim: SimConfig, grid: GridConfig):
    """Maximum inverse timestep over this grid's active cells."""
    if sim.special_relativity:
        # signal speeds bounded by c = 1 (new_dt.c:65-66)
        dti = 0.0
        for a in range(3):
            if grid.active(a):
                dti = max(dti, 1.0 / grid.dx[a])
        import jax.numpy as _jnp
        return _jnp.asarray(dti, state.U.dtype)

    sl = grid.interior()
    U = state.U[(slice(None),) + sl]
    di = 1.0 / U[ID]
    v = [U[IM1 + a] * di for a in range(3)]
    qsq = v[0] ** 2 + v[1] ** 2 + v[2] ** 2

    if sim.mhd:
        b = []
        for a, Bi in enumerate((state.B1i, state.B2i, state.B3i)):
            Bc = state.Bcc[a][sl]
            b.append(Bc + jnp.abs(Bi[sl] - Bc))
        bsq = b[0] ** 2 + b[1] ** 2 + b[2] ** 2
        if sim.adiabatic:
            p = jnp.maximum(sim.gamma_1 * (U[IEN] - 0.5 * U[ID] * qsq
                                           - 0.5 * bsq), TINY_NUMBER)
            asq = sim.gamma * p * di
        else:
            asq = sim.iso_csound2
        tsum = bsq * di + asq
        tdif = bsq * di - asq
        cfsq = [0.5 * (tsum + jnp.sqrt(
            tdif * tdif + 4.0 * asq *
            (b[(a + 1) % 3] ** 2 + b[(a + 2) % 3] ** 2) * di))
            for a in range(3)]
    else:
        if sim.adiabatic:
            p = jnp.maximum(sim.gamma_1 * (U[IEN] - 0.5 * U[ID] * qsq),
                            TINY_NUMBER)
            asq = sim.gamma * p * di
        else:
            asq = sim.iso_csound2 * jnp.ones_like(di)
        cfsq = [asq, asq, asq]

    dti = jnp.zeros((), U.dtype)
    for a in range(3):
        if grid.Nx[a] > 1:
            sig = jnp.abs(v[a]) + jnp.sqrt(cfsq[a])
            if a == 1 and grid.cylindrical:
                # phi signal speed over the ARC length r·dphi
                # (new_dt.c:129-131: max_v2 uses (|v2|+cf2)/x1)
                import numpy as np
                r = jnp.asarray(
                    np.asarray(grid.r_coords(), U.dtype)[
                        grid.lo(0):grid.hi(0) + 1])
                sig = sig / r
            max_v = jnp.max(sig)
            dti = jnp.maximum(dti, max_v / grid.dx[a])
    return dti


def new_dt(state: State, sim: SimConfig, grid: GridConfig, cour_no: float):
    """New dt with the 2× growth clamp (new_dt.c:167-171)."""
    dti = max_dti(state, sim, grid)
    dt = cour_no / dti
    return jnp.where(state.nstep == 0, dt, jnp.minimum(2.0 * state.dt, dt))
