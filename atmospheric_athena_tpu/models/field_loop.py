"""Field-loop advection problem (reference: src/prob/field_loop.c).

A weak magnetic loop (from the vector potential A3 = A0*(rad - r) inside
r < rad) advected by a uniform flow; the classic CT divergence-preservation
test.  The interface field comes from utils.vecpot_to_b_interface — the
whole-grid vecpot2b*i (utils.c) — so div(B) = 0 to roundoff at t=0 and CT
keeps it there.

<problem>: rad, amp, vflow [, drat=1], iprob=1 (the loop in the x1-x2
plane; other iprob orientations pending).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..utils.fields import compute_div_b, vecpot_to_b_interface
from . import register


@register("field_loop")
class FieldLoop:
    sim_overrides = {"gas": "mhd"}

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        # flow direction uses the ROOT domain extents (RootMinX/RootMaxX,
        # field_loop.c:230-233), not this level's
        from ..config import grid_config_from_par
        self.root = grid_config_from_par(par) if par.exist(
            "domain1", "Nx1") else grid

    def init(self, par, sim: SimConfig, grid: GridConfig):
        dtype = sim.jnp_dtype()
        st = state_mod.zeros(sim, grid)
        rad = par.getd("problem", "rad")
        amp = par.getd("problem", "amp")
        vflow = par.getd("problem", "vflow")
        iprob = par.geti_def("problem", "iprob", 1)
        assert iprob == 1, "field_loop orientations beyond iprob=1 pending"

        def A3(x1, x2, x3):
            r = np.sqrt(x1 ** 2 + x2 ** 2)
            return amp * np.maximum(rad - r, 0.0)

        B1i, B2i, B3i = vecpot_to_b_interface((None, None, A3), grid)
        B1i = jnp.asarray(B1i, dtype)
        B2i = jnp.asarray(B2i, dtype)
        B3i = jnp.asarray(B3i, dtype)

        def cc(Bi, a):
            return 0.5 * (Bi + jnp.roll(Bi, -1, axis=2 - a)) \
                if grid.active(a) else Bi

        Bcc = jnp.stack([cc(B1i, 0), cc(B2i, 1), cc(B3i, 2)])

        # uniform flow along the full 3D root-domain diagonal, with a
        # density (and passive-scalar) enhancement `drat` inside the
        # loop (field_loop.c:230-253; RootMaxX sizes are used even when
        # an axis is collapsed, so a 2D run can carry M3)
        sizes = [self.root.xmax[a] - self.root.xmin[a] for a in range(3)]
        diag = math.sqrt(sum(sz ** 2 for sz in sizes))
        drat = par.getd_def("problem", "drat", 1.0)
        x1c = np.asarray(grid.cc_coords(0)).reshape(1, 1, -1)
        x2c = np.asarray(grid.cc_coords(1)).reshape(1, -1, 1)
        x3c = np.asarray(grid.cc_coords(2)).reshape(-1, 1, 1)
        inloop = (x1c ** 2 + x2c ** 2 + x3c ** 2) < rad * rad
        d0 = jnp.asarray(np.where(inloop, drat, 1.0), dtype)
        d0 = jnp.broadcast_to(d0, st.U.shape[1:])
        U = st.U.at[ID].set(d0)
        U = U.at[IM1].set(d0 * vflow * sizes[0] / diag)
        U = U.at[IM1 + 1].set(d0 * vflow * sizes[1] / diag)
        U = U.at[IM1 + 2].set(d0 * vflow * sizes[2] / diag)
        if sim.adiabatic:
            P0 = 1.0
            Msq = U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2
            me = 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
            U = U.at[IEN].set(P0 / sim.gamma_1 + 0.5 * Msq / d0 + me)
        for n in range(sim.nscalars):
            U = U.at[sim.ncons - sim.nscalars + n].set(
                jnp.asarray(np.where(inloop, 1.0, 0.0), dtype))
        return st.replace(U=U, Bcc=Bcc, B1i=B1i, B2i=B2i, B3i=B3i)
