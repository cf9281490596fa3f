"""History dumps: volume-averaged scalar time series
(reference: src/dump_history.c:90-360).

Columns (Newtonian): time, dt, mass, [E_total], M1, M2, M3, KE1, KE2, KE3,
[ME1, ME2, ME3], scalars..., then user-enrolled scalars
(dump_history_enroll, src/dump_history.c:42-75).  Sums over active cells ×
dVol, divided by the total domain volume; under pjit the jnp.sum is the
MPI_Reduce of the reference (dump_history.c:299-304).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..state import State


def history_names(sim: SimConfig, user=()):  # noqa: D103
    names = ["time", "dt", "mass"]
    if sim.adiabatic:
        names.append("total E")
    names += ["x1 Mom.", "x2 Mom.", "x3 Mom.",
              "x1-KE", "x2-KE", "x3-KE"]
    if sim.mhd:
        names += ["x1-ME", "x2-ME", "x3-ME"]
    for n in range(sim.nscalars):
        names.append(f"scalar {n}")
    names += [u[0] for u in user]
    return names


def compute_history(state: State, sim: SimConfig, grid: GridConfig,
                    user=()):
    """Volume-averaged history scalars (jittable)."""
    sl = grid.interior()
    U = state.U[(slice(None),) + sl]
    dvol = 1.0
    vol = 1.0
    for a in range(3):
        if grid.dx[a] > 0.0:
            dvol *= grid.dx[a]
        ext = grid.xmax[a] - grid.xmin[a]
        if grid.Nx[a] > 1 or a == 0:
            vol *= ext
    avg = lambda q: jnp.sum(q) * (dvol / vol)

    d1 = 1.0 / U[ID]
    out = [state.time, state.dt, avg(U[ID])]
    if sim.adiabatic:
        out.append(avg(U[IEN]))
    for m in range(3):
        out.append(avg(U[IM1 + m]))
    for m in range(3):
        out.append(avg(0.5 * U[IM1 + m] ** 2 * d1))
    if sim.mhd:
        B = state.Bcc[(slice(None),) + sl]
        for m in range(3):
            out.append(avg(0.5 * B[m] ** 2))
    iscal = 5 if sim.adiabatic else 4
    for n in range(sim.nscalars):
        out.append(avg(U[iscal + n]))
    for name, fn in user:
        out.append(avg(fn(state, sim, grid)))
    return out


class HistoryWriter:
    """Appends one row per output time to <problem_id>.hst
    (header format per dump_history.c:358-376)."""

    def __init__(self, path: str, sim: SimConfig, user=()):
        self.path = path
        self.sim = sim
        self.user = user
        self._wrote_header = os.path.exists(path)

    def __call__(self, state: State, grid: GridConfig):
        vals = [float(v) for v in compute_history(state, self.sim, grid,
                                                  self.user)]
        with open(self.path, "a") as fh:
            if not self._wrote_header:
                fh.write("# Athena history dump\n#")
                for i, n in enumerate(history_names(self.sim, self.user)):
                    fh.write(f"   [{i + 1}]={n}")
                fh.write("\n")
                self._wrote_header = True
            fh.write(" ".join(f"{v:14.6e}" for v in vals) + "\n")
