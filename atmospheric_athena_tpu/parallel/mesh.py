"""Device meshes and state shardings.

Replacement for the reference's MPI domain decomposition
(init_mesh.c:540 dom_decomp + per-rank GridS): the state stays ONE logical
array per field, sharded over a 3-D ('z','y','x') device mesh with
jax.sharding.NamedSharding.  Under jit, XLA GSPMD inserts the halo
collective-permutes for the stencil shifts and the psum/pmin for the global
reductions — the collectives the reference hand-codes with MPI_Irecv/Isend
(bvals_mhd.c:199-276) and MPI_Allreduce (new_dt.c:175).

A hand-scheduled shard_map + ppermute halo-exchange path (with
interior/boundary compute overlap, SURVEY.md §5.8) is the planned
optimization on top; this module provides the portable baseline that any
step function runs under unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import GridConfig, SimConfig
from ..state import State


def factor3(n: int) -> Tuple[int, int, int]:
    """Split n devices into a near-cubic (nz, ny, nx) grid, mirroring the
    minimal-surface automatic decomposition (init_mesh.c dom_decomp)."""
    best = (1, 1, n)
    best_cost = None
    for nz in range(1, n + 1):
        if n % nz:
            continue
        m = n // nz
        for ny in range(1, m + 1):
            if m % ny:
                continue
            nx = m // ny
            cost = nz * ny + ny * nx + nx * nz  # surface area proxy
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = (nz, ny, nx)
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int, int]] = None,
              devices=None) -> Mesh:
    """3-D device mesh with axes ('z','y','x')."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if shape is None:
        shape = factor3(n_devices)
    assert math.prod(shape) == n_devices, (shape, n_devices)
    dev = np.asarray(devices[:n_devices]).reshape(shape)
    return Mesh(dev, axis_names=("z", "y", "x"))


def state_shardings(mesh: Mesh, sim: SimConfig) -> State:
    """NamedSharding pytree matching the State structure: field arrays
    sharded over their three spatial dims, scalars replicated."""
    s3 = NamedSharding(mesh, P("z", "y", "x"))
    # Eflux has Nx+1 faces along the sweep axis; keep that axis unsharded so
    # the +1 face dimension needs no divisibility (and the cumprod scan stays
    # shard-local along x)
    ef = NamedSharding(mesh, P("z", "y", None))
    v3 = NamedSharding(mesh, P(None, "z", "y", "x"))
    r = NamedSharding(mesh, P())
    kw = {}
    if sim.mhd:
        kw = dict(Bcc=v3, B1i=s3, B2i=s3, B3i=s3)
    return State(U=v3, time=r, dt=r, nstep=r, Eflux=ef, **kw)


def shard_state(state: State, mesh: Mesh, sim: SimConfig) -> State:
    """Place an (unsharded) state onto the mesh (None fields stay None)."""
    sh = state_shardings(mesh, sim)

    def place(x, s):
        return x if x is None else jax.device_put(x, s)

    return state.replace(
        U=place(state.U, sh.U),
        time=place(state.time, sh.time),
        dt=place(state.dt, sh.dt),
        nstep=place(state.nstep, sh.nstep),
        Bcc=place(state.Bcc, sh.Bcc),
        B1i=place(state.B1i, sh.B1i),
        B2i=place(state.B2i, sh.B2i),
        B3i=place(state.B3i, sh.B3i),
        Eflux=place(state.Eflux, sh.Eflux))
