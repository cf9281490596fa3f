"""Checkpoint / restart (reference: src/restart.c, src/dump_restart).

The reference writes per-rank binary blobs tied to the rank count
(restart.c:22-23 — "must restart on same #ranks").  Here a checkpoint is a
single .npz of the full logical state pytree (incl. EdgeFlux, which the
reference also persists, restart.c:279) plus the resolved parameter DB —
rank-count and mesh-shape INDEPENDENT by construction: on load the arrays
are resharded onto whatever device mesh is active.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np

from ..config import GridConfig, SimConfig
from ..par import ParameterDB
from ..state import State


def save_checkpoint(path: str, state: State, sim: SimConfig,
                    grid: GridConfig, par: ParameterDB):
    arrays = {}
    for name in ("U", "Bcc", "B1i", "B2i", "B3i", "Eflux",
                 "time", "dt", "nstep"):
        v = getattr(state, name)
        if v is not None:
            arrays[name] = np.asarray(v)
    meta = dict(sim=sim.__dict__ if not hasattr(sim, "__dataclass_fields__")
                else {k: getattr(sim, k) for k in sim.__dataclass_fields__},
                grid={k: getattr(grid, k) for k in grid.__dataclass_fields__},
                par=par.dump())
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str):
    """Returns (state, sim, grid, par)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        kw = {}
        for name in ("U", "Bcc", "B1i", "B2i", "B3i", "Eflux"):
            if name in z:
                kw[name] = jnp.asarray(z[name])
        state = State(time=jnp.asarray(z["time"]),
                      dt=jnp.asarray(z["dt"]),
                      nstep=jnp.asarray(z["nstep"]), **kw)
    gmeta = meta["grid"]
    grid = GridConfig(Nx=tuple(gmeta["Nx"]), xmin=tuple(gmeta["xmin"]),
                      xmax=tuple(gmeta["xmax"]),
                      bc=tuple(tuple(b) for b in gmeta["bc"]),
                      nghost=gmeta["nghost"])
    # options a newer SimConfig no longer has are dropped
    sim = SimConfig(**{k: v for k, v in meta["sim"].items()
                       if k in SimConfig.__dataclass_fields__})
    par = ParameterDB.from_string(meta["par"])
    return state, sim, grid, par
