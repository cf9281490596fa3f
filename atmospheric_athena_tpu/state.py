"""Simulation state pytree.

Data model replacing the reference's MeshS→DomainS→GridS
arrays-of-structs (src/athena.h:254-425) with a structure-of-arrays pytree:
dense [nvar, Nz(+2g), Ny(+2g), Nx(+2g)] arrays including ghost zones, so halo
exchange and ``allclose`` comparisons against the reference's padded grids are
direct (SURVEY.md §7 design stance).

Fields:
  U    : cell-centered conserved variables [ncons, ...] —
         (d, M1, M2, M3, [E], s...) per defs.py index constants.
  Bcc  : cell-centered magnetic field [3, ...] (MHD only, else None).
  B1i/B2i/B3i : face-centered fields for constrained transport; along their
         normal axis they have one extra face on the upper side
         (src/athena.h:306: B1i sized (Nx3,Nx2,Nx1+1) on active grids —
         the reference actually allocates same-size arrays and uses
         [i..ie+1]; we keep padded cell-count arrays and treat index i as the
         lower face of cell i, with face ie+1 stored at index ie+1 which is
         inside the ghost padding).
  Eflux : ionizing radiation edge flux [Nz, Ny, Nx+1-style] (active cells +1
         along sweep; allocated by the radiation module, else None).
  time, dt : scalars (traced — dt is produced inside the step because the
         radiation sub-cycle may shrink it, ionrad_3d.c:983,1033).
  nstep : int32 scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from . import defs
from .config import GridConfig, SimConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class State:
    U: jax.Array
    time: jax.Array
    dt: jax.Array
    nstep: jax.Array
    Bcc: Optional[jax.Array] = None
    B1i: Optional[jax.Array] = None
    B2i: Optional[jax.Array] = None
    B3i: Optional[jax.Array] = None
    Eflux: Optional[jax.Array] = None

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)


def zeros(sim: SimConfig, grid: GridConfig) -> State:
    """Allocate an all-zero state (init_grid.c analogue)."""
    dt = sim.jnp_dtype()
    shape = grid.padded_shape()
    U = jnp.zeros((sim.ncons,) + shape, dt)
    kw = {}
    if sim.mhd:
        kw["Bcc"] = jnp.zeros((3,) + shape, dt)
        kw["B1i"] = jnp.zeros(shape, dt)
        kw["B2i"] = jnp.zeros(shape, dt)
        kw["B3i"] = jnp.zeros(shape, dt)
    return State(U=U, time=jnp.zeros((), dt), dt=jnp.zeros((), dt),
                 nstep=jnp.zeros((), jnp.int32), **kw)
