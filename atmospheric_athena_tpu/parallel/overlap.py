"""Explicit-halo sharded hydro step (shard_map + ppermute).

The baseline multichip path lets GSPMD insert halo collectives for every
stencil shift of the jitted step.  This module is the hand-scheduled
equivalent of the reference's per-rank update (bvals_mhd.c:199-276 halo
exchange + the purely local integrate_3d_ctu): each device carries its
block of the padded state, refreshes an nghost-deep halo with ONE
ppermute pair per mesh axis up front, and then runs the UNMODIFIED serial
CTU step on its local padded block.  All stencil communication happens in
that single prologue exchange, so XLA's latency-hiding scheduler can
overlap the ppermutes with the start of the (halo-independent) interior
compute — the array-program version of the reference's
interior/boundary-partition overlap strategy (SURVEY.md §5.8).

Correctness argument: the local padded block is the device's slice of the
global PADDED array plus an nghost halo.  Cells the step may validly
update (everything up to the global ghost zones) see exactly the same
stencil inputs as the serial whole-grid step; halo cells beyond the
global edges receive ring-wrapped garbage, which only ever contaminates
global ghost cells — and those are rewritten by bvals.apply_bc right
after the step, exactly like the serial path's wrap-contaminated ghosts.

Scope: 3-D Cartesian hydrodynamics, with or without static gravity —
the potential enters through per-shard halo-padded blocks precomputed
once at setup (phi_halo_arrays: zero per-step communication).  The
production multichip path (Simulation._build_step with a >1-device
mesh) composes this with the distributed radiation scan (ionrad.plane)
and the local sharded ghost fill (bvals.apply_bc_sharded), so a full
production step's collective profile is nearest-neighbor permutes plus
the global dt/stop reductions — no all-gathers or all-to-alls.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import GridConfig, SimConfig
from ..state import State
from .halo import exchange


def _local_grid(grid: GridConfig, mesh: Mesh) -> GridConfig:
    """GridConfig for one device's halo-padded local block: the local
    'active' region is the device's whole slice of the padded global
    array (edge shards thus 'update' global ghosts with garbage, which
    apply_bc immediately overwrites — see module docstring)."""
    NZp, NYp, NXp = grid.padded_shape()
    nz, ny, nx = mesh.shape["z"], mesh.shape["y"], mesh.shape["x"]
    assert NZp % nz == 0 and NYp % ny == 0 and NXp % nx == 0, (
        "padded shape must divide the mesh", (NZp, NYp, NXp), mesh.shape)
    Nl = (NXp // nx, NYp // ny, NZp // nz)
    # keep the GLOBAL cell size: GridConfig derives dx from extent/Nx
    xmax = tuple(grid.xmin[a] + Nl[a] * grid.dx[a] for a in range(3))
    return dataclasses.replace(grid, Nx=Nl, xmin=grid.xmin, xmax=xmax)


def hydro_step_sharded(state: State, dt, sim: SimConfig, grid: GridConfig,
                       mesh: Mesh):
    """One explicit-halo CTU hydro step over the mesh; state.U sharded
    P(None,'z','y','x') over its padded dims.  Returns the updated U
    (ghost zones garbage — caller must apply_bc, as the serial driver
    already does after every step)."""
    try:
        from jax import shard_map as _shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map as _shard_map
    from ..integrators import ctu3d

    ng = grid.nghost
    lgrid = _local_grid(grid, mesh)

    def body(U_loc):
        pad = [(0, 0), (ng, ng), (ng, ng), (ng, ng)]
        Up = jnp.pad(U_loc, pad)
        Up = exchange(Up, mesh, ng)
        lstate = State(U=Up, time=state.time, dt=dt,
                       nstep=state.nstep)
        out = ctu3d.step(lstate, dt, sim, lgrid, problem=None)
        return out.U[:, ng:-ng, ng:-ng, ng:-ng]

    spec = P(None, "z", "y", "x")
    Unew = _shard_map(body, mesh=mesh, in_specs=(spec,),
                      out_specs=spec)(state.U)
    return state.replace(U=Unew)


def phi_halo_arrays(problem, grid: GridConfig, mesh: Mesh, dtype):
    """Per-device halo-padded static-potential blocks, computed ONCE at
    setup — the static-gravity extension of the explicit-halo step.

    The serial step evaluates phi analytically on the global padded grid
    (integrators/ctu3d._phi_arrays).  Here the four fields (phic +
    the three left-face families) are stacked, each device's slice
    padded with an nghost halo, and the halo filled with one setup-time
    ring exchange (halo.gather_halos).  At global domain edges the extra
    halo wraps periodically — wrong values, but they only ever feed
    updates of global ghost cells, which apply_bc rewrites (the same
    correctness argument as the state halo, see module docstring).

    Returns None for potential-free problems, else a
    [4, (NZl+2ng)*nz, (NYl+2ng)*ny, (NXl+2ng)*nx] array sharded
    P(None,'z','y','x') whose per-device block is the device's
    halo-padded (phic, phif1, phif2, phif3).  Because phi is static this
    costs ZERO per-step communication."""
    import jax

    from ..integrators.ctu3d import _phi_arrays
    from .halo import gather_halos

    phic, phif = _phi_arrays(problem, grid, dtype)
    if phic is None:
        return None
    stack = jnp.stack([phic, phif[0], phif[1], phif[2]])
    spec = P(None, "z", "y", "x")
    fn = jax.jit(lambda q: gather_halos(q, mesh, grid.nghost, spec=spec))
    return fn(stack)


def hydro_step_sharded_grav(state: State, dt, sim: SimConfig,
                            grid: GridConfig, mesh: Mesh, phi_halo=None):
    """Explicit-halo CTU hydro step WITH static gravity: one ppermute
    pair per mesh axis for the state halo; the potential enters through
    the precomputed per-shard halo-padded blocks (phi_halo_arrays)."""
    if phi_halo is None:
        return hydro_step_sharded(state, dt, sim, grid, mesh)
    try:
        from jax import shard_map as _shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map as _shard_map
    from ..integrators import ctu3d

    ng = grid.nghost
    lgrid = _local_grid(grid, mesh)

    def body(U_loc, ph_loc):
        pad = [(0, 0), (ng, ng), (ng, ng), (ng, ng)]
        Up = jnp.pad(U_loc, pad)
        Up = exchange(Up, mesh, ng)
        lstate = State(U=Up, time=state.time, dt=dt, nstep=state.nstep)
        phi = (ph_loc[0], [ph_loc[1], ph_loc[2], ph_loc[3]])
        out = ctu3d.step(lstate, dt, sim, lgrid, problem=None, phi=phi)
        return out.U[:, ng:-ng, ng:-ng, ng:-ng]

    spec = P(None, "z", "y", "x")
    Unew = _shard_map(body, mesh=mesh, in_specs=(spec, spec),
                      out_specs=spec)(state.U, phi_halo)
    return state.replace(U=Unew)
