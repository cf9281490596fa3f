"""Boundary conditions on the cell-centered state (reference: src/bvals_mhd.c).

Physical BCs fill the nghost ghost layers per axis, in the fixed order
x1 → x2 → x3 so that edge/corner ghosts are filled correctly
(bvals_mhd.c:170-171).  Flags (bvals_mhd.c:540-637):

  1 reflect   — mirror cells, negate the normal momentum and normal B;
                the normal interface field is zeroed ON the boundary face and
                odd-mirrored about it (bvals_mhd.c:982-989, 1041-1048)
  2 outflow   — zero-gradient copy of the edge active plane
  4 periodic  — wrap-around copy (serial analogue of the MPI wraparound)
  5 conductor — identical to reflect in this fork: case 5 dispatches to the
                same reflect_* functions (bvals_mhd.c:579-581, 629-631)
  0 user      — problem-enrolled function (bvals_mhd_fun, bvals_mhd.c:917)

The sharded version (parallel/halo.py) replaces interior faces with
`ppermute` halo exchange; these physical BCs then apply only on true domain
edges, exactly like the reference applies them only on ranks with no
neighbor (bvals_mhd.c:199-276).
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import (BC_CONDUCTOR, BC_DONOTHING, BC_OUTFLOW, BC_PERIODIC,
                     BC_REFLECT, BC_USER, GridConfig, SimConfig)
from .defs import IM1
from .state import State


def _adim(axis: int) -> int:
    return 2 - axis


def _fill(arr, axis_dim, ng, side, block):
    """Write `block` into the ghost slab on `side` ('lo'/'hi') of axis_dim."""
    idx = [slice(None)] * arr.ndim
    idx[axis_dim] = slice(0, ng) if side == "lo" else slice(-ng, None)
    return arr.at[tuple(idx)].set(block)


def _take(arr, axis_dim, sl):
    idx = [slice(None)] * arr.ndim
    idx[axis_dim] = sl
    return arr[tuple(idx)]


def _ghost_block(arr, axis_dim, ng, side, flag, negate_comp=None):
    """Build the ghost slab for one array/side from the active cells."""
    n = arr.shape[axis_dim]
    if flag == BC_PERIODIC:
        src = slice(n - 2 * ng, n - ng) if side == "lo" else slice(ng, 2 * ng)
        return _take(arr, axis_dim, src)
    if flag == BC_OUTFLOW:
        src = slice(ng, ng + 1) if side == "lo" else slice(n - ng - 1, n - ng)
        edge = _take(arr, axis_dim, src)
        reps = [1] * arr.ndim
        reps[axis_dim] = ng
        return jnp.tile(edge, reps)
    if flag in (BC_REFLECT, BC_CONDUCTOR):
        src = slice(ng, 2 * ng) if side == "lo" else slice(n - 2 * ng, n - ng)
        return jnp.flip(_take(arr, axis_dim, src), axis=axis_dim)
    raise NotImplementedError(f"BC flag {flag}")


def _reflect_normal_face(arr, axis_dim, ng, side):
    """Reflect/conductor fill of the face field normal to the boundary.

    With face index f = lower face of cell f, the boundary face sits at
    f0 = ng (lo) or f0 = n-ng (hi).  The reference zeroes B_normal on the
    boundary face and sets the ng-1 ghost faces to the negated mirror:
    B[f0 - j] = -B[f0 + j] (lo) / B[f0 + j] = -B[f0 - j] (hi), j=1..ng-1
    (reflect_ix1 bvals_mhd.c:982-989; reflect_ox1 :1041-1048).
    """
    n = arr.shape[axis_dim]
    f0 = ng if side == "lo" else n - ng
    zero_idx = [slice(None)] * arr.ndim
    zero_idx[axis_dim] = slice(f0, f0 + 1)
    arr = arr.at[tuple(zero_idx)].set(0.0)
    if side == "lo":
        src, dst = slice(f0 + 1, f0 + ng), slice(f0 - ng + 1, f0)
    else:
        src, dst = slice(f0 - ng + 1, f0), slice(f0 + 1, f0 + ng)
    blk = -jnp.flip(_take(arr, axis_dim, src), axis=axis_dim)
    idx = [slice(None)] * arr.ndim
    idx[axis_dim] = dst
    return arr.at[tuple(idx)].set(blk)


def apply_bc(state: State, grid: GridConfig, sim: SimConfig,
             problem=None) -> State:
    """Fill all ghost zones of U (and Bcc/B*i for MHD)."""
    ng = grid.nghost
    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i] if sim.mhd else None

    for axis in (0, 1, 2):
        if axis == 2 and sim.shearing_box and grid.active(0) \
                and grid.bc[0][0] == BC_PERIODIC:
            # shearing-sheet remap of the x1 ghost slabs runs after the
            # periodic x1 + x2 fills and before x3 (bvals_mhd.c:390-401)
            from .shearing import shearing_sheet
            state = state.replace(U=U, **(dict(Bcc=Bcc, B1i=Bi[0],
                                               B2i=Bi[1], B3i=Bi[2])
                                          if sim.mhd else {}))
            state = shearing_sheet(state, sim, grid, state.time)
            U = state.U
            Bcc = state.Bcc
            if sim.mhd:
                Bi = [state.B1i, state.B2i, state.B3i]
        if not grid.active(axis):
            continue
        ad_U = _adim(axis) + 1      # +1 for variable axis of U / Bcc
        ad = _adim(axis)
        for side, flag in zip(("lo", "hi"), grid.bc[axis]):
            if flag == BC_DONOTHING:
                # flag 3: ghosts keep their problem-initialized values
                # (the tst/cylindrical decks' do_nothing_bc enrollment)
                continue
            # a problem-enrolled function overrides the deck flag for its
            # side, exactly like bvals_mhd_fun (bvals_mhd.c:906-939 — the
            # enrolled pointer replaces whatever the flag selected)
            name = f"bc_{'i' if side == 'lo' else 'o'}x{axis + 1}"
            user_fn = getattr(problem, name, None) if problem else None
            if flag == BC_USER or user_fn is not None:
                fn = user_fn
                if fn is None:
                    raise ValueError(
                        f"BC flag 0 on axis {axis} ({side}) but problem "
                        "enrolls no user BC function")
                state = state.replace(
                    U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2]) \
                    if sim.mhd else state.replace(U=U)
                state = fn(state, grid, sim)
                U = state.U
                Bcc = state.Bcc
                if sim.mhd:
                    Bi = [state.B1i, state.B2i, state.B3i]
                continue
            blk = _ghost_block(U, ad_U, ng, side, flag)
            if flag in (BC_REFLECT, BC_CONDUCTOR):
                blk = blk.at[IM1 + axis].multiply(-1.0)
            U = _fill(U, ad_U, ng, side, blk)
            if sim.mhd:
                bblk = _ghost_block(Bcc, ad_U, ng, side, flag)
                if flag in (BC_REFLECT, BC_CONDUCTOR):
                    bblk = bblk.at[axis].multiply(-1.0)
                Bcc = _fill(Bcc, ad_U, ng, side, bblk)
                for b in range(3):
                    if flag in (BC_REFLECT, BC_CONDUCTOR) and b == axis:
                        # Normal face field: zero the boundary face itself
                        # and odd-mirror the ghost faces about it; the
                        # outermost lo ghost face (is-nghost) is untouched
                        # (reflect_ix1/ox1, bvals_mhd.c:982-989,1041-1048).
                        Bi[b] = _reflect_normal_face(Bi[b], ad, ng, side)
                    elif b == axis:
                        # Normal face field under periodic/outflow: the
                        # outermost lo ghost face is never set ("B1i is
                        # not set at i=is-nghost") and on the hi side
                        # the SHARED ACTIVE face ie+1 is never a BC
                        # ("B1i is not set at i=ie+1", periodic_ox1 /
                        # outflow_ox1) — in a shearing box the two
                        # boundary faces differ, so clobbering ie+1
                        # with is breaks the CT field
                        fblk = _ghost_block(Bi[b], ad, ng, side, flag)
                        n = Bi[b].shape[ad]
                        idx = [slice(None)] * Bi[b].ndim
                        sub = [slice(None)] * fblk.ndim
                        idx[ad] = slice(1, ng) if side == "lo" \
                            else slice(n - ng + 1, None)
                        sub[ad] = slice(1, None)
                        Bi[b] = Bi[b].at[tuple(idx)].set(
                            fblk[tuple(sub)])
                    else:
                        fblk = _ghost_block(Bi[b], ad, ng, side, flag)
                        Bi[b] = _fill(Bi[b], ad, ng, side, fblk)

    kw = dict(U=U)
    if sim.mhd:
        kw.update(Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])
    return state.replace(**kw)


def apply_bc_sharded(state: State, grid: GridConfig, sim: SimConfig,
                     problem, mesh) -> State:
    """Ghost fill for the explicit-halo multichip step: each EDGE shard
    fills its own slab of the global ghost zones purely from local data
    (shard_map + lax.cond on axis_index) — zero collectives, versus the
    roll/dynamic-update-slice chain of the serial fill which GSPMD turns
    into all-gathers.

    Supported: hydro, outflow/reflect/conductor/do-nothing flags, no
    user BC functions, and every shard's padded slab at least 2*nghost
    deep (so the fill's source cells are local to the edge shard).
    Anything else raises AssertionError at trace time — the caller falls
    back to the serial fill under GSPMD (correct, just heavier)."""
    import jax
    try:
        from jax import shard_map as _shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map as _shard_map
    from jax.sharding import PartitionSpec as P

    assert not sim.mhd and not sim.shearing_box
    assert problem is None or not any(
        getattr(problem, f"bc_{s}x{a}", None) is not None
        for s in ("i", "o") for a in (1, 2, 3))
    ng = grid.nghost
    names = {0: "x", 1: "y", 2: "z"}   # Athena axis -> mesh axis name
    padded = grid.padded_shape()        # (NZ, NY, NX)
    for axis in range(3):
        if not grid.active(axis):
            continue
        nsh = mesh.shape[names[axis]]
        assert padded[2 - axis] % nsh == 0
        assert padded[2 - axis] // nsh >= 2 * ng
        for flag in grid.bc[axis]:
            assert flag in (BC_OUTFLOW, BC_REFLECT, BC_CONDUCTOR,
                            BC_DONOTHING)

    def body(U):
        for axis in (0, 1, 2):
            if not grid.active(axis):
                continue
            ad_U = _adim(axis) + 1   # +1 for the variable axis
            nsh = mesh.shape[names[axis]]
            for side, flag in zip(("lo", "hi"), grid.bc[axis]):
                if flag == BC_DONOTHING:
                    continue

                def fill(u, side=side, flag=flag, axis=axis, ad_U=ad_U):
                    blk = _ghost_block(u, ad_U, ng, side, flag)
                    if flag in (BC_REFLECT, BC_CONDUCTOR):
                        blk = blk.at[IM1 + axis].multiply(-1.0)
                    return _fill(u, ad_U, ng, side, blk)

                if nsh == 1:
                    U = fill(U)
                else:
                    pos = jax.lax.axis_index(names[axis])
                    is_edge = (pos == 0) if side == "lo" \
                        else (pos == nsh - 1)
                    U = jax.lax.cond(is_edge, fill, lambda u: u, U)
        return U

    spec = P(None, "z", "y", "x")
    Unew = _shard_map(body, mesh=mesh, in_specs=(spec,),
                      out_specs=spec)(state.U)
    return state.replace(U=Unew)
