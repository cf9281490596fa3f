"""Reflecting/conductor-wall ghost fill vs the reference formulas.

Checks apply_bc against the exact index relations of reflect_ix1/ox1 (and
the x2/x3 analogues) in /root/reference/src/bvals_mhd.c:956-1070:

  U[is-i]    =  U[is+(i-1)],  M_normal and B_normal,cc negated   (i=1..ng)
  Bni[is]    =  0                       (normal face field, boundary face)
  Bni[is-i]  = -Bni[is+i]               (i=1..ng-1; is-ng face untouched)
  Bti[is-i]  =  Bti[is+(i-1)]           (transverse face fields)

and mirrored on the outer side.  Conductor (flag 5) dispatches to the same
reflect_* functions in this fork (bvals_mhd.c:579-581) so must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from atmospheric_athena_tpu import bvals, state as state_mod
from atmospheric_athena_tpu.config import (BC_CONDUCTOR, BC_OUTFLOW,
                                           BC_REFLECT, GridConfig, SimConfig)


def _random_state(sim, grid, seed=0):
    rng = np.random.default_rng(seed)
    st = state_mod.zeros(sim, grid)
    st = st.replace(
        U=jnp.asarray(rng.normal(size=st.U.shape) + 3.0),
        Bcc=jnp.asarray(rng.normal(size=st.Bcc.shape)),
        B1i=jnp.asarray(rng.normal(size=st.B1i.shape)),
        B2i=jnp.asarray(rng.normal(size=st.B2i.shape)),
        B3i=jnp.asarray(rng.normal(size=st.B3i.shape)))
    return st


@pytest.fixture(scope="module")
def setup():
    sim = SimConfig(gas="mhd", eos="adiabatic", gamma=1.4)
    grid = GridConfig(Nx=(12, 10, 8), bc=((BC_REFLECT, BC_REFLECT),) * 3)
    st0 = _random_state(sim, grid)
    st = bvals.apply_bc(st0, grid, sim)
    return sim, grid, st0, st


def _axslice(ndim, axis_dim, idx):
    out = [slice(None)] * ndim
    out[axis_dim] = idx
    return tuple(out)


class TestReflectMHD:
    def test_cell_centered(self, setup):
        sim, grid, st0, st = setup
        ng = grid.nghost
        for axis in range(3):
            ad = 2 - axis          # array dim of U's spatial axes (0-based z,y,x)
            n = st.U.shape[1 + ad]
            for i in range(1, ng + 1):
                lo_g = _axslice(st.U.ndim - 1, ad, ng - i)
                lo_s = _axslice(st.U.ndim - 1, ad, ng + i - 1)
                sgnU = np.ones(st.U.shape[0])
                sgnU[1 + axis] = -1.0   # normal momentum negated
                np.testing.assert_allclose(
                    np.asarray(st.U)[(slice(None),) + lo_g],
                    sgnU[:, None, None]
                    * np.asarray(st.U)[(slice(None),) + lo_s])
                hi_g = _axslice(st.U.ndim - 1, ad, n - ng - 1 + i)
                hi_s = _axslice(st.U.ndim - 1, ad, n - ng - i)
                np.testing.assert_allclose(
                    np.asarray(st.U)[(slice(None),) + hi_g],
                    sgnU[:, None, None]
                    * np.asarray(st.U)[(slice(None),) + hi_s])
                sgnB = np.ones(3)
                sgnB[axis] = -1.0
                np.testing.assert_allclose(
                    np.asarray(st.Bcc)[(slice(None),) + lo_g],
                    sgnB[:, None, None]
                    * np.asarray(st.Bcc)[(slice(None),) + lo_s])

    def test_normal_face_field(self, setup):
        sim, grid, st0, st = setup
        ng = grid.nghost
        for axis, name in ((0, "B1i"), (1, "B2i"), (2, "B3i")):
            ad = 2 - axis
            B = np.asarray(getattr(st, name))
            B0 = np.asarray(getattr(st0, name))
            n = B.shape[ad]
            # boundary faces zeroed
            assert np.all(B[_axslice(3, ad, ng)] == 0.0)
            assert np.all(B[_axslice(3, ad, n - ng)] == 0.0)
            # ghost faces odd-mirrored about the boundary face
            for j in range(1, ng):
                np.testing.assert_allclose(
                    B[_axslice(3, ad, ng - j)], -B[_axslice(3, ad, ng + j)])
                np.testing.assert_allclose(
                    B[_axslice(3, ad, n - ng + j)],
                    -B[_axslice(3, ad, n - ng - j)])
            # the outermost lo ghost face is untouched (is-nghost not set);
            # only where later BC passes on the other axes don't refill it
            act = [slice(ng, -ng)] * 3
            act[ad] = 0
            np.testing.assert_allclose(B[tuple(act)], B0[tuple(act)])

    def test_transverse_face_field(self, setup):
        sim, grid, st0, st = setup
        ng = grid.nghost
        # B2i/B3i about the x1 boundary: even slab mirror, no negation
        for name in ("B2i", "B3i"):
            B = np.asarray(getattr(st, name))
            n = B.shape[2]
            for i in range(1, ng + 1):
                np.testing.assert_allclose(B[:, :, ng - i],
                                           B[:, :, ng + i - 1])
                np.testing.assert_allclose(B[:, :, n - ng - 1 + i],
                                           B[:, :, n - ng - i])

    def test_conductor_identical_to_reflect(self, setup):
        sim, grid, st0, st = setup
        grid_c = GridConfig(Nx=grid.Nx,
                            bc=((BC_CONDUCTOR, BC_CONDUCTOR),) * 3)
        st_c = bvals.apply_bc(st0, grid_c, sim)
        for f in ("U", "Bcc", "B1i", "B2i", "B3i"):
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          np.asarray(getattr(st_c, f)))


def _ref_hydro_fill(U, flag, ng):
    """Ghost fill of a hydro U [nvar, z, y, x] straight from the index
    relations of bvals_mhd.c, x1 then x2 then x3 (:170-171), each pass over
    the full extent of the other axes:

      outflow_ix1   U[is-i] = U[is]                          (i=1..ng)
      reflect_ix1   U[is-i] = U[is+(i-1)], M_normal negated
      (and mirrored at ie; conductor dispatches to reflect_*)
    """
    U = U.copy()
    for axis in range(3):
        ad = 3 - axis
        n = U.shape[ad]
        for i in range(1, ng + 1):
            if flag == BC_OUTFLOW:
                pairs = ((ng - i, ng), (n - ng - 1 + i, n - ng - 1))
            else:
                pairs = ((ng - i, ng + i - 1), (n - ng - 1 + i, n - ng - i))
            for dst, src in pairs:
                blk = np.take(U, src, axis=ad).copy()
                if flag != BC_OUTFLOW:
                    blk[1 + axis] *= -1.0
                idx = [slice(None)] * U.ndim
                idx[ad] = dst
                U[tuple(idx)] = blk
    return U


@pytest.mark.parametrize("flag", [BC_OUTFLOW, BC_REFLECT, BC_CONDUCTOR],
                         ids=["outflow", "reflect", "conductor"])
def test_hydro_ghost_fill_3d(flag):
    """The production ghost fill (hydro, one passive scalar, every face
    the same flag) matches the reference's index relations exactly."""
    sim = SimConfig(gas="hydro", eos="adiabatic", gamma=5.0 / 3.0,
                    nscalars=1)
    grid = GridConfig(Nx=(12, 10, 8), bc=((flag, flag),) * 3)
    rng = np.random.default_rng(1)
    st0 = state_mod.zeros(sim, grid)
    st0 = st0.replace(U=jnp.asarray(rng.normal(size=st0.U.shape) + 3.0))
    out = np.asarray(bvals.apply_bc(st0, grid, sim).U)
    U0 = np.asarray(st0.U)
    np.testing.assert_array_equal(out, _ref_hydro_fill(U0, flag,
                                                       grid.nghost))
    sl = (slice(None),) + grid.interior()
    np.testing.assert_array_equal(out[sl], U0[sl])
