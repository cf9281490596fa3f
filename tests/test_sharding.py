"""Sharded-vs-unsharded equivalence on a virtual 8-device CPU mesh.

The reference's correctness criterion for MPI runs is that results match
the serial run (SURVEY.md §4); here the same criterion applies to the
GSPMD-sharded step: jitting the identical step function with the state
sharded over a ('z','y','x') mesh must reproduce the single-device result
(XLA inserts the halo collective-permutes and reduction collectives that
replace the reference's MPI_Irecv/Isend and MPI_Allreduce).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atmospheric_athena_tpu import ParameterDB, Simulation
from atmospheric_athena_tpu.parallel.mesh import (factor3, make_mesh,
                                                  shard_state,
                                                  state_shardings)

BLAST3D_DECK = """
<comment>
config  = --with-gas=hydro --with-problem=blast
<job>
problem_id = Blast
<time>
cour_no = 0.4
nlim    = 3
tlim    = 0.05
<domain1>
Nx1 = 16
x1min = -0.5
x1max = 0.5
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 16
x2min = -0.5
x2max = 0.5
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 16
x3min = -0.5
x3max = 0.5
bc_ix3 = 4
bc_ox3 = 4
<problem>
gamma  = 1.66666666666667
pamb   = 0.1
prat   = 100.0
radius = 0.25
"""


def test_factor3():
    assert factor3(8) == (2, 2, 2)
    assert factor3(4) in ((1, 2, 2), (2, 2, 1))
    assert factor3(1) == (1, 1, 1)


@pytest.mark.slow
def test_sharded_step_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest forces 8 virtual CPU devices"
    par = ParameterDB.from_string(BLAST3D_DECK)
    s = Simulation.from_par(par)
    fn = s._build_step().__wrapped__
    aux = s._step_aux

    # single device
    out1 = jax.jit(fn)(s.state, aux)

    # 8-device mesh
    mesh = make_mesh(8)
    sh = state_shardings(mesh, s.sim)
    stS = shard_state(s.state, mesh, s.sim)
    out8 = jax.jit(lambda st: fn(st, aux), in_shardings=(sh,),
                   out_shardings=sh)(stS)

    np.testing.assert_allclose(np.asarray(out8.U), np.asarray(out1.U),
                               rtol=0, atol=1e-13)
    assert float(out8.dt) == pytest.approx(float(out1.dt), rel=1e-14)


@pytest.mark.slow
def test_sharded_ioniz_sphere_step():
    """Full production step (radiation sub-cycle incl. the cumprod scan and
    global reductions + hydro + gravity) sharded over 8 devices."""
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _ISPH_DECK
    par = ParameterDB.from_string(_ISPH_DECK.format(n=16))
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64")
    fn = s._build_step().__wrapped__
    aux = s._step_aux

    out1 = jax.jit(fn)(s.state, aux)

    mesh = make_mesh(8)
    sh = state_shardings(mesh, s.sim)
    stS = shard_state(s.state, mesh, s.sim)
    out8 = jax.jit(lambda st: fn(st, aux), in_shardings=(sh,),
                   out_shardings=sh)(stS)

    # sharded reductions reassociate sums -> tiny drift relative to each
    # field's scale is expected (momenta start near zero)
    U1 = np.asarray(out1.U)
    U8 = np.asarray(out8.U)
    for k in range(U1.shape[0]):
        scale = np.abs(U1[k]).max() or 1.0
        np.testing.assert_allclose(U8[k], U1[k], rtol=0,
                                   atol=1e-11 * scale)
    assert float(out8.dt) == pytest.approx(float(out1.dt), rel=1e-12)
    E1 = np.asarray(out1.Eflux)
    np.testing.assert_allclose(np.asarray(out8.Eflux), E1, rtol=0,
                               atol=1e-11 * np.abs(E1).max())


@pytest.mark.slow
def test_distributed_radiation_scan_x_sharded():
    """The sweep (x) axis sharded over 4 devices: the radiation sub-cycle
    uses the blockwise ppermute-carried prefix scan
    (plane.get_ph_rate_plane_dist) instead of a shard-local cumprod —
    the round-2 Eflux pin P('z','y',None) is gone.  Must reproduce the
    serial step to roundoff (the scan reassociates the product)."""
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _ISPH_DECK
    par = ParameterDB.from_string(_ISPH_DECK.format(n=16))
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64")

    f0 = s._build_step().__wrapped__
    out1 = jax.jit(f0)(s.state, s._step_aux)

    mesh = make_mesh(8, shape=(1, 2, 4))
    s.mesh = mesh
    s._jit_step = None
    fn = s._build_step().__wrapped__
    aux = s._step_aux
    sh = state_shardings(mesh, s.sim)
    stS = shard_state(s.state, mesh, s.sim)
    out8 = jax.jit(lambda st: fn(st, aux), in_shardings=(sh,),
                   out_shardings=sh)(stS)

    U1 = np.asarray(out1.U)
    U8 = np.asarray(out8.U)
    for k in range(U1.shape[0]):
        scale = np.abs(U1[k]).max() or 1.0
        np.testing.assert_allclose(U8[k], U1[k], rtol=0,
                                   atol=1e-11 * scale)
    assert float(out8.dt) == pytest.approx(float(out1.dt), rel=1e-12)
    E1 = np.asarray(out1.Eflux)
    np.testing.assert_allclose(np.asarray(out8.Eflux), E1, rtol=0,
                               atol=1e-11 * np.abs(E1).max())


@pytest.mark.slow
def test_explicit_halo_step_matches_serial():
    """Explicit shard_map + ppermute halo step (parallel/overlap.py) at the
    production nghost=4, with halo exchange composed against physical
    (periodic) BCs: must reproduce the serial CTU step on the interior."""
    from atmospheric_athena_tpu import bvals
    from atmospheric_athena_tpu.integrators import ctu3d
    from atmospheric_athena_tpu.parallel.overlap import hydro_step_sharded

    par = ParameterDB.from_string(BLAST3D_DECK)
    s = Simulation.from_par(par)
    state = s.state
    dt = state.dt

    ref = ctu3d.step(state, dt, s.sim, s.grid, problem=None)
    ref = bvals.apply_bc(ref, s.grid, s.sim, None)

    mesh = make_mesh(8, shape=(2, 2, 2))
    sh = state_shardings(mesh, s.sim)
    stS = shard_state(state, mesh, s.sim)
    out = jax.jit(lambda st: hydro_step_sharded(st, dt, s.sim, s.grid,
                                                mesh),
                  in_shardings=(sh,), out_shardings=sh)(stS)
    out = bvals.apply_bc(out, s.grid, s.sim, None)

    np.testing.assert_allclose(np.asarray(out.U), np.asarray(ref.U),
                               rtol=0, atol=1e-13)


def test_sharded_radiation_coverage_guard():
    """An x-sharded mesh with a radiation configuration the distributed
    scan does not cover must fail loudly at trace time, not silently run
    a shard-local attenuation scan (ionradplane_3d.c:226-318)."""
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _ISPH_DECK
    from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer
    par = ParameterDB.from_string(_ISPH_DECK.format(n=16))
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64")
    s._build_step()        # populates s.ion
    mesh = make_mesh(8, shape=(1, 2, 4))   # x sharded x4

    # SMR-fine inlet mode under x-sharding: not covered -> loud failure
    inlet = jnp.ones(s.grid.padded_shape()[:2] + (1,), s.state.U.dtype)
    with pytest.raises(NotImplementedError, match="sharded"):
        ion_radtransfer(s.state, s.sim, s.grid, s.ion, s.state.time,
                        s.cour_no, inlet=inlet,
                        tcoarse=jnp.zeros(()), mesh=mesh)

    # a plane sweeping an UNSHARDED axis under the same mesh is fine:
    # the serial scan partitions correctly (sweep axis device-local)
    import dataclasses
    mesh_zx = make_mesh(8, shape=(2, 1, 4))   # y unsharded
    ion_y = dataclasses.replace(s.ion, radplanes=((-2, 1.0),),
                                time_ramp=False)
    out, dtn = ion_radtransfer(s.state, s.sim, s.grid, ion_y,
                               s.state.time, s.cour_no, mesh=mesh_zx)
    assert np.isfinite(np.asarray(out.U)).all()

    # ...but the same plane on a y-sharded mesh fails loudly
    with pytest.raises(NotImplementedError, match="sharded"):
        ion_radtransfer(s.state, s.sim, s.grid, ion_y, s.state.time,
                        s.cour_no, mesh=mesh)


@pytest.mark.slow
def test_explicit_halo_production_step_matches_serial():
    """The FULL production step through Simulation with a >1-device mesh
    selects the explicit-halo path (overlap.hydro_step_sharded_grav with
    per-shard phi halo blocks + bvals.apply_bc_sharded + the distributed
    radiation scan): active-zone results must match the serial step."""
    import sys
    sys.path.insert(0, "/root/repo")
    from __graft_entry__ import _ISPH_DECK
    par = ParameterDB.from_string(_ISPH_DECK.format(n=16))
    s1 = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64")
    fn1 = s1._build_step().__wrapped__
    out1 = jax.jit(fn1)(s1.state, s1._step_aux)

    par2 = ParameterDB.from_string(_ISPH_DECK.format(n=16))
    s8 = Simulation.from_par(par2, problem="ioniz_sphere",
                             dtype="float64")
    mesh = make_mesh(8)
    s8.mesh = mesh
    fn8 = s8._build_step().__wrapped__
    sh = state_shardings(mesh, s8.sim)
    stS = shard_state(s8.state, mesh, s8.sim)
    aux8 = s8._step_aux
    out8 = jax.jit(lambda st: fn8(st, aux8), in_shardings=(sh,),
                   out_shardings=sh)(stS)

    # interior (active-zone) comparison: the explicit-halo step leaves
    # garbage in the global ghosts by design until the next fill; the
    # step itself ends with apply_bc so ghosts should ALSO match, but
    # reassociated sharded reductions allow tiny drift
    U1 = np.asarray(out1.U)
    U8 = np.asarray(out8.U)
    for k in range(U1.shape[0]):
        scale = np.abs(U1[k]).max() or 1.0
        np.testing.assert_allclose(U8[k], U1[k], rtol=0,
                                   atol=1e-11 * scale)
    assert float(out8.dt) == pytest.approx(float(out1.dt), rel=1e-12)
