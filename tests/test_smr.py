"""Static mesh refinement vs the reference C build (--enable-smr).

Goldens generated from /root/reference configured with
--with-problem=blast --with-gas=hydro --with-flux=roe --with-order=2
--enable-h-correction --enable-smr, run serially on
tests/golden/athinput.blast2lev for 10 cycles (root 32^3 + one 2x child
32^3 over the centre).  Checks the (time, dt) trajectory and the final
root- and child-level conserved fields — exercising conserved restriction,
fine/coarse flux correction, and ghost-zone prolongation
(src/smr.c:1207-1675, 2359-3130).
"""

import os

import numpy as np
import pytest

from atmospheric_athena_tpu import ParameterDB
from atmospheric_athena_tpu.hierarchy import MeshSimulation
from atmospheric_athena_tpu import smr
from atmospheric_athena_tpu.config import GridConfig

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden")


def test_restrict_prolong_roundtrip():
    """A linear field prolongs exactly (mcd slopes reproduce linears) and
    restriction is the exact adjoint mean."""
    pg = GridConfig(Nx=(16, 16, 16), xmin=(0, 0, 0), xmax=(1, 1, 1))
    cg = GridConfig(Nx=(16, 16, 16), xmin=(0.25, 0.25, 0.25),
                    xmax=(0.75, 0.75, 0.75))
    link = smr.child_link(pg, cg, (8, 8, 8))
    zc = [np.asarray(pg.cc_coords(a)) for a in range(3)]
    X = (zc[0][None, None, :] + 2 * zc[1][None, :, None]
         - zc[2][:, None, None])
    Up = np.stack([X, 1 + 0 * X])
    Uf = np.zeros((2,) + cg.padded_shape())
    out = np.asarray(smr.prolong_ghosts(Up, Uf, pg, cg, link))
    fc = [np.asarray(cg.cc_coords(a)) for a in range(3)]
    Xf = (fc[0][None, None, :] + 2 * fc[1][None, :, None]
          - fc[2][:, None, None])
    # ghost cells (outside the interior splice) must carry the linear field
    g = cg.nghost
    np.testing.assert_allclose(out[0, :g], Xf[:g], rtol=1e-12)
    np.testing.assert_allclose(out[0, :, :, -g:], Xf[:, :, -g:],
                               rtol=1e-12)
    # restriction of the prolonged interior reproduces the coarse values
    fine_full = np.asarray(smr.prolong_box(
        Up[(slice(None),) + pg.interior()], (True,) * 3))
    rest = np.asarray(smr.restrict_mean(fine_full, (True,) * 3))
    np.testing.assert_allclose(rest, Up[(slice(None),) + pg.interior()],
                               rtol=1e-12)


@pytest.mark.slow
def test_blast_2level_matches_reference():
    gold = np.load(os.path.join(GOLD, "blast2lev_10cycles.npz"))
    s = MeshSimulation.from_par(
        ParameterDB.from_file(os.path.join(GOLD, "athinput.blast2lev")),
        problem="blast")
    assert len(s.levels) == 2
    traj = gold["traj"]
    gold3 = np.load(os.path.join(GOLD, "blast2lev_3cycles.npz"))
    for i in range(10):
        s.step()
        t_ref, dt_ref = traj[i]
        assert float(s.state.time) == pytest.approx(t_ref, rel=1e-6), i
        assert float(s.state.dt) == pytest.approx(dt_ref, rel=1e-6), i
        if i == 2:
            # pre-divergence checkpoint: machine-precision agreement of
            # restriction + flux correction + prolongation
            r3 = np.asarray(s.levels[0].state.U)[
                (slice(None),) + s.levels[0].grid.interior()]
            l3 = np.asarray(s.levels[1].state.U)[
                (slice(None),) + s.levels[1].grid.interior()]
            for k, n in enumerate(["d", "M1", "M2", "M3", "E"]):
                np.testing.assert_allclose(
                    r3[k], gold3[f"root_{n}"], rtol=0,
                    atol=1e-13 * np.abs(gold3[f"root_{n}"]).max())
                np.testing.assert_allclose(
                    l3[k], gold3[f"lev1_{n}"], rtol=0,
                    atol=1e-13 * np.abs(gold3[f"lev1_{n}"]).max())

    # Cycles 1-3 agree with the reference to machine epsilon (~4e-16); at
    # cycle 4 a borderline Roe intermediate-state fallback (roe.c:256-284)
    # flips on a last-ulp difference and seeds a ~1e-10 local diff that
    # grows to ~2e-6 by cycle 10 — the same agreement class as the
    # single-level goldens.
    names = ["d", "M1", "M2", "M3", "E"]
    root = np.asarray(s.levels[0].state.U)[
        (slice(None),) + s.levels[0].grid.interior()]
    lev1 = np.asarray(s.levels[1].state.U)[
        (slice(None),) + s.levels[1].grid.interior()]
    for k, n in enumerate(names):
        scale = np.abs(gold[f"root_{n}"]).max()
        np.testing.assert_allclose(root[k], gold[f"root_{n}"], rtol=0,
                                   atol=2e-5 * scale, err_msg=f"root {n}")
        scale = np.abs(gold[f"lev1_{n}"]).max()
        np.testing.assert_allclose(lev1[k], gold[f"lev1_{n}"], rtol=0,
                                   atol=2e-5 * scale, err_msg=f"lev1 {n}")


@pytest.mark.slow
def test_blast_3level_matches_reference():
    """3-LEVEL hierarchy vs the reference --enable-smr build (every
    earlier SMR test was 2-level).  Exercises the general
    Domain tree with a grandchild: restriction and flux correction
    through two levels, prolongation root->lev1->lev2.  5 cycles at
    machine precision (cycle 6 hits a Roe-fallback branch flip on a
    1-2 ulp reassociation difference and diverges chaotically — the
    same integrator reproduces the reference bit-for-bit when fed the
    reference's own dump, so the pre-flip window is the honest
    comparison)."""
    gold = np.load(os.path.join(GOLD, "athinput.blast3lev".replace(
        "athinput.blast3lev", "blast3lev_5cycles.npz")))
    s = MeshSimulation.from_par(
        ParameterDB.from_file(os.path.join(GOLD, "athinput.blast3lev")),
        problem="blast")
    assert len(s.levels) == 3
    traj = gold["traj"]
    for i in range(5):
        s.step()
        # (the per-cycle times pin every dt actually used; the
        # reference's printed "next dt" lags its own output clipping)
        assert float(s.state.time) == pytest.approx(traj[i][0],
                                                    rel=1e-6), i
    for li, pre in [(0, "root"), (1, "lev1"), (2, "lev2")]:
        U = np.asarray(s.levels[li].state.U)[
            (slice(None),) + s.levels[li].grid.interior()]
        for k, n in enumerate(["d", "M1", "M2", "M3", "E"]):
            scale = np.abs(gold[f"{pre}_{n}"]).max()
            np.testing.assert_allclose(
                U[k], gold[f"{pre}_{n}"], rtol=0,
                atol=1e-12 * max(scale, 1e-30),
                err_msg=f"level {li} field {n}")


def _blast2lev_small():
    par = ParameterDB.from_file(os.path.join(GOLD, "athinput.blast2lev"))
    for dom, n in (("domain1", 8), ("domain2", 8)):
        for a in "123":
            par.set(dom, f"Nx{a}", n)
    for a in "ijk":
        par.set("domain2", f"{a}Disp", 4)
    return MeshSimulation.from_par(par, problem="blast")


@pytest.mark.parametrize("limit", [None, 10 ** 15, 1])
def test_phased_choice_from_compiled_peak(monkeypatch, limit):
    """The whole cycle runs as one program unless its compiled peak, with
    the margin, exceeds the device's limit; no limit (the CPU) compiles
    nothing extra.  The phased cycle gives the whole cycle's result."""
    from atmospheric_athena_tpu import hierarchy
    monkeypatch.setattr(hierarchy, "_bytes_limit", lambda: limit)
    s = _blast2lev_small()
    s.step()
    s.step()
    assert s.phased == (limit == 1)
    if limit is None:
        assert s.whole_peak_bytes is None
        return
    assert s.whole_peak_bytes > 0
    if not s.phased:
        return
    monkeypatch.setattr(hierarchy, "_bytes_limit", lambda: None)
    ref = _blast2lev_small()
    ref.step()
    ref.step()
    assert float(s.state.time) == float(ref.state.time)
    for a, b in zip(s.levels, ref.levels):
        Ua, Ub = np.asarray(a.state.U), np.asarray(b.state.U)
        np.testing.assert_allclose(Ua, Ub, rtol=0,
                                   atol=1e-13 * np.abs(Ub).max())
