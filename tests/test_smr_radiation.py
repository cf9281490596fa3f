"""SMR + ionizing radiation validation (the flagship hierarchy path).

No reference golden is possible here: the reference C build itself
(--enable-smr --enable-ion-radiation, serial) produces NaN density and
energy on the fine level within 10 cycles of the committed
tests/golden/athinput.isph2lev deck — reproduced in-tree on 2026-08-21
with /root/reference built via
  ./configure --with-problem=ioniz_sphere --with-gas=hydro
     --enable-ion-radiation --enable-ion-plane --with-flux=roe
     --enable-h-correction --enable-smr
  bin/athena -i athinput.isph2lev time/nlim=10 ionradiation/maxiter=10000
which prints 'Neg or NaN dens: nan ... lev:1' from cycle <10 on (the
fine-level prolongation feeds the unstable front; the reference merely
warns, prob/ioniz_sphere.c:280-281, and keeps running with NaN cells).

Validation here instead cross-checks the SMR fine level against a
SINGLE-DOMAIN run of the whole box at the fine resolution, over the
refined region, both advanced to the same physical time: the refined
region's solution must agree up to discretization differences (the
coarse-level attenuation upstream of the fine box, and the different
check_range/dt trajectories).
"""

import os

import numpy as np
import pytest

from atmospheric_athena_tpu import ParameterDB, Simulation

DECK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                    "athinput.isph2lev")
TLIM = 2.0e1
# (field, index in U, tolerance as a share of the uniform run's scale)
TOLS = (("d", 0, 1e-2), ("E", 4, 1e-3), ("s0", 5, 1e-2))
TOL_EFLUX = 2e-2


def fine_level_vs_uniform_fine_run():
    """Run the deck to TLIM as SMR and as one 64^3 domain; return
    (field, err, scale, tol) for the fine level against the uniform run
    over the refined region: the max for the fields of U, the mean for the
    radiation flux.  Runs in the caller's precision."""
    par = ParameterDB.from_file(DECK)
    par.set("ionradiation", "maxiter", 200)
    par.set("time", "tlim", TLIM)
    par.set("time", "nlim", 40)
    ms = Simulation.from_par(par, problem="ioniz_sphere")
    ms.run()
    assert float(ms.state.time) == pytest.approx(TLIM)

    par2 = ParameterDB.from_file(DECK)
    par2.set("ionradiation", "maxiter", 200)
    par2.set("time", "tlim", TLIM)
    par2.set("time", "nlim", 60)
    par2.set("job", "num_domains", 1)
    for a in ("1", "2", "3"):
        par2.set("domain1", f"Nx{a}", 64)
    s = Simulation.from_par(par2, problem="ioniz_sphere")
    s.run()
    assert float(s.state.time) == pytest.approx(TLIM)

    # fine level (level 1, 32^3 at root cells [8,24)) vs the uniform 64^3
    # run's cells [16,48) — same physical region at the same resolution
    fine = ms.levels[1]
    Uf = np.asarray(fine.state.U)[(slice(None),) + fine.grid.interior()]
    Uu = np.asarray(s.state.U)[:, 20:52, 20:52, 20:52]
    assert np.isfinite(Uf).all() and np.isfinite(Uu).all()
    rows = [(name, float(np.abs(Uf[k] - Uu[k]).max()),
             float(np.abs(Uu[k]).max()), tol) for name, k, tol in TOLS]
    # the radiation flux on the cell faces along the sweep: the fine
    # level's comes in through its inlet from the parent's flux
    Ef = np.asarray(fine.state.Eflux)
    Eu = np.asarray(s.state.Eflux)[16:48, 16:48, 16:49]
    # a few faces at the edge of the planet's shadow differ by half the
    # inflow between the two runs, so the flux is compared in the mean:
    # 7.0e-3 of the mean flux; 8.9e-2 with the inlet taken from the
    # child's downstream face instead of its upstream one
    rows.append(("Eflux (mean over faces)", float(np.abs(Ef - Eu).mean()),
                 float(np.abs(Eu).mean()), TOL_EFLUX))
    return rows


@pytest.mark.slow
def test_smr_fine_level_matches_uniform_fine_run():
    for name, err, scale, tol in fine_level_vs_uniform_fine_run():
        assert err < tol * scale, (name, err, scale)
