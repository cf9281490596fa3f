#!/usr/bin/env python
"""Smoke test of the production path on an NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-4
    python chip_smoke.py --multi    # four cards: the sharded production step

Phases (one process, every phase must pass):

  1. device      — JAX must report a GPU (no CPU fallback); prints the card's
                   name and power limit from nvidia-smi.
  2. golden      — tests/golden/athinput.isph64 in float64 for 10 cycles vs
                   the reference-binary golden, at the tier-1 test's
                   tolerance (atol 1e-10 x field scale, (time, dt) to 1e-6).
  3. production  — the CLI (``python -m atmospheric_athena_tpu``) on the
                   256^3 float32 ioniz_sphere deck for 3 cycles with the
                   deck's maxiter=10000 radiation turn-on; the final restart
                   dump must be finite with dt > 0.
  4. smr         — tests/golden/athinput.isph2lev through Simulation.from_par
                   for 3 cycles at cour_no=0.01 (ROADMAP D9); every level
                   finite.  Then, at the deck's cour_no, the fine level at
                   t=20 s against one 64^3 domain over the refined region.
  5. multi       — (--multi only, and then alone) the explicit-halo
                   production step at 256^3 float32 sharded over four cards
                   for 3 cycles vs the same run on one card: the fields,
                   dt and the distributed scan's radiation flux.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}; any
failure raises, so the exit code is non-zero and that line is not printed.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "out", "chip_smoke")
FIELDS = ("d", "M1", "M2", "M3", "E", "s0")
NCYC = 3
N_PROD = 256


def log(msg):
    print(msg, flush=True)


def phase_golden(jax):
    from atmospheric_athena_tpu import Simulation
    from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_ioniz_sphere import GOLD, REF_TRAJ

    with jax.enable_x64(True):
        s = Simulation.from_file(os.path.join(GOLD, "athinput.isph64"),
                                 problem="ioniz_sphere")
        s._jit_step = s._build_step()
        # the step's own sub-cycle count, from the same pre-step state
        count = jax.jit(lambda st: ion_radtransfer(
            st, s.sim, s.grid, s.ion, st.time, s.cour_no,
            return_niter=True)[2])
        for i, (t_ref, dt_ref) in enumerate(REF_TRAJ):
            niter = int(count(s.state))
            s.step()
            t, dt = float(s.state.time), float(s.state.dt)
            log(f"[golden] cycle={i + 1} rad_iters={niter} time={t:.6e} "
                f"dt={dt:.6e}")
            assert abs(t - t_ref) <= 1e-6 * t_ref, (i, t, t_ref)
            assert abs(dt - dt_ref) <= 1e-6 * dt_ref, (i, dt, dt_ref)
        gold = np.load(os.path.join(GOLD, "ioniz_sphere_64_10cycles.npz"))
        U = np.asarray(s.state.U)[(slice(None),) + s.grid.interior()]
    bad = []
    for k, name in enumerate(FIELDS):
        scale = np.abs(gold[name]).max() or 1.0
        err = float(np.abs(U[k] - gold[name]).max())
        log(f"[golden] {name}: max|err|={err:.3e} scale={scale:.3e} "
            f"rel={err / scale:.3e} (tolerance 1e-10)")
        if err > 1e-10 * scale:
            bad.append(name)
    assert not bad, f"golden mismatch in {bad}"


def phase_production(jax):
    from __graft_entry__ import _ISPH_DECK
    from atmospheric_athena_tpu.__main__ import main as cli_main
    from atmospheric_athena_tpu.utils.device import nvidia_smi

    os.makedirs(OUT, exist_ok=True)
    for f in glob.glob(os.path.join(OUT, "isph256.*.rst.npz")):
        os.remove(f)
    deck = os.path.join(OUT, f"athinput.isph{N_PROD}")
    with open(deck, "w") as fh:
        # one restart dump, forced at the end of the run
        fh.write(_ISPH_DECK.format(n=N_PROD) + """
<job>
problem_id = isph256
maxout = 1

<output1>
out_fmt = rst
time = 1e30
""")
    compile_s = [0.0]

    def on_event(event, duration, **kw):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += duration
    jax.monitoring.register_event_duration_secs_listener(on_event)
    t0 = time.perf_counter()
    rc = cli_main(["-i", deck, "-d", OUT, "--problem", "ioniz_sphere",
                   "--dtype", "float32", f"time/nlim={NCYC}"])
    wall = time.perf_counter() - t0
    assert rc == 0, f"CLI exit code {rc}"
    dumps = sorted(glob.glob(os.path.join(OUT, "isph256.*.rst.npz")))
    assert dumps, "CLI wrote no restart dump"
    with np.load(dumps[-1]) as z:
        U, dt, nstep = z["U"], float(z["dt"]), int(z["nstep"])
    os.remove(dumps[-1])
    assert U.shape == (6,) + (N_PROD + 8,) * 3 and U.dtype == np.float32, (
        U.shape, U.dtype)
    assert nstep == NCYC, nstep
    finite = [bool(np.isfinite(U[k]).all()) for k in range(U.shape[0])]
    log(f"[production] finite per field {dict(zip(FIELDS, finite))} "
        f"dt={dt:.6e} nstep={nstep}")
    assert all(finite) and dt > 0.0
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[production] {N_PROD}^3 f32 {NCYC} cycles on {nvidia_smi()}: CLI "
        f"wall {wall:.2f} s, of which compile {compile_s[0]:.2f} s, steps "
        f"and I/O {wall - compile_s[0]:.2f} s; peak_bytes_in_use {peak}")


def phase_smr(jax):
    from atmospheric_athena_tpu import ParameterDB, Simulation
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_smr_radiation import DECK, TLIM, fine_level_vs_uniform_fine_run

    with jax.enable_x64(True):
        par = ParameterDB.from_file(DECK)
        # at the deck's cour_no=0.4 the first cycle ends at dt ~30 s and the
        # second goes non-finite; a uniform 64^3 run of the deck does too
        # once its dt reaches tens of seconds (ROADMAP D9).  0.01 keeps dt
        # near 1 s; maxiter as in the production deck
        log("[smr] cycles at cour_no=0.01, not the deck's 0.4 (ROADMAP D9)")
        par.set("time", "cour_no", 0.01)
        par.set("ionradiation", "maxiter", 10000)
        ms = Simulation.from_par(par, problem="ioniz_sphere")
        for i in range(NCYC):
            ms.step()
            log(f"[smr] cycle={i + 1} time={float(ms.state.time):.6e} "
                f"dt={float(ms.state.dt):.6e}")
        log(f"[smr] phased={ms.phased} whole-cycle peak "
            f"{ms.whole_peak_bytes} B")
        for li, lev in enumerate(ms.levels):
            U = np.asarray(lev.state.U)
            ok = bool(np.isfinite(U).all())
            log(f"[smr] level {li} Nx={lev.grid.Nx} finite={ok}")
            assert ok, f"level {li} not finite"
        assert float(ms.state.dt) > 0.0

        # the radiation coupling (inlet flux from the parent, restriction)
        # at the deck's own cour_no: the fine level's fields and radiation
        # flux against one 64^3 domain over the refined region, at t=TLIM
        bad = []
        for name, err, scale, tol in fine_level_vs_uniform_fine_run():
            log(f"[smr] fine level vs uniform 64^3 at t={TLIM:g}: {name} "
                f"|err|={err:.3e} rel={err / scale:.3e} "
                f"(tolerance {tol:g})")
            if not err < tol * scale:
                bad.append(name)
        assert not bad, f"fine level differs from the uniform run in {bad}"


def phase_multi(jax, ndev=4):
    from __graft_entry__ import _ISPH_DECK
    from atmospheric_athena_tpu import ParameterDB, Simulation
    from atmospheric_athena_tpu.parallel.mesh import make_mesh, shard_state

    assert len(jax.devices()) >= ndev, f"need {ndev} GPUs"

    def run(mesh):
        par = ParameterDB.from_string(_ISPH_DECK.format(n=N_PROD))
        s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float32")
        if mesh is not None:
            s.mesh = mesh
            s.state = shard_state(s.state, mesh, s.sim)
        t0 = time.perf_counter()
        for _ in range(NCYC):
            s.step()
        jax.block_until_ready(s.state.U)
        return s, time.perf_counter() - t0

    s1, wall1 = run(None)
    U1, dt1 = np.asarray(s1.state.U), float(s1.state.dt)
    F1 = np.asarray(s1.state.Eflux)
    del s1
    mesh = make_mesh(ndev)
    log(f"[multi] mesh {dict(mesh.shape)} (parallel.mesh.factor3)")
    s4, wall4 = run(mesh)
    devs = {sh.device for sh in s4.state.U.addressable_shards}
    log(f"[multi] U shards on {len(devs)} devices: "
        f"{sorted(str(d) for d in devs)}")
    assert len(devs) == ndev, devs
    U4, dt4 = np.asarray(s4.state.U), float(s4.state.dt)
    log(f"[multi] wall incl. compile: 1 card {wall1:.2f} s, "
        f"{ndev} cards {wall4:.2f} s")
    # at the turn-on kph*dt is too small next to s0 and E for U to show a
    # wrong carry in the distributed scan: with the carry dropped, U stays
    # equal to one device's and the radiation flux on the cell faces
    # (Eflux), the scan's own output, is off by its whole scale.  A sound
    # run reads 0.0 for U, dt and Eflux on four H100s; the tolerances, 1e-4
    # of each field's scale and 1e-5 of the flux's, leave XLA room to
    # reassociate the attenuation product
    tol, tol_flux = 1e-4, 1e-5
    log(f"[multi] dt 1 card {dt1:.9e}, {ndev} cards {dt4:.9e}")
    assert abs(dt4 - dt1) <= tol * dt1, (dt1, dt4)
    sl = (slice(None),) + s4.grid.interior()
    checks = [(name, U1[sl][k], U4[sl][k], tol)
              for k, name in enumerate(FIELDS)]
    checks.append(("Eflux", F1, np.asarray(s4.state.Eflux), tol_flux))
    for name, a, b, t in checks:
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = float(np.abs(a).max()) or 1.0
        err = float(np.abs(a - b).max())
        log(f"[multi] {name}: max|diff|={err:.3e} rel={err / scale:.3e} "
            f"(tolerance {t:g})")
        assert np.isfinite(b).all() and err <= t * scale, name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded production step")
    args = ap.parse_args(argv)

    import jax

    sys.path.insert(0, HERE)
    from atmospheric_athena_tpu.utils.cache import enable_compile_cache
    from atmospheric_athena_tpu.utils.device import (describe, nvidia_smi,
                                                     require_gpu)

    dev = require_gpu()
    log(f"[device] {describe(dev)}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    log(f"[device] compile cache: {enable_compile_cache()}")

    if args.multi:
        phases = [("multi", phase_multi)]
    else:
        phases = [("golden", phase_golden), ("production", phase_production),
                  ("smr", phase_smr)]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"[{name}] start")
        fn(jax)
        log(f"[{name}] passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": describe(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
