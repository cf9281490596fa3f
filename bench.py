#!/usr/bin/env python
"""Benchmark: zone-cycles/second on the production ioniz_sphere step, with
per-phase device times from a profiler trace.

    python bench.py

The cell: the full production step (radiation sub-cycle + ghost fill + 3D
CTU hydro + H-correction + PlanetPot gravity + inner-core reset + new_dt)
at 256**3, float32, radiation maxiter=50, on the first GPU JAX finds (it
exits non-zero when there is none).  It prints the device and the phase
breakdown on earlier lines and ONE JSON line last.  The headline metric
(zone-cycles/s on the host clock, to block_until_ready) keeps its earlier
definition; the other keys break the step down:

  step_device_ms / step_idle_share —
      the whole step's kernel time in the trace, and the share of the span
      from its first kernel to its last in which no kernel ran.
  <phase>_ms, for radiation, ghost_fill, ctu_hydro, userwork, new_dt —
      device time per call of that phase jitted on its own: the sum of its
      kernels' durations in the trace over the number of calls.
  rad_ms_per_iter / rad_iters_per_step_bench / rad_iters_step1_unclamped —
      radiation device time per sub-iteration, the sub-iterations in one
      bench step, and the REAL count of the first production step when
      maxiter is left at the deck's 10000.
  hydro_bytes_per_cell / hydro_hbm_gbps / hydro_roofline_pct —
      XLA cost_analysis bytes the CTU step moves per cell, over its device
      time, as a share of the card's peak bandwidth (PEAK_BYTES_PER_S).
  ghost_fill_copy_bound_ms — one read and one write of U at that peak.
  step_peak_bytes — compiled.memory_analysis() peak of the step.

The trace and a JSON file with each phase's leading kernels go to
<checkout>/out/bench/.

vs_baseline: the reference C code has no published numbers (BASELINE.md);
the baseline used here is the measured serial throughput of the reference
binary on a CPU core for the same 64^3 configuration
(zone-cycles/wall-second = 3.11e5) — i.e. vs_baseline = our
zone-cycles/s per card / reference zone-cycles/s per core.
"""

import glob
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "out", "bench")
N = 256
MAXITER = 50   # radiation sub-iterations per step: a stable workload
STEPS = 5      # full steps timed for the headline
REPS = 5       # calls of each phase in the trace
REF_BASELINE = 3.11e5  # reference C serial zone-cycles/s, one CPU core

# peak device-memory bandwidth (bytes/s) by jax device_kind, from NVIDIA's
# H100 data sheet (SXM part)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_bandwidth(device_kind: str) -> float:
    if device_kind not in PEAK_BYTES_PER_S:
        raise KeyError(f"no peak bandwidth known for {device_kind!r}; "
                       "add it to bench.PEAK_BYTES_PER_S with its source")
    return PEAK_BYTES_PER_S[device_kind]


def device_kernels(trace_dir):
    """[(hlo_module, hlo_op, start_ns, dur_ns)] of every kernel on a GPU
    plane of the newest trace under trace_dir."""
    import jax
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    out = []
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if "GPU" not in plane.name:
            continue
        for ln in plane.lines:
            for ev in ln.events:
                st = dict(ev.stats)
                if st.get("hlo_module") is not None:
                    out.append((str(st["hlo_module"]),
                                str(st.get("hlo_op", ev.name)),
                                ev.start_ns, ev.duration_ns))
    return out


def busy_ns(intervals):
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def phase_times(kernels, name, calls):
    """Device time of the jitted function `name` from its kernels."""
    mod = f"jit_{name}"
    evs = [k for k in kernels
           if k[0] == mod or k[0].startswith((mod + "(", mod + "."))]
    if not evs:
        raise RuntimeError(f"no kernel of {mod} in the trace")
    span = max(k[2] + k[3] for k in evs) - min(k[2] for k in evs)
    ops = {}
    for k in evs:
        ops[k[1]] = ops.get(k[1], 0.0) + k[3]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ms": sum(k[3] for k in evs) / calls / 1e6,
            "kernels": len(evs) / calls,
            "idle_share": 1.0 - busy_ns([(k[2], k[2] + k[3])
                                         for k in evs]) / span,
            "top_ops_ms": {k: v / calls / 1e6 for k, v in top}}


def main():
    sys.path.insert(0, HERE)
    import jax

    from atmospheric_athena_tpu.utils.cache import enable_compile_cache
    from atmospheric_athena_tpu.utils.device import (describe, nvidia_smi,
                                                     require_gpu)

    dev = require_gpu()
    peak = peak_bandwidth(dev.device_kind)
    card = nvidia_smi()
    print(f"device: {describe(dev)}; nvidia-smi: {card}", flush=True)
    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)

    from atmospheric_athena_tpu import ParameterDB, Simulation, bvals
    from atmospheric_athena_tpu import dt as dt_mod
    from atmospheric_athena_tpu.integrators import ctu3d
    from atmospheric_athena_tpu.ionrad.config import ion_config_from_par
    from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer
    from __graft_entry__ import _ISPH_DECK

    par = ParameterDB.from_string(_ISPH_DECK.format(n=N))
    par.set("ionradiation", "maxiter", MAXITER)
    par.set("time", "nlim", 10000)
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float32")
    # warmup/compile: two steps (the second covers the Eflux None->array
    # structure retrace)
    s.step()
    s.step()
    st = jax.block_until_ready(s.state)
    sim, grid, problem, ion, cour = (s.sim, s.grid, s.problem, s.ion,
                                     s.cour_no)
    phi, uw_aux, _ = s._step_aux

    # --- each phase as its own program, and the whole step ----------------
    def radiation(st):
        return ion_radtransfer(st, sim, grid, ion, st.time, cour,
                               return_niter=True)

    def ghost_fill(st):
        return bvals.apply_bc(st, grid, sim, problem)

    def ctu_hydro(st, phi):
        return ctu3d.step(st, st.dt, sim, grid, problem, phi=phi)

    def userwork(st, aux):
        return problem.userwork_in_loop(st, sim, grid, aux=aux)

    def new_dt(st):
        return dt_mod.new_dt(st, sim, grid, cour)

    phases = {"radiation": (jax.jit(radiation), (st,)),
              "ghost_fill": (jax.jit(ghost_fill), (st,)),
              "ctu_hydro": (jax.jit(ctu_hydro), (st, phi)),
              "userwork": (jax.jit(userwork), (st, uw_aux)),
              "new_dt": (jax.jit(new_dt), (st,)),
              "step": (s._jit_step, (st, s._step_aux))}
    compiled = {name: fn.lower(*a).compile()
                for name, (fn, a) in phases.items()}
    ca = compiled["ctu_hydro"].cost_analysis()
    hydro_bytes = (ca[0] if isinstance(ca, list) else ca)["bytes accessed"]
    ma = compiled["step"].memory_analysis()
    step_peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                 + ma.temp_size_in_bytes - ma.alias_size_in_bytes)
    n50 = int(phases["radiation"][0](st)[2])

    # --- device time per phase, from the trace ----------------------------
    for fn, a in phases.values():
        jax.block_until_ready(fn(*a))
    trace_dir = os.path.join(OUT, "trace")
    with jax.profiler.trace(trace_dir):
        for fn, a in phases.values():
            for _ in range(REPS):
                jax.block_until_ready(fn(*a))
    kernels = device_kernels(trace_dir)
    dev_t = {name: phase_times(kernels, name, REPS) for name in phases}
    for name, d in dev_t.items():
        print(f"{name}: {d['device_ms']:.3f} ms/call on the device, "
              f"{d['kernels']:.0f} kernels", flush=True)

    # --- the REAL first-step iteration count, unclamped -------------------
    par2 = ParameterDB.from_string(_ISPH_DECK.format(n=N))
    s2 = Simulation.from_par(par2, problem="ioniz_sphere", dtype="float32")
    ion_unc = ion_config_from_par(par2, s2.grid,
                                  radplanes=s2.problem.radplanes)
    niter_unc = int(jax.jit(lambda st: ion_radtransfer(
        st, s2.sim, s2.grid, ion_unc, st.time, s2.cour_no,
        return_niter=True)[2])(s2.state))
    del s2

    # --- headline: full production step, host clock -----------------------
    t0 = time.perf_counter()
    for _ in range(STEPS):
        s.step()
    jax.block_until_ready(s.state)
    wall = (time.perf_counter() - t0) / STEPS

    hydro_s = dev_t["ctu_hydro"]["device_ms"] / 1e3
    u_bytes = st.U.size * st.U.dtype.itemsize
    stats = dev.memory_stats() or {}
    zcps = N ** 3 / wall
    res = {
        "metric": "zone_cycles_per_second",
        "value": zcps,
        "unit": "zone-cycles/s/card (ioniz_sphere %d^3 f32, full step, "
                "ionrad maxiter=%d)" % (N, MAXITER),
        "vs_baseline": zcps / REF_BASELINE,
        "device": describe(dev),
        "nvidia_smi": card,
        "step_ms": wall * 1e3,
        "step_device_ms": dev_t["step"]["device_ms"],
        "step_idle_share": dev_t["step"]["idle_share"],
        **{f"{name}_ms": dev_t[name]["device_ms"]
           for name in phases if name != "step"},
        "rad_ms_per_iter": dev_t["radiation"]["device_ms"] / max(n50, 1),
        "rad_iters_per_step_bench": n50,
        "rad_iters_step1_unclamped": niter_unc,
        "hydro_bytes_per_cell": hydro_bytes / N ** 3,
        "hydro_hbm_gbps": hydro_bytes / hydro_s / 1e9,
        "hydro_roofline_pct": 100.0 * hydro_bytes / hydro_s / peak,
        "ghost_fill_copy_bound_ms": 2 * u_bytes / peak * 1e3,
        "step_peak_bytes": step_peak,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }
    with open(os.path.join(OUT, "bench.json"), "w") as fh:
        json.dump({**res, "phases": dev_t}, fh, indent=1)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
