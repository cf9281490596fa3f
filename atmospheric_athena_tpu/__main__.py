"""Command-line driver (reference: src/main.c:161-201, 862-877).

Flags mirror the reference binary:
  -i <file>   athinput parameter file (required unless -r)
  -r <file>   restart from a checkpoint (.rst.npz)
  -d <dir>    output directory (change_rundir analogue)
  -n          parse input and quit (show config)
  -c          show configuration then quit
  -t hh:mm:ss wall-time limit: terminate gracefully before it
  block/name=value  parameter overrides (par_cmdline)

plus extras:
  --problem <name>  problem generator (the reference bakes this in at
                    configure time; we select at runtime)
  --dtype float32|float64
"""

from __future__ import annotations

import argparse
import sys
import time as _time


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="atmospheric_athena_tpu",
                                 description=__doc__)
    ap.add_argument("-i", dest="input", help="athinput parameter file")
    ap.add_argument("-r", dest="restart", help="restart checkpoint")
    ap.add_argument("-d", dest="outdir", default=".", help="output dir")
    ap.add_argument("-n", dest="parse_only", action="store_true")
    ap.add_argument("-c", dest="show_config", action="store_true")
    ap.add_argument("-t", dest="wall_limit", default=None,
                    help="wall-time limit hh:mm:ss")
    ap.add_argument("--problem", default=None)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("overrides", nargs="*", help="block/name=value")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from . import Simulation
    from .utils.cache import enable_compile_cache

    enable_compile_cache()

    overrides = {}
    if args.dtype:
        overrides["dtype"] = args.dtype

    if args.restart:
        from .io.restart import load_checkpoint
        from .models import get_problem
        state, sim, grid, par = load_checkpoint(args.restart)
        par.apply_cmdline(args.overrides)
        from .simulation import parse_configure_line
        problem = args.problem or parse_configure_line(par).get("_problem")
        prob = get_problem(problem)(par, sim, grid)
        s = Simulation(par, sim, grid, prob, state)
    else:
        if not args.input:
            print("error: -i <athinput> or -r <checkpoint> required",
                  file=sys.stderr)
            return 1
        s = Simulation.from_file(args.input, problem=args.problem,
                                 cmdline=args.overrides, **overrides)

    if args.parse_only or args.show_config:
        print(s.par.dump())
        print(f"# sim config: {s.sim}")
        print(f"# grid: Nx={s.grid.Nx} dx={s.grid.dx}")
        return 0

    wall_limit = None
    if args.wall_limit:
        h, m, sec = (int(x) for x in args.wall_limit.split(":"))
        wall_limit = h * 3600 + m * 60 + sec

    # POSIX signal handling (src/ath_signal.c, checked each cycle at
    # main.c:657): a scheduler SIGTERM triggers a graceful stop with a
    # final forced dump instead of losing the run.
    import signal as _signal
    caught = {"sig": 0}

    def _sig_handler(signum, frame):
        caught["sig"] = signum
    for _s in (_signal.SIGTERM, _signal.SIGUSR1):
        try:
            _signal.signal(_s, _sig_handler)
        except (ValueError, OSError):
            pass

    outs = s.make_outputs(args.outdir)
    t0 = _time.perf_counter()

    def output_fn(sim_obj):
        outs(sim_obj)
        if caught["sig"]:
            raise KeyboardInterrupt(f"caught signal {caught['sig']}")
        if wall_limit and _time.perf_counter() - t0 > wall_limit:
            raise KeyboardInterrupt("wall-time limit reached")

    try:
        res = s.run(verbose=True, output_fn=output_fn)
    except KeyboardInterrupt:
        print("terminating on wall-limit/interrupt; writing final outputs")
        outs(s, force=True)
        return 0
    outs(s, force=True)
    print(f"zone-cycles/wall-second = {res['zone_cycles_per_sec']:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
