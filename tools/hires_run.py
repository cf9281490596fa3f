"""Run the flagship 5-level SMR production deck
(tst/massloss/athinput.ioniz_sphere_hires) end-to-end for N cycles on the
GPU and record sanity metrics (finiteness, mass, timing) to
chiprun_out/smr_hires.json.

    python tools/hires_run.py <path/to/athinput.ioniz_sphere_hires>"""
import json, os, sys, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import jax, jax.numpy as jnp
import numpy as np
from atmospheric_athena_tpu import ParameterDB, Simulation
from atmospheric_athena_tpu.utils.cache import enable_compile_cache
from atmospheric_athena_tpu.utils.device import nvidia_smi, require_gpu

require_gpu()
enable_compile_cache()
OUT = os.path.join(REPO, 'chiprun_out', 'smr_hires.json')
os.makedirs(os.path.dirname(OUT), exist_ok=True)

NCYC = int(os.environ.get('HIRES_NCYC', '10'))
par = ParameterDB.from_file(sys.argv[1])
par.set('ionradiation', 'maxiter', int(os.environ.get('HIRES_MAXITER', '10000')))
s = Simulation.from_par(par, problem='ioniz_sphere', dtype='float32')
print('levels:', [(l.lev, l.grid.Nx) for l in s.levels], flush=True)

t0 = time.perf_counter()
s.step()
print('first step (incl compile): %.1fs' % (time.perf_counter() - t0), flush=True)
rows = []
t0 = time.perf_counter()
DEADLINE = float(os.environ.get('HIRES_DEADLINE_S', '1e9'))


def snapshot(ncyc_done, wall):
    zones = sum(int(np.prod(l.grid.Nx)) for l in s.levels)
    masses = []
    finite = True
    for l in s.levels:
        Ua = np.asarray(l.state.U[0][l.grid.interior()])
        finite &= bool(np.isfinite(np.asarray(l.state.U)).all())
        masses.append(float(Ua.sum() *
                            np.prod([l.grid.dx[a] for a in range(3)])))
    out = dict(ncyc=ncyc_done, wall_after_first=wall,
               zc_per_s=(zones * max(ncyc_done - 1, 0) / wall
                         if wall > 0 else None),
               time=float(s.state.time), dt=float(s.state.dt),
               finite=finite, level_masses=masses,
               levels=[list(l.grid.Nx) for l in s.levels],
               traj_tail=rows[-5:])
    with open(OUT, 'w') as f:
        json.dump(out, f, indent=1)


for i in range(NCYC - 1):
    s.step()
    t = float(s.state.time); dt = float(s.state.dt)
    print('cycle=%d time=%.6e dt=%.6e' % (i + 2, t, dt), flush=True)
    rows.append((t, dt))
    snapshot(i + 2, time.perf_counter() - t0)
    if time.perf_counter() - t0 > DEADLINE:
        print('deadline reached at cycle', i + 2, flush=True)
        break
wall = time.perf_counter() - t0
zones = sum(int(np.prod(l.grid.Nx)) for l in s.levels)
masses = []
finite = True
for l in s.levels:
    U = np.asarray(l.state.U[0][l.grid.interior()])
    finite &= bool(np.isfinite(np.asarray(l.state.U)).all())
    masses.append(float(U.sum() * np.prod([l.grid.dx[a] for a in range(3)])))
ncyc_done = len(rows) + 1
out = dict(ncyc=ncyc_done, wall_after_first=wall,
           zc_per_s=zones * len(rows) / wall if wall > 0 else None,
           time=float(s.state.time), dt=float(s.state.dt),
           finite=finite, level_masses=masses,
           levels=[list(l.grid.Nx) for l in s.levels], card=nvidia_smi())
print(json.dumps(out), flush=True)
with open(OUT, 'w') as f:
    json.dump(out, f, indent=1)
