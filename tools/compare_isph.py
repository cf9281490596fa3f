import os, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['JAX_PLATFORMS']='cpu'
import jax; jax.config.update('jax_enable_x64', True)
from atmospheric_athena_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import numpy as np
from atmospheric_athena_tpu import Simulation

s = Simulation.from_file(
    os.path.join(REPO, '.refbuild/run/isph/athinput.isph'),
    problem='ioniz_sphere')
print('h_corr:', s.sim.h_correction, flush=True)
t0=time.perf_counter()
for i in range(10):
    s.step()
    print(f'cycle={i+1} time={float(s.state.time):.6e} next_dt={float(s.state.dt):.6e}', flush=True)
print('elapsed', time.perf_counter()-t0, flush=True)
ref = np.loadtxt(os.path.join(REPO, '.refbuild/run/isph/isph.0001.tab'))
N = 64
U = np.asarray(s.state.U)[(slice(None),)+s.grid.interior()]
for name,k,c in [('d',0,6),('M1',1,7),('M2',2,8),('M3',3,9),('E',4,10),('s0',5,11)]:
    r = ref[:,c].reshape(N,N,N)
    diff = np.abs(U[k]-r)
    sc = np.abs(r).max()
    print(f'{name}: max abs {diff.max():.3e}  rel {diff.max()/(sc if sc else 1):.3e}', flush=True)
print('DONE', flush=True)
