import os, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ['JAX_PLATFORMS']='cpu'
import jax; jax.config.update('jax_enable_x64', True)
from atmospheric_athena_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import numpy as np
from atmospheric_athena_tpu import Simulation

s = Simulation.from_file(
    os.path.join(REPO, '.refbuild/run/ifront/athinput.ifront10'),
    problem='ifront')
for i in range(10):
    s.step()
    print(f'cycle={i} time={float(s.state.time):.6e} next_dt={float(s.state.dt):.6e} last_dt={float(s.state.U[0,4,4,4])*0:.0e}', flush=True)

ref = np.loadtxt(os.path.join(REPO, '.refbuild/run/ifront/ifront.0001.tab'))
N = 64
U = np.asarray(s.state.U)[(slice(None),)+s.grid.interior()]
for name,k,c in [('d',0,6),('M1',1,7),('E',4,10),('s0',5,11)]:
    r = ref[:,c].reshape(N,N,N)
    diff = np.abs(U[k]-r)
    print(f'{name}: max abs {diff.max():.3e}  rel {diff.max()/np.abs(r).max():.3e}', flush=True)
print('DONE', flush=True)
