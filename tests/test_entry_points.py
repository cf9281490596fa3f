"""Entry points: the production step through __graft_entry__, the compile
cache location, chip_smoke.py's refusal to run without a GPU, and a scan
that keeps accelerator-specific kernels and switches out of the code."""

import glob
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_graft_entry_production_step():
    """One full ioniz_sphere production step at 32^3 f32 (radiation
    sub-cycle, ghost fill, CTU hydro + H-correction + gravity, userwork,
    new_dt) is finite with a positive next dt."""
    sys.path.insert(0, REPO)
    from __graft_entry__ import entry
    fn, (state, aux) = entry()
    out = jax.jit(fn)(state, aux)
    assert out.U.shape == state.U.shape and out.U.dtype == np.float32
    assert np.isfinite(np.asarray(out.U)).all()
    assert float(out.dt) > 0.0
    assert int(out.nstep) == 1


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    from atmospheric_athena_tpu.utils import cache
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv(cache.ENV, str(tmp_path))
            assert cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; the helper sets nothing
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv(cache.ENV, raising=False)
            path = cache.enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


FORBIDDEN = [r"pallas\.tpu", r"pallas import tpu",
             r"default_backend\(\)\s*==\s*['\"]tpu['\"]", r"interpret\s*=",
             r"ATHENA_TPU_"]


def test_no_accelerator_specific_switches():
    """No Mosaic-TPU kernel, interpreter fallback, backend branch or
    environment switch in the package, the scripts, the tools or the
    tests."""
    files = (glob.glob(os.path.join(REPO, "atmospheric_athena_tpu", "**",
                                    "*.py"), recursive=True)
             + glob.glob(os.path.join(REPO, "tools", "*.py"))
             + glob.glob(os.path.join(REPO, "tests", "*.py"))
             + [os.path.join(REPO, f) for f in
                ("bench.py", "chip_smoke.py", "__graft_entry__.py")])
    files = [f for f in files if os.path.abspath(f) != __file__]
    assert len(files) > 50
    hits = []
    for f in files:
        with open(f) as fh:
            for ln, line in enumerate(fh, 1):
                for pat in FORBIDDEN:
                    if re.search(pat, line):
                        hits.append(f"{os.path.relpath(f, REPO)}:{ln}: "
                                    f"{line.strip()}")
    assert not hits, "\n".join(hits)
