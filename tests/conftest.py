"""Test configuration: CPU backend with 8 virtual devices + float64.

Sharding tests exercise a virtual 8-device mesh on CPU
(xla_force_host_platform_device_count); numerics tests run in f64 to compare
tightly against the double-precision reference.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# jax may already have been imported with another platform selected; the
# config update still takes effect as long as no backend is initialized
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# persistent compilation cache: first compile of the big CTU graphs is ~30s,
# cached compiles are near-instant across test processes
from atmospheric_athena_tpu.utils import cache  # noqa: E402

cache.enable_compile_cache()
