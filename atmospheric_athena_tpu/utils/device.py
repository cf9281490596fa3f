"""The accelerator a measurement runs on.

Every number a benchmark or smoke test prints names its device, and a
measurement path that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return jax.devices()[0]; raise SystemExit when it is not a GPU."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"JAX found no GPU (platform {dev.platform!r}); "
                         "refusing to measure the CPU")
    return dev


def nvidia_smi() -> str:
    """The cards' names and power limits as nvidia-smi reports them, one
    line per card (a card below its maximum limit runs slower under
    load, so this goes beside every number)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def describe(dev) -> dict:
    """platform / device_kind / device count, as JAX reports them."""
    import jax
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
