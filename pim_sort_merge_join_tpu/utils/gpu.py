"""The GPU a measurement runs on.

Measurement scripts (chip_smoke.py, bench.py) time the GPU and nothing else:
they refuse to fall back to the CPU, and they print the card's name and
power limit beside every number, because a card set below its maximum power
runs slower under load.
"""

from __future__ import annotations

import subprocess


def require_gpu(count: int = 1):
    """The first ``count`` JAX devices; exits unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"JAX found no GPU (default platform is {devs[0].platform!r}); "
            "this measurement runs only on GPUs"
        )
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs, JAX found {len(devs)}")
    return devs[:count]


def card_info() -> str:
    """Name and power limit of each card, one line per card (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()
