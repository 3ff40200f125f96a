"""CPU "simulator" backend: the engine without a GPU.

The analog of the reference's functional-simulator backend
(`libdpufsim.so`, selected by the `"backend=simulator"` profile string at
app.c:175 / `UPMEM_PROFILE_BASE`, upmem_env.sh:15-20; SURVEY.md S3): the
same engine code runs on N virtual CPU devices in one process, so
multi-device behavior -- sharding, all_to_all exchange, SPMD join -- is
fully exercised on a machine with no accelerator.

Must be called before JAX initializes a backend (i.e. before the first
jax array/computation); raises otherwise.
"""

from __future__ import annotations

import os


def use_simulator(num_devices: int = 8) -> None:
    """Force the CPU platform with ``num_devices`` virtual devices."""
    import jax

    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", num_devices)
    except RuntimeError as e:
        raise RuntimeError(
            "use_simulator() must run before JAX initializes a backend; "
            "call it first thing in the process"
        ) from e


def simulator_active() -> bool:
    import jax

    return jax.default_backend() == "cpu"
