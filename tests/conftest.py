"""Test harness: run everything on a virtual 8-device CPU mesh.

The analog of the reference's functional-simulator backend
(`"backend=simulator"`, app.c:175; SURVEY.md section 4 item 2): N emulated
devices in one process so multi-chip sharding is exercised without hardware.
"""

import os

# Must be set before jax initializes. Unit tests run on the virtual CPU mesh
# by default; `SMJ_TEST_PLATFORM=cuda` keeps the GPU for the gpu-marked tests.
_PLATFORM = os.environ.get("SMJ_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# jax may already be imported (pytest plugins); the config update still works
# as long as no backend has been initialized yet.
jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none. Decided here, at
    run time, never while modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with SMJ_TEST_PLATFORM=cuda -m gpu)")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20241220)


def make_reference_like_tables(rng, nrow: int, ncol: int = 4, key_range=None):
    """Paired tables matching generate_data.py: col1 unique ints sampled
    without replacement from [1, 3N], other columns uniform in [1, 3N)."""
    hi = 3 * nrow if key_range is None else key_range
    out = []
    for _ in range(2):
        col1 = rng.choice(np.arange(1, hi + 1), size=nrow, replace=False)
        rest = rng.integers(1, hi, size=(nrow, ncol - 1))
        out.append(np.column_stack([col1, rest]).astype(np.int64))
    return out


@pytest.fixture
def small_tables(rng):
    return make_reference_like_tables(rng, 200)


@pytest.fixture
def dup_tables(rng):
    """Tables with heavy key duplication to exercise 1:1 vs inner semantics."""
    out = []
    for _ in range(2):
        keys = rng.integers(0, 20, size=300)
        rest = rng.integers(0, 1000, size=(300, 3))
        out.append(np.column_stack([keys, rest]).astype(np.int64))
    return out
