"""Device profiling hooks.

The analog of the reference's profiling stack (SURVEY.md S10:
`bin/dpu-profiling` wrapping Linux perf, on-DPU perfcounters
`perfcounter.h:33-52`, Chrome-trace conversion): here a thin wrapper over
`jax.profiler` that captures a device trace viewable in TensorBoard or
Perfetto (the modern Chrome-trace); `bench/stage_trace.py` reduces such a
trace to per-scope device time.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (TensorBoard / Perfetto readable)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
