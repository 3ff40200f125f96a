"""Per-iteration device time by the serial-chain slope protocol.

Host clocks around one call include dispatch and the readback that ends it,
which swamp sub-millisecond steps. The protocol here cancels both:

1. Build ONE jitted program that runs the operation K times in a
   `lax.fori_loop` whose carry (an int32 accumulator folded into the next
   iteration's input) creates a true serial data dependency, so XLA cannot
   hoist the body out of the loop or overlap iterations.
2. Force a single scalar readback of the carry, timing the whole call.
3. Measure at two chain lengths K1 < K2 and report the slope
   ``(t(K2) - t(K1)) / (K2 - K1)`` -- dispatch and readback cancel out.

This is the analog of the reference's self-timed kernels: the UPMEM timer
brackets `dpu_launch(DPU_SYNCHRONOUS)` (timer.h:38-63, app.c:247).
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def opaque_zero(carry: jax.Array) -> jax.Array:
    """An int32 zero XLA cannot constant-fold.

    ``carry`` is a runtime accumulator of non-negative counts; comparing it
    to a negative sentinel yields 0 at runtime, but the compiler cannot
    prove it, so whatever consumes the result stays data-dependent on the
    previous iteration.
    """
    return jnp.where(carry == jnp.int32(-0x5EED), jnp.int32(1), jnp.int32(0))


def _timed_call(fn, reps: int) -> float:
    """Median wall ms of ``fn()`` (which must end in a host readback)."""
    fn()  # warm: compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times))


def time_chained_ms(
    body: Callable[..., jax.Array],
    *operands,
    k1: int = 2,
    k2: int = 10,
    reps: int = 5,
) -> float:
    """Per-iteration device ms of ``body`` via serial-chain slope.

    ``body(carry, *operands) -> carry`` must thread the int32 scalar carry
    through the measured computation (use `opaque_zero(carry)` to perturb an
    input and fold an output scalar back into the carry). Pass the arrays the
    body reads as ``operands`` rather than closing over them -- closed-over
    device arrays are embedded in the compiled program as constants, which
    bloats the executable. The returned time excludes dispatch latency and
    readback cost by construction.
    """

    def chained(k: int):
        looped = jax.jit(
            lambda c, *ops: jax.lax.fori_loop(
                0, k, lambda i, cc: body(cc, *ops), c
            )
        )

        def run():
            out = looped(jnp.int32(0), *operands)
            return int(out)  # scalar readback: waits for the whole chain

        return run

    t1 = _timed_call(chained(k1), reps)
    t2 = _timed_call(chained(k2), reps)
    return max((t2 - t1) / (k2 - k1), 0.0)


def readback_floor_ms(reps: int = 10) -> float:
    """Median ms of a trivial dispatch + scalar readback (the host floor)."""
    triv = jax.jit(lambda x: x + 1)

    def run():
        return int(triv(jnp.int32(0)))

    return _timed_call(run, reps)
