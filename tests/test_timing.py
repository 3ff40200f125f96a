"""The chained-slope timing protocol (bench/timing.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from bench.timing import opaque_zero, readback_floor_ms, time_chained_ms


def test_opaque_zero_is_zero_for_nonnegative_carries():
    for v in (0, 1, 33101, 2**31 - 1):
        assert int(opaque_zero(jnp.int32(v))) == 0


def test_chained_slope_scales_with_work():
    # The protocol's whole claim is that the slope isolates per-iteration
    # device time: a body doing 8x the work must report ~8x the time.
    # Pin the RATIO (wide slack for CI noise), not just monotonicity --
    # a slope that measured dispatch overhead instead of work would be
    # nearly flat in W and fail the lower bound.
    x = jnp.asarray(
        np.random.default_rng(0).integers(0, 1 << 30, 1 << 18), jnp.int32
    )

    def make_body(w):
        def body(carry, arr):
            y = arr.at[0].add(opaque_zero(carry))
            for _ in range(w):
                # Multiplying by an odd constant permutes int32 values and
                # scrambles their order, so every sort gets unsorted input
                # (a sort of sorted data is cheaper: the work would not be 8x).
                y = jax.lax.sort(y * jnp.int32(-1640531535))
                # Re-perturb so the next sort cannot be folded away.
                y = y.at[0].add(opaque_zero(carry) + jnp.int32(1))
            return carry + y[0]

        return body

    t1 = time_chained_ms(make_body(1), x, k1=1, k2=5, reps=5)
    t8 = time_chained_ms(make_body(8), x, k1=1, k2=5, reps=5)
    assert t1 > 0 and t8 > 0
    ratio = t8 / t1
    assert 3.0 < ratio < 24.0, f"8x work timed at {ratio:.2f}x"


def test_readback_floor_nonnegative():
    assert readback_floor_ms(reps=3) >= 0
