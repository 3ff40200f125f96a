"""The 1:1 join's slot scan (`ops/join._merged_dest_xla`) against a plain
per-run numpy statement of its algebra.

Input: both key vectors merged in (key, concat position) order. Within a run
of equal live keys, side-1 rows (position < cap1) come first; the k-th
side-1 row pairs the k-th side-2 row for k < min(count1, count2), and the
pair takes output slot (pairs in earlier runs) + k. Every other element,
and every sentinel key, gets the drop slot n.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar.table import key_sentinel
from pim_sort_merge_join_tpu.ops.join import _merged_dest_xla


def _reference_dest(mkeys: np.ndarray, mpos: np.ndarray, cap1: int, sent):
    n = mkeys.shape[0]
    dest = np.full(n, n, dtype=np.int64)
    slot = 0
    start = 0
    while start < n:
        end = start
        while end < n and mkeys[end] == mkeys[start]:
            end += 1
        if mkeys[start] != sent:
            side1 = [i for i in range(start, end) if mpos[i] < cap1]
            side2 = [i for i in range(start, end) if mpos[i] >= cap1]
            for k in range(min(len(side1), len(side2))):
                dest[side1[k]] = dest[side2[k]] = slot + k
            slot += min(len(side1), len(side2))
        start = end
    return dest, slot


def _merged(rng, n1, n2, pool, dtype, sentinel_frac):
    sent = np.asarray(key_sentinel(jnp.dtype(dtype)))
    k1 = rng.choice(pool, size=n1).astype(dtype)
    k2 = rng.choice(pool, size=n2).astype(dtype)
    k1[rng.random(n1) < sentinel_frac] = sent
    k2[rng.random(n2) < sentinel_frac] = sent
    keys = np.concatenate([k1, k2])
    pos = np.arange(n1 + n2, dtype=np.int32)
    order = np.lexsort((pos, keys))
    return keys[order], pos[order], sent


@pytest.mark.parametrize(
    "n1,n2,pool,dtype,sentinel_frac",
    [
        (700, 900, np.arange(1, 4000), np.int64, 0.1),     # mostly unique
        (700, 900, np.arange(1, 8), np.int64, 0.1),        # long duplicate runs
        (500, 500, np.array([-(2**40), -5, 0, 7, 2**40]), np.int64, 0.0),
        (512, 300, np.arange(1, 50), np.int32, 0.2),       # narrow keys
        (1, 1, np.array([3]), np.int32, 0.0),              # single pair
        (400, 200, np.arange(1, 30), np.int32, 1.0),       # every key dead
        (600, 400, np.array([42]), np.int64, 0.0),         # one run over all
        (300, 1, np.arange(1, 4), np.int64, 0.0),          # lopsided sides
    ],
)
def test_slot_scan_matches_run_algebra(rng, n1, n2, pool, dtype, sentinel_frac):
    mkeys, mpos, sent = _merged(rng, n1, n2, pool, dtype, sentinel_frac)
    want_dest, want_num = _reference_dest(mkeys, mpos, n1, sent)
    dest, num_out = _merged_dest_xla(jnp.asarray(mkeys), jnp.asarray(mpos), n1)
    np.testing.assert_array_equal(np.asarray(dest), want_dest)
    assert int(num_out) == want_num
