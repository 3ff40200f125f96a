"""The sort contract of `ops/sort.py` on `jax.lax.sort`.

`stable_key_sort` must equal a stable sort on its key operands (ties keep
input order) for every engine dtype and shape, and `sort_by_key` must order
a padded table's valid rows with the sentinel padding at the tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar.table import Table, key_sentinel
from pim_sort_merge_join_tpu.ops import oracle
from pim_sort_merge_join_tpu.ops.sort import sort_by_key, stable_key_sort

DTYPE_KEYS = {
    "int32": lambda rng, n: rng.integers(-5, 5, n).astype(np.int32),
    "int64": lambda rng, n: (rng.integers(-5, 5, n) * (1 << 40)).astype(np.int64),
    "uint64": lambda rng, n: (np.uint64(1 << 63) + rng.integers(0, 9, n).astype(np.uint64)),
    "float64": lambda rng, n: rng.integers(-4, 4, n) * 0.75 + np.where(
        rng.random(n) < 0.05, np.inf, 0.0
    ),
}


@pytest.mark.parametrize("n", [1, 1001, 2048])
@pytest.mark.parametrize("dtype", sorted(DTYPE_KEYS))
def test_ties_stay_stable(rng, dtype, n):
    keys = DTYPE_KEYS[dtype](rng, n)
    pay = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    got_k, got_i, got_p = stable_key_sort(
        (jnp.asarray(keys), jnp.arange(n, dtype=jnp.int32), jnp.asarray(pay))
    )
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(got_k), keys[order])
    np.testing.assert_array_equal(np.asarray(got_i), order)
    np.testing.assert_array_equal(np.asarray(got_p), pay[order])


def test_num_keys_two_orders_by_both(rng):
    n = 2048
    k1 = rng.integers(0, 9, n).astype(np.int32)
    k2 = rng.permutation(n).astype(np.int32)
    pay = rng.integers(0, 10**12, n).astype(np.int64)
    got = stable_key_sort(
        (jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(pay)), num_keys=2
    )
    order = np.lexsort((k2, k1))
    for g, w in zip(got, (k1, k2, pay)):
        np.testing.assert_array_equal(np.asarray(g), w[order])


def test_unique_keys_permutation(rng):
    n = 4099
    perm = rng.permutation(n).astype(np.int32)
    pay = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    got_k, got_p = stable_key_sort(
        (jnp.asarray(perm), jnp.asarray(pay)), unique_keys=True
    )
    np.testing.assert_array_equal(np.asarray(got_k), np.arange(n))
    np.testing.assert_array_equal(np.asarray(got_p), pay[np.argsort(perm)])


def test_unique_pair_keys_with_sentinel_runs(rng):
    # The join's merge-sort shape: duplicate primary keys, including runs of
    # the int32 sentinel, made unique by the concat position as second key.
    # Must equal the stable one-key sort.
    n = 2048
    keys = rng.integers(0, 50, n).astype(np.int32)
    keys[rng.choice(n, 200, replace=False)] = np.iinfo(np.int32).max
    pos = np.arange(n, dtype=np.int32)
    got_k, got_p = stable_key_sort(
        (jnp.asarray(keys), jnp.asarray(pos)), num_keys=2, unique_keys=True
    )
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(got_k), keys[order])
    np.testing.assert_array_equal(np.asarray(got_p), order)


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64"])
def test_sort_by_key_padded_table(rng, dtype):
    n, cap = 1000, 1024
    rows = rng.integers(0, 300, size=(n, 4)).astype(dtype)
    t = Table.from_numpy(rows, capacity=cap, dtype=dtype)
    # Garbage in the padding must not leak into the valid prefix.
    t = t.replace(data=t.data.at[n:].set(np.asarray(1, dtype)))
    s = sort_by_key(t, 0)
    np.testing.assert_array_equal(s.to_numpy(), oracle.sort_oracle(rows, 0))
    assert int(s.num_rows) == n
    tail_keys = np.asarray(s.masked_keys(0))[n:]
    assert (tail_keys == np.asarray(key_sentinel(dtype))).all()


def test_sort_by_key_narrow_param(rng):
    rows = np.column_stack(
        [rng.integers(-500, 500, 300), rng.integers(0, 99, (300, 3))]
    ).astype(np.int64)
    t = Table.from_numpy(rows, capacity=384)
    wide = sort_by_key(t, 0).to_numpy()
    narrow = sort_by_key(t, 0, narrow=True).to_numpy()
    np.testing.assert_array_equal(narrow, wide)
    np.testing.assert_array_equal(wide, oracle.sort_oracle(rows, 0))
