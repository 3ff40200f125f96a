"""Sort operator: order a table ascending by its join-key column.

Re-design of the reference sort stage: the DPU kernel runs an O(rows^2)
per-tasklet insertion sort directly on MRAM rows followed by a log2(16)-round
tasklet merge tree (sort_dpu.c:157-187, :251-323), and the host then merges
per-DPU runs pairwise in a log-depth DPU tree (app.c:408-547). Here a single
device sorts its whole partition in one O(n log n) vectorized pass with
`jax.lax.sort`, which XLA lowers to its own sort kernel or, for one key with
at most one payload, to a library radix sort. Cross-device merging is
replaced entirely by the range-exchange in `exchange/` (no merge tree: one
all_to_all round).

Padding rows carry a +inf key sentinel so they sort to the tail and stay
invalid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pim_sort_merge_join_tpu.columnar.table import Table


def sort_by_key(table: Table, key: int, *, narrow: bool = False) -> Table:
    """Sort valid rows ascending by column ``key``; stable on ties.

    Multi-operand sort: the row's columns ride the sort as payload operands
    instead of an argsort followed by a row gather.

    ``narrow`` (driver-resolved, see config.narrow_keys): sort 64-bit
    integer keys as a single int32 plane -- every valid key value must fit
    int32 (validated at ingest).
    """
    keys = table.masked_keys(key)
    if (
        narrow is True
        and jnp.issubdtype(keys.dtype, jnp.integer)
        and keys.dtype.itemsize == 8
    ):
        from pim_sort_merge_join_tpu.ops.join import _narrow32

        keys = _narrow32(keys)
    cols = tuple(table.data[:, c] for c in range(table.ncol))
    sorted_ops = jax.lax.sort((keys,) + cols, num_keys=1, is_stable=True)
    return table.replace(data=jnp.stack(sorted_ops[1:], axis=1))


def stable_key_sort(
    operands: tuple[jax.Array, ...],
    *,
    num_keys: int = 1,
    unique_keys: bool = False,
) -> tuple[jax.Array, ...]:
    """Stable multi-operand sort by ``operands[:num_keys]``.

    Semantics equal ``jax.lax.sort(operands, num_keys=num_keys,
    is_stable=True)``. ``unique_keys=True`` asserts the joint key tuple is
    unique, so stability is vacuous and the sort may drop its tie-break
    machinery (the join's four internal sorts all qualify).
    """
    return jax.lax.sort(operands, num_keys=num_keys, is_stable=not unique_keys)
