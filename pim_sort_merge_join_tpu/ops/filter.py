"""Vectorized selection (filter) operator.

Re-design of the reference SELECT kernel (select.c): where the DPU kernel
scans 256-byte MRAM chunks per tasklet, computes an exclusive prefix count
through a serial tasklet handshake chain (select.c:42-61) and compacts rows
in place, this operator evaluates the predicate over the whole column vector
and compacts with one stable sort on the inverted mask -- the same
count-then-place result, expressed as data parallelism XLA fuses.

The reference's only predicate form is strictly-greater-than on one column
(select.c:31); we support the full comparison set (config.PredicateOp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.config import Predicate

_OPS = {
    ">": jnp.greater,
    ">=": jnp.greater_equal,
    "<": jnp.less,
    "<=": jnp.less_equal,
    "==": jnp.equal,
    "!=": jnp.not_equal,
}


def predicate_mask(table: Table, pred: Predicate) -> jax.Array:
    """Boolean mask of valid rows satisfying the predicate."""
    value = jnp.asarray(pred.value, dtype=table.dtype)
    return table.valid_mask() & _OPS[pred.op](table.column(pred.col), value)


def compact(table: Table, mask: jax.Array) -> Table:
    """Stable-compact masked rows to the front; returns same-capacity table.

    Parallel equivalent of the reference's handshake prefix-count + dense
    write-back (select.c:149-156), realized as ONE stable multi-operand
    sort keyed on the inverted mask: selected rows float to the front in
    original order, with the row's columns riding the sort as operands.
    """
    count = jnp.sum(mask, dtype=jnp.int32)
    inv = (~mask).astype(jnp.int8)
    cols = tuple(table.data[:, c] for c in range(table.ncol))
    sorted_ops = jax.lax.sort((inv,) + cols, num_keys=1, is_stable=True)
    new_data = jnp.stack(sorted_ops[1:], axis=1)
    return table.replace(data=new_data, num_rows=count)


def apply_filter(table: Table, pred: Predicate) -> Table:
    """SELECT rows satisfying ``pred``; compacted, row order preserved."""
    return compact(table, predicate_mask(table, pred))
