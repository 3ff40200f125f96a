"""Pairwise merge of sorted runs, and the log-depth merge-tree reduction.

Re-design of the reference's merge phase:

- `merge_dpu.c` merges two sorted runs inside one DPU: tasklets slice run 1
  (merge_dpu.c:70-85), binary-search run 2 for the co-partition boundary
  (binary_search, merge_dpu.c:24-53), merge by compare-swap + re-insertion
  (:130-169), then a serialized shift pass rebuilds one contiguous run
  (:174-217).
- The host drives a binary reduction tree over DPUs (app.c:408-547): each
  round ships pairs of runs into fresh DPUs, launches merge_dpu, gathers,
  and halves the run count until one run per table remains.

Here the pairwise merge is ONE stable multi-operand sort of the
concatenated runs (run 1 first): stability alone realizes the reference's
tie rule (run-1 rows win ties, each run's inner order preserved) with no
cursor walk, no shift pass -- and no scatters.

Note the engine's *distributed* pipeline does not use a merge tree at all --
a single splitter-based all_to_all range exchange replaces the whole
log-depth reduction (exchange/, SURVEY.md section 5 "Long-context"), because
the tree's final round leaves one device holding the entire table (the
reference's known sequential bottleneck, app.c:531-540). This module exists
for the capability itself: incremental/streaming ingestion of pre-sorted
runs, and parity with merge_dpu.c / the app.c reduction driver.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from pim_sort_merge_join_tpu.columnar.table import Table


def merge_sorted(t1: Table, t2: Table, key: int) -> Table:
    """Merge two key-sorted tables into one sorted table.

    Both inputs must share a schema and be sorted ascending on column
    ``key`` (padding tails carry the +inf sentinel, see `ops/sort.py`).
    The output has capacity ``cap1 + cap2`` and ``num_rows = n1 + n2``;
    stable: ties keep run-1 rows first, preserving each run's inner order
    (the reference merge has the same property -- run 1 elements win ties,
    merge_dpu.c:130-169).
    """
    if t1.ncol != t2.ncol:
        raise ValueError(f"schema mismatch: {t1.ncol} vs {t2.ncol} columns")
    from pim_sort_merge_join_tpu.ops.sort import stable_key_sort

    # Stable sort of the concatenation, run 1 first: ties keep run-1 rows
    # ahead and each run's inner order intact (merge_dpu.c:130-169
    # semantics). Padding sentinels sort to the tail; run-1 padding lands
    # before run-2 padding, so valid rows stay a dense prefix.
    k = jnp.concatenate([t1.masked_keys(key), t2.masked_keys(key)])
    cols = tuple(
        jnp.concatenate([t1.data[:, c], t2.data[:, c]])
        for c in range(t1.ncol)
    )
    sorted_ops = stable_key_sort((k,) + cols, num_keys=1)
    return Table(
        data=jnp.stack(sorted_ops[1:], axis=1),
        num_rows=(t1.num_rows + t2.num_rows).astype(jnp.int32),
        names=t1.names,
    )


def merge_tree(tables: Sequence[Table], key: int) -> Table:
    """Log-depth pairwise reduction of N sorted runs into one sorted table.

    The host-driver analog of the reference's stage-3 loop (app.c:419-547):
    each round merges adjacent pairs and carries an odd leftover
    (app.c:505-520). Rounds are traced jointly, so XLA schedules the whole
    tree as one program -- there is no per-round device round-trip.
    """
    if not tables:
        raise ValueError("merge_tree needs at least one run")
    runs = list(tables)
    while len(runs) > 1:
        nxt = [
            merge_sorted(runs[i], runs[i + 1], key)
            for i in range(0, len(runs) - 1, 2)
        ]
        if len(runs) % 2:
            nxt.append(runs[-1])  # odd leftover carries to the next round
        runs = nxt
    return runs[0]
