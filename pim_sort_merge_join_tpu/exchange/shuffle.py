"""The all_to_all row exchange (runs inside shard_map).

The replacement for the reference's host-mediated data movement (SURVEY.md
section 2d): where every inter-DPU byte bounces through host DRAM via
`dpu_push_xfer` gathers, host memcpy regroup and re-scatter (app.c:272-288,
425-501), this module moves rows device-to-device (NVLink between the GPUs
of a host) with a single `lax.all_to_all` inside `shard_map` -- no host on
the path.

Variable per-destination row counts (the "dynamic shapes" hard part,
SURVEY.md section 7) are handled with fixed-capacity buckets: each shard
packs its rows into P buckets of C rows, exchanges the [P, C] block plus the
true per-bucket counts, then compacts the received rows. Overflowing a bucket
cannot corrupt data -- overflow rows are dropped deterministically and the
true counts travel with the data, so the caller can detect the overflow
(received count > capacity) and fail loudly or re-run with more slack.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ExchangeResult(NamedTuple):
    data: jax.Array        # [recv_capacity, ncol] compacted received rows
    num_rows: jax.Array    # int32: rows actually materialized (post-drop)
    true_rows: jax.Array   # int32: rows that SHOULD have arrived (overflow if >)


def all_to_all_exchange(
    data: jax.Array,
    dest: jax.Array,
    axis_name: str,
    *,
    bucket_capacity: int,
    recv_capacity: int | None = None,
    num_chunks: int = 1,
) -> ExchangeResult:
    """Route rows of ``data`` to the shard named by ``dest`` over ``axis_name``.

    Must be called inside ``shard_map`` over a mesh axis of size P.

    Args:
      data: [cap, ncol] local rows (padding rows allowed).
      dest: [cap] int32 destination shard per row; values >= P mark rows to
        drop (invalid/padding rows).
      axis_name: mesh axis to exchange over.
      bucket_capacity: C, max rows this shard may send to any one shard.
      recv_capacity: capacity of the compacted receive buffer (default P*C).
      num_chunks: split the row payload into this many independent
        all_to_all collectives over bucket sub-ranges. The result is
        bit-identical for any value; >1 gives XLA's latency-hiding
        scheduler finer units to overlap with independent compute (the
        other table's local sort in the fused pipeline region) -- the
        replacement for the reference's DPU_XFER_ASYNC + dpu_callback overlap (dpu.h:72-82, :651; SURVEY.md section 7
        "double-buffered chunked all_to_all").

    Rows keep a deterministic global order: received rows are ordered by
    (source shard, source local order), which downstream stable sorts
    preserve into reproducible, run-invariant output.
    """
    num_partitions = jax.lax.axis_size(axis_name)
    cap, ncol = data.shape
    c = bucket_capacity
    recv_cap = num_partitions * c if recv_capacity is None else recv_capacity

    # --- pack rows into per-destination buckets ---------------------------
    # Stable multi-operand sort by destination groups rows while preserving
    # local order (rows ride the sort network; no random gather).
    sorted_ops = jax.lax.sort(
        (dest.astype(jnp.int32),) + tuple(data[:, c] for c in range(ncol)),
        num_keys=1,
        is_stable=True,
    )
    sorted_dest = sorted_ops[0]
    sorted_rows = jnp.stack(sorted_ops[1:], axis=1)

    # Per-destination counts from run boundaries in the sorted dest vector.
    boundaries = jnp.searchsorted(
        sorted_dest, jnp.arange(num_partitions + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    counts = boundaries[1:] - boundaries[:-1]
    starts = boundaries[:-1]  # exclusive prefix, [P]
    safe_dest = jnp.minimum(sorted_dest, num_partitions - 1)
    offset = jnp.arange(cap, dtype=jnp.int32) - jnp.take(starts, safe_dest)
    slot = safe_dest * c + offset
    in_range = (sorted_dest < num_partitions) & (offset < c)
    slot = jnp.where(in_range, slot, num_partitions * c)
    buckets = jnp.zeros((num_partitions * c, ncol), dtype=data.dtype)
    buckets = buckets.at[slot, :].set(sorted_rows, mode="drop")

    # --- the exchange -----------------------------------------------------
    # Block j of our buckets goes to shard j; received block i sits at
    # position i, so arrival order is source-shard order. With
    # num_chunks > 1 the payload moves as several independent collectives
    # over row sub-ranges of every bucket; recombining along axis 1
    # restores the exact single-collective layout.
    blocks = buckets.reshape(num_partitions, c, ncol)
    k = max(min(num_chunks, c), 1)
    if c % k != 0:
        k = 1  # uneven split: fall back to one collective
    if k == 1:
        recv = jax.lax.all_to_all(
            blocks, axis_name, split_axis=0, concat_axis=0, tiled=False
        ).reshape(num_partitions * c, ncol)
    else:
        step = c // k
        parts = [
            jax.lax.all_to_all(
                blocks[:, i * step : (i + 1) * step, :],
                axis_name,
                split_axis=0,
                concat_axis=0,
                tiled=False,
            )
            for i in range(k)
        ]
        recv = jnp.concatenate(parts, axis=1).reshape(
            num_partitions * c, ncol
        )
    sent_counts = jnp.minimum(counts, c)  # what actually fit
    recv_counts = jax.lax.all_to_all(
        sent_counts.reshape(num_partitions, 1), axis_name, 0, 0
    ).reshape(num_partitions)
    recv_true = jax.lax.all_to_all(
        counts.reshape(num_partitions, 1), axis_name, 0, 0
    ).reshape(num_partitions)

    # --- compact received rows -------------------------------------------
    flat_idx = jnp.arange(num_partitions * c, dtype=jnp.int32)
    chunk = flat_idx // c
    off = flat_idx % c
    valid = off < jnp.take(recv_counts, chunk)
    num_rows = jnp.sum(valid, dtype=jnp.int32)
    pos = jnp.where(valid, jnp.cumsum(valid, dtype=jnp.int32) - 1, recv_cap)
    out = jnp.zeros((recv_cap, ncol), dtype=data.dtype)
    out = out.at[pos, :].set(recv, mode="drop")
    return ExchangeResult(
        data=out,
        num_rows=jnp.minimum(num_rows, recv_cap),
        true_rows=jnp.sum(recv_true, dtype=jnp.int32),
    )
