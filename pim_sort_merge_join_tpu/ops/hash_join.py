"""Hash join and hash aggregate (the comparison path to sort-merge).

BASELINE.json asks for a hash-join and hash-aggregate path alongside the
sort-merge pipeline. Instead of a pointer-chasing hash table, "hash"
semantics are realized as *bijective-hash ordering*:

  - `mix64`/`mix32` are finalizer-style avalanche permutations (bijections)
    on the key space, so hash equality IS key equality -- no collision
    chains, no verification pass.
  - `hash_join` sorts both sides by the hashed key and merge-matches in hash
    space: the data-dependent key distribution becomes uniform, which is
    exactly what a hash table buys, with sorts and scans instead of random
    probes. Output rows are restored to
    probe-side (table 1) row order -- the streaming-hash-join order -- so
    results are deterministic and independent of hash values.
  - `hash_aggregate` groups by hashed key with segment reductions and emits
    (key, aggregate) pairs sorted by key.

Equality semantics options mirror `ops/join.py` (`one_to_one` preserves the
reference's cursor-advance pairing by matching the k-th duplicate in table-1
ROW order with the k-th duplicate in table-2 row order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pim_sort_merge_join_tpu.columnar.table import Table

_M32_1 = jnp.uint32(0x85EBCA6B)
_M32_2 = jnp.uint32(0xC2B2AE35)
_M64_1 = 0xBF58476D1CE4E5B9
_M64_2 = 0x94D049BB133111EB


def mix32(x: jax.Array) -> jax.Array:
    """Murmur3 finalizer: a bijection on uint32."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _M32_1
    x = x ^ (x >> 13)
    x = x * _M32_2
    x = x ^ (x >> 16)
    return x


def mix64(x: jax.Array) -> jax.Array:
    """splitmix64 finalizer: a bijection on uint64."""
    x = x.astype(jnp.uint64)
    x = x ^ (x >> 30)
    x = x * jnp.uint64(_M64_1)
    x = x ^ (x >> 27)
    x = x * jnp.uint64(_M64_2)
    x = x ^ (x >> 31)
    return x


def _float_order_bits(keys: jax.Array) -> jax.Array:
    """Order-preserving bijection float -> unsigned int of the same width.

    A plain value cast (`x.astype(uint64)`) truncates: distinct floats 1.2
    and 1.5 would collide. Instead reinterpret the IEEE-754 bits and apply
    the standard total-order map -- negative values get all bits flipped,
    non-negative values get the sign bit set -- so distinct floats map to
    distinct ints and float order is preserved. -0.0 is normalized to +0.0
    first so the two zero encodings hash equal (they compare equal as keys).
    """
    keys = jnp.where(keys == 0, jnp.zeros_like(keys), keys)
    if keys.dtype.itemsize <= 4:
        bits = jax.lax.bitcast_convert_type(keys, jnp.int32)
        flipped = jnp.where(
            bits < 0, ~bits, bits | jnp.int32(-(2**31))
        )
        return jax.lax.bitcast_convert_type(flipped, jnp.uint32)
    u = jax.lax.bitcast_convert_type(keys, jnp.uint64)
    sign = jnp.uint64(1) << 63
    return jnp.where((u & sign) != 0, ~u, u | sign)


def hash_column(keys: jax.Array) -> jax.Array:
    """Bijective hash of a key column, ordered-comparable (unsigned).

    Float keys are bit-cast through an order-preserving map first (a value
    cast would make distinct floats hash equal).
    """
    if jnp.issubdtype(keys.dtype, jnp.floating):
        keys = _float_order_bits(keys)
    if keys.dtype.itemsize <= 4:
        return mix32(keys)
    return mix64(keys)


def _hashed_keys(table: Table, key: int) -> jax.Array:
    """Hashed keys with padding forced to the max unsigned sentinel."""
    h = hash_column(table.column(key))
    sentinel = jnp.array(jnp.iinfo(h.dtype).max, dtype=h.dtype)
    return jnp.where(table.valid_mask(), h, sentinel)


def hash_join(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    *,
    mode: str = "one_to_one",
    out_capacity: int | None = None,
) -> Table:
    """Join on hashed-key ordering; output in table-1 row order.

    Note: a valid key hashing exactly to the sentinel (2^32-1 / 2^64-1)
    would be treated as padding; the mix functions map 0x40ebfa9c / a single
    64-bit preimage there -- vanishingly unlikely and excluded by the
    non-negative key contract of the reference generator.
    """
    from pim_sort_merge_join_tpu.ops import join as join_ops

    cap1 = t1.capacity

    if mode == "one_to_one":
        # Merged-domain realization: the hashed key
        # vectors feed the SAME zero-gather core as the sort-merge join --
        # `_one_to_one_merged` never needed sorted inputs, and its stable
        # merge pairs the k-th duplicate in table ROW order on each side,
        # which is exactly the streaming-hash-join pairing. This replaces
        # the former two `searchsorted(method='sort')` calls (each paying
        # hidden rank-by-merge sorts) and `_emit`'s random row gathers. The core emits in HASH order; a final permutation
        # sort keyed on a hidden original-row-index column restores
        # streaming (table-1 row) order.
        h1 = _hashed_keys(t1, key1)
        h2 = _hashed_keys(t2, key2)
        # The row-restore index rides as a table-dtype column; for inexact
        # dtypes it must stay exactly representable (float32 mantissa holds
        # integers only up to 2**24) or the restore sort silently scrambles
        # row order (advisor r4). int64/float64 are always safe here.
        if jnp.issubdtype(t1.dtype, jnp.inexact):
            mant = jnp.finfo(t1.dtype).nmant + 1
            if cap1 > (1 << mant):
                raise ValueError(
                    f"hash_join one_to_one: capacity {cap1} exceeds the "
                    f"exact-integer range 2**{mant} of table dtype "
                    f"{jnp.dtype(t1.dtype).name}; use a wider dtype or "
                    "join_algorithm='sort_merge'"
                )
        iota1 = jnp.arange(cap1, dtype=jnp.int32)
        t1aug = t1.replace(
            data=jnp.concatenate(
                [t1.data, iota1.astype(t1.dtype)[:, None]], axis=1
            )
        )
        joined = join_ops._one_to_one_merged(t1aug, t2, key2, h1, h2)
        # joined columns: t1 cols, ord1 (at index t1.ncol), t2 cols - key.
        ncol_out = t1.ncol + t2.ncol - 1
        ordc = t1.ncol
        num_out = joined.num_rows
        big = jnp.asarray(cap1, joined.dtype)
        restore_key = jnp.where(
            jnp.arange(joined.capacity, dtype=jnp.int32) < num_out,
            joined.data[:, ordc],
            big,
        ).astype(jnp.int32)
        keep = [c for c in range(joined.ncol) if c != ordc]
        # Matched rows carry distinct ord1 values; dropped rows get unique
        # keys big + i so both backends skip their tie-break plane.
        restore_u = jnp.where(
            restore_key >= jnp.int32(cap1),
            jnp.int32(cap1) + jnp.arange(joined.capacity, dtype=jnp.int32),
            restore_key,
        )
        from pim_sort_merge_join_tpu.ops.sort import stable_key_sort

        ops = stable_key_sort(
            (restore_u,) + tuple(joined.data[:, c] for c in keep),
            unique_keys=True,
        )
        data = jnp.stack(ops[1:], axis=1)
        valid_out = jnp.arange(joined.capacity, dtype=jnp.int32) < num_out
        data = jnp.where(valid_out[:, None], data, jnp.zeros_like(data))
        return Table(
            data=data,
            num_rows=num_out,
            names=tuple(f"col{i + 1}" for i in range(ncol_out)),
        )

    if mode == "inner":
        # Sort both sides by hash (stable: row order preserved within
        # equal-hash runs), then reuse the merged-domain match info and the
        # scatter+cummax slot lookup -- no `searchsorted(method='sort')`.
        h1 = _hashed_keys(t1, key1)
        h2 = _hashed_keys(t2, key2)
        iota1 = jnp.arange(cap1, dtype=jnp.int32)
        sorted1 = jax.lax.sort(
            (h1, iota1) + tuple(t1.data[:, c] for c in range(t1.ncol)),
            num_keys=1, is_stable=True,
        )
        sh1, ord1 = sorted1[0], sorted1[1]
        s1 = t1.replace(data=jnp.stack(sorted1[2:], axis=1))
        sorted2 = jax.lax.sort(
            (h2,) + tuple(t2.data[:, c] for c in range(t2.ncol)),
            num_keys=1, is_stable=True,
        )
        sh2 = sorted2[0]
        s2 = t2.replace(data=jnp.stack(sorted2[1:], axis=1))

        info = join_ops._match_info_keys(sh1, sh2)
        valid1 = s1.valid_mask()
        out_cap = cap1 if out_capacity is None else out_capacity
        cnt = jnp.where(valid1, info.cnt2, 0)
        # Order output by original t1 row: per-original-row counts.
        inv1 = jnp.zeros((cap1,), dtype=jnp.int32).at[ord1].set(
            jnp.arange(cap1, dtype=jnp.int32)
        )
        cnt_orig = jnp.take(cnt, inv1)  # per original t1 row
        starts = jnp.cumsum(cnt_orig, dtype=jnp.int32) - cnt_orig
        total = jnp.sum(cnt_orig, dtype=jnp.int32)
        j = jnp.arange(out_cap, dtype=jnp.int32)
        # Which original t1 row does output slot j belong to? Scatter each
        # contributing row's (row, start) at slot start and prefix-max --
        # the same formulation as ops/join.merge_join_inner, replacing the
        # former searchsorted(starts, j, method='sort').
        has = cnt_orig > 0
        io1 = jnp.arange(cap1, dtype=jnp.int32)
        slot = jnp.where(has, starts, out_cap)
        row_orig = jax.lax.cummax(
            jnp.zeros((out_cap,), jnp.int32)
            .at[slot]
            .max(jnp.where(has, io1, 0), mode="drop")
        )
        start_of = jax.lax.cummax(
            jnp.zeros((out_cap,), jnp.int32)
            .at[slot]
            .max(jnp.where(has, starts, 0), mode="drop")
        )
        offset = j - start_of
        pos_hash = jnp.take(inv1, row_orig)
        src2 = jnp.take(info.lo2, pos_hash) + offset
        valid_out = j < jnp.minimum(total, out_cap)
        return join_ops._emit(s1, s2, key2, pos_hash, src2, valid_out, total)
    raise ValueError(f"unknown join mode {mode!r}")


_AGGS = ("sum", "count", "min", "max")


def hash_aggregate(
    table: Table, key: int, value: int, agg: str = "sum"
) -> Table:
    """Group rows by key column; aggregate the value column.

    Returns a 2-column table (key, aggregate) sorted ascending by key, with
    one row per distinct key.
    """
    if agg not in _AGGS:
        raise ValueError(f"agg must be one of {_AGGS}, got {agg!r}")
    cap = table.capacity
    dtype = table.dtype
    # Group in hash order (uniform buckets), emit in key order.
    h = _hashed_keys(table, key)
    sh, sk, sv, validi = jax.lax.sort(
        (
            h,
            table.column(key),
            table.column(value),
            table.valid_mask().astype(jnp.int8),
        ),
        num_keys=1,
        is_stable=True,
    )
    valid = validi.astype(jnp.bool_)

    head = valid & jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), sh[1:] != sh[:-1]]
    )
    gid = jnp.cumsum(head, dtype=jnp.int32) - 1  # group id per row
    num_groups = jnp.sum(head, dtype=jnp.int32)
    gid = jnp.where(valid, gid, cap)  # padding drops out of scatters

    if jnp.issubdtype(jnp.dtype(dtype), jnp.floating):
        lo, hi = jnp.finfo(dtype).min, jnp.finfo(dtype).max
    else:
        lo, hi = jnp.iinfo(dtype).min, jnp.iinfo(dtype).max
    if agg == "sum":
        out_v = jnp.zeros((cap,), dtype).at[gid].add(sv, mode="drop")
    elif agg == "count":
        out_v = jnp.zeros((cap,), dtype).at[gid].add(1, mode="drop")
    elif agg == "min":
        out_v = jnp.full((cap,), hi, dtype).at[gid].min(sv, mode="drop")
    else:  # max
        out_v = jnp.full((cap,), lo, dtype).at[gid].max(sv, mode="drop")
    out_k = jnp.zeros((cap,), dtype).at[gid].set(sk, mode="drop")

    # Emit sorted by key: groups currently in hash order.
    gvalid = jnp.arange(cap, dtype=jnp.int32) < num_groups
    sort_keys = jnp.where(gvalid, out_k, hi)
    _, final_k, final_v = jax.lax.sort(
        (sort_keys, out_k, out_v), num_keys=1, is_stable=True
    )
    data = jnp.stack([final_k, final_v], axis=1)
    data = jnp.where(gvalid[:, None], data, jnp.zeros_like(data))
    return Table(data=data, num_rows=num_groups, names=("key", agg))
