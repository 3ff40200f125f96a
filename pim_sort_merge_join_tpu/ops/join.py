"""Sorted merge-join operators.

Re-design of the reference JOIN kernel (join.c): the DPU kernel slices
run 1 across tasklets, binary-searches run 2 for co-partition boundaries
(join.c:99-118), then does two passes -- count matches (join.c:151-179),
prefix offsets (:184-191), emit concatenated rows (:205-248). This module
keeps that count-then-emit structure but expresses both passes as
whole-vector sorts and scans (1:1) or prefix sums plus gathers (inner); the
per-tasklet cursor walk disappears.

Two equality semantics:

- ``one_to_one`` -- the reference's semantics (join.c:160-173,
  cpu_app.c:213-217): on equal keys both cursors advance once, so the k-th
  duplicate of a key in table 1 pairs with the k-th duplicate in table 2 and
  a key with a copies left / b copies right yields min(a, b) rows, not a*b.
  Vectorized as occurrence-rank matching: row i of table 1 with occurrence
  rank r (its index within its equal-key run) matches iff r < (count of the
  key in table 2), partnering row ``lower_bound2 + r``.
- ``inner`` -- standard SQL inner-join cross product on duplicates.

Output schema: table1 columns ++ table2 columns minus its key column
(join.c:212-231); output rows follow table-1 key order.

Both tables must already be sorted ascending on their keys, with +inf
sentinel padding (see `ops/sort.py`). Keys equal to the sentinel value
(int64 max / +inf) in *valid* rows are not supported.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from pim_sort_merge_join_tpu.columnar.table import Table, key_sentinel


def _out_names(t1: Table, t2: Table, key2: int) -> tuple:
    ncol = t1.ncol + t2.ncol - 1
    return tuple(f"col{i + 1}" for i in range(ncol))


def _emit(
    t1: Table,
    t2: Table,
    key2: int,
    src1: jax.Array,
    src2: jax.Array,
    valid_out: jax.Array,
    num_out: jax.Array,
) -> Table:
    """Gather matched row pairs into the concatenated output table.

    ``src1[j]``/``src2[j]`` give the table-1/table-2 row feeding output row
    ``j``; ``valid_out`` masks live output slots (already front-compacted).
    """
    safe1 = jnp.where(valid_out, src1, 0)
    safe2 = jnp.where(valid_out, src2, 0)
    part1 = jnp.take(t1.data, safe1, axis=0)
    keep2 = [c for c in range(t2.ncol) if c != key2]
    part2 = jnp.take(t2.data[:, jnp.asarray(keep2)], safe2, axis=0)
    data = jnp.concatenate([part1, part2], axis=1)
    data = jnp.where(valid_out[:, None], data, jnp.zeros_like(data))
    return Table(
        data=data,
        num_rows=num_out.astype(jnp.int32),
        names=_out_names(t1, t2, key2),
    )


class _MatchInfo(NamedTuple):
    lo2: jax.Array  # lower bound of t1 key in t2 keys, per t1 row
    cnt2: jax.Array  # multiplicity of t1 key in t2, per t1 row
    occ: jax.Array  # occurrence rank of t1 row within its equal-key run


def _run_starts(keys: jax.Array) -> jax.Array:
    """For sorted ``keys``: index of the first element of each equal run.

    O(n) head-flag + running max -- replaces a self-searchsorted, which at
    16M int64 elements costs seconds in scan mode.
    """
    n = keys.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), keys[1:] != keys[:-1]]
    )
    return jax.lax.cummax(jnp.where(head, iota, 0))


def _match_info(t1: Table, t2: Table, key1: int, key2: int) -> _MatchInfo:
    """Per-t1-row (lo2, cnt2, occ) via the merged key domain."""
    return _match_info_keys(t1.masked_keys(key1), t2.masked_keys(key2))


def _match_info_keys(k1: jax.Array, k2: jax.Array) -> _MatchInfo:
    """Per-k1-element (lo2, cnt2, occ) from pre-masked key vectors.

    Replaces `jnp.searchsorted(..., method='sort')` -- which internally
    pays TWO rank-by-merge sorts plus gathers -- with one explicit merge
    sort, forward run algebra (see `_one_to_one_merged`), and one
    un-merge sort: ~3x less sort work for the same quantities. Also the
    match core of the hash join (hash-space key vectors).
    """
    cap1, cap2 = k1.shape[0], k2.shape[0]
    n = cap1 + cap2
    keys = jnp.concatenate([k1, k2])
    pos = jnp.arange(n, dtype=jnp.int32)
    mkeys, mpos = jax.lax.sort((keys, pos), num_keys=2)
    is2 = (mpos >= cap1).astype(jnp.int32)
    head = jnp.concatenate([jnp.ones((1,), jnp.bool_), mkeys[1:] != mkeys[:-1]])
    tail = jnp.concatenate([mkeys[1:] != mkeys[:-1], jnp.ones((1,), jnp.bool_)])
    iota = jnp.arange(n, dtype=jnp.int32)
    c2 = jnp.cumsum(is2, dtype=jnp.int32)
    run_start = _head_broadcast(head, iota)
    base2 = _head_broadcast(head, c2 - is2)
    end2 = jax.lax.cummin(jnp.where(tail, c2, n), reverse=True)
    live = mkeys != key_sentinel(mkeys.dtype)
    # Per side-1 element: its key's run in k2 starts at the count of
    # side-2 before my run (base2) and has end2 - base2 members; a side-1
    # element's in-run index is its side rank (side-1 precede side-2).
    lo2_m = base2
    cnt2_m = jnp.where(live, end2 - base2, 0)
    occ_m = iota - run_start
    _, lo2, cnt2, occ = jax.lax.sort(
        (mpos, lo2_m, cnt2_m, occ_m), num_keys=1
    )
    return _MatchInfo(lo2=lo2[:cap1], cnt2=cnt2[:cap1], occ=occ[:cap1])


def _head_broadcast(head: jax.Array, vals: jax.Array) -> jax.Array:
    """Broadcast each run head's value over its run.

    ``vals`` must be globally NON-DECREASING (true for every prefix count
    used here), which makes a plain running max correct -- no segmented
    scan needed.
    """
    return jax.lax.cummax(jnp.where(head, vals, 0))


def _narrow32(k: jax.Array) -> jax.Array:
    """Map 64-bit integer keys whose values fit int32 onto int32.

    SURVEY.md §7's "pack key when key width permits": the merge sort's key
    operand shrinks from 8 to 4 bytes, cutting that sort's HBM traffic by a
    third. Order-preserving by construction -- the caller guarantees every
    valid key lies in [INT32_MIN, INT32_MAX) (validated host-side,
    utils/validate.check_narrow_keys) -- and the 64-bit sentinel remaps to
    the 32-bit one, which no valid key can collide with.
    """
    sent64 = key_sentinel(k.dtype)
    sent32 = jnp.iinfo(jnp.int32).max
    return jnp.where(k == sent64, jnp.asarray(sent32, k.dtype), k).astype(
        jnp.int32
    )


def _merged_dest_xla(mkeys, mpos, cap1: int):
    """Output slot per merged element, as XLA scan ops.

    The algebra: within an equal-key run, every side-1 (t1) element
    precedes every side-2 element (ties sort by concat position), so
    side-2 matches and the witness prefix are forward scans; only the
    side-1 match test needs one backward broadcast (its run's side-2
    total lies ahead of it). 1:1 semantics per join.c:160-173: the k-th
    t1 duplicate pairs the k-th t2 duplicate; a run yields
    min(cnt1, cnt2) rows.
    """
    n = mkeys.shape[0]
    is2 = (mpos >= cap1).astype(jnp.int32)
    head = jnp.concatenate([jnp.ones((1,), jnp.bool_), mkeys[1:] != mkeys[:-1]])
    tail = jnp.concatenate([mkeys[1:] != mkeys[:-1], jnp.ones((1,), jnp.bool_)])
    iota = jnp.arange(n, dtype=jnp.int32)
    c2 = jnp.cumsum(is2, dtype=jnp.int32)
    # Run-head broadcasts as int32 cummaxes.
    run_start = _head_broadcast(head, iota)
    base2 = _head_broadcast(head, c2 - is2)
    # In-run index and in-run inclusive side-2 count give both ranks:
    # side-1 elements precede every side-2 element of their run, so a
    # side-1 element's in-run index IS its side rank.
    jr = iota - run_start
    s2r = c2 - base2
    rank = jnp.where(is2 == 1, s2r - 1, jr)
    live = mkeys != key_sentinel(mkeys.dtype)
    matched2 = (is2 == 1) & (rank < (jr + 1 - s2r)) & live
    # Matched side-2 elements are the "witnesses": in merged (= key) order
    # they enumerate the output slots directly, no per-run base needed.
    m2cum = jnp.cumsum(matched2.astype(jnp.int32), dtype=jnp.int32)
    # A side-1 element needs its run's side-2 TOTAL: c2 at the run's end,
    # broadcast backward -- the single remaining backward scan.
    end2 = jax.lax.cummin(jnp.where(tail, c2, n), reverse=True)
    matched1 = (is2 == 0) & (rank < (end2 - base2)) & live
    big = jnp.int32(n)
    dest = jnp.where(
        matched2,
        m2cum - 1,
        jnp.where(matched1, m2cum + rank, big),
    )
    num_out = jnp.sum(matched2, dtype=jnp.int32)
    return dest, num_out


def _one_to_one_merged(
    t1: Table,
    t2: Table,
    key2: int,
    k1,
    k2,
    *,
    narrow: bool = False,
    narrow_data: bool = False,
) -> Table:
    """1:1 join core over pre-masked key vectors; sortedness NOT required.

    Merged-domain realization: the count-then-emit structure of the
    reference kernel (join.c:151-248) is re-expressed as sorts and a
    handful of O(n) scans -- no gather or scatter anywhere:

      1. merge both key columns with a side flag and original position (one
         2-key sort); every per-run quantity (occurrence rank, side
         multiplicities, matched prefix) then falls out of running sums +
         head-broadcast maxima, and each element learns its output slot or
         the drop sentinel;
      2. un-merge slots back to row positions (one sort keyed on the
         carried position -- a permutation inverse);
      3. per table, sort rows by output slot (matched rows land densely at
         the front in key order; the reference's two-pass count/emit
         collapses into this single permutation-by-sort).

    Duplicate keys pair k-th occurrence with k-th occurrence in each
    table's ROW order (stable merge), which equals key order for sorted
    inputs -- the reference cursor semantics either way.

    Each stage runs under a `jax.named_scope` (merge_sort, slot_scan,
    unmerge_sort, emit_sort1, emit_sort2) so a profiler trace attributes
    device time to it.
    """
    cap1, cap2 = t1.capacity, t2.capacity
    n = cap1 + cap2

    # `narrow is True`: the config's "auto" sentinel must be resolved by the
    # driver layer before tracing (config.resolve_narrow / the pipelines'
    # device probe); an unresolved "auto" takes the wide path.
    if narrow is True and jnp.issubdtype(k1.dtype, jnp.integer) and k1.dtype.itemsize == 8:
        k1, k2 = _narrow32(k1), _narrow32(k2)

    # --- 1. merge the key columns (t1 wins ties) ---------------------------
    # The concat position doubles as the side flag (pos >= cap1 means t2)
    # and as the inversion key for step 2; sorting it as a secondary KEY
    # (num_keys=2) puts t1 first on ties and keeps each side's original row
    # order -- identical to a stable 1-key sort, but since (key, pos) is
    # unique by construction the sort needs no synthetic tie-break operand.
    keys = jnp.concatenate([k1, k2])
    pos = jnp.arange(n, dtype=jnp.int32)
    from pim_sort_merge_join_tpu.ops.sort import stable_key_sort

    with jax.named_scope("merge_sort"):
        mkeys, mpos = stable_key_sort((keys, pos), num_keys=2, unique_keys=True)
    with jax.named_scope("slot_scan"):
        dest, num_out = _merged_dest_xla(mkeys, mpos, cap1)

    # --- 2. un-merge: slots back to original row positions -----------------
    # mpos is a permutation of [0, n); sorting by it inverts the merge.
    # Unique keys < n < INT32_MAX: tie-break machinery skipped again.
    with jax.named_scope("unmerge_sort"):
        _, dest_by_pos = stable_key_sort((mpos, dest), unique_keys=True)
    dest1 = dest_by_pos[:cap1]
    dest2 = dest_by_pos[cap1:]

    # --- 3. emit: permute each table's rows to their output slots ----------
    # Matched rows carry UNIQUE dest slots; dropped rows (dest = big) are
    # uniquified with their row index (big + i < 2*cap1 + cap2, which fits
    # int32 for any single-device table up to ~700M rows; distributed
    # shards are far smaller) so both emit sorts run with unique_keys=True
    # and need no tie-break operand. Dropped rows' contents are zeroed by the
    # valid_out mask below, so their relative order never matters.
    #
    # narrow_data (driver-resolved; every table VALUE fits int32, validated
    # at ingest / probed on device): payload planes ride the emit sorts as
    # int32, halving the bytes those sorts move.
    def _plane(col: jax.Array) -> jax.Array:
        if (
            narrow_data is True
            and jnp.issubdtype(col.dtype, jnp.integer)
            and col.dtype.itemsize == 8
        ):
            return col.astype(jnp.int32)
        return col

    big32 = jnp.int32(n)
    dest1u = jnp.where(
        dest1 >= big32, big32 + jnp.arange(cap1, dtype=jnp.int32), dest1
    )
    dest2u = jnp.where(
        dest2 >= big32, big32 + jnp.arange(cap2, dtype=jnp.int32), dest2
    )
    with jax.named_scope("emit_sort1"):
        ops1 = stable_key_sort(
            (dest1u,) + tuple(_plane(t1.data[:, c]) for c in range(t1.ncol)),
            unique_keys=True,
        )
    part1 = jnp.stack(ops1[1:], axis=1).astype(t1.dtype)[:cap1]
    keep2 = [c for c in range(t2.ncol) if c != key2]
    with jax.named_scope("emit_sort2"):
        ops2 = stable_key_sort(
            (dest2u,) + tuple(_plane(t2.data[:, c]) for c in keep2),
            unique_keys=True,
        )
    part2_full = jnp.stack(ops2[1:], axis=1).astype(t2.dtype)
    part2 = part2_full[:cap1] if cap2 >= cap1 else jnp.concatenate(
        [
            part2_full,
            jnp.zeros((cap1 - cap2, t2.ncol - 1), t2.dtype),
        ],
        axis=0,
    )
    valid_out = jnp.arange(cap1, dtype=jnp.int32) < num_out
    data = jnp.concatenate([part1, part2], axis=1)
    data = jnp.where(valid_out[:, None], data, jnp.zeros_like(data))
    return Table(
        data=data,
        num_rows=num_out,
        names=_out_names(t1, t2, key2),
    )


def merge_join_one_to_one(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    *,
    narrow: bool = False,
    narrow_data: bool = False,
) -> Table:
    """Reference-semantics 1:1 merge join of two sorted tables.

    Output capacity equals table 1's capacity (1:1 output rows <= n1).
    See `_one_to_one_merged` for the realization.
    """
    return _one_to_one_merged(
        t1, t2, key2, t1.masked_keys(key1), t2.masked_keys(key2),
        narrow=narrow, narrow_data=narrow_data,
    )


def filter_join_one_to_one(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    mask1: jax.Array,
    mask2: jax.Array,
    *,
    narrow: bool = False,
    narrow_data: bool = False,
) -> Table:
    """Fused filter + sort + 1:1 join of two UNSORTED tables.

    ``mask1``/``mask2`` select the rows that survive filtering (already
    AND-ed with validity); masked-out rows get sentinel keys and can never
    match. Because `_one_to_one_merged` never needed sorted inputs -- the
    merge sort establishes key order and the emit sorts place rows by
    output slot -- the whole reference pipeline (select.c -> sort_dpu.c ->
    merge tree -> join.c) collapses into this single operator: no
    standalone compaction, no standalone table sort. Output rows and their
    order are byte-identical to the staged filter -> sort -> join path.
    """
    sent1 = key_sentinel(t1.dtype)
    sent2 = key_sentinel(t2.dtype)
    k1 = jnp.where(mask1, t1.data[:, key1], sent1)
    k2 = jnp.where(mask2, t2.data[:, key2], sent2)
    return _one_to_one_merged(
        t1, t2, key2, k1, k2, narrow=narrow, narrow_data=narrow_data
    )


def merge_join_inner(
    t1: Table, t2: Table, key1: int, key2: int, *, out_capacity: int | None = None
) -> Table:
    """Standard inner join (full cross product on duplicate keys).

    ``out_capacity`` bounds the output (default: table 1 capacity); rows
    beyond it are dropped and the true count is still reported in
    ``num_rows`` so callers can detect overflow (num_rows > capacity).
    """
    info = _match_info(t1, t2, key1, key2)
    cnt = jnp.where(t1.valid_mask(), info.cnt2, 0)
    starts = jnp.cumsum(cnt, dtype=jnp.int32) - cnt  # exclusive prefix
    total = jnp.sum(cnt, dtype=jnp.int32)
    out_cap = t1.capacity if out_capacity is None else out_capacity
    j = jnp.arange(out_cap, dtype=jnp.int32)
    # Which t1 row does output slot j belong to? Last i with starts[i] <= j.
    # Slot-scatter formulation: rows with cnt > 0 have strictly increasing
    # (hence unique) starts, and the first such row has start 0, so
    # scattering (i, starts[i]) at slot starts[i] and prefix-maxing covers
    # every live slot. Replaces `searchsorted(..., method='sort')`, which
    # paid two rank-by-merge sorts of 2*out_cap elements, with two O(n)
    # scatters + two cummax scans.
    has = cnt > 0
    i1 = jnp.arange(t1.capacity, dtype=jnp.int32)
    slot = jnp.where(has, starts, out_cap)  # dead rows scatter out of range
    src1 = jax.lax.cummax(
        jnp.zeros((out_cap,), jnp.int32)
        .at[slot]
        .max(jnp.where(has, i1, 0), mode="drop")
    )
    start_of = jax.lax.cummax(
        jnp.zeros((out_cap,), jnp.int32)
        .at[slot]
        .max(jnp.where(has, starts, 0), mode="drop")
    )
    offset = j - start_of
    src2 = jnp.take(info.lo2, src1) + offset
    valid_out = j < jnp.minimum(total, out_cap)
    # Zero-match rows never scatter (their slot lands out of range, mode
    # "drop"), so every live slot's cummax resolves to the unique row with
    # starts[i] <= j < starts[i] + cnt[i]; slots past `total` hold stale
    # maxima but are already invalid.
    return _emit(t1, t2, key2, src1, src2, valid_out, total)


def merge_join(
    t1: Table,
    t2: Table,
    key1: int,
    key2: int,
    *,
    mode: str = "one_to_one",
    out_capacity: int | None = None,
    presorted: bool = True,
    narrow: bool = False,
    narrow_data: bool = False,
) -> Table:
    """Join two tables on their key columns.

    ``presorted=False`` (one_to_one only) accepts unsorted inputs -- the
    merged-domain core establishes key order itself, so callers can skip
    their own sort pass entirely. ``narrow`` (one_to_one only) sorts the
    merge pass on int32 keys; valid only when every key value fits int32
    (config.narrow_keys, validated at ingest). ``narrow_data`` additionally
    rides the emit sorts' payload planes as int32; valid only when every
    table VALUE fits int32 (config.narrow_data).
    """
    if mode == "one_to_one":
        if not presorted:
            return filter_join_one_to_one(
                t1, t2, key1, key2, t1.valid_mask(), t2.valid_mask(),
                narrow=narrow, narrow_data=narrow_data,
            )
        return merge_join_one_to_one(
            t1, t2, key1, key2, narrow=narrow, narrow_data=narrow_data
        )
    if mode == "inner":
        if not presorted:
            raise ValueError("inner join requires key-sorted inputs")
        return merge_join_inner(t1, t2, key1, key2, out_capacity=out_capacity)
    raise ValueError(f"unknown join mode {mode!r}")
