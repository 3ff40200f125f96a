"""Distributed pipeline tests on a virtual 8-device CPU mesh.

The multi-device analog of the reference's simulator-backed runs
(SURVEY.md section 4 item 2): N emulated devices in one process exercise the
shard_map + all_to_all path without GPUs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.engine.distributed import (
    DistributedQueryPipeline,
    ShardedTable,
)
from pim_sort_merge_join_tpu.exchange.partition import choose_splitters, sample_keys
from pim_sort_merge_join_tpu.exchange.shuffle import all_to_all_exchange
from pim_sort_merge_join_tpu.ops import oracle


def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual CPU devices"
    return Mesh(np.array(devs[:8]), ("p",))


def test_exchange_routes_rows():
    mesh = mesh8()
    p = 8
    cap = 16
    # Shard i holds rows with payload i*cap..i*cap+cap-1, destined to row%8.
    data = np.arange(p * cap, dtype=np.int64).reshape(p * cap, 1)
    dest = (data[:, 0] % p).astype(np.int32)

    def body(d, t):
        res = all_to_all_exchange(d, t, "p", bucket_capacity=4, recv_capacity=32)
        return res.data, res.num_rows.reshape(1), res.true_rows.reshape(1)

    out, nrows, true = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("p", None), P("p")),
            out_specs=(P("p", None), P("p"), P("p")),
            check_vma=False,
        )
    )(jnp.asarray(data), jnp.asarray(dest))
    out = np.asarray(out).reshape(p, 32)
    nrows = np.asarray(nrows)
    for shard in range(p):
        got = out[shard, : nrows[shard]]
        want = np.sort(data[dest == shard, 0])
        np.testing.assert_array_equal(np.sort(got), want)
        # Arrival order: source-shard-major, preserving local order.
        want_order = np.concatenate(
            [
                data[i * cap : (i + 1) * cap][dest[i * cap : (i + 1) * cap] == shard, 0]
                for i in range(p)
            ]
        )
        np.testing.assert_array_equal(got, want_order)


def test_exchange_overflow_detected():
    mesh = mesh8()
    p, cap = 8, 16
    data = np.arange(p * cap, dtype=np.int64).reshape(p * cap, 1)
    dest = np.zeros(p * cap, dtype=np.int32)  # everything to shard 0

    def body(d, t):
        res = all_to_all_exchange(d, t, "p", bucket_capacity=4, recv_capacity=32)
        return res.num_rows.reshape(1), res.true_rows.reshape(1)

    nrows, true = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P("p", None), P("p")),
            out_specs=(P("p"), P("p")),
            check_vma=False,
        )
    )(jnp.asarray(data), jnp.asarray(dest))
    assert int(true[0]) == p * cap  # true demand recorded
    assert int(nrows[0]) == 32  # only capacity materialized
    assert int(true[0]) > int(nrows[0])  # overflow visible


def test_splitter_sampling_balanced():
    keys = jnp.asarray(np.arange(1000, dtype=np.int64))
    smp = sample_keys(keys, jnp.asarray(1000), 128)
    spl = choose_splitters(smp, 8)
    # Splitters should be roughly evenly spaced quantiles.
    gaps = np.diff(np.concatenate([[0], np.asarray(spl), [1000]]))
    assert gaps.min() > 50


@pytest.mark.parametrize("nrow", [64, 1000])
def test_distributed_matches_oracle(rng, nrow):
    from tests.conftest import make_reference_like_tables

    r1, r2 = make_reference_like_tables(rng, nrow)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", nrow // 2),
        predicate2=Predicate(0, ">", nrow // 2),
        splitter_sample=128,
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    out = pipe.run_arrays(r1, r2)
    want = oracle.pipeline_oracle(
        r1, r2, pred1=(0, ">", nrow // 2), pred2=(0, ">", nrow // 2)
    )
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_distributed_duplicate_keys(rng):
    # Heavy duplication: equal keys must co-locate and keep 1:1 semantics.
    keys1 = rng.integers(0, 15, 400)
    keys2 = rng.integers(0, 15, 300)
    r1 = np.column_stack([keys1, rng.integers(0, 100, (400, 3))]).astype(np.int64)
    r2 = np.column_stack([keys2, rng.integers(0, 100, (300, 3))]).astype(np.int64)
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        splitter_sample=64,
        exchange_slack=16.0,  # 15 distinct keys over 8 shards: heavy skew
        heavy_hitter_fraction=1.0,  # keep keys range-routed: this test pins
        # the global key-order contract; rank-spreading (tested in
        # test_skew_*) trades that order away by design
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    out = pipe.run_arrays(r1, r2).to_numpy()
    want = oracle.pipeline_oracle(r1, r2, pred1=(1, ">=", 0), pred2=(1, ">=", 0))
    # BYTE-IDENTICAL to the single-chip/oracle order, duplicates included:
    # exchange arrival order is (source shard, source position) == global
    # ingestion order for contiguous row-block scatter, and the merged-domain
    # join is stable, so equal-key rows keep global insertion order through
    # the distributed path (range scheme, rank-spreading disabled).
    np.testing.assert_array_equal(out, want)
    # Keys arrive in globally nondecreasing order.
    assert (np.diff(out[:, 0]) >= 0).all()


def test_distributed_empty_result():
    mesh = mesh8()
    rng = np.random.default_rng(0)
    r = np.column_stack(
        [rng.integers(0, 100, 64), rng.integers(0, 100, (64, 3))]
    ).astype(np.int64)
    cfg = EngineConfig(predicate1=Predicate(0, ">", 10**9))
    pipe = DistributedQueryPipeline(cfg, mesh)
    out = pipe.run_arrays(r, r.copy())
    assert out.to_numpy().shape == (0, 7)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_distributed_aggregate_matches_oracle(rng, agg):
    keys = rng.integers(0, 40, size=500)
    rows = np.column_stack([keys, rng.integers(1, 100, (500, 2))]).astype(np.int64)
    cfg = EngineConfig(exchange_slack=8.0, splitter_sample=128)
    mesh = mesh8()
    pipe = DistributedQueryPipeline(cfg, mesh)
    t = ShardedTable.from_numpy(rows, mesh, "p")
    out = pipe.run_aggregate(t, key=0, value=1, agg=agg)
    got = out.to_numpy()
    want = oracle.hash_aggregate_oracle(rows, 0, 1, agg)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["one_to_one", "inner"])
def test_distributed_hash_partition_matches_oracle(rng, mode):
    # BASELINE config 3: hash-partitioned shuffle. Equal keys co-locate via
    # mix(key) % P; output is the oracle's multiset (shard order does not
    # follow key order under hashing -- documented in engine/distributed.py).
    from tests.conftest import make_reference_like_tables

    r1, r2 = make_reference_like_tables(rng, 800)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 200),
        predicate2=Predicate(0, ">", 200),
        partition_scheme="hash",
        join_mode=mode,
        join_slack=2.0,
        exchange_slack=4.0,
        splitter_sample=64,
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    out = pipe.run_arrays(r1, r2).to_numpy()
    want = oracle.pipeline_oracle(
        r1, r2, pred1=(0, ">", 200), pred2=(0, ">", 200), mode=mode
    )
    assert out.shape == want.shape
    np.testing.assert_array_equal(
        out[np.lexsort(out.T[::-1])], want[np.lexsort(want.T[::-1])]
    )


def test_distributed_hash_partition_aggregate(rng):
    keys = rng.integers(0, 64, size=600)
    rows = np.column_stack([keys, rng.integers(1, 100, (600, 2))]).astype(np.int64)
    cfg = EngineConfig(
        partition_scheme="hash", exchange_slack=8.0, splitter_sample=64
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    t = ShardedTable.from_numpy(rows, pipe.mesh, "p")
    out = pipe.run_aggregate(t, key=0, value=1, agg="sum").to_numpy()
    want = oracle.hash_aggregate_oracle(rows, key=0, value=1, agg="sum")
    got = out[np.argsort(out[:, 0])]
    np.testing.assert_array_equal(got, want[np.argsort(want[:, 0])])


def _skewed_tables(rng, n1=600, n2=600, hot=7, hot_frac=0.7):
    """Tables where one key holds ``hot_frac`` of all rows (Zipf-like)."""
    nh1, nh2 = int(n1 * hot_frac), int(n2 * hot_frac)
    k1 = np.concatenate([np.full(nh1, hot), rng.integers(100, 10_000, n1 - nh1)])
    k2 = np.concatenate([np.full(nh2, hot), rng.integers(100, 10_000, n2 - nh2)])
    r1 = np.column_stack([k1, rng.integers(0, 100, (n1, 3))]).astype(np.int64)
    r2 = np.column_stack([k2, rng.integers(0, 100, (n2, 3))]).astype(np.int64)
    return rng.permutation(r1), rng.permutation(r2)


def test_skew_heavy_hitter_one_to_one(rng):
    # A 70%-hot key would overflow any single shard at slack 1.3; rank
    # co-partitioning (exchange/skew.py) spreads it across all 8 shards and
    # preserves the reference's k-th-pairs-k-th 1:1 semantics exactly.
    r1, r2 = _skewed_tables(rng)
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        exchange_slack=1.3,
        splitter_sample=256,
        heavy_hitter_fraction=0.2,
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    out = pipe.run_arrays(r1, r2).to_numpy()
    want = oracle.pipeline_oracle(r1, r2, pred1=(1, ">=", 0), pred2=(1, ">=", 0))
    assert out.shape == want.shape
    np.testing.assert_array_equal(
        out[np.lexsort(out.T[::-1])], want[np.lexsort(want.T[::-1])]
    )


def test_skew_disabled_raises(rng):
    from pim_sort_merge_join_tpu.engine.errors import ExchangeOverflowError

    r1, r2 = _skewed_tables(rng)
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        exchange_slack=1.3,
        splitter_sample=256,
        heavy_hitter_fraction=1.0,  # skew handling off
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    with pytest.raises(ExchangeOverflowError):
        pipe.run_arrays(r1, r2)


def test_skew_heavy_hitter_inner_broadcast(rng):
    # Inner-join skew: table 1 hot on one key, table 2 has a handful of
    # rows for it -- the broadcast-side path replicates those to all shards.
    n1 = 600
    k1 = np.concatenate([np.full(400, 7), rng.integers(100, 10_000, n1 - 400)])
    r1 = np.column_stack([k1, rng.integers(0, 100, (n1, 3))]).astype(np.int64)
    k2 = np.concatenate([np.full(5, 7), rng.integers(100, 10_000, 295)])
    r2 = np.column_stack([k2, rng.integers(0, 100, (300, 3))]).astype(np.int64)
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        join_mode="inner",
        join_slack=30.0,  # 400*5 cross-product rows land on 8 shards
        exchange_slack=1.5,
        splitter_sample=256,
        heavy_hitter_fraction=0.2,
    )
    pipe = DistributedQueryPipeline(cfg, mesh8())
    out = pipe.run_arrays(np.asarray(r1), r2).to_numpy()
    want = oracle.pipeline_oracle(
        r1, r2, pred1=(1, ">=", 0), pred2=(1, ">=", 0), mode="inner"
    )
    assert out.shape == want.shape
    np.testing.assert_array_equal(
        out[np.lexsort(out.T[::-1])], want[np.lexsort(want.T[::-1])]
    )


def test_distributed_resumable_matches_and_resumes(rng, tmp_path):
    """Exchange-boundary checkpoint: correct output, and a rerun resumes
    from the persisted co-partitioned state (garbage inputs prove the
    exchange was skipped)."""
    from tests.conftest import make_reference_like_tables

    r1, r2 = make_reference_like_tables(rng, 600)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 300),
        predicate2=Predicate(0, ">", 300),
        splitter_sample=128,
        checkpoint_dir=str(tmp_path),
    )
    mesh = mesh8()
    pipe = DistributedQueryPipeline(cfg, mesh)
    t1 = ShardedTable.from_numpy(r1, mesh, "p")
    t2 = ShardedTable.from_numpy(r2, mesh, "p")
    out1 = pipe.run_tables_resumable(t1, t2).to_numpy()
    want = oracle.pipeline_oracle(
        r1, r2, pred1=(0, ">", 300), pred2=(0, ">", 300)
    )
    np.testing.assert_array_equal(out1, want)

    # Resume: garbage inputs of the same shape must not matter.
    garbage = ShardedTable.from_numpy(np.zeros_like(r1), mesh, "p")
    out2 = (
        DistributedQueryPipeline(cfg, mesh)
        .run_tables_resumable(garbage, garbage)
        .to_numpy()
    )
    np.testing.assert_array_equal(out2, want)


def test_resumable_resolves_narrow_auto(rng, tmp_path):
    """Advisor r4 (medium): the resumable route must resolve
    narrow_keys/narrow_data='auto' to concrete bools exactly like
    run_tables -- previously the string 'auto' reached ops/join.py and
    silently disabled the narrow paths."""
    from tests.conftest import make_reference_like_tables

    r1, r2 = make_reference_like_tables(rng, 600)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 300),
        predicate2=Predicate(0, ">", 300),
        splitter_sample=128,
        checkpoint_dir=str(tmp_path),
    )
    assert cfg.narrow_keys == "auto" and cfg.narrow_data == "auto"
    mesh = mesh8()
    pipe = DistributedQueryPipeline(cfg, mesh)
    out = pipe.run_tables_resumable(
        ShardedTable.from_numpy(r1, mesh, "p"),
        ShardedTable.from_numpy(r2, mesh, "p"),
    ).to_numpy()
    # Reference-like keys/values all fit int32 -> both resolve True.
    assert pipe.resolved_narrow_keys is True
    assert pipe.resolved_narrow_data is True
    want = oracle.pipeline_oracle(
        r1, r2, pred1=(0, ">", 300), pred2=(0, ">", 300)
    )
    np.testing.assert_array_equal(out, want)


def test_resumable_resume_probes_checkpoint_not_inputs(rng, tmp_path):
    """On resume the narrow probe must read the restored exchanged state:
    a wide-keyed checkpoint resumed with in-int32-range placeholder inputs
    must NOT resolve narrow (that would feed 64-bit keys to the int32
    join)."""
    n = 512
    keys1 = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
    keys2 = rng.permutation(np.arange(1, n + 1)).astype(np.int64)
    # Push half the keys beyond int32 on both sides (same offset keeps
    # matches aligned).
    big = np.int64(1) << 40
    keys1[keys1 % 2 == 0] += big
    keys2[keys2 % 2 == 0] += big
    pay = lambda: rng.integers(1, 100, (n, 3))
    r1 = np.column_stack([keys1, pay()]).astype(np.int64)
    r2 = np.column_stack([keys2, pay()]).astype(np.int64)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 0),
        predicate2=Predicate(0, ">", 0),
        splitter_sample=128,
        checkpoint_dir=str(tmp_path),
    )
    mesh = mesh8()
    pipe = DistributedQueryPipeline(cfg, mesh)
    out1 = pipe.run_tables_resumable(
        ShardedTable.from_numpy(r1, mesh, "p"),
        ShardedTable.from_numpy(r2, mesh, "p"),
    ).to_numpy()
    assert pipe.resolved_narrow_keys is False
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 0), pred2=(0, ">", 0))
    np.testing.assert_array_equal(out1, want)

    # Resume with all-zero placeholders (which WOULD probe narrow): the
    # checkpointed wide keys must keep the join wide and the output exact.
    garbage = ShardedTable.from_numpy(np.zeros_like(r1), mesh, "p")
    pipe2 = DistributedQueryPipeline(cfg, mesh)
    out2 = pipe2.run_tables_resumable(garbage, garbage).to_numpy()
    assert pipe2.resolved_narrow_keys is False
    np.testing.assert_array_equal(out2, want)


def test_distributed_resume_rejects_mesh_size_change(rng, tmp_path):
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.checkpoint import StageCheckpointer

    r1, r2 = (
        np.column_stack([rng.permutation(np.arange(1, 65)), rng.integers(1, 64, (64, 3))]).astype(np.int64)
        for _ in range(2)
    )
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        checkpoint_dir=str(tmp_path),
    )
    mesh = mesh8()
    pipe = DistributedQueryPipeline(cfg, mesh)
    pipe.run_tables_resumable(
        ShardedTable.from_numpy(r1, mesh, "p"),
        ShardedTable.from_numpy(r2, mesh, "p"),
    )
    # A 4-device mesh cannot consume an 8-way co-partitioned checkpoint.
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("p",))
    p8 = DistributedQueryPipeline(cfg, mesh)
    ckpt = StageCheckpointer(
        str(tmp_path),
        __import__(
            "pim_sort_merge_join_tpu.engine.checkpoint", fromlist=["x"]
        ).config_fingerprint(cfg)
        + "|mesh=8",
    )
    with pytest.raises(ValueError, match="shards"):
        ckpt.load_sharded("exchanged", "t1", mesh4, "p")


@pytest.mark.parametrize("chunks", [2, 4, 16])
def test_chunked_exchange_bit_identical(chunks):
    """num_chunks only changes collective granularity, never the result."""
    mesh = mesh8()
    p, cap = 8, 16
    rng = np.random.default_rng(3)
    data = rng.integers(0, 1000, (p * cap, 2)).astype(np.int64)
    dest = rng.integers(0, p, p * cap).astype(np.int32)

    def body(d, t, k):
        res = all_to_all_exchange(
            d, t, "p", bucket_capacity=16, recv_capacity=64, num_chunks=k
        )
        return res.data, res.num_rows.reshape(1), res.true_rows.reshape(1)

    outs = {}
    for k in (1, chunks):
        outs[k] = jax.jit(
            jax.shard_map(
                lambda d, t, k=k: body(d, t, k),
                mesh=mesh,
                in_specs=(P("p", None), P("p")),
                out_specs=(P("p", None), P("p"), P("p")),
                check_vma=False,
            )
        )(jnp.asarray(data), jnp.asarray(dest))
    for a, b in zip(outs[1], outs[chunks]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pipeline_chunked_exchange_matches_oracle(rng):
    from tests.conftest import make_reference_like_tables

    r1, r2 = make_reference_like_tables(rng, 500)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 250),
        predicate2=Predicate(0, ">", 250),
        splitter_sample=128,
        exchange_chunks=8,
    )
    out = DistributedQueryPipeline(cfg, mesh8()).run_arrays(r1, r2).to_numpy()
    want = oracle.pipeline_oracle(
        r1, r2, pred1=(0, ">", 250), pred2=(0, ">", 250)
    )
    np.testing.assert_array_equal(out, want)
