"""narrow_keys: the packed int32 merge-sort key fast path (ops/join._narrow32).

SURVEY.md §7 "pack key+index into one 64-bit word when key width permits":
for 64-bit tables whose key VALUES fit int32 (the benchmark generator's keys
are <= 3N, generate_data.py:7-9), the 1:1 join's merge pass sorts int32 keys
instead -- a third less HBM traffic on that sort. The contract: output is
byte-identical to the wide path, and out-of-range keys fail loudly at ingest.
"""

import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar import csv_io
from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.engine.errors import MalformedInputError
from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
from pim_sort_merge_join_tpu.ops import oracle


def _cfg(**kw):
    kw.setdefault("predicate1", Predicate(0, ">", 100))
    kw.setdefault("predicate2", Predicate(0, ">", 100))
    return EngineConfig(**kw)


def _pipe_out(cfg, r1, r2, tmp_path, tag):
    p1 = str(tmp_path / f"{tag}1.csv")
    p2 = str(tmp_path / f"{tag}2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    return QueryPipeline(cfg).run_csv(p1, p2).to_numpy()


def test_narrow_matches_wide_unique_keys(small_tables, tmp_path):
    r1, r2 = small_tables
    wide = _pipe_out(_cfg(), r1, r2, tmp_path, "w")
    narrow = _pipe_out(_cfg(narrow_keys=True), r1, r2, tmp_path, "n")
    np.testing.assert_array_equal(narrow, wide)
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(narrow, want)


def test_narrow_matches_wide_duplicates_and_negatives(rng, tmp_path):
    # Duplicate keys exercise the 1:1 rank pairing; negative keys exercise
    # order preservation of the int64 -> int32 cast across the sign range.
    for tag, lo, hi in (("dup", 0, 25), ("neg", -(2**31), 2**31 - 2)):
        keys1 = rng.integers(lo, hi, size=300)
        keys2 = rng.integers(lo, hi, size=300)
        r1 = np.column_stack([keys1, rng.integers(0, 99, (300, 3))]).astype(np.int64)
        r2 = np.column_stack([keys2, rng.integers(0, 99, (300, 3))]).astype(np.int64)
        cfg_w = _cfg(predicate1=Predicate(1, ">", -1), predicate2=Predicate(1, ">", -1))
        cfg_n = _cfg(
            predicate1=Predicate(1, ">", -1),
            predicate2=Predicate(1, ">", -1),
            narrow_keys=True,
        )
        wide = _pipe_out(cfg_w, r1, r2, tmp_path, f"{tag}w")
        narrow = _pipe_out(cfg_n, r1, r2, tmp_path, f"{tag}n")
        np.testing.assert_array_equal(narrow, wide)


def test_narrow_staged_path_matches(small_tables, tmp_path):
    # The staged (non-fused) sort_merge path threads narrow through
    # pipeline_core's merge_join call; inner mode ignores it by contract.
    r1, r2 = small_tables
    wide = _pipe_out(_cfg(join_mode="inner"), r1, r2, tmp_path, "iw")
    narrow = _pipe_out(
        _cfg(join_mode="inner", narrow_keys=True), r1, r2, tmp_path, "in"
    )
    np.testing.assert_array_equal(narrow, wide)


def test_narrow_distributed_matches_single_chip(small_tables):
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    r1, r2 = small_tables
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    out = DistributedQueryPipeline(_cfg(narrow_keys=True), mesh).run_arrays(r1, r2)
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_narrow_out_of_range_key_raises(tmp_path):
    rows = np.array([[2**31, 1, 1, 1], [5, 2, 2, 2]], dtype=np.int64)
    p = str(tmp_path / "wide.csv")
    csv_io.write_csv(p, rows)
    pipe = QueryPipeline(_cfg(narrow_keys=True, predicate1=Predicate(0, ">", -1)))
    with pytest.raises(MalformedInputError, match="narrow_keys"):
        pipe.run_csv(p, p)


def test_narrow_distributed_out_of_range_raises(small_tables):
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    r1, r2 = small_tables
    r1 = r1.copy()
    r1[0, 0] = 2**31
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    pipe = DistributedQueryPipeline(_cfg(narrow_keys=True), mesh)
    with pytest.raises(MalformedInputError, match="narrow_keys"):
        pipe.run_arrays(r1, r2)


def test_narrow_rejects_float_dtype():
    with pytest.raises(ValueError, match="narrow_keys"):
        EngineConfig(dtype="float64", narrow_keys=True)


# --- narrow_keys="auto" (the round-3 default) -------------------------------


def test_auto_narrow_resolves_on_for_reference_style_keys(small_tables, tmp_path):
    r1, r2 = small_tables
    pipe = QueryPipeline(_cfg())  # default narrow_keys="auto"
    got = _pipe_out(_cfg(), r1, r2, tmp_path, "auto")
    assert QueryPipeline(_cfg()).config.narrow_keys == "auto"
    p1, p2 = str(tmp_path / "a1.csv"), str(tmp_path / "a2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    out = pipe.run_csv(p1, p2)
    assert pipe.resolved_narrow_keys is True
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)
    np.testing.assert_array_equal(got, want)


def test_auto_narrow_resolves_off_for_wide_keys(rng, tmp_path):
    n = 200
    keys = rng.integers(2**40, 2**45, size=n)
    r1 = np.column_stack([keys, rng.integers(0, 99, (n, 3))]).astype(np.int64)
    r2 = np.column_stack(
        [rng.permutation(keys), rng.integers(0, 99, (n, 3))]
    ).astype(np.int64)
    cfg = _cfg(predicate1=Predicate(1, ">", -1), predicate2=Predicate(1, ">", -1))
    pipe = QueryPipeline(cfg)
    p1, p2 = str(tmp_path / "w1.csv"), str(tmp_path / "w2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    out = pipe.run_csv(p1, p2)
    assert pipe.resolved_narrow_keys is False
    want = oracle.pipeline_oracle(r1, r2, pred1=(1, ">", -1), pred2=(1, ">", -1))
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_auto_narrow_device_probe_run_tables(small_tables):
    # run_tables has no host arrays: "auto" resolves via the device probe.
    from pim_sort_merge_join_tpu.columnar.table import Table

    r1, r2 = small_tables
    pipe = QueryPipeline(_cfg())
    out = pipe.run_tables(Table.from_numpy(r1), Table.from_numpy(r2))
    assert pipe.resolved_narrow_keys is True
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)

    wide1 = r1.copy()
    wide1[3, 0] = 2**33  # filtered IN (pred on col0 > 100) but irrelevant:
    pipe2 = QueryPipeline(_cfg())
    out2 = pipe2.run_tables(Table.from_numpy(wide1), Table.from_numpy(r2))
    assert pipe2.resolved_narrow_keys is False
    want2 = oracle.pipeline_oracle(
        wide1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100)
    )
    np.testing.assert_array_equal(out2.to_numpy(), want2)


def test_auto_narrow_distributed_global_probe(small_tables):
    """The distributed probe reduces over the GLOBAL array: a wide key in
    any single shard flips the decision for every shard identically (the
    multi-process agreement property, exercised for real in
    test_multihost.py)."""
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    r1, r2 = small_tables
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    pipe = DistributedQueryPipeline(_cfg(), mesh)
    out = pipe.run_arrays(r1, r2)
    assert pipe.resolved_narrow_keys is True
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)

    r1w = r1.copy()
    r1w[-1, 0] = 2**35  # lands in the LAST shard only
    pipe2 = DistributedQueryPipeline(_cfg(), mesh)
    out2 = pipe2.run_arrays(r1w, r2)
    assert pipe2.resolved_narrow_keys is False
    want2 = oracle.pipeline_oracle(
        r1w, r2, pred1=(0, ">", 100), pred2=(0, ">", 100)
    )
    np.testing.assert_array_equal(out2.to_numpy(), want2)


# --- narrow_data: int32 emit-sort payload planes (round 4) -------------------


def test_narrow_data_matches_wide(small_tables, tmp_path):
    r1, r2 = small_tables
    wide = _pipe_out(_cfg(narrow_data=False), r1, r2, tmp_path, "dw")
    nd = _pipe_out(_cfg(narrow_data=True), r1, r2, tmp_path, "dn")
    np.testing.assert_array_equal(nd, wide)
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(nd, want)


def test_narrow_data_negative_payloads(rng, tmp_path):
    # Negative payload values must roundtrip the int64->int32->int64 cast.
    n = 300
    keys1 = rng.integers(0, 200, size=n)
    keys2 = rng.integers(0, 200, size=n)
    pay = lambda: rng.integers(-(2**31), 2**31 - 2, (n, 3))
    r1 = np.column_stack([keys1, pay()]).astype(np.int64)
    r2 = np.column_stack([keys2, pay()]).astype(np.int64)
    cfg_w = _cfg(
        predicate1=Predicate(0, ">", -1), predicate2=Predicate(0, ">", -1),
        narrow_data=False,
    )
    cfg_n = _cfg(
        predicate1=Predicate(0, ">", -1), predicate2=Predicate(0, ">", -1),
        narrow_data=True,
    )
    wide = _pipe_out(cfg_w, r1, r2, tmp_path, "ndw")
    nd = _pipe_out(cfg_n, r1, r2, tmp_path, "ndn")
    np.testing.assert_array_equal(nd, wide)


def test_narrow_data_cast_path_below_regime_gate(rng, tmp_path):
    # The int64->int32 payload cast engages at every size (no size gate):
    # full-range int32 payloads must come back identical to the wide path.
    n = 300
    keys1 = rng.integers(0, 200, size=n)
    keys2 = rng.integers(0, 200, size=n)
    pay = lambda: rng.integers(-(2**31), 2**31 - 2, (n, 3))
    r1 = np.column_stack([keys1, pay()]).astype(np.int64)
    r2 = np.column_stack([keys2, pay()]).astype(np.int64)
    cfg_w = _cfg(
        predicate1=Predicate(0, ">", -1), predicate2=Predicate(0, ">", -1),
        narrow_data=False,
    )
    cfg_n = _cfg(
        predicate1=Predicate(0, ">", -1), predicate2=Predicate(0, ">", -1),
        narrow_data=True,
    )
    wide = _pipe_out(cfg_w, r1, r2, tmp_path, "rgw")
    nd = _pipe_out(cfg_n, r1, r2, tmp_path, "rgn")
    np.testing.assert_array_equal(nd, wide)


def test_narrow_data_auto_resolution(rng, tmp_path):
    # Narrow keys but a wide PAYLOAD value: narrow_keys resolves True while
    # narrow_data resolves False, and output still matches the oracle.
    n = 200
    r1 = np.column_stack(
        [rng.integers(0, 500, n), rng.integers(0, 99, (n, 3))]
    ).astype(np.int64)
    r2 = np.column_stack(
        [rng.integers(0, 500, n), rng.integers(0, 99, (n, 3))]
    ).astype(np.int64)
    r1[7, 2] = 2**40  # payload too wide; key col untouched
    cfg = _cfg(predicate1=Predicate(0, ">", -1), predicate2=Predicate(0, ">", -1))
    pipe = QueryPipeline(cfg)
    p1, p2 = str(tmp_path / "ad1.csv"), str(tmp_path / "ad2.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    out = pipe.run_csv(p1, p2)
    assert pipe.resolved_narrow_keys is True
    assert pipe.resolved_narrow_data is False
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", -1), pred2=(0, ">", -1))
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_narrow_data_device_probe(small_tables):
    from pim_sort_merge_join_tpu.columnar.table import Table

    r1, r2 = small_tables
    pipe = QueryPipeline(_cfg())
    pipe.run_tables(Table.from_numpy(r1), Table.from_numpy(r2))
    assert pipe.resolved_narrow_data is True
    r1w = r1.copy()
    r1w[2, 3] = -(2**35)
    pipe2 = QueryPipeline(_cfg())
    out = pipe2.run_tables(Table.from_numpy(r1w), Table.from_numpy(r2))
    assert pipe2.resolved_narrow_data is False
    want = oracle.pipeline_oracle(r1w, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_narrow_data_out_of_range_raises(tmp_path):
    rows = np.array([[5, 1, 2**31, 1], [6, 2, 2, 2]], dtype=np.int64)
    p = str(tmp_path / "widedata.csv")
    csv_io.write_csv(p, rows)
    pipe = QueryPipeline(_cfg(narrow_data=True, predicate1=Predicate(0, ">", -1)))
    with pytest.raises(MalformedInputError, match="narrow_data"):
        pipe.run_csv(p, p)


def test_narrow_data_distributed_matches(small_tables):
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    r1, r2 = small_tables
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    pipe = DistributedQueryPipeline(_cfg(narrow_data=True), mesh)
    out = pipe.run_arrays(r1, r2)
    assert pipe.resolved_narrow_data is True
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)
