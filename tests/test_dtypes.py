"""Narrow-dtype (int32) pipeline support and input-range validation."""

import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar import csv_io
from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.engine.errors import MalformedInputError
from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
from pim_sort_merge_join_tpu.ops import oracle


def test_int32_pipeline_matches_oracle(small_tables, tmp_path):
    r1, r2 = small_tables
    p1, p2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100),
        predicate2=Predicate(0, ">", 100),
        dtype="int32",
    )
    pipe = QueryPipeline(cfg)
    out = pipe.run_csv(p1, p2, str(tmp_path / "r.csv"))
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy().astype(np.int64), want)
    # CSV digits identical regardless of dtype.
    got_csv = csv_io.load_csv_numpy(str(tmp_path / "r.csv"))
    np.testing.assert_array_equal(got_csv, want)


def test_int32_overflowing_input_raises(tmp_path):
    rows = np.array([[2**40, 1], [5, 2]], dtype=np.int64)
    p = str(tmp_path / "big.csv")
    csv_io.write_csv(p, rows)
    pipe = QueryPipeline(EngineConfig(dtype="int32"))
    with pytest.raises(MalformedInputError, match="int32"):
        pipe.run_csv(p, p)


def test_int32_distributed(small_tables):
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    r1, r2 = small_tables
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100),
        predicate2=Predicate(0, ">", 100),
        dtype="int32",
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    pipe = DistributedQueryPipeline(cfg, mesh)
    out = pipe.run_arrays(r1.astype(np.int32), r2.astype(np.int32))
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy().astype(np.int64), want)
    # Exchange byte accounting present.
    ex = [s for s in pipe.metrics.stages if s.name == "execute"][-1]
    assert ex.bytes_moved and ex.bytes_moved > 0


def test_donated_inputs_pipeline(small_tables):
    r1, r2 = small_tables
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100),
        predicate2=Predicate(0, ">", 100),
        donate_inputs=True,
    )
    pipe = QueryPipeline(cfg)
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    out = pipe.run_tables(t1, t2)
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)
    # Donated buffers are consumed where the backend honors donation (CPU
    # ignores it with a warning). XLA reuses a donated buffer only for an
    # output of its shape, which here is a row-count scalar.
    import jax

    if jax.default_backend() != "cpu":
        assert t1.num_rows.is_deleted() or t2.num_rows.is_deleted()


def test_float64_pipeline_matches_oracle(small_tables):
    """Reference T=double mode (common.h:5): same pipeline over float64."""
    import functools

    import jax

    from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core

    r1, r2 = small_tables
    f1 = r1.astype(np.float64) + 0.5  # non-integral keys exercise real floats
    f2 = r2.astype(np.float64) + 0.5
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100),
        predicate2=Predicate(0, ">", 100),
        dtype="float64",
    )
    t1 = Table.from_numpy(f1, dtype=np.float64)
    t2 = Table.from_numpy(f2, dtype=np.float64)
    out = jax.jit(functools.partial(pipeline_core, config=cfg))(t1, t2)
    want = oracle.pipeline_oracle(f1, f2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_uint64_pipeline_matches_oracle(small_tables):
    """Reference T=uint64_t mode (common.h:3), keys above int64 range."""
    import functools

    import jax

    from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core

    r1, r2 = small_tables
    # Push keys into the uint64-only range (> 2^63) to prove no wraparound.
    hi = np.uint64(2**63)
    u1 = r1.astype(np.uint64)
    u2 = r2.astype(np.uint64)
    u1[:, 0] += hi
    u2[:, 0] += hi
    thr = int(2**63 + 100)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", thr),
        predicate2=Predicate(0, ">", thr),
        dtype="uint64",
    )
    t1 = Table.from_numpy(u1, dtype=np.uint64)
    t2 = Table.from_numpy(u2, dtype=np.uint64)
    out = jax.jit(functools.partial(pipeline_core, config=cfg))(t1, t2)
    want = oracle.pipeline_oracle(u1, u2, pred1=(0, ">", thr), pred2=(0, ">", thr))
    assert out.to_numpy().dtype == np.uint64
    np.testing.assert_array_equal(out.to_numpy(), want)
