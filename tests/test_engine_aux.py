"""Aux subsystem tests: checkpoint/resume, errors, logging, CLI, simulator."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar import csv_io
from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.engine.checkpoint import (
    StageCheckpointer,
    config_fingerprint,
)
from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
from pim_sort_merge_join_tpu.ops import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_checkpoint_roundtrip(tmp_path, small_tables):
    t = Table.from_numpy(small_tables[0])
    ckpt = StageCheckpointer(str(tmp_path), "fp1")
    ckpt.save("sorted", t1=t)
    assert ckpt.has("sorted")
    back = ckpt.load_table("sorted", "t1")
    np.testing.assert_array_equal(back.to_numpy(), t.to_numpy())
    assert back.names == t.names


def test_checkpoint_fingerprint_invalidates(tmp_path, small_tables):
    t = Table.from_numpy(small_tables[0])
    StageCheckpointer(str(tmp_path), "fpA").save("sorted", t1=t)
    assert not StageCheckpointer(str(tmp_path), "fpB").has("sorted")


def test_resumable_pipeline_matches_and_resumes(tmp_path, small_tables):
    r1, r2 = small_tables
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100),
        predicate2=Predicate(0, ">", 100),
        checkpoint_dir=str(tmp_path),
    )
    pipe = QueryPipeline(cfg)
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    out1 = pipe.run_tables_resumable(t1, t2).to_numpy()
    want = oracle.pipeline_oracle(r1, r2, pred1=(0, ">", 100), pred2=(0, ">", 100))
    np.testing.assert_array_equal(out1, want)
    ckpt = StageCheckpointer(str(tmp_path), config_fingerprint(cfg))
    assert set(ckpt.completed_stages()) == {"sorted", "joined"}
    # Resume: garbage inputs prove stage 1 is skipped (sorted state loaded).
    garbage = Table.from_numpy(np.zeros_like(r1))
    out2 = QueryPipeline(cfg).run_tables_resumable(garbage, garbage).to_numpy()
    np.testing.assert_array_equal(out2, want)


def test_exchange_overflow_raises():
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline
    from pim_sort_merge_join_tpu.engine.errors import ExchangeOverflowError

    rng = np.random.default_rng(3)
    # All rows share one key -> everything routes to a single shard, far
    # beyond slack 1.0.
    keys = np.full(800, 7)
    rows = np.column_stack([keys, rng.integers(0, 10, (800, 3))]).astype(np.int64)
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        exchange_slack=1.0,
        splitter_sample=32,
        heavy_hitter_fraction=1.0,  # skew handling off: exercise the error path
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    pipe = DistributedQueryPipeline(cfg, mesh)
    with pytest.raises(ExchangeOverflowError) as ei:
        pipe.run_arrays(rows, rows.copy())
    assert "exchange_slack" in str(ei.value)


def test_inner_join_overflow_raises(dup_tables):
    from pim_sort_merge_join_tpu.engine.errors import JoinOverflowError

    r1, r2 = dup_tables  # heavy duplication -> cross product >> capacity
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        join_mode="inner",
        join_slack=1.0,  # capacity = t1 capacity, far below the cross product
    )
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    with pytest.raises(JoinOverflowError, match="join_slack"):
        QueryPipeline(cfg).run_tables(t1, t2)


def test_inner_join_overflow_raises_distributed(rng):
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline
    from pim_sort_merge_join_tpu.engine.errors import JoinOverflowError

    # Two distinct keys, 100 copies each: per-key cross product is 100*100 =
    # 10,000 rows, far beyond the per-shard output capacity, while the
    # exchange itself (<=200 rows/shard) stays within slack.
    keys = np.repeat([3, 9], 100)
    r1 = np.column_stack([keys, rng.integers(0, 50, (200, 3))]).astype(np.int64)
    r2 = np.column_stack([keys, rng.integers(0, 50, (200, 3))]).astype(np.int64)
    cfg = EngineConfig(
        predicate1=Predicate(1, ">=", 0),
        predicate2=Predicate(1, ">=", 0),
        join_mode="inner",
        join_slack=1.0,
        exchange_slack=2.5,
        splitter_sample=128,
        heavy_hitter_fraction=1.0,  # keep both keys range-routed: the point
        # is the JOIN capacity check, not skew spreading
    )
    mesh = Mesh(np.array(jax.devices()[:2]), ("p",))
    pipe = DistributedQueryPipeline(cfg, mesh)
    with pytest.raises(JoinOverflowError):
        pipe.run_arrays(r1, r2)


def test_distributed_dtype_range_validation():
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline
    from pim_sort_merge_join_tpu.engine.errors import MalformedInputError

    rows = np.array([[2**40, 1, 2, 3], [5, 6, 7, 8]], dtype=np.int64)
    cfg = EngineConfig(dtype="int32")
    mesh = Mesh(np.array(jax.devices()[:2]), ("p",))
    pipe = DistributedQueryPipeline(cfg, mesh)
    with pytest.raises(MalformedInputError, match="int32"):
        pipe.run_arrays(rows, rows.copy())


def test_structured_logging(capsys):
    import io

    from pim_sort_merge_join_tpu.engine import logging as elog

    buf = io.StringIO()
    elog.configure(stream=buf)
    elog.log_event("stage_done", stage="sort", rows=123)
    line = buf.getvalue().strip()
    payload = json.loads(line)
    assert payload["event"] == "stage_done"
    assert payload["stage"] == "sort"
    assert payload["rows"] == 123


def _capture_events(buf):
    lines = [l for l in buf.getvalue().strip().splitlines() if l]
    return [json.loads(l) for l in lines]


def test_debug_log_pipeline_stages(tmp_path, small_tables_factory=None):
    """config.debug_log wires log_event through a real pipeline run -- the
    runtime analog of the reference's DEBUG per-stage row dumps
    (user.h:1; app.c:294-305, 379-400)."""
    import io

    from pim_sort_merge_join_tpu.columnar.generate import generate_table
    from pim_sort_merge_join_tpu.engine import logging as elog

    buf = io.StringIO()
    elog.configure(stream=buf)
    rows1 = generate_table(300, seed=1)
    rows2 = generate_table(300, seed=2)
    d1, d2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    csv_io.write_csv(d1, rows1)
    csv_io.write_csv(d2, rows2)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 50),
        predicate2=Predicate(0, ">", 50),
        debug_log=True,
    )
    pipe = QueryPipeline(cfg)
    result = pipe.run_csv(d1, d2, str(tmp_path / "r.csv"))
    events = {e["event"]: e for e in _capture_events(buf)}
    assert events["ingest"]["table1_rows"] == 300
    filt = events["filter"]
    assert filt["table1_rows_in"] == 300
    want = oracle.pipeline_oracle(
        rows1, rows2, pred1=(0, ">", 50), pred2=(0, ">", 50)
    )
    assert filt["table1_rows_out"] == int(np.sum(rows1[:, 0] > 50))
    join = events["join"]
    assert join["rows_out"] == want.shape[0] == int(result.num_rows)
    assert join["overflow_headroom"] == join["output_capacity"] - join["rows_out"]
    mat = events["materialize"]
    assert mat["rows"] == want.shape[0]


def test_debug_log_distributed_stages():
    import io

    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.columnar.generate import generate_table
    from pim_sort_merge_join_tpu.engine import logging as elog
    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    buf = io.StringIO()
    elog.configure(stream=buf)
    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 20),
        predicate2=Predicate(0, ">", 20),
        debug_log=True,
    )
    mesh = Mesh(np.array(jax.devices()[:4]), ("p",))
    pipe = DistributedQueryPipeline(cfg, mesh)
    rows1 = generate_table(400, seed=3)
    rows2 = generate_table(400, seed=4)
    out = pipe.run_arrays(rows1, rows2)
    events = {e["event"]: e for e in _capture_events(buf)}
    exch = events["exchange"]
    assert exch["per_shard_capacity"] >= exch["table1_max_shard_rows"]
    assert exch["overflow_headroom"] >= 0
    want = oracle.pipeline_oracle(
        rows1, rows2, pred1=(0, ">", 20), pred2=(0, ">", 20)
    )
    assert events["join"]["rows_out"] == want.shape[0]
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_cli_run_and_generate(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    d1, d2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    out = str(tmp_path / "r.csv")
    gen = subprocess.run(
        [sys.executable, "-m", "pim_sort_merge_join_tpu.runner.cli",
         "generate", "500", "--out1", d1, "--out2", d2],
        capture_output=True, text=True, env=env, cwd=REPO,
    )
    assert gen.returncode == 0, gen.stderr
    run = subprocess.run(
        [sys.executable, "-m", "pim_sort_merge_join_tpu.runner.cli",
         "run", d1, d2, "-o", out, "--select-val1", "100",
         "--select-val2", "100", "--simulator", "4", "--distributed",
         "--narrow-keys", "--metrics"],
        capture_output=True, text=True, env=env, cwd=REPO,
    )
    assert run.returncode == 0, run.stderr
    rows1 = csv_io.load_csv_numpy(d1)
    rows2 = csv_io.load_csv_numpy(d2)
    want = oracle.pipeline_oracle(
        rows1, rows2, pred1=(0, ">", 100), pred2=(0, ">", 100)
    )
    got = csv_io.load_csv_numpy(out)
    np.testing.assert_array_equal(got, want)
    json.loads(run.stdout)  # --metrics emits valid JSON


def test_malformed_csv_message(tmp_path):
    p = str(tmp_path / "bad.csv")
    with open(p, "w") as f:
        f.write("col1,col2\n1,2\n3\n")
    with pytest.raises(ValueError, match="bad.csv"):
        csv_io.load_csv_numpy(p)


def test_cli_profile_captures_trace(tmp_path):
    """--profile wires engine/profiling.device_trace into the run path and
    leaves a TensorBoard/Perfetto-readable trace on disk (S10 analog)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    d1, d2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    trace_dir = str(tmp_path / "trace")
    subprocess.run(
        [sys.executable, "-m", "pim_sort_merge_join_tpu.runner.cli",
         "generate", "200", "--out1", d1, "--out2", d2],
        capture_output=True, text=True, env=env, cwd=REPO, check=True,
    )
    run = subprocess.run(
        [sys.executable, "-m", "pim_sort_merge_join_tpu.runner.cli",
         "run", d1, d2, "-o", str(tmp_path / "r.csv"),
         "--select-val1", "50", "--select-val2", "50",
         "--simulator", "2", "--profile", trace_dir],
        capture_output=True, text=True, env=env, cwd=REPO,
    )
    assert run.returncode == 0, run.stderr
    assert "device trace captured" in run.stderr
    traces = [
        os.path.join(root, f)
        for root, _, files in os.walk(trace_dir)
        for f in files
    ]
    assert any(f.endswith((".pb", ".json.gz", ".trace.json.gz")) for f in traces), traces
