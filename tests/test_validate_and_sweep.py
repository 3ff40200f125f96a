"""Validation utils, determinism harness, and sweep smoke test."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.utils import validate

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_check_table_ok(small_tables):
    t = Table.from_numpy(np.sort(small_tables[0], axis=0))
    validate.check_table(t, sorted_by=0)


def test_check_table_unsorted_raises(small_tables):
    t = Table.from_numpy(small_tables[0])
    with pytest.raises(validate.ValidationError, match="not sorted"):
        validate.check_table(t, sorted_by=0)


def test_pipeline_deterministic(small_tables):
    import functools

    import jax

    from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core

    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100), predicate2=Predicate(0, ">", 100)
    )
    t1 = Table.from_numpy(small_tables[0])
    t2 = Table.from_numpy(small_tables[1])
    fn = jax.jit(functools.partial(pipeline_core, config=cfg))
    validate.check_deterministic(fn, t1, t2, reps=3)


def test_distributed_deterministic(small_tables):
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline

    cfg = EngineConfig(
        predicate1=Predicate(0, ">", 100), predicate2=Predicate(0, ">", 100)
    )
    mesh = Mesh(np.array(jax.devices()[:8]), ("p",))
    pipe = DistributedQueryPipeline(cfg, mesh)
    outs = []
    for _ in range(2):
        outs.append(pipe.run_arrays(small_tables[0], small_tables[1]).to_numpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_sweep_smoke():
    res = subprocess.run(
        [sys.executable, "-m", "bench.sweep", "--sizes", "2000", "--reps", "2"],
        capture_output=True,
        text=True,
        cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO)),
    )
    assert res.returncode == 0, res.stderr
    lines = [json.loads(l) for l in res.stdout.strip().splitlines()]
    engines = {l["engine"] for l in lines}
    assert engines == {"cpu_oracle", "device"}
    assert {l["platform"] for l in lines if l["engine"] == "device"} == {"cpu"}


def test_multihost_single_process(tmp_path, small_tables):
    from pim_sort_merge_join_tpu.columnar import csv_io
    from pim_sort_merge_join_tpu.runner import multihost
    from pim_sort_merge_join_tpu.ops import oracle

    d1, d2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    out = str(tmp_path / "r.csv")
    csv_io.write_csv(d1, small_tables[0])
    csv_io.write_csv(d2, small_tables[1])
    rc = multihost.main(
        [d1, d2, "-o", out, "--select-val1", "100", "--select-val2", "100"]
    )
    assert rc == 0
    got = csv_io.load_csv_numpy(out)
    want = oracle.pipeline_oracle(
        small_tables[0], small_tables[1], pred1=(0, ">", 100), pred2=(0, ">", 100)
    )
    np.testing.assert_array_equal(got, want)
