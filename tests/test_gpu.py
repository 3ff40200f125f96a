"""Tests that need the card. They skip elsewhere; on a GPU machine run

    SMJ_TEST_PLATFORM=cuda python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

from pim_sort_merge_join_tpu.columnar.generate import generate_table
from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
from pim_sort_merge_join_tpu.ops import oracle


@pytest.mark.gpu
@pytest.mark.parametrize("keys", ["unique", "zipf"])
def test_fused_pipeline_on_gpu(gpu, keys):
    n = 1_000_000
    r1 = generate_table(n, seed=11, key_distribution=keys)
    r2 = generate_table(n, seed=12, key_distribution=keys)
    pred = (1, ">", (3 * n) // 20)
    cfg = EngineConfig(predicate1=Predicate(*pred), predicate2=Predicate(*pred))
    out = QueryPipeline(cfg).run_tables(Table.from_numpy(r1), Table.from_numpy(r2))
    assert out.data.devices() == {gpu}
    want = oracle.pipeline_oracle(r1, r2, pred1=pred, pred2=pred)
    np.testing.assert_array_equal(out.to_numpy(), want)


@pytest.mark.gpu
def test_donation_consumes_inputs_on_gpu(gpu):
    # XLA reuses a donated buffer only for an output of the same shape: the
    # 1:1 output is [n, 7] against [n, 4] inputs, so only a row-count
    # scalar is taken; the table buffers stay alive.
    r1 = generate_table(4096, seed=1)
    r2 = generate_table(4096, seed=2)
    cfg = EngineConfig(donate_inputs=True)
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    with pytest.warns(UserWarning, match="donated buffers were not usable"):
        out = QueryPipeline(cfg).run_tables(t1, t2)
    np.testing.assert_array_equal(out.to_numpy(), oracle.pipeline_oracle(r1, r2))
    assert t1.num_rows.is_deleted() or t2.num_rows.is_deleted()
    assert not t1.data.is_deleted()
