"""The trace reduction of bench/stage_trace.py, on HLO text and on a CPU
trace of a small fused pipeline step."""

import dataclasses
import functools
import glob
import os

import jax

from bench.stage_trace import SCOPES, hlo_instructions, reduce_trace
from bench.workload import headline_config, headline_predicate, table_pair
from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core
from pim_sort_merge_join_tpu.engine.profiling import device_trace

HLO = """
%fused_scan (p0: s32[8]) -> s32[8] {
  %p0 = s32[8]{0} parameter(0)
  ROOT %add.1 = s32[8]{0} add(%p0, %p0), metadata={op_name="jit(f)/slot_scan/add"}
}

ENTRY %main (a: s32[8], b: s32[8]) -> (s32[8], s32[8]) {
  %a = s32[8]{0} parameter(0)
  %b = s32[8]{0} parameter(1)
  %sort.3 = (s32[8]{0}, s32[8]{0}) sort(%a, %b), dimensions={0}, to_apply=%cmp, metadata={op_name="jit(f)/merge_sort/sort"}
  %fusion.2 = s32[8]{0} fusion(%a), kind=kLoop, calls=%fused_scan
  ROOT %cc = (s32[8]{0}, s32[8]{0}) custom-call(%a, %b), custom_call_target="__cub$DeviceRadixSort", metadata={op_name="jit(f)/emit_sort1/sort"}
}
"""


def test_hlo_instructions_scopes_and_kernels():
    instrs = hlo_instructions(HLO)
    assert instrs["sort.3"]["opcode"] == "sort"
    assert instrs["sort.3"]["scope"] == "merge_sort"
    # A fusion without metadata takes the scope of the computation it calls.
    assert instrs["fusion.2"]["scope"] == "slot_scan"
    assert instrs["cc"]["target"] == "__cub$DeviceRadixSort"
    assert instrs["cc"]["scope"] == "emit_sort1"


def test_reduce_cpu_trace_of_pipeline_step(tmp_path):
    r1, r2 = table_pair(4000, 0, "unique")
    cfg = dataclasses.replace(
        headline_config(headline_predicate(4000, "unique")), narrow_keys=True, narrow_data=True
    )
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    step = jax.jit(functools.partial(pipeline_core, config=cfg)).lower(t1, t2).compile()
    jax.block_until_ready(step(t1, t2))
    with device_trace(str(tmp_path)):
        jax.block_until_ready(step(t1, t2))
    (path,) = glob.glob(os.path.join(tmp_path, "**", "*.xplane.pb"), recursive=True)
    rep = reduce_trace(
        jax.profiler.ProfileData.from_file(path).planes, step.as_text(), "/host:CPU"
    )
    assert set(SCOPES) <= set(rep["scope_ms"])
    assert all(rep["scope_ms"][s] > 0 for s in SCOPES)
    assert {s["scope"] for s in rep["sorts"]} >= {"merge_sort", "emit_sort1", "emit_sort2"}
    assert 0 < rep["busy_ms"] <= rep["window_ms"]
