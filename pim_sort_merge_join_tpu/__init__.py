"""Vectorized query-execution engine on JAX/XLA, run on NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of the UPMEM PIM
reference `5eoyeon/pim-sort-merge-join` (filter -> sort -> merge-join
relational pipeline):

- CSV-ingested columnar tables on device (`columnar/`)
- vectorized relational operators: selection, sort, sorted 1:1 merge-join,
  inner join, hash join, hash aggregate (`ops/`)
- distributed range/hash shuffle over a `jax.sharding.Mesh` with
  `shard_map` + `all_to_all` collectives (`exchange/`)
- the staged query pipeline with metrics, checkpointing and structured
  logging (`engine/`)
- single-chip / multi-chip / CPU-simulator entry points (`runner/`)

The reference's semantics contract (preserved exactly; see SURVEY.md section 7):
  filter keeps rows where col[SELECT_COL] > SELECT_VAL (strict >;
  select.c:31), tables sort ascending by join key, the join advances both
  cursors on key equality (1:1 semantics, join.c:160-173), and the output
  schema is table1 columns ++ table2 columns minus its join key
  (join.c:212-231), written as CSV with a col1..colN header (app.c:727-755).
"""

import jax

# The engine's contract dtype is int64 (reference `T`, common.h:1-9); without
# x64 JAX silently downcasts int64 arrays to int32, which would corrupt keys
# above 2^31. Enable it process-wide at import.
jax.config.update("jax_enable_x64", True)

from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.columnar import csv_io
from pim_sort_merge_join_tpu.ops import filter as filter_ops
from pim_sort_merge_join_tpu.ops import sort as sort_ops
from pim_sort_merge_join_tpu.ops import join as join_ops
from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "Predicate",
    "Table",
    "csv_io",
    "filter_ops",
    "sort_ops",
    "join_ops",
    "QueryPipeline",
    "__version__",
]
