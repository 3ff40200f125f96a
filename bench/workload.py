"""The headline workload that chip_smoke.py and bench/stage_trace.py drive.

Two tables from `columnar/generate.py` (seeds ``seed`` and ``seed + 1``)
and the predicate ``col > 3N/20`` on both (bench.py's headline query).
"""

from __future__ import annotations


def table_pair(rows: int, seed: int, keys: str):
    """Two ``rows``-row int64 tables with ``keys`` key distribution."""
    from pim_sort_merge_join_tpu.columnar.generate import generate_table

    return (
        generate_table(rows, seed=seed, key_distribution=keys),
        generate_table(rows, seed=seed + 1, key_distribution=keys),
    )


def headline_predicate(rows: int, keys: str) -> tuple:
    """``col > 3N/20`` as (col, op, value). Zipf tables filter on the
    uniform column 2, so the heavy low keys survive the filter."""
    return (0 if keys == "unique" else 1, ">", (3 * rows) // 20)


def headline_config(pred: tuple, **kw):
    """An EngineConfig applying ``pred`` to both tables."""
    from pim_sort_merge_join_tpu.config import EngineConfig, Predicate

    return EngineConfig(predicate1=Predicate(*pred), predicate2=Predicate(*pred), **kw)
