"""Headline benchmark: the reference workload on one NVIDIA GPU.

Runs the reference's own benchmark pipeline -- two 100k-row tables generated
from a seed with the reference generator's distribution (filter col1>5000,
sort by col1, 1:1 merge join; the workload timed in BASELINE.md) -- on the
GPU, and reports steady-state device execution time against the
reference's published total (37,897.143 ms, NR_DPUS=64 / NR_TASKLETS=16 /
CACHE_SIZE=256 on the UPMEM functional simulator; BASELINE.md table 1).

Timing uses the serial-chain slope protocol in `bench/timing.py`: the
per-iteration device time is the slope between two chain lengths of a
data-dependent `fori_loop`, so dispatch and readback cancel.

Exits non-zero when JAX finds no GPU. Prints the card's name and power
limit on a line of its own, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N}
vs_baseline is the speedup factor (reference_ms / ours_ms; higher is better).
"""

import json
import sys

import numpy as np

REF_TOTAL_MS = 37897.143  # BASELINE.md: 100k rows, CPU->DPU + DPU + DPU->CPU


def main():
    import functools

    import jax

    from pim_sort_merge_join_tpu.utils.compile_cache import enable_compile_cache
    from pim_sort_merge_join_tpu.utils.gpu import card_info, require_gpu

    require_gpu(1)
    enable_compile_cache()
    print(f"# card: {card_info()}", flush=True)

    import pim_sort_merge_join_tpu as smj
    from bench.timing import opaque_zero, time_chained_ms
    from pim_sort_merge_join_tpu.columnar.generate import generate_table
    from pim_sort_merge_join_tpu.columnar.table import Table
    from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core

    rows1 = generate_table(100_000, seed=1)
    rows2 = generate_table(100_000, seed=2)
    # Resolve narrow_keys="auto" exactly as QueryPipeline.run_csv would:
    # the reference generator's keys are <= 3N (generate_data.py:9), so the
    # default path takes the int32 merge-sort keys.
    config = (
        smj.EngineConfig()
        .resolve_narrow(rows1[:, 0], rows2[:, 0])
        .resolve_narrow_data(rows1, rows2)
    )

    dtype = config.jnp_dtype()
    t1 = Table.from_numpy(rows1, dtype=dtype)
    t2 = Table.from_numpy(rows2, dtype=dtype)
    jax.block_until_ready((t1.data, t2.data))

    core = functools.partial(pipeline_core, config=config)

    # Correctness readback first (row count survives to the final report).
    out = jax.jit(core)(t1, t2)
    expect_rows = int(out.num_rows)
    assert expect_rows > 0, "join produced no rows -- benchmark invalid"

    import jax.numpy as jnp

    def body(carry, a, b):
        # opaque_zero keeps each iteration data-dependent on the last so
        # XLA cannot hoist or overlap the pipeline across iterations.
        ap = a.replace(num_rows=a.num_rows + opaque_zero(carry))
        res = core(ap, b)
        # Fold an element of the DATA into the carry, not just the row
        # count: a body that consumes only num_rows lets XLA dead-code-
        # eliminate the join's emit stage inside the loop.
        return carry + res.num_rows + res.data[0, 0].astype(jnp.int32)

    # Long chains (200 iterations of signal between the two lengths): one
    # 100k-row iteration is short, so short chains drown in host jitter.
    # Median of 3 independent slopes.
    runs = [
        time_chained_ms(body, t1, t2, k1=10, k2=210, reps=5) for _ in range(3)
    ]
    value = sorted(runs)[1]

    # 10M-row companion figure: 100x more device work per iteration than
    # the 100k workload, reported in the same JSON line.
    n10 = 10_000_000
    r1b = generate_table(n10, seed=1)
    r2b = generate_table(n10, seed=2)
    thr = (3 * n10) // 20
    cfg10 = (
        smj.EngineConfig(
            predicate1=smj.Predicate(0, ">", thr),
            predicate2=smj.Predicate(0, ">", thr),
        )
        .resolve_narrow(r1b[:, 0], r2b[:, 0])
        .resolve_narrow_data(r1b, r2b)
    )
    core10 = functools.partial(pipeline_core, config=cfg10)
    t1b = Table.from_numpy(r1b, dtype=dtype)
    t2b = Table.from_numpy(r2b, dtype=dtype)
    del r1b, r2b
    jax.block_until_ready((t1b.data, t2b.data))

    def body10(carry, a, b):
        ap = a.replace(num_rows=a.num_rows + opaque_zero(carry))
        res = core10(ap, b)
        return carry + res.num_rows + res.data[0, 0].astype(jnp.int32)

    runs10 = [
        time_chained_ms(body10, t1b, t2b, k1=1, k2=4, reps=3) for _ in range(3)
    ]
    value10 = sorted(runs10)[1]

    print(
        json.dumps(
            {
                "metric": "sort_merge_join_pipeline_100k_rows",
                "value": round(value, 3),
                "unit": "ms",
                "vs_baseline": round(REF_TOTAL_MS / value, 1),
                "pipeline_10m_ms": round(value10, 1),
                "pipeline_10m_rows_per_s": round(2 * n10 / (value10 / 1e3)),
            }
        )
    )
    print(
        f"# device={jax.devices()[0].device_kind} joined_rows={expect_rows} "
        f"chained-slope timing (bench/timing.py) "
        f"reference_total={REF_TOTAL_MS}ms 10M-row figure: full "
        f"materialization, median of 3 slopes",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
