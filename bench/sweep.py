"""Size-sweep benchmark harness.

The machine-readable replacement for the reference's `test/run.sh:1-31`
(7 dataset sizes x {cpu_app, app}, output parsed by eye): sweeps row counts,
runs the numpy-oracle CPU pipeline and the device pipeline on identical
inputs, validates outputs, and emits one JSON line per (size, engine) pair.

Run: python -m bench.sweep [--sizes 10000,100000,...] [--skip-cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

DEFAULT_SIZES = [10_000, 100_000, 200_000, 300_000, 500_000, 700_000, 1_000_000]


def run_sweep(sizes, *, skip_cpu=False, reps=5, key_distribution="unique"):
    import functools

    import jax

    import pim_sort_merge_join_tpu as smj
    from bench.timing import opaque_zero, time_chained_ms
    from pim_sort_merge_join_tpu.columnar.generate import generate_table
    from pim_sort_merge_join_tpu.columnar.table import Table
    from pim_sort_merge_join_tpu.engine.pipeline import pipeline_core
    from pim_sort_merge_join_tpu.ops import oracle

    records = []
    pending_checks = []
    platform = jax.devices()[0].platform
    for n in sizes:
        rows1 = generate_table(n, seed=1, key_distribution=key_distribution)
        rows2 = generate_table(n, seed=2, key_distribution=key_distribution)
        thr = (3 * n) // 100  # keep ~97% of rows, like the reference's 5000/3N
        pred = (0, ">", thr)
        cfg = smj.EngineConfig(
            predicate1=smj.Predicate(*pred), predicate2=smj.Predicate(*pred)
        ).resolve_narrow(rows1[:, 0], rows2[:, 0])

        want_rows = None
        if not skip_cpu:
            t0 = time.perf_counter()
            want = oracle.pipeline_oracle(rows1, rows2, pred1=pred, pred2=pred)
            cpu_ms = (time.perf_counter() - t0) * 1000
            want_rows = want.shape[0]
            records.append(
                {"engine": "cpu_oracle", "rows": n, "wall_ms": round(cpu_ms, 3),
                 "out_rows": want_rows}
            )
            print(json.dumps(records[-1]), flush=True)

        t1 = Table.from_numpy(rows1)
        t2 = Table.from_numpy(rows2)
        jax.block_until_ready((t1.data, t2.data))
        fn = jax.jit(functools.partial(pipeline_core, config=cfg))
        out = fn(t1, t2)  # correctness run (validated below)

        def body(carry, a, b, cfg=cfg):
            import jax.numpy as jnp

            ap = a.replace(num_rows=a.num_rows + opaque_zero(carry))
            res = pipeline_core(ap, b, config=cfg)
            # data[0,0] forces the emit stage; num_rows alone lets XLA
            # eliminate it inside the loop as dead code.
            return carry + res.num_rows + res.data[0, 0].astype(jnp.int32)

        med_ms = time_chained_ms(body, t1, t2, k1=1, k2=5, reps=reps)
        # Under heavy host load the slope can clamp to 0.0 (t(k2) <= t(k1)
        # within noise); report the throughput as null instead of dividing
        # by zero -- the smoke test only checks structure, not numbers.
        rec = {
            "engine": "device",
            "platform": platform,
            "rows": n,
            "wall_ms": round(med_ms, 3),
            "rows_per_s": round(2 * n / (med_ms / 1000)) if med_ms > 0 else None,
        }
        records.append(rec)
        print(json.dumps(rec), flush=True)
        if want_rows is not None:
            pending_checks.append((n, out.num_rows, want_rows))
    # Deferred row-count validation, after all timing.
    for n, got_rows, want_rows in pending_checks:
        assert int(got_rows) == want_rows, (
            f"row-count mismatch at n={n}: {int(got_rows)} != {want_rows}"
        )
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=",".join(map(str, DEFAULT_SIZES)))
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--keys", default="unique",
                    choices=["unique", "uniform", "zipf"])
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")]
    run_sweep(sizes, skip_cpu=args.skip_cpu, reps=args.reps,
              key_distribution=args.keys)
    return 0


if __name__ == "__main__":
    sys.exit(main())
