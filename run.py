"""Side-by-side launcher: CPU oracle vs the engine on the same inputs.

The analog of the reference's `run.py:1-25` (make -> ./cpu_app -> ./app):
runs the numpy oracle pipeline (the cpu_app equivalent) and the device
pipeline on the same CSV pair, prints both timings, and -- unlike the
reference, which left output comparison to the user's eyeballs
(README.md:63-64) -- verifies the outputs match before reporting.

Usage: python run.py [data1.csv data2.csv [result.csv]]
Without inputs it first writes a 100k-row pair (data1.csv, data2.csv) with
the reference generator's distribution, from a fixed seed.
"""

import sys
import time


def main() -> int:
    if len(sys.argv) > 2:
        d1, d2 = sys.argv[1], sys.argv[2]
    else:
        from pim_sort_merge_join_tpu.columnar.generate import write_table_pair

        d1, d2 = "data1.csv", "data2.csv"
        write_table_pair(d1, d2, 100_000, seed=1)
    out = sys.argv[3] if len(sys.argv) > 3 else "result.csv"

    import numpy as np

    import pim_sort_merge_join_tpu as smj
    from pim_sort_merge_join_tpu.columnar import csv_io
    from pim_sort_merge_join_tpu.ops import oracle

    rows1 = csv_io.load_csv_numpy(d1)
    rows2 = csv_io.load_csv_numpy(d2)

    print("######### CPU oracle #########")
    t0 = time.perf_counter()
    want = oracle.pipeline_oracle(rows1, rows2)
    cpu_ms = (time.perf_counter() - t0) * 1000
    print(f"rows: {want.shape[0]}   exec time: {cpu_ms:.1f} ms")

    import jax

    print(f"######### engine on {jax.devices()[0].device_kind} #########")
    pipe = smj.QueryPipeline(smj.EngineConfig())
    result = pipe.run_csv(d1, d2, out)
    got = result.to_numpy()
    stages = {s.name: s.wall_s * 1000 for s in pipe.metrics.stages}
    for name, ms in stages.items():
        print(f"{name:>16}: {ms:.1f} ms")
    print(f"{'total':>16}: {sum(stages.values()):.1f} ms")

    if np.array_equal(got, want):
        print(f"OUTPUT MATCH: {got.shape[0]} rows -> {out}")
        return 0
    print("OUTPUT MISMATCH between oracle and engine!", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
