"""Command-line interface.

The runtime-configurable replacement for the reference's compile-time
workflow (edit user.h -> make -> ./app data1 data2, README.md:54-61 and
run.py:1-25): one binary, all knobs as flags.

Subcommands:
  run        -- execute the pipeline on two CSVs, write result CSV
  generate   -- create benchmark table pairs (generate_data.py analog)
  bench      -- run the headline benchmark and print the JSON metric line
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_run_parser(sub):
    p = sub.add_parser("run", help="run the filter/sort/join pipeline")
    p.add_argument("table1")
    p.add_argument("table2")
    p.add_argument("-o", "--output", default="result.csv")
    p.add_argument("--select-col1", type=int, default=0)
    p.add_argument("--select-op1", default=">")
    p.add_argument("--select-val1", type=int, default=5000)
    p.add_argument("--select-col2", type=int, default=0)
    p.add_argument("--select-op2", default=">")
    p.add_argument("--select-val2", type=int, default=5000)
    p.add_argument("--join-key1", type=int, default=0)
    p.add_argument("--join-key2", type=int, default=0)
    p.add_argument("--join-mode", choices=["one_to_one", "inner"], default="one_to_one")
    p.add_argument(
        "--join-algorithm", choices=["sort_merge", "hash"], default="sort_merge"
    )
    p.add_argument(
        "--distributed",
        action="store_true",
        help="shard over all available devices (mesh over axis 'p')",
    )
    p.add_argument(
        "--simulator",
        type=int,
        metavar="N",
        default=None,
        help="run on N virtual CPU devices (no GPU needed)",
    )
    p.add_argument(
        "--dtype",
        choices=["int64", "uint64", "int32", "float64"],
        default="int64",
        help="element type (reference T modes + narrow int32, common.h:1-9)",
    )
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument(
        "--narrow-keys",
        action="store_true",
        help="sort the join's merge pass on int32 keys (requires every "
        "join-key value to fit int32; validated at ingest)",
    )
    p.add_argument("--metrics", action="store_true", help="print stage metrics JSON")
    p.add_argument(
        "--debug",
        action="store_true",
        help="emit per-stage structured debug events (rows in/out, bytes, "
        "overflow headroom) to stderr -- the reference's DEBUG mode "
        "(user.h:1, app.c:294-305) as a runtime flag",
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="capture a jax.profiler device trace of the run into DIR "
        "(view in TensorBoard/Perfetto; the dpu-profiling analog)",
    )


def _add_generate_parser(sub):
    p = sub.add_parser("generate", help="generate benchmark table pairs")
    p.add_argument("rows", type=int)
    p.add_argument("--cols", type=int, default=4)
    p.add_argument("--out1", default="data1.csv")
    p.add_argument("--out2", default="data2.csv")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--keys", choices=["unique", "uniform", "zipf"], default="unique"
    )


def _cmd_run(args) -> int:
    if args.simulator:
        from pim_sort_merge_join_tpu.runner.simulator import use_simulator

        use_simulator(args.simulator)
    from pim_sort_merge_join_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from pim_sort_merge_join_tpu.config import EngineConfig, Predicate

    if args.debug:
        from pim_sort_merge_join_tpu.engine.logging import configure

        configure()

    config = EngineConfig(
        predicate1=Predicate(args.select_col1, args.select_op1, args.select_val1),
        predicate2=Predicate(args.select_col2, args.select_op2, args.select_val2),
        join_key1=args.join_key1,
        join_key2=args.join_key2,
        join_mode=args.join_mode,
        join_algorithm=args.join_algorithm,
        dtype=args.dtype,
        checkpoint_dir=args.checkpoint_dir,
        # --narrow-keys forces the narrowing on (with ingest validation);
        # without it the engine's "auto" probe decides per query.
        narrow_keys=True if args.narrow_keys else "auto",
        debug_log=args.debug,
    )
    import contextlib

    trace_cm = contextlib.nullcontext()
    if args.profile:
        from pim_sort_merge_join_tpu.engine.profiling import device_trace

        trace_cm = device_trace(args.profile)

    with trace_cm:
        if args.distributed:
            from pim_sort_merge_join_tpu.columnar import csv_io
            from pim_sort_merge_join_tpu.engine.distributed import (
                DistributedQueryPipeline,
            )

            pipe = DistributedQueryPipeline(config)
            rows1 = csv_io.load_csv_numpy(args.table1)
            rows2 = csv_io.load_csv_numpy(args.table2)
            out = pipe.run_arrays(rows1, rows2)
            result = out.to_numpy()
            csv_io.write_csv(args.output, result)
            n = result.shape[0]
        else:
            from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline

            pipe = QueryPipeline(config)
            result_t = pipe.run_csv(args.table1, args.table2, args.output)
            n = int(result_t.num_rows)
    print(f"wrote {n} rows to {args.output}", file=sys.stderr)
    if args.profile:
        print(f"device trace captured under {args.profile}", file=sys.stderr)
    if args.metrics:
        print(pipe.metrics_json())
    return 0


def _cmd_generate(args) -> int:
    from pim_sort_merge_join_tpu.columnar.generate import write_table_pair

    write_table_pair(
        args.out1,
        args.out2,
        args.rows,
        seed=args.seed,
        num_cols=args.cols,
        key_distribution=args.keys,
    )
    print(f"wrote {args.rows}-row pair to {args.out1}, {args.out2}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="smj-tpu", description="sort/merge-join query engine on JAX"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_run_parser(sub)
    _add_generate_parser(sub)
    sub.add_parser("bench", help="run the headline benchmark")
    args = parser.parse_args(argv)
    if args.cmd == "run":
        return _cmd_run(args)
    if args.cmd == "generate":
        return _cmd_generate(args)
    if args.cmd == "bench":
        import runpy

        runpy.run_path("bench.py", run_name="__main__")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
