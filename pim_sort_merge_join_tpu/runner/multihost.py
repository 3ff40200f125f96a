"""Multi-host entry point.

Scales the SPMD pipeline beyond one host (the BASELINE.json N>=2-hosts
configuration). One process drives all the GPUs of its host;
`jax.distributed.initialize` joins the processes of several hosts into one
global runtime, the mesh spans every device, and the same
`distributed_pipeline_core` program runs unchanged -- the all_to_all
exchange crosses NVLink between the cards of a host and the network
between hosts. A single host needs no initialization: `smj-tpu run
--distributed` meshes over its cards directly.

The reference has no multi-node story at all (its scale ceiling is 64 DPUs
on one host's memory bus, user.h:3).

Launch (one process per host; the coordinator address, process count and
process id must be given, nothing discovers them):

    python -m pim_sort_merge_join_tpu.runner.multihost \
        --coordinator <host0>:8476 --num-processes N --process-id $ID \
        data1.csv data2.csv -o result.csv
"""

from __future__ import annotations

import argparse
import sys


def initialize_multihost(
    coordinator: str | None,
    num_processes: int | None,
    process_id: int | None,
    cpu_devices: int | None = None,
) -> None:
    """Join the global JAX runtime. No-ops for single-process runs.

    ``cpu_devices`` forces the CPU backend with N local virtual devices --
    the multi-PROCESS simulator configuration (reference S3 analog): N
    processes x M virtual devices exercise real process boundaries, Gloo
    collectives, and the process-0-writes contract without a GPU.
    """
    import jax

    if cpu_devices:
        from pim_sort_merge_join_tpu.runner.simulator import use_simulator

        use_simulator(cpu_devices)
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def run_query(args) -> int:
    import jax
    import numpy as np

    from pim_sort_merge_join_tpu.columnar import csv_io
    from pim_sort_merge_join_tpu.config import EngineConfig, Predicate
    from pim_sort_merge_join_tpu.engine.distributed import (
        DistributedQueryPipeline,
        ShardedTable,
    )

    config = EngineConfig(
        predicate1=Predicate(args.select_col1, ">", args.select_val1),
        predicate2=Predicate(args.select_col2, ">", args.select_val2),
        join_key1=args.join_key1,
        join_key2=args.join_key2,
        exchange_slack=args.exchange_slack,
        exchange_chunks=args.exchange_chunks,
        checkpoint_dir=args.checkpoint_dir,
    )
    pipe = DistributedQueryPipeline(config)

    # Scale-out ingest: each process parses ONLY its byte range of the
    # CSVs (csv_io.load_csv_shard) and contributes its rows in place --
    # the global table never materializes on any single host.
    pid, nproc = jax.process_index(), jax.process_count()
    rows1 = csv_io.load_csv_shard(args.table1, pid, nproc)
    rows2 = csv_io.load_csv_shard(args.table2, pid, nproc)
    t1 = ShardedTable.from_process_local(rows1, pipe.mesh, config.mesh_axis)
    t2 = ShardedTable.from_process_local(rows2, pipe.mesh, config.mesh_axis)

    if args.aggregate:
        # Distributed group-by aggregate over the mesh (the BASELINE
        # config-5 hash_aggregate analog), previously reachable only from
        # the Python API.
        out = pipe.run_aggregate(
            t1, key=args.agg_key, value=args.agg_value, agg=args.aggregate
        )
        result = out.to_numpy()
        if jax.process_index() == 0:
            csv_io.write_csv(args.output, result)
            print(
                f"wrote {result.shape[0]} aggregate rows to {args.output}",
                file=sys.stderr,
            )
            print(pipe.metrics_json())
        return 0

    if args.bench_reps:
        # Steady-state timing mode: warm up once (compile), then time whole
        # run_tables calls, each fenced by block_until_ready.
        import time as _time

        pipe.run_tables(t1, t2)
        times = []
        for _ in range(args.bench_reps):
            t0 = _time.perf_counter()
            pipe.run_tables(t1, t2)
            times.append((_time.perf_counter() - t0) * 1000.0)
        if jax.process_index() == 0:
            import json as _json

            print(
                _json.dumps(
                    {
                        "bench": "multihost_pipeline",
                        "exchange_chunks": config.exchange_chunks,
                        "processes": nproc,
                        "rows": int(rows1.shape[0]),
                        "times_ms": [round(t, 1) for t in times],
                        "median_ms": round(sorted(times)[len(times) // 2], 1),
                    }
                )
            )
        return 0

    if args.checkpoint_dir:
        # Exchange-boundary checkpointed execution: a rerun with the same
        # config + mesh resumes at the join (distributed
        # run_tables_resumable; every process calls it -- the gather is
        # collective, process 0 writes the files).
        resumed = pipe.checkpoint_stages()
        out = pipe.run_tables_resumable(t1, t2)
        print(f"checkpoint resumed_from={resumed}", file=sys.stderr)
    else:
        out = pipe.run_tables(t1, t2)

    # to_numpy replicates across processes (a collective): every process
    # participates, process 0 writes.
    result = out.to_numpy()
    if jax.process_index() == 0:
        csv_io.write_csv(args.output, result)
        print(f"wrote {result.shape[0]} rows to {args.output}", file=sys.stderr)
        # The narrow decision is made from a replicated device reduce, so
        # every process resolved the same value; print it for inspection.
        print(
            f"narrow_keys resolved={pipe.resolved_narrow_keys}", file=sys.stderr
        )
        print(pipe.metrics_json())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("table1")
    ap.add_argument("table2")
    ap.add_argument("-o", "--output", default="result.csv")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument(
        "--cpu-devices",
        type=int,
        default=None,
        help="force CPU backend with N virtual devices per process "
        "(multi-process simulator mode)",
    )
    ap.add_argument(
        "--checkpoint-dir",
        default=None,
        help="stage-boundary checkpoint directory (shared storage: process "
        "0 writes, all read); reruns resume after the last completed stage",
    )
    ap.add_argument("--exchange-slack", type=float, default=2.0)
    ap.add_argument("--exchange-chunks", type=int, default=4)
    ap.add_argument(
        "--aggregate",
        default=None,
        choices=["sum", "min", "max", "count"],
        help="instead of the join, run a distributed group-by aggregate "
        "on table1 (--agg-key by --agg-value)",
    )
    ap.add_argument("--agg-key", type=int, default=0)
    ap.add_argument("--agg-value", type=int, default=1)
    ap.add_argument(
        "--bench-reps",
        type=int,
        default=0,
        help="time N steady-state run_tables calls instead of writing output",
    )
    ap.add_argument("--select-col1", type=int, default=0)
    ap.add_argument("--select-val1", type=int, default=5000)
    ap.add_argument("--select-col2", type=int, default=0)
    ap.add_argument("--select-val2", type=int, default=5000)
    ap.add_argument("--join-key1", type=int, default=0)
    ap.add_argument("--join-key2", type=int, default=0)
    args = ap.parse_args(argv)
    initialize_multihost(
        args.coordinator, args.num_processes, args.process_id, args.cpu_devices
    )
    return run_query(args)


if __name__ == "__main__":
    sys.exit(main())
