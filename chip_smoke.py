"""End-to-end smoke run of the engine on NVIDIA GPUs.

Drives the main path once through the entry points a user calls, at the
README's headline scale, and checks every result exactly against the numpy
oracle (`ops/oracle.py`). The data are integers, only compared and moved,
so every comparison is exact equality.

Phases (one card):

  1. the reference workload, 100k rows/table, through
     `QueryPipeline.run_csv`, byte-compared with an oracle-written CSV;
  2. 10M rows/table (``--rows``), int64, unique keys, predicate
     ``col1 > 3N/20``, through `QueryPipeline.run_tables`; prints the step's
     `memory_analysis()` and times the step with ``narrow_data`` forced on
     and off, in turns;
  3. the same with Zipf keys, whose long equal-key runs exercise the
     duplicate path of the 1:1 slot scan;
  4. 1M rows/table through the other modes users reach: inner join, hash
     join, and a checkpointed run followed by a resume.

``--four`` runs only the four-card path: `DistributedQueryPipeline` over a
4-card mesh at ``--rows`` rows per card, unique and Zipf keys, compared with
the oracle and with a one-card run of the same input on device 0.

Each phase prints one line (row counts, wall times with compilation
reported apart, ``peak_bytes_in_use``). Phases 2-3 compile the step ahead of
time and say whether the persistent compilation cache had it; elsewhere the
compile share is the first call less a warm one. The last line of standard
output is one JSON object naming the device. With no GPU the script exits
non-zero before any phase and prints no result.

Run:  python chip_smoke.py [--rows N] [--seed S] [--four]
"""

from __future__ import annotations

import argparse
import collections
import functools
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

from bench.workload import headline_config, headline_predicate, table_pair

SMALL_ROWS = 1_000_000
REFERENCE_ROWS = 100_000


def _compile(lowered_fn):
    """Time ``lowered_fn().compile()``; returns (compiled, seconds, cache),
    cache being "hit" or "miss" in the persistent compilation cache, or
    "off" when no cache directory is set."""
    import jax

    seen = collections.Counter()

    def listen(event: str, **_) -> None:
        seen[event] += 1

    jax.monitoring.register_event_listener(listen)
    try:
        compiled, seconds = _timed(lambda: lowered_fn().compile())
    finally:
        jax.monitoring.unregister_event_listener(listen)
    cache = (
        "hit" if seen["/jax/compilation_cache/cache_hits"]
        else "miss" if seen["/jax/compilation_cache/compile_requests_use_cache"]
        else "off"
    )
    return compiled, seconds, cache


def _peak_bytes(device=None) -> str:
    """Peak device bytes in use so far in this process (not per phase)."""
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return "n/a" if not stats else str(stats.get("peak_bytes_in_use", "n/a"))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _check_equal(name: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(
            f"{name}: got {got.shape} {got.dtype}, oracle {want.shape} {want.dtype}"
        )
    if not np.array_equal(got, want):
        bad = int(np.argmax((got != want).any(axis=1)))
        raise AssertionError(
            f"{name}: first differing row {bad}: {got[bad]} vs oracle {want[bad]}"
        )


def _check_rank_routed(name: str, got: np.ndarray, want: np.ndarray, counts) -> int:
    """Mesh output whose heavy keys were routed by occurrence rank, vs the
    oracle's key-ordered output, row order included.

    The skew design (exchange/skew.py) sends the pair of occurrence rank r
    of a heavy key to card r % P and every other key whole to its range
    card, and each card emits in key order, equal keys by rank. So: the rows
    are the oracle's multiset; each card's block is a subsequence of the
    oracle's output; and a key whose rows lie on several cards has its
    rank-r row on card r % P. Returns the number of such spread keys.
    """
    counts = np.asarray(counts)
    og, ow = np.lexsort(got.T[::-1]), np.lexsort(want.T[::-1])
    _check_equal(f"{name} (row multiset)", got[og], want[ow])
    pos = np.empty(len(got), np.int64)
    pos[og] = ow  # got[i] is the oracle's row pos[i]
    in_order = np.diff(pos) > 0
    bounds = np.cumsum(counts)[:-1]
    in_order[bounds[(bounds > 0) & (bounds < len(got))] - 1] = True
    if not in_order.all():
        bad = int(np.argmin(in_order))
        raise AssertionError(f"{name}: card output out of oracle order at row {bad + 1}")
    card = np.repeat(np.arange(len(counts)), counts)
    keys = want[:, 0]
    rank = (np.arange(len(want)) - np.searchsorted(keys, keys, side="left"))[pos]
    key_card = np.unique(np.stack([got[:, 0], card]), axis=1)
    spread, n_cards = np.unique(key_card[0], return_counts=True)
    spread = spread[n_cards > 1]
    on_spread = np.isin(got[:, 0], spread)
    if not np.array_equal(card[on_spread], rank[on_spread] % len(counts)):
        raise AssertionError(f"{name}: a spread key's row is not on card rank % P")
    return len(spread)


def phase_reference_csv(workdir: str, *, rows: int = REFERENCE_ROWS, seed: int = 0) -> dict:
    """Phase 1: the reference workload through run_csv, byte-exact."""
    from pim_sort_merge_join_tpu.columnar import csv_io
    from pim_sort_merge_join_tpu.config import EngineConfig
    from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
    from pim_sort_merge_join_tpu.native import csv_native
    from pim_sort_merge_join_tpu.ops import oracle

    r1, r2 = table_pair(rows, seed, "unique")
    p1, p2 = os.path.join(workdir, "data1.csv"), os.path.join(workdir, "data2.csv")
    out = os.path.join(workdir, "result.csv")
    csv_io.write_csv(p1, r1)
    csv_io.write_csv(p2, r2)
    pipe = QueryPipeline(EngineConfig())
    res, first_s = _timed(lambda: pipe.run_csv(p1, p2, out))
    n_first = len(pipe.metrics.stages)
    res, warm_s = _timed(lambda: pipe.run_csv(p1, p2, out))
    stages = {m.name: round(m.wall_s, 6) for m in pipe.metrics.stages[n_first:]}
    want = io.StringIO()
    csv_io.write_csv(want, oracle.pipeline_oracle(r1, r2))
    with open(out, "rb") as f:
        got = f.read()
    if got != want.getvalue().encode():
        raise AssertionError("phase 1: result.csv differs from the oracle's CSV")
    native = csv_native.available()
    print(
        f"phase 1 reference_csv: {rows}+{rows} rows -> {int(res.num_rows)} rows, "
        f"byte-exact; first call {first_s:.3f} s (of which compile and parser "
        f"build ~{first_s - warm_s:.3f} s), warm call {warm_s:.4f} s {stages}; "
        f"native CSV parser "
        f"{'built and used' if native else 'unavailable, numpy path used'}; "
        f"peak_bytes_in_use {_peak_bytes()}",
        flush=True,
    )
    return {"rows_out": int(res.num_rows), "warm_s": warm_s, "native_csv": native}


def phase_tables(rows: int, *, seed: int = 0, keys: str = "unique", ab_reps: int = 0) -> dict:
    """Phases 2-3: ``rows`` per table through run_tables, exact vs the oracle.

    ``ab_reps`` > 0 also times the step with narrow_data forced on and off,
    alternating which goes first, ``ab_reps`` times each.
    """
    import jax

    from pim_sort_merge_join_tpu.columnar.table import Table
    from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline, pipeline_core
    from pim_sort_merge_join_tpu.ops import oracle

    (r1, r2), gen_s = _timed(lambda: table_pair(rows, seed, keys))
    pred = headline_predicate(rows, keys)
    cfg = headline_config(pred)
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    jax.block_until_ready((t1, t2))

    # Compile the step run_tables will run, before its first call, so that
    # compile time is reported apart: narrow_* resolved from the host arrays
    # here decide as run_tables' device probe does (checked below).
    resolved = cfg.resolve_narrow(
        r1[:, cfg.join_key1], r2[:, cfg.join_key2]
    ).resolve_narrow_data(r1, r2)
    nk, nd = resolved.narrow_keys, resolved.narrow_data
    step = jax.jit(functools.partial(pipeline_core, config=resolved))
    compiled, compile_s, cache = _compile(lambda: step.lower(t1, t2))
    mem = compiled.memory_analysis()
    mem_txt = {
        k: getattr(mem, k)
        for k in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes")
        if mem is not None and hasattr(mem, k)
    }

    pipe = QueryPipeline(cfg)
    res, first_s = _timed(lambda: pipe.run_tables(t1, t2))
    res, warm_s = _timed(lambda: pipe.run_tables(t1, t2))
    if (pipe.resolved_narrow_keys, pipe.resolved_narrow_data) != (nk, nd):
        raise AssertionError(
            f"run_tables resolved narrow_keys={pipe.resolved_narrow_keys} "
            f"narrow_data={pipe.resolved_narrow_data}, host probe {nk}/{nd}"
        )
    got = res.to_numpy()
    want, oracle_s = _timed(lambda: oracle.pipeline_oracle(r1, r2, pred1=pred, pred2=pred))
    _check_equal(f"{keys} {rows}", got, want)
    print(
        f"phase {keys} run_tables: {rows}+{rows} rows -> {got.shape[0]} rows, "
        f"exact; narrow_keys={nk} narrow_data={nd}; generate {gen_s:.2f} s, "
        f"oracle {oracle_s:.2f} s; compile {compile_s:.2f} s (persistent cache "
        f"{cache}); first call {first_s:.3f} s (run + "
        f"{'cache load' if cache != 'off' else 'compile'}), warm call "
        f"{warm_s:.4f} s; memory_analysis {mem_txt}; peak_bytes_in_use "
        f"{_peak_bytes()}",
        flush=True,
    )
    out = {"rows_out": got.shape[0], "warm_s": warm_s, "narrow_data": nd}
    if ab_reps:
        times = {True: [], False: []}
        for flag in (True, False):  # warm both executables first
            alt = pipe.run_tables(t1, t2, narrow=nk, narrow_data=flag)
            _check_equal(f"{keys} {rows} narrow_data={flag}", alt.to_numpy(), want)
        for i in range(ab_reps):
            for flag in ((True, False) if i % 2 == 0 else (False, True)):
                _, dt = _timed(lambda: pipe.run_tables(t1, t2, narrow=nk, narrow_data=flag))
                times[flag].append(dt)
        med = {f: float(np.median(v)) for f, v in times.items()}
        print(
            f"phase {keys} narrow_data A/B ({ab_reps} turns each): on median "
            f"{med[True]:.5f} s {[round(t, 5) for t in times[True]]}; off median "
            f"{med[False]:.5f} s {[round(t, 5) for t in times[False]]}",
            flush=True,
        )
        out["ab_median_s"] = med
    return out


def phase_modes(workdir: str, *, rows: int = SMALL_ROWS, seed: int = 0) -> dict:
    """Phase 4: inner join, hash join, and checkpointed run + resume."""
    from pim_sort_merge_join_tpu.columnar.table import Table
    from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
    from pim_sort_merge_join_tpu.ops import oracle

    pred = headline_predicate(rows, "unique")
    report = {}

    # Inner join on uniform keys: duplicates on both sides, so cross products.
    r1, r2 = table_pair(rows, seed, "uniform")
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    pipe = QueryPipeline(headline_config(pred, join_mode="inner"))
    _, first_s = _timed(lambda: pipe.run_tables(t1, t2))
    res, warm_s = _timed(lambda: pipe.run_tables(t1, t2))
    want = oracle.pipeline_oracle(r1, r2, pred1=pred, pred2=pred, mode="inner")
    _check_equal("inner", res.to_numpy(), want)
    report["inner"] = (want.shape[0], first_s, warm_s)

    # Hash join, 1:1, unique keys: output follows table-1 filtered-row order.
    r1, r2 = table_pair(rows, seed, "unique")
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    pipe = QueryPipeline(headline_config(pred, join_algorithm="hash"))
    _, first_s = _timed(lambda: pipe.run_tables(t1, t2))
    res, warm_s = _timed(lambda: pipe.run_tables(t1, t2))
    want = oracle.pipeline_oracle(r1, r2, pred1=pred, pred2=pred)
    f1_keys = oracle.filter_oracle(r1, *pred)[:, 0]
    row_of_key = np.argsort(f1_keys, kind="stable")[
        np.searchsorted(np.sort(f1_keys), want[:, 0])
    ]
    _check_equal("hash", res.to_numpy(), want[np.argsort(row_of_key, kind="stable")])
    report["hash"] = (want.shape[0], first_s, warm_s)

    # Checkpointed run, then a fresh pipeline that resumes from the checkpoint.
    cfg = headline_config(pred, checkpoint_dir=os.path.join(workdir, "ckpt"))
    res, first_s = _timed(lambda: QueryPipeline(cfg).run_tables_resumable(t1, t2))
    _check_equal("resumable run", res.to_numpy(), want)
    resumer = QueryPipeline(cfg)
    res, resume_s = _timed(lambda: resumer.run_tables_resumable(t1, t2))
    stages = [m.name for m in resumer.metrics.stages]
    if "filter_sort" in stages:
        raise AssertionError(f"resume re-ran the checkpointed stage: {stages}")
    _check_equal("resumed run", res.to_numpy(), want)
    report["resumable"] = (want.shape[0], first_s, resume_s)
    parts = "; ".join(
        f"{name} {n} rows exact, first {a:.3f} s "
        + (f"(compile + run), resume {b:.4f} s" if name == "resumable"
           else f"(of which compile ~{a - b:.3f} s), warm {b:.4f} s")
        for name, (n, a, b) in report.items()
    )
    print(
        f"phase 4 modes: {rows}+{rows} rows; {parts}; peak_bytes_in_use {_peak_bytes()}",
        flush=True,
    )
    return report


def phase_four(rows_per_card: int, *, seed: int = 0, devices=None) -> dict:
    """The 4-card path: mesh run vs oracle and vs a one-card run on device 0.

    Unique keys must match byte for byte. With Zipf keys the default skew
    handling routes heavy keys by occurrence rank, which by design gives up
    the global key order (engine/distributed.py): the one-card run must
    match the oracle byte for byte, and the mesh output the order that
    design promises (`_check_rank_routed`).
    """
    import jax
    from jax.sharding import Mesh

    from pim_sort_merge_join_tpu.columnar.table import Table
    from pim_sort_merge_join_tpu.engine.distributed import DistributedQueryPipeline
    from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline
    from pim_sort_merge_join_tpu.ops import oracle

    devices = list(devices if devices is not None else jax.devices()[:4])
    mesh = Mesh(np.array(devices), ("p",))
    rows = rows_per_card * len(devices)
    report = {}
    for keys in ("unique", "zipf"):
        r1, r2 = table_pair(rows, seed, keys)
        pred = headline_predicate(rows, keys)
        cfg = headline_config(pred)
        dpipe = DistributedQueryPipeline(cfg, mesh)
        _, first_s = _timed(lambda: dpipe.run_arrays(r1, r2))
        out, warm_s = _timed(lambda: dpipe.run_arrays(r1, r2))
        got = out.to_numpy()
        per_card = {
            str(s.device): int(np.asarray(s.data).sum())
            for s in out.counts.addressable_shards
        }
        with jax.default_device(devices[0]):
            t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
            one, one_s = _timed(lambda: QueryPipeline(cfg).run_tables(t1, t2))
        single = one.to_numpy()
        want = oracle.pipeline_oracle(r1, r2, pred1=pred, pred2=pred)
        _check_equal(f"four {keys}: one card vs oracle", single, want)
        spread = 0
        if keys == "unique":
            _check_equal(f"four {keys} vs oracle", got, want)
            if got.tobytes() != single.tobytes():
                raise AssertionError("four unique: mesh output bytes differ from one card")
        else:
            spread = _check_rank_routed(f"four {keys}", got, want, out.counts)
        fair = got.shape[0] / len(devices)
        if min(per_card.values()) < 0.25 * fair:
            raise AssertionError(f"four {keys}: exchange left a card nearly empty {per_card}")
        print(
            f"phase four {keys}: {len(devices)} cards x {rows_per_card} rows/table "
            f"-> {got.shape[0]} rows, equal to oracle and to one card ("
            f"{'bytes' if keys == 'unique' else f'rank-routed order, {spread} spread keys'}"
            f"); joined rows per "
            f"card {per_card}; mesh first call {first_s:.3f} s (of which compile "
            f"~{first_s - warm_s:.2f} s), warm {warm_s:.4f} s; one card first "
            f"call {one_s:.3f} s (compile + run); "
            f"peak_bytes_in_use per card "
            f"{[_peak_bytes(d) for d in devices]}",
            flush=True,
        )
        report[keys] = {"rows_out": got.shape[0], "per_card": per_card, "spread_keys": spread}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows per table in phases 2-3; rows per card with --four")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card distributed path and its comparisons")
    args = ap.parse_args(argv)

    from pim_sort_merge_join_tpu.utils.gpu import card_info, require_gpu

    devices = require_gpu(4 if args.four else 1)

    import jax

    from pim_sort_merge_join_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    for line in card_info().splitlines():
        print(f"card: {line}")
    print(f"jax {jax.__version__}; {len(jax.devices())} device(s): {devices[0].device_kind}",
          flush=True)

    if args.four:
        phase_four(args.rows, seed=args.seed, devices=devices)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            phase_reference_csv(workdir, seed=args.seed)
            phase_tables(args.rows, seed=args.seed, keys="unique", ab_reps=5)
            phase_tables(args.rows, seed=args.seed, keys="zipf")
            phase_modes(workdir, seed=args.seed)

    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
