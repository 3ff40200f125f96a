"""Where the device time of one fused pipeline step goes, from a profiler trace.

Builds chip_smoke.py's phase-2 inputs (`bench/workload.py`: ``--rows`` per
table, int64, unique keys, ``col1 > 3N/20``), warms the jitted step, traces
ONE step with `engine/profiling.device_trace`, and reduces the trace with
`jax.profiler.ProfileData`:

- kernel time per HLO instruction (the trace's ``hlo_op`` stat), attributed
  to the join's named scopes (merge_sort, slot_scan, unmerge_sort,
  emit_sort1, emit_sort2; ops/join.py) through the optimized HLO's
  ``op_name`` metadata;
- which kernel each of the four sorts became: XLA's own ``sort`` or a
  library ``custom-call`` (e.g. a CUB radix sort);
- the device's busy time and idle share over the step's window.

XLA on the GPU replays a step's kernels as one command buffer (CUDA graph),
which the trace shows as a single event; the script turns command buffers
off (``--xla_gpu_enable_command_buffer=``) so that each kernel appears with
its own time.

Run on a GPU:  python -m bench.stage_trace [--rows N] [--out FILE]
The full JSON report goes to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import glob
import json
import os
import re
import tempfile

SCOPES = ("merge_sort", "slot_scan", "unmerge_sort", "emit_sort1", "emit_sort2")
_COMPUTATION = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*.*?\s([\w\-]+)\(")
_OP_NAME = re.compile(r'op_name="([^"]+)"')
_TARGET = re.compile(r'custom_call_target="([^"]+)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_instructions(hlo_text: str) -> dict:
    """name -> {"opcode", "scope", "target", "line"} for the module's
    instructions (fused computations included). An instruction without
    scope metadata (e.g. a fusion) takes the commonest scope of the
    computation it calls."""
    out = {}
    comp_scopes = collections.defaultdict(collections.Counter)
    comp = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if not m:
            c = _COMPUTATION.match(line)
            if c:
                comp = c.group(1)
            continue
        name, opcode = m.groups()
        op_name = _OP_NAME.search(line)
        scope = "other"
        if op_name:
            parts = op_name.group(1).split("/")
            scope = next((s for s in SCOPES if s in parts), "other")
        if comp is not None and scope != "other":
            comp_scopes[comp][scope] += 1
        target = _TARGET.search(line)
        calls = _CALLS.search(line)
        out[name] = {
            "opcode": opcode,
            "scope": scope,
            "target": target.group(1) if target else None,
            "calls": calls.group(1) if calls else None,
            "line": line.strip()[:400],
        }
    for info in out.values():
        called = comp_scopes.get(info.pop("calls"))
        if info["scope"] == "other" and called:
            info["scope"] = called.most_common(1)[0][0]
    return out


def reduce_trace(planes, hlo_text: str, device_prefix: str = "/device:GPU:0") -> dict:
    """Per-scope and per-instruction kernel time of one traced step.

    ``planes`` are `ProfileData.planes`; kernel events are those carrying an
    ``hlo_op`` stat on the plane named ``device_prefix``.
    """
    instrs = hlo_instructions(hlo_text)
    per_op = collections.defaultdict(lambda: {"ns": 0.0, "count": 0, "kernels": set()})
    intervals = []
    for plane in planes:
        if not plane.name.startswith(device_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = stats.get("hlo_op")
                if op is None:
                    continue
                rec = per_op[op]
                rec["ns"] += ev.duration_ns
                rec["count"] += 1
                rec["kernels"].add(ev.name)
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)) if intervals else 0.0
    scopes = collections.defaultdict(float)
    ops = []
    for op, rec in per_op.items():
        info = instrs.get(op, {"opcode": "?", "scope": "other", "target": None, "line": ""})
        scopes[info["scope"]] += rec["ns"]
        ops.append({
            "hlo_op": op, "ms": rec["ns"] / 1e6, "launches": rec["count"],
            "scope": info["scope"], "opcode": info["opcode"], "target": info["target"],
            "kernels": sorted(rec["kernels"])[:4],
        })
    ops.sort(key=lambda r: -r["ms"])
    sorts = [
        {"scope": i["scope"], "hlo_op": name, "opcode": i["opcode"],
         "target": i["target"], "line": i["line"]}
        for name, i in instrs.items()
        if i["opcode"] == "sort" or "sort" in (i["target"] or "").lower()
    ]
    return {
        "busy_ms": busy / 1e6,
        "window_ms": window / 1e6,
        "idle_share": (1 - busy / window) if window else None,
        "scope_ms": {k: v / 1e6 for k, v in sorted(scopes.items())},
        "sorts": sorts,
        "ops": ops[:40],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the JSON report here")
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()

    from pim_sort_merge_join_tpu.utils.compile_cache import enable_compile_cache
    from pim_sort_merge_join_tpu.utils.gpu import card_info, require_gpu

    require_gpu(1)
    enable_compile_cache()
    card = card_info()
    print(f"card: {card}", flush=True)

    import jax

    from bench.workload import headline_config, headline_predicate, table_pair
    from pim_sort_merge_join_tpu.columnar.table import Table
    from pim_sort_merge_join_tpu.engine.pipeline import QueryPipeline, pipeline_core
    from pim_sort_merge_join_tpu.engine.profiling import device_trace

    r1, r2 = table_pair(args.rows, args.seed, "unique")
    cfg = headline_config(headline_predicate(args.rows, "unique"))
    t1, t2 = Table.from_numpy(r1), Table.from_numpy(r2)
    pipe = QueryPipeline(cfg)
    pipe.run_tables(t1, t2)  # resolves narrow_keys / narrow_data
    resolved = dataclasses.replace(
        cfg, narrow_keys=pipe.resolved_narrow_keys, narrow_data=pipe.resolved_narrow_data
    )
    compiled = jax.jit(functools.partial(pipeline_core, config=resolved)).lower(t1, t2).compile()
    for _ in range(3):
        jax.block_until_ready(compiled(t1, t2))
    with tempfile.TemporaryDirectory() as tdir:
        with device_trace(tdir):
            jax.block_until_ready(compiled(t1, t2))
        (path,) = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True)
        report = reduce_trace(
            jax.profiler.ProfileData.from_file(path).planes, compiled.as_text()
        )
    report.update(card=card, xla_flags=os.environ["XLA_FLAGS"], rows=args.rows, narrow_keys=resolved.narrow_keys,
                  narrow_data=resolved.narrow_data, device=jax.devices()[0].device_kind)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(f"busy {report['busy_ms']:.3f} ms of a {report['window_ms']:.3f} ms window "
          f"(idle share {report['idle_share']})")
    for scope, ms in report["scope_ms"].items():
        print(f"scope {scope}: {ms:.3f} ms")
    for s in report["sorts"]:
        print(f"sort {s['scope']}: {s['hlo_op']} opcode={s['opcode']} "
              f"target={s['target']} | {s['line'][:160]}")
    for op in report["ops"][:25]:
        print(f"op {op['hlo_op']} [{op['scope']}] {op['opcode']} {op['ms']:.3f} ms "
              f"x{op['launches']} {op['kernels']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
