"""The staged query pipeline: ingest -> filter -> sort -> join -> materialize.

Re-design of the reference host orchestration (`app.c` main,
775 lines): where the reference runs four separately-launched DPU programs
with host gathers/re-scatters between stages (select -> per-DPU sort ->
pairwise merge-tree reduction -> co-partitioned join; call stack in SURVEY.md
section 3.1), this pipeline traces the whole filter+sort+join dataflow into a
single jitted XLA program per capacity signature -- the stage boundaries that
were host round-trips become fusion points.

Single-chip path here; the sharded multi-chip path lives in
`engine/distributed.py` and swaps the sort stage for
partition-exchange-then-local-sort.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import numpy as np

from pim_sort_merge_join_tpu.columnar import csv_io
from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.config import EngineConfig
from pim_sort_merge_join_tpu.engine.metrics import MetricsCollector
from pim_sort_merge_join_tpu.ops import filter as filter_ops
from pim_sort_merge_join_tpu.ops import join as join_ops
from pim_sort_merge_join_tpu.ops import sort as sort_ops


def pipeline_core(t1: Table, t2: Table, config: EngineConfig) -> Table:
    """The traced filter -> sort -> join dataflow on two device tables."""
    if config.join_algorithm == "sort_merge" and config.join_mode == "one_to_one":
        # Fused path: filtering is a key mask and the join's slot-permutation
        # sorts subsume the standalone compaction + table sorts -- ~2x fewer
        # memory passes than the staged path below, byte-identical output.
        m1 = filter_ops.predicate_mask(t1, config.predicate1)
        m2 = filter_ops.predicate_mask(t2, config.predicate2)
        return join_ops.filter_join_one_to_one(
            t1, t2, config.join_key1, config.join_key2, m1, m2,
            narrow=config.narrow_keys,
            narrow_data=config.narrow_data,
        )
    f1 = filter_ops.apply_filter(t1, config.predicate1)
    f2 = filter_ops.apply_filter(t2, config.predicate2)
    if config.join_algorithm == "hash":
        from pim_sort_merge_join_tpu.ops.hash_join import hash_join

        # Hash join orders itself in hash space; it never needs the sorted
        # runs, so the branch sits BEFORE the sort stage -- tracing sorts
        # here and relying on XLA's dead-code elimination to drop them would
        # leave traced code that never runs.
        # Output row order is the STREAMING contract (table-1 filtered-row
        # order, the standard hash-join order; tests/test_hash_ops.py), not
        # the sort-merge path's key order -- same multiset of rows.
        out_cap = None
        if config.join_mode == "inner":
            out_cap = int(t1.capacity * config.join_slack)
        return hash_join(
            f1, f2, config.join_key1, config.join_key2,
            mode=config.join_mode, out_capacity=out_cap,
        )
    s1 = sort_ops.sort_by_key(
        f1, config.join_key1, narrow=config.narrow_keys is True
    )
    s2 = sort_ops.sort_by_key(
        f2, config.join_key2, narrow=config.narrow_keys is True
    )
    out_cap = None
    if config.join_mode == "inner":
        out_cap = int(t1.capacity * config.join_slack)
    return join_ops.merge_join(
        s1, s2, config.join_key1, config.join_key2,
        mode=config.join_mode, out_capacity=out_cap,
        narrow=config.narrow_keys,
        narrow_data=config.narrow_data,
    )


class QueryPipeline:
    """Host-facing driver: CSV paths in, result table / CSV out.

    Jit-compiles `pipeline_core` once per (capacity, ncol, dtype) signature;
    repeated queries at the same shape reuse the executable (the reference
    re-allocates DPUs and reloads ELFs every stage, app.c:307,402,503,761).
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.metrics = MetricsCollector(enabled=self.config.collect_metrics)
        self._jitted = {}
        self._filter_probe = None
        self._narrow_probe = None
        # Concrete narrow_keys / narrow_data decisions of the most recent
        # run (observability + tests); None until a query resolves them.
        self.resolved_narrow_keys: bool | None = None
        self.resolved_narrow_data: bool | None = None

    def _jit_for(self, narrow: bool, narrow_data: bool):
        key = (narrow, narrow_data)
        if key not in self._jitted:
            import dataclasses

            cfg = dataclasses.replace(
                self.config, narrow_keys=narrow, narrow_data=narrow_data
            )
            self._jitted[key] = jax.jit(
                functools.partial(pipeline_core, config=cfg),
                donate_argnums=(0, 1) if cfg.donate_inputs else (),
            )
        return self._jitted[key]

    def _resolve_narrow_device(self, t1: Table, t2: Table) -> tuple[bool, bool]:
        """Resolve narrow_keys/narrow_data="auto" from device tables.

        One tiny readback. Probes the RAW buffers (padding included):
        padding zeros can only keep the range inside int32, never push a
        valid value out, so the decision is safe and identical to the host
        probe on real data. Returns (keys_fit, all_data_fits).
        """
        if not self.config.narrowable():
            return False, False
        if self._narrow_probe is None:
            import jax.numpy as jnp

            k1c, k2c = self.config.join_key1, self.config.join_key2

            def probe(a: Table, b: Table):
                klo = jnp.minimum(jnp.min(a.data[:, k1c]), jnp.min(b.data[:, k2c]))
                khi = jnp.maximum(jnp.max(a.data[:, k1c]), jnp.max(b.data[:, k2c]))
                dlo = jnp.minimum(jnp.min(a.data), jnp.min(b.data))
                dhi = jnp.maximum(jnp.max(a.data), jnp.max(b.data))
                return klo, khi, dlo, dhi

            self._narrow_probe = jax.jit(probe)
        klo, khi, dlo, dhi = self._narrow_probe(t1, t2)
        import numpy as np

        info = np.iinfo(np.int32)
        keys_fit = bool(int(klo) >= info.min and int(khi) < info.max)
        data_fit = bool(int(dlo) >= info.min and int(dhi) < info.max)
        return keys_fit, data_fit

    def _debug_filter_counts(self, t1: Table, t2: Table) -> None:
        """DEBUG-mode per-stage row dump (reference app.c:294-305 analog).

        Costs one extra device pass per table, only when debug_log is on --
        the fused pipeline never materializes the post-filter count
        otherwise.
        """
        from pim_sort_merge_join_tpu.engine.logging import log_event

        if self._filter_probe is None:
            import jax.numpy as jnp

            cfg = self.config

            def probe(a: Table, b: Table):
                ma = filter_ops.predicate_mask(a, cfg.predicate1) & a.valid_mask()
                mb = filter_ops.predicate_mask(b, cfg.predicate2) & b.valid_mask()
                return (
                    jnp.sum(ma, dtype=jnp.int32),
                    jnp.sum(mb, dtype=jnp.int32),
                )

            self._filter_probe = jax.jit(probe)
        c1, c2 = self._filter_probe(t1, t2)
        log_event(
            "filter",
            table1_rows_in=int(t1.num_rows),
            table1_rows_out=int(c1),
            table2_rows_in=int(t2.num_rows),
            table2_rows_out=int(c2),
            predicate1=self.config.predicate1.describe(),
            predicate2=self.config.predicate2.describe(),
        )

    # -- device path -------------------------------------------------------
    def run_tables(
        self,
        t1: Table,
        t2: Table,
        *,
        narrow: bool | None = None,
        narrow_data: bool | None = None,
    ) -> Table:
        if narrow is None or narrow_data is None:
            need_probe = (narrow is None and self.config.narrow_keys == "auto") or (
                narrow_data is None and self.config.narrow_data == "auto"
            )
            probed = self._resolve_narrow_device(t1, t2) if need_probe else (False, False)
            if narrow is None:
                narrow = (
                    self.config.narrow_keys
                    if self.config.narrow_keys != "auto"
                    else probed[0]
                )
            if narrow_data is None:
                narrow_data = (
                    self.config.narrow_data
                    if self.config.narrow_data != "auto"
                    else probed[1]
                )
        self.resolved_narrow_keys = bool(narrow)
        self.resolved_narrow_data = bool(narrow_data)
        if self.config.debug_log:
            self._debug_filter_counts(t1, t2)
        with self.metrics.stage("execute") as m:
            result = self._jit_for(bool(narrow), bool(narrow_data))(t1, t2)
            result = jax.block_until_ready(result)
            m.rows_out = int(result.num_rows)
        if self.config.debug_log:
            from pim_sort_merge_join_tpu.engine.logging import log_event

            log_event(
                "join",
                rows_out=m.rows_out,
                output_capacity=result.capacity,
                overflow_headroom=result.capacity - m.rows_out,
            )
        # Inner joins report the TRUE match count in num_rows even past the
        # output capacity (ops/join.py merge_join_inner); rows beyond the
        # capacity were dropped, so surface that instead of silently
        # truncating.
        if m.rows_out > result.capacity:
            from pim_sort_merge_join_tpu.engine.errors import JoinOverflowError

            raise JoinOverflowError(m.rows_out, result.capacity)
        return result

    # -- end-to-end CSV path ----------------------------------------------
    def run_csv(
        self,
        path1: str,
        path2: str,
        output_path: str | None = None,
        *,
        capacity: int | None = None,
    ) -> Table:
        dtype = self.config.jnp_dtype()
        with self.metrics.stage("ingest") as m:
            rows1 = csv_io.load_csv_numpy(path1, dtype=np.int64)
            rows2 = csv_io.load_csv_numpy(path2, dtype=np.int64)
            m.rows_in = rows1.shape[0] + rows2.shape[0]
        if self.config.debug_log:
            from pim_sort_merge_join_tpu.engine.logging import log_event

            log_event(
                "ingest",
                table1_rows=rows1.shape[0],
                table2_rows=rows2.shape[0],
                table1_bytes=rows1.nbytes,
                table2_bytes=rows2.nbytes,
            )
        if np.dtype(dtype).itemsize < 8:
            from pim_sort_merge_join_tpu.utils.validate import check_dtype_range

            check_dtype_range(rows1, dtype, path1)
            check_dtype_range(rows2, dtype, path2)
            rows1 = rows1.astype(dtype)
            rows2 = rows2.astype(dtype)
        if self.config.narrow_keys is True:
            from pim_sort_merge_join_tpu.utils.validate import check_narrow_keys

            check_narrow_keys(rows1, self.config.join_key1, path1)
            check_narrow_keys(rows2, self.config.join_key2, path2)
        if self.config.narrow_data is True:
            from pim_sort_merge_join_tpu.utils.validate import check_narrow_data

            check_narrow_data(rows1, path1)
            check_narrow_data(rows2, path2)
        narrow = None
        narrow_data = None
        if self.config.narrow_keys == "auto":
            # Host probe: resolve the narrow-key dispatch from the numpy
            # arrays while they are still on host (free vs a device
            # readback).
            narrow = self.config.resolve_narrow(
                rows1[:, self.config.join_key1], rows2[:, self.config.join_key2]
            ).narrow_keys
        if self.config.narrow_data == "auto":
            narrow_data = self.config.resolve_narrow_data(rows1, rows2).narrow_data
        with self.metrics.stage("host_to_device") as m:
            t1 = Table.from_numpy(rows1, capacity=capacity, dtype=dtype)
            t2 = Table.from_numpy(rows2, capacity=capacity, dtype=dtype)
            jax.block_until_ready((t1, t2))
            m.bytes_moved = rows1.nbytes + rows2.nbytes
        result = self.run_tables(t1, t2, narrow=narrow, narrow_data=narrow_data)
        if output_path is not None:
            with self.metrics.stage("materialize") as m:
                out = result.to_numpy()
                csv_io.write_csv(output_path, out, names=result.names)
                m.rows_out = out.shape[0]
                m.bytes_moved = out.nbytes
            if self.config.debug_log:
                from pim_sort_merge_join_tpu.engine.logging import log_event

                log_event(
                    "materialize",
                    rows=out.shape[0],
                    bytes=out.nbytes,
                    path=output_path,
                )
        return result

    def metrics_json(self) -> str:
        return self.metrics.to_json()

    # -- resumable path ----------------------------------------------------
    def run_tables_resumable(self, t1: Table, t2: Table) -> Table:
        """Stage-boundary-checkpointed execution (config.checkpoint_dir).

        The fused pipeline is split at the sorted-tables boundary (the
        post-sort state is exactly what the reference's SDK-level
        checkpoint would snapshot from MRAM, dpu_checkpoint.h:46): stage 1
        filters + sorts both tables and checkpoints them; stage 2 joins.
        A rerun with the same config resumes after the last completed
        stage.
        """
        if self.config.checkpoint_dir is None:
            return self.run_tables(t1, t2)
        from pim_sort_merge_join_tpu.engine.checkpoint import (
            StageCheckpointer,
            config_fingerprint,
        )

        ckpt = StageCheckpointer(
            self.config.checkpoint_dir, config_fingerprint(self.config)
        )
        cfg = self.config
        if ckpt.has("sorted"):
            s1 = ckpt.load_table("sorted", "t1")
            s2 = ckpt.load_table("sorted", "t2")
        else:
            with self.metrics.stage("filter_sort") as m:
                stage1 = jax.jit(
                    lambda a, b: (
                        sort_ops.sort_by_key(
                            filter_ops.apply_filter(a, cfg.predicate1),
                            cfg.join_key1,
                        ),
                        sort_ops.sort_by_key(
                            filter_ops.apply_filter(b, cfg.predicate2),
                            cfg.join_key2,
                        ),
                    )
                )
                s1, s2 = jax.block_until_ready(stage1(t1, t2))
            ckpt.save("sorted", t1=s1, t2=s2)
        with self.metrics.stage("join") as m:
            out_cap = None
            if cfg.join_mode == "inner":
                out_cap = int(t1.capacity * cfg.join_slack)
            join_fn = jax.jit(
                lambda a, b: join_ops.merge_join(
                    a, b, cfg.join_key1, cfg.join_key2,
                    mode=cfg.join_mode, out_capacity=out_cap,
                )
            )
            result = jax.block_until_ready(join_fn(s1, s2))
            m.rows_out = int(result.num_rows)
        ckpt.save("joined", result=result)
        return result
