"""Multi-chip distributed pipeline over a `jax.sharding.Mesh`.

The replacement for the reference's whole multi-DPU orchestration
(SURVEY.md section 3.1): host row-block scatter (app.c:179-218) becomes a
sharded device array; the per-DPU select/sort kernels become per-shard
vectorized ops inside `shard_map`; the host-driven pairwise merge tree
(app.c:408-547) and the stage-4 binary-search co-partitioning (app.c:585-633)
are together replaced by ONE splitter-based range exchange (`exchange/`),
after which every shard sorts and joins its own co-partitioned key range
locally. The whole thing -- filter, sample, exchange, sort, join -- is a
single jitted SPMD program; no host round-trips between stages.

Output global order: with `partition_scheme="range"` (default), partitions
are ascending key ranges, each shard's join output follows its local key
order, so concatenating shard outputs in shard order reproduces the
single-chip (and reference) row order exactly -- duplicate keys included.
Equal-key rows keep global insertion order end to end: contiguous row-block
scatter makes (source shard, source position) == global position, the
stable filter compaction and the exchange both preserve it (arrival order
is source-shard-major, shuffle.py), and the merged-domain join breaks key
ties by arrival position (`test_distributed_duplicate_keys` pins byte
equality). Two modes trade this order away by design: skew rank-spreading
(heavy keys are routed by occurrence rank, not range) and
`partition_scheme="hash"` (BASELINE config 3), where equal keys still
co-locate but shard order does not follow key order: output is the same
multiset of rows, deterministic, key-sorted WITHIN each shard; callers that
need globally key-ordered output merge the shard streams at
materialization.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pim_sort_merge_join_tpu.columnar.table import Table, key_sentinel
from pim_sort_merge_join_tpu.config import EngineConfig
from pim_sort_merge_join_tpu.engine.metrics import MetricsCollector
from pim_sort_merge_join_tpu.exchange.partition import (
    choose_splitters,
    destination_of,
    hash_destination_of,
    sample_keys,
)
from pim_sort_merge_join_tpu.exchange.shuffle import all_to_all_exchange
from pim_sort_merge_join_tpu.exchange import skew
from pim_sort_merge_join_tpu.ops import filter as filter_ops
from pim_sort_merge_join_tpu.ops import join as join_ops
from pim_sort_merge_join_tpu.ops import sort as sort_ops


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "counts"],
    meta_fields=["names"],
)
@dataclasses.dataclass(frozen=True)
class ShardedTable:
    """A table partitioned row-wise across a mesh axis (a JAX pytree).

    ``data`` is ``[P * shard_capacity, ncol]`` sharded ``P(axis, None)``;
    ``counts`` is ``[P]`` sharded ``P(axis)`` -- valid-row count per shard.
    ``names`` is static pytree metadata.
    """

    data: jax.Array
    counts: jax.Array
    names: tuple = ()

    def replace(self, **changes) -> "ShardedTable":
        """Copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)

    @property
    def ncol(self) -> int:
        return self.data.shape[1]

    def total_rows(self) -> jax.Array:
        return jnp.sum(self.counts)

    @classmethod
    def from_numpy(
        cls,
        array: np.ndarray,
        mesh: Mesh,
        axis: str,
        *,
        shard_capacity: int | None = None,
        names: Sequence[str] | None = None,
        dtype=jnp.int64,
    ) -> "ShardedTable":
        """Scatter host rows into P contiguous row blocks (the analog of the
        reference's stage-1 row-block partitioning, app.c:179-218)."""
        nrow, ncol = array.shape
        p = mesh.shape[axis]
        if shard_capacity is None:
            shard_capacity = -(-nrow // p) if nrow else 1
        if names is None:
            names = tuple(f"col{i + 1}" for i in range(ncol))
        buf = np.zeros((p * shard_capacity, ncol), dtype=np.dtype(dtype))
        counts = np.zeros((p,), dtype=np.int32)
        base = nrow // p
        rem = nrow % p
        start = 0
        for i in range(p):
            n_i = base + (1 if i < rem else 0)
            if n_i > shard_capacity:
                raise ValueError(
                    f"shard {i} needs {n_i} rows > shard_capacity {shard_capacity}"
                )
            buf[i * shard_capacity : i * shard_capacity + n_i] = array[
                start : start + n_i
            ]
            counts[i] = n_i
            start += n_i
        # make_array_from_callback works identically for single-process and
        # multi-process meshes (device_put cannot target non-addressable
        # shards); every process must hold the same ``array``. The callback
        # slices the HOST buffer, so each device receives only its own block.
        data = jax.make_array_from_callback(
            buf.shape, NamedSharding(mesh, P(axis, None)), lambda i: buf[i]
        )
        cnt = jax.make_array_from_callback(
            counts.shape, NamedSharding(mesh, P(axis)), lambda i: counts[i]
        )
        return cls(data=data, counts=cnt, names=tuple(names))

    @classmethod
    def from_process_local(
        cls,
        array: np.ndarray,
        mesh: Mesh,
        axis: str,
        *,
        names: Sequence[str] | None = None,
        dtype=jnp.int64,
    ) -> "ShardedTable":
        """Build a global sharded table from PER-PROCESS row blocks.

        Each process contributes only the rows it holds (e.g. its byte range
        of the CSV, csv_io.load_csv_shard); no process ever materializes the
        global table. The global row order is (process, local order). A
        collective: every process in the mesh must call this.
        """
        from jax.experimental import multihost_utils

        nrow, ncol = array.shape
        if names is None:
            names = tuple(f"col{i + 1}" for i in range(ncol))
        local_devs = [d for d in mesh.devices.ravel() if d.process_index == jax.process_index()]
        n_local = len(local_devs)
        # Agree on one per-device capacity across processes.
        all_rows = multihost_utils.process_allgather(
            np.array([nrow], dtype=np.int64)
        ).ravel()
        shard_capacity = int(max(-(-int(r) // n_local) for r in all_rows))
        shard_capacity = max(shard_capacity, 1)
        buf = np.zeros((n_local * shard_capacity, ncol), dtype=np.dtype(dtype))
        counts = np.zeros((n_local,), dtype=np.int32)
        base, rem = nrow // n_local, nrow % n_local
        start = 0
        for i in range(n_local):
            n_i = base + (1 if i < rem else 0)
            buf[i * shard_capacity : i * shard_capacity + n_i] = array[
                start : start + n_i
            ]
            counts[i] = n_i
            start += n_i
        data = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axis, None)), buf
        )
        cnt = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(axis)), counts
        )
        return cls(data=data, counts=cnt, names=tuple(names))

    def _host_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        data, counts = self.data, self.counts
        if not data.is_fully_addressable:
            # Replicate across processes (an all_gather), then read the
            # local replica. A collective: every process must call this.
            mesh = data.sharding.mesh
            rep = NamedSharding(mesh, P())
            data, counts = jax.jit(
                lambda d, c: (d, c), out_shardings=(rep, rep)
            )(data, counts)
        return (
            np.asarray(jax.device_get(data)),
            np.asarray(jax.device_get(counts)),
        )

    def to_numpy(self) -> np.ndarray:
        """Gather valid rows of all shards, in shard order.

        Multi-process safe (replicates first); collective in that case.
        """
        p = self.counts.shape[0]
        shard_cap = self.data.shape[0] // p
        data, counts = self._host_arrays()
        parts = [
            data[i * shard_cap : i * shard_cap + counts[i]] for i in range(p)
        ]
        return np.concatenate(parts, axis=0) if parts else data[:0]


def _host_diag(x) -> np.ndarray:
    """Device->host for a (possibly process-sharded) diagnostic array.

    Replicates across processes first when needed; a collective then --
    every process of the mesh must reach the same check.
    """
    if hasattr(x, "is_fully_addressable") and not x.is_fully_addressable:
        mesh = x.sharding.mesh
        x = jax.jit(lambda v: v, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(jax.device_get(x))


# ---------------------------------------------------------------------------
# The SPMD pipeline
# ---------------------------------------------------------------------------


def _local_table(data: jax.Array, count: jax.Array, names: tuple) -> Table:
    return Table(data=data, num_rows=count.reshape(()).astype(jnp.int32), names=names)


def _fused_local_join(config: EngineConfig) -> bool:
    return (
        config.join_mode == "one_to_one" and config.join_algorithm == "sort_merge"
    )


def distributed_exchange_core(
    t1: ShardedTable,
    t2: ShardedTable,
    config: EngineConfig,
    mesh: Mesh,
    *,
    exchange_capacity: int,
):
    """Stages 1-3: filter -> sample splitters -> range exchange [-> sort].

    Returns (s1, s2, diagnostics): the co-partitioned post-exchange tables.
    This is the distributed checkpoint boundary (the analog of the SDK's
    MRAM snapshot, dpu_checkpoint.h:46): everything before it is
    key-routing, everything after is per-shard local work.
    """
    axis = config.mesh_axis
    num_partitions = mesh.shape[axis]
    sample_size = config.splitter_sample
    bucket_cap = -(-exchange_capacity // num_partitions)

    def stage_filter_sample(data, counts, pred, key):
        t = _local_table(data, counts, ())
        f = filter_ops.apply_filter(t, pred)
        keys = f.masked_keys(key)
        smp = sample_keys(keys, f.num_rows, sample_size)
        return f.data, f.num_rows.reshape(1), smp.reshape(1, sample_size)

    # For the 1:1 sort-merge mode the local sort after the exchange is
    # skipped entirely: the merged-domain join core (ops/join.py) never
    # needs sorted inputs, and exchange arrival order is deterministic, so
    # per-shard output is still reproducible and key-ordered.
    fused_local_join = _fused_local_join(config)
    # Skew-aware repartitioning (exchange/skew.py): heavy keys detected from
    # the pooled sample are rank-co-partitioned (both modes); inner mode
    # additionally broadcasts table 2's heavy rows (cross products need
    # every pair co-located, not just matching ranks).
    heavy_frac = (
        config.heavy_hitter_fraction
        if config.heavy_hitter_fraction is not None
        else 0.5 / num_partitions
    )
    k_heavy = skew.max_heavy_hitters(heavy_frac, num_partitions)
    heavy_cap = (
        config.heavy_gather_capacity
        if config.heavy_gather_capacity is not None
        else bucket_cap
    )
    broadcast_side2 = config.join_mode == "inner"

    def stage_exchange_sort(data, counts, splitters, heavy_keys, key, side):
        t = _local_table(data, counts, ())
        keys = t.masked_keys(key)
        if config.partition_scheme == "hash":
            dest = hash_destination_of(keys, num_partitions, t.valid_mask())
        else:
            dest = destination_of(keys, splitters.reshape(-1), t.valid_mask())
        heavy_true = jnp.int32(0)
        g_rows = g_valid = None
        if heavy_keys is not None:
            is_heavy, slot = skew.heavy_slot_of(
                keys, heavy_keys.reshape(-1), t.valid_mask()
            )
            if side == 2 and broadcast_side2:
                # Exclude from the exchange; broadcast instead.
                dest = jnp.where(is_heavy, jnp.int32(num_partitions), dest)
                g_rows, g_valid, heavy_true = skew.gather_heavy_side(
                    t.data, is_heavy, axis, capacity=heavy_cap
                )
            else:
                dest_h = skew.heavy_rank_destination(
                    is_heavy, slot, k_heavy, axis
                )
                dest = jnp.where(is_heavy, dest_h, dest)
        ex = all_to_all_exchange(
            t.data,
            dest,
            axis,
            bucket_capacity=bucket_cap,
            recv_capacity=exchange_capacity,
            num_chunks=config.exchange_chunks,
        )
        if g_rows is not None:
            # Append the broadcast heavy rows and key-sort the union into a
            # valid-prefix table (one stable multi-operand sort; rows ride).
            sent = key_sentinel(ex.data.dtype)
            k_ex = jnp.where(
                jnp.arange(exchange_capacity, dtype=jnp.int32) < ex.num_rows,
                ex.data[:, key],
                sent,
            )
            k_hv = jnp.where(g_valid, g_rows[:, key], sent)
            union = jnp.concatenate([ex.data, g_rows], axis=0)
            ks = jnp.concatenate([k_ex, k_hv])
            ops = jax.lax.sort(
                (ks,) + tuple(union[:, c] for c in range(union.shape[1])),
                num_keys=1,
                is_stable=True,
            )
            local = Table(
                data=jnp.stack(ops[1:], axis=1),
                num_rows=ex.num_rows
                + jnp.sum(g_valid, dtype=jnp.int32),
                names=(),
            )
        else:
            local = Table(data=ex.data, num_rows=ex.num_rows, names=())
            if not fused_local_join:
                local = sort_ops.sort_by_key(local, key)
        return (
            local.data,
            local.num_rows.reshape(1),
            ex.true_rows.reshape(1),
            heavy_true.reshape(1),
        )

    shmap = functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False
    )

    # --- stage 1: filter + local key sample -------------------------------
    f1_data, f1_counts, smp1 = shmap(
        functools.partial(
            stage_filter_sample, pred=config.predicate1, key=config.join_key1
        ),
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis, None)),
    )(t1.data, t1.counts)
    f2_data, f2_counts, smp2 = shmap(
        functools.partial(
            stage_filter_sample, pred=config.predicate2, key=config.join_key2
        ),
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis), P(axis, None)),
    )(t2.data, t2.counts)

    # --- stage 2: global splitters from the pooled sample -----------------
    pooled = jnp.concatenate([smp1.reshape(-1), smp2.reshape(-1)])
    if k_heavy > 0:
        heavy_keys = skew.detect_heavy_hitters(
            pooled, heavy_frac, k_heavy
        )
        # Range splitters balance the REMAINING rows; heavy rows are routed
        # by rank, not range.
        splitters = choose_splitters(
            skew.mask_heavy_samples(pooled, heavy_keys), num_partitions
        )
    else:
        heavy_keys = None
        splitters = choose_splitters(pooled, num_partitions)

    # --- stage 3: range exchange + local sort (both tables) ---------------
    # The two tables' stages are independent: one fused shard_map region
    # lets XLA's latency-hiding scheduler overlap table 2's all_to_all with
    # table 1's local sort (the DPU_XFER_ASYNC/dpu_callback analog,
    # dpu.h:72-82 -- here the compiler schedules the overlap).
    def stage_exchange_sort_both(d1, c1, d2, c2, spl, hvy):
        s1d, s1c, t1r, h1 = stage_exchange_sort(
            d1, c1, spl, hvy, key=config.join_key1, side=1
        )
        s2d, s2c, t2r, h2 = stage_exchange_sort(
            d2, c2, spl, hvy, key=config.join_key2, side=2
        )
        return s1d, s1c, t1r, h1, s2d, s2c, t2r, h2

    hvy_arg = (
        heavy_keys.reshape(1, -1) if heavy_keys is not None else None
    )
    args = (f1_data, f1_counts, f2_data, f2_counts, splitters)
    in_specs = [P(axis, None), P(axis), P(axis, None), P(axis), P()]
    if hvy_arg is not None:
        args = args + (hvy_arg,)
        in_specs.append(P())
        fn = stage_exchange_sort_both
    else:
        fn = functools.partial(stage_exchange_sort_both, hvy=None)
    s1_data, s1_counts, true1, htrue1, s2_data, s2_counts, true2, htrue2 = shmap(
        fn,
        in_specs=tuple(in_specs),
        out_specs=(
            P(axis, None), P(axis), P(axis), P(axis),
            P(axis, None), P(axis), P(axis), P(axis),
        ),
    )(*args)

    diagnostics = {
        "exchange_true_rows1": true1,
        "exchange_true_rows2": true2,
        "heavy_true_rows1": htrue1,
        "heavy_true_rows2": htrue2,
        "heavy_gather_capacity": heavy_cap,
        "sorted_rows1": s1_counts,
        "sorted_rows2": s2_counts,
    }
    s1 = ShardedTable(data=s1_data, counts=s1_counts, names=t1.names)
    s2 = ShardedTable(data=s2_data, counts=s2_counts, names=t2.names)
    return s1, s2, diagnostics


def distributed_join_core(
    s1: ShardedTable,
    s2: ShardedTable,
    config: EngineConfig,
    mesh: Mesh,
) -> ShardedTable:
    """Stage 4: co-partitioned local join of post-exchange tables."""
    axis = config.mesh_axis
    fused_local_join = _fused_local_join(config)

    def stage_join(d1, c1, d2, c2):
        a = _local_table(d1, c1, tuple(f"col{i+1}" for i in range(d1.shape[1])))
        b = _local_table(d2, c2, tuple(f"col{i+1}" for i in range(d2.shape[1])))
        out_cap = None
        if config.join_mode == "inner":
            # join_slack sizes the per-shard output past the per-shard input
            # capacity; `num_rows` still reports the TRUE match count, so the
            # driver can detect overflow (ops/join.py merge_join_inner).
            out_cap = -(-int(d1.shape[0] * config.join_slack) // 128) * 128
        out = join_ops.merge_join(
            a, b, config.join_key1, config.join_key2,
            mode=config.join_mode, presorted=not fused_local_join,
            out_capacity=out_cap, narrow=config.narrow_keys,
            narrow_data=config.narrow_data,
        )
        return out.data, out.num_rows.reshape(1)

    out_data, out_counts = jax.shard_map(
        stage_join,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis), P(axis, None), P(axis)),
        out_specs=(P(axis, None), P(axis)),
        check_vma=False,
    )(s1.data, s1.counts, s2.data, s2.counts)

    ncol_out = s1.ncol + s2.ncol - 1
    names = tuple(f"col{i + 1}" for i in range(ncol_out))
    return ShardedTable(data=out_data, counts=out_counts, names=names)


def distributed_pipeline_core(
    t1: ShardedTable,
    t2: ShardedTable,
    config: EngineConfig,
    mesh: Mesh,
    *,
    exchange_capacity: int,
):
    """filter -> sample splitters -> range exchange -> sort -> join, SPMD.

    One fused program (when jitted as a whole): XLA schedules the two
    tables' exchanges and local work together; the phase split exists for
    the checkpoint boundary (`run_tables_resumable`)."""
    s1, s2, diagnostics = distributed_exchange_core(
        t1, t2, config, mesh, exchange_capacity=exchange_capacity
    )
    result = distributed_join_core(s1, s2, config, mesh)
    return result, diagnostics


def distributed_aggregate_core(
    t: ShardedTable,
    config: EngineConfig,
    mesh: Mesh,
    *,
    key: int,
    value: int,
    agg: str,
    exchange_capacity: int,
):
    """Distributed group-by aggregate: range-exchange by key, local aggregate.

    Equal keys co-locate (same invariant as the join), so per-shard
    aggregation is globally correct; output shards hold disjoint ascending
    key ranges, so concatenation in shard order is globally key-sorted.
    """
    axis = config.mesh_axis
    num_partitions = mesh.shape[axis]
    sample_size = config.splitter_sample
    bucket_cap = -(-exchange_capacity // num_partitions)

    def stage_sample(data, counts):
        t_loc = _local_table(data, counts, ())
        keys = t_loc.masked_keys(key)
        return sample_keys(keys, t_loc.num_rows, sample_size).reshape(
            1, sample_size
        )

    def stage_exchange_aggregate(data, counts, splitters):
        from pim_sort_merge_join_tpu.ops.hash_join import hash_aggregate

        t_loc = _local_table(data, counts, ())
        keys = t_loc.masked_keys(key)
        if config.partition_scheme == "hash":
            dest = hash_destination_of(keys, num_partitions, t_loc.valid_mask())
        else:
            dest = destination_of(
                keys, splitters.reshape(-1), t_loc.valid_mask()
            )
        ex = all_to_all_exchange(
            t_loc.data,
            dest,
            axis,
            bucket_capacity=bucket_cap,
            recv_capacity=exchange_capacity,
            num_chunks=config.exchange_chunks,
        )
        local = Table(data=ex.data, num_rows=ex.num_rows, names=())
        out = hash_aggregate(local, key, value, agg)
        return out.data, out.num_rows.reshape(1), ex.true_rows.reshape(1)

    shmap = functools.partial(jax.shard_map, mesh=mesh, check_vma=False)
    smp = shmap(
        stage_sample,
        in_specs=(P(axis, None), P(axis)),
        out_specs=P(axis, None),
    )(t.data, t.counts)
    splitters = choose_splitters(smp.reshape(-1), num_partitions)
    out_data, out_counts, true_rows = shmap(
        stage_exchange_aggregate,
        in_specs=(P(axis, None), P(axis), P()),
        out_specs=(P(axis, None), P(axis), P(axis)),
    )(t.data, t.counts, splitters)
    result = ShardedTable(data=out_data, counts=out_counts, names=("key", agg))
    return result, {"exchange_true_rows": true_rows}


class DistributedQueryPipeline:
    """Driver for the SPMD pipeline over a device mesh.

    The multi-chip analog of `QueryPipeline`: same CSV-in/CSV-out contract,
    with tables scattered over the mesh's partition axis. The "simulator"
    configuration (reference S3, `backend=simulator`) is this same class on
    a CPU mesh with `--xla_force_host_platform_device_count=N`.
    """

    def __init__(
        self,
        config: EngineConfig | None = None,
        mesh: Mesh | None = None,
    ):
        self.config = config or EngineConfig()
        if mesh is None:
            devs = jax.devices()
            mesh = Mesh(np.array(devs), (self.config.mesh_axis,))
        self.mesh = mesh
        self.metrics = MetricsCollector(enabled=self.config.collect_metrics)
        self._jitted = {}
        self._narrow_probe = None
        self.resolved_narrow_keys: bool | None = None
        self.resolved_narrow_data: bool | None = None

    def _get_jitted(self, exchange_capacity: int, narrow: bool, narrow_data: bool):
        key = (exchange_capacity, narrow, narrow_data)
        if key not in self._jitted:
            import dataclasses

            cfg = dataclasses.replace(
                self.config, narrow_keys=narrow, narrow_data=narrow_data
            )
            self._jitted[key] = jax.jit(
                functools.partial(
                    distributed_pipeline_core,
                    config=cfg,
                    mesh=self.mesh,
                    exchange_capacity=exchange_capacity,
                )
            )
        return self._jitted[key]

    def _resolve_narrow_device(
        self, t1: ShardedTable, t2: ShardedTable
    ) -> tuple[bool, bool]:
        """Resolve narrow_keys/narrow_data="auto" from GLOBAL sharded data.

        The reduce runs over the global jax.Array view, so its (replicated)
        result is identical on every process of a multi-process run --
        per-process HOST probes see only their shard and could disagree,
        desynchronizing the SPMD program (the round-2 auto-enable blocker).
        Probes raw buffers; padding zeros can only keep the range inside
        int32, never push a valid value out. Returns (keys_fit, data_fit).
        """
        if not self.config.narrowable():
            return False, False
        if self._narrow_probe is None:
            k1c, k2c = self.config.join_key1, self.config.join_key2

            def probe(d1, d2):
                klo = jnp.minimum(jnp.min(d1[:, k1c]), jnp.min(d2[:, k2c]))
                khi = jnp.maximum(jnp.max(d1[:, k1c]), jnp.max(d2[:, k2c]))
                dlo = jnp.minimum(jnp.min(d1), jnp.min(d2))
                dhi = jnp.maximum(jnp.max(d1), jnp.max(d2))
                return klo, khi, dlo, dhi

            self._narrow_probe = jax.jit(probe)
        klo, khi, dlo, dhi = self._narrow_probe(t1.data, t2.data)
        info = np.iinfo(np.int32)
        keys_fit = bool(int(klo) >= info.min and int(khi) < info.max)
        data_fit = bool(int(dlo) >= info.min and int(dhi) < info.max)
        return keys_fit, data_fit

    def run_tables(
        self, t1: ShardedTable, t2: ShardedTable, *, check_overflow: bool = True
    ) -> ShardedTable:
        p = self.mesh.shape[self.config.mesh_axis]
        shard_cap = max(t1.data.shape[0], t2.data.shape[0]) // p
        exchange_capacity = int(shard_cap * self.config.exchange_slack)
        # Round to a lane-friendly multiple.
        exchange_capacity = -(-exchange_capacity // 128) * 128
        need_probe = "auto" in (self.config.narrow_keys, self.config.narrow_data)
        probed = self._resolve_narrow_device(t1, t2) if need_probe else (False, False)
        narrow = (
            self.config.narrow_keys
            if self.config.narrow_keys != "auto"
            else probed[0]
        )
        narrow_data = (
            self.config.narrow_data
            if self.config.narrow_data != "auto"
            else probed[1]
        )
        self.resolved_narrow_keys = bool(narrow)
        self.resolved_narrow_data = bool(narrow_data)
        fn = self._get_jitted(exchange_capacity, bool(narrow), bool(narrow_data))
        with self.metrics.stage("execute") as m:
            out, diag = fn(t1, t2)
            out = jax.block_until_ready(out)
            m.rows_out = int(jnp.sum(out.counts))
            row_bytes = t1.ncol * np.dtype(t1.data.dtype).itemsize
            shuffled = int(jnp.sum(diag["sorted_rows1"])) + int(
                jnp.sum(diag["sorted_rows2"])
            )
            m.bytes_moved = shuffled * row_bytes
        if self.config.debug_log:
            from pim_sort_merge_join_tpu.engine.logging import log_event

            true1 = _host_diag(diag["exchange_true_rows1"])
            true2 = _host_diag(diag["exchange_true_rows2"])
            log_event(
                "exchange",
                bytes_moved=m.bytes_moved,
                per_shard_capacity=exchange_capacity,
                table1_max_shard_rows=int(true1.max()),
                table2_max_shard_rows=int(true2.max()),
                overflow_headroom=int(
                    exchange_capacity - max(true1.max(), true2.max())
                ),
            )
            counts = _host_diag(out.counts)
            log_event(
                "join",
                rows_out=m.rows_out,
                per_shard_capacity=out.data.shape[0] // p,
                max_shard_rows=int(counts.max()),
            )
        if check_overflow:
            self._check_exchange_overflow(diag, exchange_capacity)
            self._check_join_overflow(out)
        return out

    def _check_exchange_overflow(self, diag, exchange_capacity: int) -> None:
        from pim_sort_merge_join_tpu.engine.errors import ExchangeOverflowError

        for name, true_key in (
            ("table1", "exchange_true_rows1"),
            ("table2", "exchange_true_rows2"),
        ):
            true = _host_diag(diag[true_key])
            if (true > exchange_capacity).any():
                raise ExchangeOverflowError(name, true, exchange_capacity)
        hcap = int(diag["heavy_gather_capacity"])
        for name in ("heavy_true_rows1", "heavy_true_rows2"):
            true = _host_diag(diag[name])
            if (true > hcap).any():
                raise ExchangeOverflowError(
                    f"{name} (broadcast side)", true, hcap
                )

    def _check_join_overflow(self, out: ShardedTable) -> None:
        # Inner joins report per-shard TRUE match counts; rows past the
        # per-shard output capacity were dropped on device.
        from pim_sort_merge_join_tpu.engine.errors import JoinOverflowError

        p = self.mesh.shape[self.config.mesh_axis]
        counts = _host_diag(out.counts)
        shard_out_cap = out.data.shape[0] // p
        if (counts > shard_out_cap).any():
            raise JoinOverflowError(int(counts.max()), shard_out_cap)

    def _checkpointer(self):
        from pim_sort_merge_join_tpu.engine.checkpoint import (
            StageCheckpointer,
            config_fingerprint,
        )

        p = self.mesh.shape[self.config.mesh_axis]
        return StageCheckpointer(
            self.config.checkpoint_dir,
            config_fingerprint(self.config) + f"|mesh={p}",
        )

    def checkpoint_stages(self) -> list:
        """Stages already completed in checkpoint_dir for this config+mesh."""
        if self.config.checkpoint_dir is None:
            return []
        return self._checkpointer().completed_stages()

    def run_tables_resumable(
        self, t1: ShardedTable, t2: ShardedTable
    ) -> ShardedTable:
        """Exchange-boundary-checkpointed distributed execution.

        The SPMD pipeline is split at the post-exchange boundary (the
        distributed analog of the SDK's MRAM snapshot,
        dpu_checkpoint.h:46): phase 1 filters, samples, and exchanges both
        tables, then checkpoints the co-partitioned sharded state; phase 2
        joins. A rerun with the same config and mesh size resumes at the
        join, skipping the collectives entirely.
        """
        if self.config.checkpoint_dir is None:
            return self.run_tables(t1, t2)
        import dataclasses

        p = self.mesh.shape[self.config.mesh_axis]
        ckpt = self._checkpointer()
        axis = self.config.mesh_axis
        # Resolve narrow_keys/narrow_data="auto" to concrete bools exactly
        # as run_tables does -- the string "auto" fails the `narrow is True`
        # checks in ops/join.py and would silently disable the narrow-key /
        # narrow-data paths on the resumable route (advisor r4, medium).
        # On RESUME the probe must read the restored checkpoint state, not
        # the caller's inputs (which the resume contract allows to be
        # arbitrary same-shape placeholders): probing placeholders could
        # resolve narrow=True over a wide-keyed checkpoint. Probing the
        # exchanged buffers is conservative-correct -- their padding
        # sentinels can only push the range WIDER, never let out-of-range
        # keys slip into the narrow path.
        resumed = ckpt.has("exchanged")
        if resumed:
            s1 = ckpt.load_sharded("exchanged", "t1", self.mesh, axis)
            s2 = ckpt.load_sharded("exchanged", "t2", self.mesh, axis)
            probe_src = (s1, s2)
        else:
            probe_src = (t1, t2)
        need_probe = "auto" in (self.config.narrow_keys, self.config.narrow_data)
        probed = (
            self._resolve_narrow_device(*probe_src)
            if need_probe
            else (False, False)
        )
        narrow = (
            self.config.narrow_keys
            if self.config.narrow_keys != "auto"
            else probed[0]
        )
        narrow_data = (
            self.config.narrow_data
            if self.config.narrow_data != "auto"
            else probed[1]
        )
        self.resolved_narrow_keys = bool(narrow)
        self.resolved_narrow_data = bool(narrow_data)
        resolved_cfg = dataclasses.replace(
            self.config, narrow_keys=bool(narrow), narrow_data=bool(narrow_data)
        )
        if not resumed:
            shard_cap = max(t1.data.shape[0], t2.data.shape[0]) // p
            cap = -(-int(shard_cap * self.config.exchange_slack) // 128) * 128
            key = ("exchange", cap, bool(narrow), bool(narrow_data))
            if key not in self._jitted:
                self._jitted[key] = jax.jit(
                    functools.partial(
                        distributed_exchange_core,
                        config=resolved_cfg,
                        mesh=self.mesh,
                        exchange_capacity=cap,
                    )
                )
            with self.metrics.stage("exchange") as m:
                s1, s2, diag = self._jitted[key](t1, t2)
                jax.block_until_ready((s1, s2))
                m.rows_out = int(jnp.sum(s1.counts)) + int(jnp.sum(s2.counts))
            self._check_exchange_overflow(diag, cap)
            ckpt.save("exchanged", t1=s1, t2=s2)
        key = ("join", s1.data.shape, s2.data.shape, bool(narrow), bool(narrow_data))
        if key not in self._jitted:
            self._jitted[key] = jax.jit(
                functools.partial(
                    distributed_join_core, config=resolved_cfg, mesh=self.mesh
                )
            )
        with self.metrics.stage("join") as m:
            out = jax.block_until_ready(self._jitted[key](s1, s2))
            m.rows_out = int(jnp.sum(out.counts))
        self._check_join_overflow(out)
        ckpt.save("joined", result=out)
        return out

    def metrics_json(self) -> str:
        return self.metrics.to_json()

    def run_aggregate(
        self,
        t: ShardedTable,
        *,
        key: int = 0,
        value: int = 1,
        agg: str = "sum",
        check_overflow: bool = True,
    ) -> ShardedTable:
        """Distributed group-by-key aggregate over the mesh."""
        p = self.mesh.shape[self.config.mesh_axis]
        shard_cap = t.data.shape[0] // p
        exchange_capacity = -(-int(shard_cap * self.config.exchange_slack) // 128) * 128
        sig = ("agg", key, value, agg, exchange_capacity)
        if sig not in self._jitted:
            self._jitted[sig] = jax.jit(
                functools.partial(
                    distributed_aggregate_core,
                    config=self.config,
                    mesh=self.mesh,
                    key=key,
                    value=value,
                    agg=agg,
                    exchange_capacity=exchange_capacity,
                )
            )
        with self.metrics.stage("aggregate") as m:
            out, diag = self._jitted[sig](t)
            out = jax.block_until_ready(out)
            m.rows_out = int(jnp.sum(out.counts))
        if check_overflow:
            from pim_sort_merge_join_tpu.engine.errors import ExchangeOverflowError

            true = _host_diag(diag["exchange_true_rows"])
            if (true > exchange_capacity).any():
                raise ExchangeOverflowError("aggregate", true, exchange_capacity)
        return out

    def run_arrays(self, rows1: np.ndarray, rows2: np.ndarray) -> ShardedTable:
        axis = self.config.mesh_axis
        dtype = self.config.jnp_dtype()
        if np.dtype(dtype).itemsize < 8:
            from pim_sort_merge_join_tpu.utils.validate import check_dtype_range

            check_dtype_range(rows1, dtype, "table1")
            check_dtype_range(rows2, dtype, "table2")
        if self.config.narrow_keys is True:
            from pim_sort_merge_join_tpu.utils.validate import check_narrow_keys

            check_narrow_keys(rows1, self.config.join_key1, "table1")
            check_narrow_keys(rows2, self.config.join_key2, "table2")
        if self.config.narrow_data is True:
            from pim_sort_merge_join_tpu.utils.validate import check_narrow_data

            check_narrow_data(rows1, "table1")
            check_narrow_data(rows2, "table2")
        with self.metrics.stage("host_to_device") as m:
            t1 = ShardedTable.from_numpy(rows1, self.mesh, axis, dtype=dtype)
            t2 = ShardedTable.from_numpy(rows2, self.mesh, axis, dtype=dtype)
            jax.block_until_ready((t1.data, t2.data))
            m.bytes_moved = rows1.nbytes + rows2.nbytes
        return self.run_tables(t1, t2)
