"""Runtime engine configuration.

Replaces the reference's compile-time `#define` configuration
(`sort-merge-join/user.h:1-13`, `common.h:1-11`) with a runtime dataclass:
predicates, join keys, dtype, mesh shape, partition capacities and algorithm
selection are all per-query values rather than rebuild-time constants.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import jax.numpy as jnp

# Comparison ops supported by selection predicates. The reference implements
# exactly one predicate form -- strictly-greater-than on one column
# (select.c:31, cpu_app.c:88) -- which is the default here; the rest round out
# a usable engine surface.
PredicateOp = Literal[">", ">=", "<", "<=", "==", "!="]


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A single-column comparison predicate, `col <op> value`."""

    col: int = 0
    op: PredicateOp = ">"
    value: int = 5000

    def describe(self) -> str:
        return f"col{self.col + 1} {self.op} {self.value}"


JoinMode = Literal["one_to_one", "inner"]
JoinAlgorithm = Literal["sort_merge", "hash"]
PartitionScheme = Literal["range", "hash"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All runtime tunables of the engine.

    Defaults reproduce the reference configuration: int64 elements
    (common.h:1), selection and join keys on column 0 with threshold 5000
    (user.h:6-13), and 1:1 join-equality semantics (join.c:160-173).
    """

    # --- semantics (the reference contract) ---
    predicate1: Predicate = Predicate()
    predicate2: Predicate = Predicate()
    join_key1: int = 0
    join_key2: int = 0
    join_mode: JoinMode = "one_to_one"

    # --- dtype: reference supports uint64/int64/double via `T` (common.h:1-9)
    # "int32" halves every byte moved (sorts, exchanges, gathers) when the
    # data fits; ingest validates the fit and raises instead of wrapping.
    dtype: str = "int64"

    # Donate the input tables to the jitted pipeline; they are deleted after
    # the call, so leave off when the same Table objects are reused. XLA
    # aliases a donated buffer only to an output of the same shape: the 1:1
    # output is [n, 7] against [n, 4] inputs, so on an H100 only the
    # row-count scalar is reused and peak device memory does not drop
    # (tests/test_gpu.py; ROADMAP C9).
    donate_inputs: bool = False

    # --- algorithm selection ---
    join_algorithm: JoinAlgorithm = "sort_merge"
    partition_scheme: PartitionScheme = "range"
    # Sort the 1:1 join's merge pass on int32 keys even for 64-bit tables
    # (SURVEY.md §7 "pack key when key width permits"): the merge sort's key
    # operand shrinks from 8 to 4 bytes. Valid only when every join-key
    # VALUE fits int32.
    #   "auto" (default) -- the DRIVER layer decides per query: run_csv
    #     probes the host arrays; the distributed pipelines probe the
    #     global device array (one replicated reduce, so every process of
    #     a multi-process run decides identically -- per-process host
    #     probes could disagree on shards and desynchronize the SPMD
    #     program). Direct pipeline_core callers get the wide path unless
    #     they resolve explicitly (see resolve_narrow).
    #   True -- force on; ingest validates the fit and raises.
    #   False -- force off.
    narrow_keys: bool | str = "auto"
    # Ride the 1:1 join's emit-sort PAYLOAD planes (the row data) as int32
    # as well: those two permutation sorts move 36+ bytes/row otherwise.
    # Valid only when every
    # VALUE in both tables fits int32 -- true for the reference generator,
    # whose values all lie in [1, 3N] (generate_data.py:7-9). Same
    # tri-state contract as narrow_keys; "auto" probes the whole tables.
    narrow_data: bool | str = "auto"

    # --- parallelism / capacity layout ---
    # Mesh axis name for the partition axis (the DPU-set analog, user.h:3).
    mesh_axis: str = "p"
    # Per-shard bucket capacity for the all_to_all exchange, in rows, as a
    # multiple of the even per-shard share. 2.0 tolerates 2x skew before the
    # skew-aware splitter refinement has to kick in.
    exchange_slack: float = 2.0
    # Rows sampled per shard for range splitter selection.
    splitter_sample: int = 1024
    # Split each table's all_to_all payload into this many independent
    # collectives (bit-identical result): finer units let XLA's
    # latency-hiding scheduler overlap one table's exchange with the other
    # table's local compute in the fused region (exchange/shuffle.py).
    exchange_chunks: int = 4
    # A key exceeding this fraction of the pooled sample is a heavy hitter:
    # its rows are co-partitioned by global occurrence rank (exact for the
    # 1:1 join semantics) instead of by key range; inner joins additionally
    # broadcast table 2's heavy rows. None = auto (0.5 / P: any key worth
    # half a shard's fair share); 1.0 disables skew handling.
    # (exchange/skew.py)
    heavy_hitter_fraction: float | None = None
    # Per-shard row capacity of the broadcast buffer for table-2 heavy rows
    # in inner-join mode; None = the exchange bucket capacity. Overflow is
    # detected and raised, never silent.
    heavy_gather_capacity: int | None = None

    # --- join output capacity, as a multiple of the probe-side capacity.
    join_slack: float = 1.0

    # --- observability ---
    collect_metrics: bool = True
    # Per-stage structured debug events (rows in/out, bytes, overflow
    # headroom) through engine/logging.log_event -- the runtime analog of
    # the reference's compile-time DEBUG row-count dumps (user.h:1,
    # app.c:294-305, 379-400) read back via dpu_log_read. Costs extra
    # device readbacks per stage, like the reference's DEBUG mode.
    debug_log: bool = False
    checkpoint_dir: str | None = None

    def __post_init__(self):
        for name in ("narrow_keys", "narrow_data"):
            val = getattr(self, name)
            if val not in (True, False, "auto"):
                raise ValueError(
                    f"{name} must be True, False, or 'auto' (got {val!r})"
                )
            if val is True and jnp.issubdtype(self.jnp_dtype(), jnp.floating):
                raise ValueError(
                    f"{name} applies to integer dtypes only "
                    f"(got dtype={self.dtype!r})"
                )

    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def narrowable(self) -> bool:
        """Whether narrow-key dispatch can apply to this dtype at all."""
        dt = self.jnp_dtype()
        return bool(
            jnp.issubdtype(dt, jnp.integer) and jnp.dtype(dt).itemsize == 8
        )

    def resolve_narrow(self, *key_columns) -> "EngineConfig":
        """Return a copy with ``narrow_keys`` resolved to a concrete bool.

        ``key_columns`` are host numpy arrays of join-key values (one per
        table); "auto" resolves to True iff every value fits the int32
        narrowing window [INT32_MIN, INT32_MAX) (ops/join.py:_narrow32).
        """
        if self.narrow_keys != "auto":
            return self
        resolved = False
        if self.narrowable() and key_columns:
            import numpy as np

            info = np.iinfo(np.int32)
            resolved = all(
                c.size == 0 or (c.min() >= info.min and c.max() < info.max)
                for c in key_columns
            )
        return dataclasses.replace(self, narrow_keys=resolved)

    def resolve_narrow_data(self, *tables) -> "EngineConfig":
        """Return a copy with ``narrow_data`` resolved to a concrete bool.

        ``tables`` are host numpy row arrays (whole tables); "auto" resolves
        to True iff EVERY value in every table fits the int32 window.
        """
        if self.narrow_data != "auto":
            return self
        resolved = False
        if self.narrowable() and tables:
            import numpy as np

            info = np.iinfo(np.int32)
            resolved = all(
                t.size == 0 or (t.min() >= info.min and t.max() < info.max)
                for t in tables
            )
        return dataclasses.replace(self, narrow_data=resolved)


def reference_config() -> EngineConfig:
    """The exact configuration of the reference benchmark run."""
    return EngineConfig()
