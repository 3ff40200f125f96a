"""Key-space partitioning: splitter sampling and destination assignment.

The replacement for the reference's two partitioning mechanisms
(SURVEY.md sections 2c/5): the host binary merge tree that funnels all rows
into ONE device per table (app.c:419-547, the scaling bottleneck), and the
stage-4 boundary co-partitioning by binary search (app.c:585-633). Instead we
do splitter-based range repartitioning (sample sort): sample keys from both
tables, choose P-1 splitters, and route every row to the shard owning its key
range. One all_to_all round replaces the O(log n) merge tree, and both tables
are co-partitioned by construction -- the join never needs a global table.

Skew handling: splitters come from a global sample of BOTH tables' keys, so a
Zipf-heavy key distribution moves the range boundaries instead of overloading
one shard; rows with equal keys always land on one shard (required for 1:1
join semantics), so single-key hot spots bound per-shard load from below --
the exchange's slack factor plus overflow detection (shuffle.py) make that
visible rather than silent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pim_sort_merge_join_tpu.columnar.table import key_sentinel


def sample_keys(keys: jax.Array, num_valid: jax.Array, sample_size: int) -> jax.Array:
    """Evenly-strided sample of the first ``num_valid`` entries of ``keys``.

    ``keys`` is a per-shard [cap] array (invalid tail already sentinel).
    Returns [sample_size]; when the shard holds fewer valid rows than the
    sample size, entries repeat (harmless for quantile selection); an empty
    shard contributes sentinels, which the splitter chooser masks out.
    """
    s = jnp.arange(sample_size, dtype=jnp.int32)
    idx = jnp.where(
        num_valid > 0,
        (s * jnp.maximum(num_valid, 1)) // sample_size,
        0,
    )
    sample = jnp.take(keys, idx, axis=0)
    return jnp.where(num_valid > 0, sample, key_sentinel(keys.dtype))


def choose_splitters(samples: jax.Array, num_partitions: int) -> jax.Array:
    """Pick ``num_partitions - 1`` range splitters from pooled key samples.

    ``samples``: flat array pooling every shard's samples from both tables,
    with sentinel entries for invalid slots. Returns ascending splitters
    [P-1]; partition p owns keys in (splitter[p-1], splitter[p]] -- computed
    by ``destination_of`` as searchsorted-left, so a key equal to a splitter
    routes to the partition whose upper bound it is.
    """
    sorted_samples = jnp.sort(samples)
    sentinel = key_sentinel(samples.dtype)
    valid = jnp.sum(sorted_samples != sentinel).astype(jnp.int32)
    p = jnp.arange(1, num_partitions, dtype=jnp.int32)
    idx = jnp.minimum((p * jnp.maximum(valid, 1)) // num_partitions,
                      jnp.maximum(valid - 1, 0))
    return jnp.take(sorted_samples, idx, axis=0)


def destination_of(keys: jax.Array, splitters: jax.Array, valid: jax.Array) -> jax.Array:
    """Destination shard in [0, P) per row; invalid rows get P (dropped).

    All rows with equal keys get one destination (side='left' boundary),
    which the 1:1 join semantics require.
    """
    num_partitions = splitters.shape[0] + 1
    d = jnp.searchsorted(splitters, keys, side="left").astype(jnp.int32)
    return jnp.where(valid, d, num_partitions)


def hash_destination_of(
    keys: jax.Array, num_partitions: int, valid: jax.Array
) -> jax.Array:
    """Hash-partitioned destination shard (BASELINE config 3).

    ``mix(key) % P`` with the bijective finalizers from `ops/hash_join`:
    equal keys co-locate (the join invariant) regardless of key
    distribution, with no splitter sampling round. Unlike range
    partitioning, shard order does NOT follow key order, so globally
    ordered output requires a key-merge at materialization.
    """
    from pim_sort_merge_join_tpu.ops.hash_join import hash_column

    h = hash_column(keys)
    d = (h % jnp.asarray(num_partitions, h.dtype)).astype(jnp.int32)
    return jnp.where(valid, d, num_partitions)
