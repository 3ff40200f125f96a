"""Columnar device-table model.

The engine's table representation replaces the reference's exact-size host
arrays (`T[row][col]`, loaded by `load_csv`, app.c:59-92) with a
fixed-capacity device buffer of shape ``[capacity, ncol]`` plus a traced
``num_rows`` scalar.

Physical layout note: the buffer is row-major ``[capacity, ncol]``. The
operators slice columns out (`column(c)`, a strided slice) and re-stack them
after each multi-operand sort, so the API stays columnar whatever the layout.

Capacity is static (XLA wants static shapes); ``num_rows`` carries the
data-dependent row count produced by filters and joins. Rows at index
``>= num_rows`` are padding whose contents are unspecified; every operator
masks them out (see SURVEY.md section 7 "Hard parts": capacity-bounded buffers
+ validity masks replace the reference's exact-size mallocs at app.c:266,679).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel used for masked-out sort keys: sorts after every real key.
def key_sentinel(dtype) -> jnp.ndarray:
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf, dtype=dtype)
    return jnp.array(jnp.iinfo(dtype).max, dtype=dtype)


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["data", "num_rows"],
    meta_fields=["names"],
)
@dataclasses.dataclass(frozen=True)
class Table:
    """A fixed-capacity columnar table on device (a JAX pytree).

    Attributes:
      data: ``[capacity, ncol]`` array; ``data[:, c]`` is column ``c``.
      num_rows: int32 scalar; rows ``[0, num_rows)`` are valid.
      names: static tuple of column names (``col1``, ``col2``, ...); pytree
        metadata, so it stays a Python value under ``jit``.
    """

    data: jax.Array
    num_rows: jax.Array
    names: tuple = ()

    def replace(self, **changes) -> "Table":
        """Copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)

    # --- static shape accessors -------------------------------------------
    @property
    def ncol(self) -> int:
        return self.data.shape[1]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def column(self, c: int) -> jax.Array:
        """Logical column ``c`` as a 1D ``[capacity]`` array."""
        return self.data[:, c]

    @property
    def dtype(self):
        return self.data.dtype

    # --- construction ------------------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        array: np.ndarray,
        *,
        capacity: int | None = None,
        names: Sequence[str] | None = None,
        dtype=jnp.int64,
    ) -> "Table":
        """Build a device table from a row-major ``[nrow, ncol]`` host array."""
        if array.ndim != 2:
            raise ValueError(f"expected 2D [nrow, ncol] array, got {array.shape}")
        nrow, ncol = array.shape
        capacity = nrow if capacity is None else capacity
        if capacity < nrow:
            raise ValueError(f"capacity {capacity} < nrow {nrow}")
        if names is None:
            names = tuple(f"col{i + 1}" for i in range(ncol))
        buf = np.zeros((capacity, ncol), dtype=np.dtype(dtype))
        buf[:nrow, :] = array
        return cls(
            data=jnp.asarray(buf, dtype=dtype),
            num_rows=jnp.asarray(nrow, dtype=jnp.int32),
            names=tuple(names),
        )

    @classmethod
    def empty(cls, ncol: int, capacity: int, *, names=None, dtype=jnp.int64) -> "Table":
        if names is None:
            names = tuple(f"col{i + 1}" for i in range(ncol))
        return cls(
            data=jnp.zeros((capacity, ncol), dtype=dtype),
            num_rows=jnp.asarray(0, dtype=jnp.int32),
            names=tuple(names),
        )

    # --- masks and keys ----------------------------------------------------
    def valid_mask(self) -> jax.Array:
        """Boolean ``[capacity]`` mask of valid rows."""
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.num_rows

    def masked_keys(self, col: int) -> jax.Array:
        """Column ``col`` with padding rows replaced by the +inf sentinel.

        The result is safe to sort / searchsorted: padding sorts last.
        """
        return jnp.where(self.valid_mask(), self.data[:, col], key_sentinel(self.dtype))

    # --- host materialization ---------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Row-major ``[num_rows, ncol]`` host array of the valid rows."""
        n = int(jax.device_get(self.num_rows))
        data = np.asarray(jax.device_get(self.data))
        return data[:n, :].copy()

    def with_capacity(self, capacity: int) -> "Table":
        """Return a copy padded/truncated to a new static capacity.

        Truncation below ``num_rows`` is a caller error (not checked on
        device; checked when capacity is concrete and num_rows is not traced).
        """
        cap, ncol = self.data.shape
        if capacity == cap:
            return self
        if capacity > cap:
            pad = jnp.zeros((capacity - cap, ncol), dtype=self.dtype)
            data = jnp.concatenate([self.data, pad], axis=0)
        else:
            data = self.data[:capacity, :]
        return self.replace(data=data)


def concat_tables(tables: Sequence[Table]) -> Table:
    """Concatenate same-schema tables row-wise, compacting valid rows.

    The capacity of the result is the sum of input capacities. Used by the
    host-side materialization path when gathering per-partition results (the
    analog of the reference's host re-concatenation at app.c:272-288).
    """
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    ncol = tables[0].ncol
    total_cap = sum(t.capacity for t in tables)
    out = np.zeros((0, ncol), dtype=np.dtype(tables[0].dtype))
    parts = [t.to_numpy() for t in tables]
    out = np.concatenate([out] + parts, axis=0)
    return Table.from_numpy(
        out, capacity=total_cap, names=tables[0].names, dtype=tables[0].dtype
    )
