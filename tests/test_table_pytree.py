"""`Table` and `ShardedTable` as JAX pytrees: arrays are leaves, names are
static metadata."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.engine.distributed import ShardedTable


def test_table_flatten_unflatten():
    t = Table.from_numpy(np.arange(12).reshape(6, 2), capacity=8)
    leaves, treedef = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2 and leaves[0] is t.data and leaves[1] is t.num_rows
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.names == ("col1", "col2")
    np.testing.assert_array_equal(back.to_numpy(), t.to_numpy())


def test_table_replace_is_a_copy():
    t = Table.from_numpy(np.arange(6).reshape(3, 2))
    u = t.replace(num_rows=jnp.int32(1))
    assert int(t.num_rows) == 3 and int(u.num_rows) == 1
    assert u.data is t.data and u.names == t.names


def test_table_names_static_under_jit():
    seen = []

    @jax.jit
    def f(t):
        seen.append(t.names)  # runs while tracing: names must be a tuple
        return t.replace(data=t.data + 1, names=t.names[::-1])

    t = Table.from_numpy(np.zeros((4, 2), np.int64))
    out = f(t)
    f(t.replace(data=t.data + 5))  # same names and shapes: no retrace
    assert seen == [("col1", "col2")]
    assert out.names == ("col2", "col1")
    # Different names are a different static value: a retrace.
    f(t.replace(names=("a", "b")))
    assert seen[-1] == ("a", "b")


def test_sharded_table_pytree():
    mesh = Mesh(np.array(jax.devices()[:4]), ("p",))
    st = ShardedTable.from_numpy(np.arange(40).reshape(10, 4), mesh, "p")
    leaves, treedef = jax.tree_util.tree_flatten(st)
    assert len(leaves) == 2
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.names == st.names == ("col1", "col2", "col3", "col4")
    np.testing.assert_array_equal(back.to_numpy(), np.arange(40).reshape(10, 4))
    doubled = jax.jit(lambda s: s.replace(data=s.data * 2))(st)
    assert doubled.names == st.names
    np.testing.assert_array_equal(doubled.to_numpy(), 2 * np.arange(40).reshape(10, 4))
