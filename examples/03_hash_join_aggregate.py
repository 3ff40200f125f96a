"""Example 3: hash join and hash aggregate.

The comparison path to sort-merge: bijective-hash ordering instead of key
ordering (see ops/hash_join.py).

Run: python examples/03_hash_join_aggregate.py [--simulator N]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


if "--simulator" in sys.argv:
    from pim_sort_merge_join_tpu.runner.simulator import use_simulator

    use_simulator(int(sys.argv[sys.argv.index("--simulator") + 1]))

import numpy as np

from pim_sort_merge_join_tpu.columnar.table import Table
from pim_sort_merge_join_tpu.ops.hash_join import hash_aggregate, hash_join

rng = np.random.default_rng(0)
orders = np.column_stack(
    [
        rng.integers(1, 50, 2000),      # customer id (duplicates)
        rng.integers(1, 1000, 2000),    # amount
        rng.integers(1, 10, 2000),      # quantity
    ]
).astype(np.int64)
customers = np.column_stack(
    [np.arange(1, 50), rng.integers(1, 5, 49)]
).astype(np.int64)

t_orders = Table.from_numpy(orders, names=("cust", "amount", "qty"))
t_cust = Table.from_numpy(customers, names=("cust", "region"))

joined = hash_join(t_orders, t_cust, 0, 0, mode="one_to_one")
print(f"joined rows: {int(joined.num_rows)}")

totals = hash_aggregate(t_orders, key=0, value=1, agg="sum")
print("per-customer totals (first 5):")
print(totals.to_numpy()[:5])
