"""Example 1: the reference workload on one chip.

Mirrors the reference's HelloWorld-to-app flow (example/HelloWorld +
sort-merge-join/app.c): load two CSVs, filter, sort, 1:1 merge-join, write
result.csv.

Run: python examples/01_single_chip_pipeline.py [data1.csv data2.csv]
(without arguments it generates a 100k-row pair from a seed first)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pim_sort_merge_join_tpu as smj

if len(sys.argv) > 2:
    d1, d2 = sys.argv[1], sys.argv[2]
else:
    from pim_sort_merge_join_tpu.columnar.generate import write_table_pair

    d1, d2 = "data1.csv", "data2.csv"
    write_table_pair(d1, d2, 100_000, seed=1)

config = smj.EngineConfig(
    predicate1=smj.Predicate(col=0, op=">", value=5000),
    predicate2=smj.Predicate(col=0, op=">", value=5000),
    join_key1=0,
    join_key2=0,
)
pipe = smj.QueryPipeline(config)
result = pipe.run_csv(d1, d2, "result.csv")
print(f"joined rows: {int(result.num_rows)}")
print(pipe.metrics_json())
