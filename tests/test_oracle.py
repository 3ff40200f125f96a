"""The vectorized 1:1 join oracle equals the cursor-walk definition."""

import numpy as np
import pytest

from pim_sort_merge_join_tpu.ops import oracle


def _sorted_pair(rng, n1, n2, key_hi, dtype=np.int64, offset=0):
    def table(n):
        keys = rng.integers(0, key_hi, n).astype(dtype) + dtype(offset)
        rows = np.column_stack(
            [keys, rng.integers(0, 1000, (n, 3)).astype(dtype)]
        )
        return oracle.sort_oracle(rows, 0)

    return table(n1), table(n2)


@pytest.mark.parametrize(
    "n1,n2,key_hi,dtype,offset",
    [
        (500, 500, 10**6, np.int64, 0),        # (nearly) unique keys
        (600, 400, 7, np.int64, 0),            # long duplicate runs
        (0, 300, 50, np.int64, 0),             # empty probe side
        (300, 0, 50, np.int64, 0),             # empty build side
        (400, 400, 30, np.uint64, 2**63),      # unsigned keys above int64
        (400, 300, 40, np.float64, 0),         # float keys
    ],
)
def test_vectorized_matches_loop(rng, n1, n2, key_hi, dtype, offset):
    t1, t2 = _sorted_pair(rng, n1, n2, key_hi, dtype, offset)
    want = oracle.join_one_to_one_oracle(t1, t2, 0, 0)
    got = oracle.join_one_to_one_vectorized(t1, t2, 0, 0)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
