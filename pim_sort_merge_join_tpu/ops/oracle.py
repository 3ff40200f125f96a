"""NumPy oracle implementations of the pipeline semantics.

The differential-testing counterpart of the reference's single-threaded CPU
baseline (`cpu_app.c`): the same filter / sort / 1:1-join semantics in plain
host code, used by the test suite to validate every device operator and the
end-to-end pipeline (SURVEY.md section 4 -- the reference runs `cpu_app` and
`app` side by side; we automate the comparison it left manual).
"""

from __future__ import annotations

import numpy as np

_OPS = {
    ">": np.greater,
    ">=": np.greater_equal,
    "<": np.less,
    "<=": np.less_equal,
    "==": np.equal,
    "!=": np.not_equal,
}


def filter_oracle(rows: np.ndarray, col: int, op: str, value) -> np.ndarray:
    """select_in_cpu (cpu_app.c:81-112) generalized to all comparison ops."""
    return rows[_OPS[op](rows[:, col], value)]


def sort_oracle(rows: np.ndarray, key: int) -> np.ndarray:
    """insertion_sort_in_cpu (cpu_app.c:172-202): stable ascending key sort."""
    order = np.argsort(rows[:, key], kind="stable")
    return rows[order]


def join_one_to_one_oracle(
    t1: np.ndarray, t2: np.ndarray, key1: int, key2: int
) -> np.ndarray:
    """join_in_cpu (cpu_app.c:204-266): two-cursor merge, both cursors advance
    on equality, output = t1 row ++ t2 row minus key2 column."""
    n1, c1 = t1.shape
    n2, c2 = t2.shape
    keep2 = [c for c in range(c2) if c != key2]
    out = []
    i = j = 0
    while i < n1 and j < n2:
        a, b = t1[i, key1], t2[j, key2]
        if a == b:
            out.append(np.concatenate([t1[i], t2[j, keep2]]))
            i += 1
            j += 1
        elif a < b:
            i += 1
        else:
            j += 1
    if not out:
        return np.zeros((0, c1 + c2 - 1), dtype=t1.dtype)
    return np.stack(out)


def _run_ranks(keys: np.ndarray) -> np.ndarray:
    """Occurrence rank of each element within its run of equal keys."""
    n = keys.shape[0]
    iota = np.arange(n, dtype=np.int64)
    head = np.ones(n, dtype=bool)
    head[1:] = keys[1:] != keys[:-1]
    return iota - np.maximum.accumulate(np.where(head, iota, 0))


def join_one_to_one_vectorized(
    t1: np.ndarray, t2: np.ndarray, key1: int, key2: int
) -> np.ndarray:
    """`join_one_to_one_oracle` without the Python loop, for large inputs.

    Both tables sorted ascending on their keys. The cursor walk pairs the
    k-th row of a key's run in t1 with the k-th row of that key's run in
    t2, so: rank each t1 row within its run, look its key up in t2 (run
    start ``lo``, run length ``hi - lo``), and keep it iff its rank is
    below the t2 run length, partnering row ``lo + rank``. Output follows
    t1 row order, as the loop's does. Tested equal to the loop.
    """
    c2 = t2.shape[1]
    keep2 = [c for c in range(c2) if c != key2]
    k1, k2 = t1[:, key1], t2[:, key2]
    occ = _run_ranks(k1)
    lo = np.searchsorted(k2, k1, side="left")
    hi = np.searchsorted(k2, k1, side="right")
    hit = occ < hi - lo
    return np.concatenate([t1[hit], t2[(lo + occ)[hit]][:, keep2]], axis=1)


def join_inner_oracle(t1: np.ndarray, t2: np.ndarray, key1: int, key2: int) -> np.ndarray:
    """Standard inner join, output ordered by (t1 row index, t2 row index)."""
    c1, c2 = t1.shape[1], t2.shape[1]
    keep2 = [c for c in range(c2) if c != key2]
    out = []
    order2 = np.argsort(t2[:, key2], kind="stable")
    t2s = t2[order2]
    k2 = t2s[:, key2]
    for row in t1:
        lo = np.searchsorted(k2, row[key1], side="left")
        hi = np.searchsorted(k2, row[key1], side="right")
        for j in range(lo, hi):
            out.append(np.concatenate([row, t2s[j, keep2]]))
    if not out:
        return np.zeros((0, c1 + c2 - 1), dtype=t1.dtype)
    return np.stack(out)


def pipeline_oracle(
    rows1: np.ndarray,
    rows2: np.ndarray,
    *,
    pred1=(0, ">", 5000),
    pred2=(0, ">", 5000),
    key1: int = 0,
    key2: int = 0,
    mode: str = "one_to_one",
) -> np.ndarray:
    """cpu_app.c main (:303-361): filter both, sort both, join.

    ``mode="inner"`` swaps the reference's 1:1 cursor join for a standard
    SQL inner join (cross product on duplicates).
    """
    f1 = filter_oracle(rows1, *pred1)
    f2 = filter_oracle(rows2, *pred2)
    s1 = sort_oracle(f1, key1)
    s2 = sort_oracle(f2, key2)
    if mode == "inner":
        return join_inner_oracle(s1, s2, key1, key2)
    return join_one_to_one_vectorized(s1, s2, key1, key2)


def hash_aggregate_oracle(
    rows: np.ndarray, key: int, value: int, agg: str = "sum"
) -> np.ndarray:
    """Group-by-key aggregate oracle; output sorted by key ascending."""
    keys = rows[:, key]
    uniq, inv = np.unique(keys, return_inverse=True)
    vals = rows[:, value]
    if agg == "sum":
        out = np.zeros(len(uniq), dtype=vals.dtype)
        np.add.at(out, inv, vals)
    elif agg == "count":
        out = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(out, inv, 1)
    elif agg == "min":
        out = np.full(len(uniq), np.iinfo(vals.dtype).max, dtype=vals.dtype)
        np.minimum.at(out, inv, vals)
    elif agg == "max":
        out = np.full(len(uniq), np.iinfo(vals.dtype).min, dtype=vals.dtype)
        np.maximum.at(out, inv, vals)
    else:
        raise ValueError(agg)
    return np.stack([uniq, out], axis=1)
