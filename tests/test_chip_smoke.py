"""chip_smoke.py's phases at tiny sizes on the CPU, and its GPU-only guard.

The script's own run on the card is the real check; here its control flow,
oracles and comparisons are exercised on the virtual CPU mesh.
"""

import jax
import numpy as np
import pytest

import chip_smoke


def test_phase_reference_csv(tmp_path, capsys):
    out = chip_smoke.phase_reference_csv(str(tmp_path), rows=3000, seed=5)
    assert out["rows_out"] > 0
    assert "byte-exact" in capsys.readouterr().out


@pytest.mark.parametrize("keys,ab_reps", [("unique", 2), ("zipf", 0)])
def test_phase_tables(keys, ab_reps, capsys):
    out = chip_smoke.phase_tables(4000, seed=3, keys=keys, ab_reps=ab_reps)
    assert out["rows_out"] > 0
    assert out["narrow_data"] is True
    printed = capsys.readouterr().out
    assert ("narrow_data A/B" in printed) == bool(ab_reps)
    if ab_reps:
        assert set(out["ab_median_s"]) == {True, False}


def test_phase_modes(tmp_path, capsys):
    report = chip_smoke.phase_modes(str(tmp_path), rows=3000, seed=2)
    assert set(report) == {"inner", "hash", "resumable"}
    assert all(n > 0 for n, _, _ in report.values())


def test_phase_four_on_virtual_mesh(capsys):
    report = chip_smoke.phase_four(600, seed=1, devices=jax.devices()[:4])
    for keys in ("unique", "zipf"):
        assert len(report[keys]["per_card"]) == 4
        assert min(report[keys]["per_card"].values()) > 0
    assert report["unique"]["spread_keys"] == 0
    assert report["zipf"]["spread_keys"] > 0  # heavy keys were rank-routed


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def _rank_routed(p=2, misroute=False):
    """An oracle output with one heavy key (7) and its rank-routed mesh
    layout on ``p`` cards: key 7's rank r on card r % p, other keys whole
    on their range card. ``misroute`` puts key 7's rank-1 row on card 0,
    in oracle order there."""
    want = np.array([[k, i] for i, k in enumerate([1, 2, 7, 7, 7, 7, 7, 9, 11])])
    rank = np.arange(len(want)) - np.searchsorted(want[:, 0], want[:, 0])
    card = np.where(want[:, 0] == 7, rank % p, (want[:, 0] > 7).astype(int))
    if misroute:
        card[(want[:, 0] == 7) & (rank == 1)] = 0
    got = np.concatenate([want[card == c] for c in range(p)])
    return got, want, np.bincount(card, minlength=p)


@pytest.mark.parametrize("fault", [None, "swap_in_card", "wrong_card", "lost_row"])
def test_check_rank_routed(fault):
    got, want, counts = _rank_routed(misroute=fault == "wrong_card")
    if fault is None:
        assert chip_smoke._check_rank_routed("t", got, want, counts) == 1
        return
    if fault == "swap_in_card":  # rows 0 and 1 of card 0 exchanged
        got[[0, 1]] = got[[1, 0]]
    elif fault == "lost_row":
        got[-1, 1] += 100
    with pytest.raises(AssertionError, match={
        "swap_in_card": "out of oracle order", "wrong_card": "rank % P",
        "lost_row": "row multiset",
    }[fault]):
        chip_smoke._check_rank_routed("t", got, want, counts)
