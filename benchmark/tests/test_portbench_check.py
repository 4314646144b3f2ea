"""The check's arithmetic: recall, the sample, the compared numbers."""

import numpy as np
import pytest

from benchmark import check


def test_precision_at_k_by_hand():
    served = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    exact = np.array([[4, 3, 9, 1], [5, 6, 7, 8]])
    # first query: {1, 3, 4} of 4; second: all 4
    assert check.precision_at(served, exact, 4) == pytest.approx((3 + 4) / 8)
    # at 2: {1, 2} & {4, 3} = 0; {5, 6} & {5, 6} = 2
    assert check.precision_at(served, exact, 2) == pytest.approx(0.5)


def test_sample_spreads_over_the_window_and_follows_the_seed():
    pos = check.sample_positions(1000, 10, 7)
    assert len(pos) == 10
    for s, p in enumerate(pos):                 # one in each tenth
        assert 100 * s <= p < 100 * (s + 1)
    np.testing.assert_array_equal(pos, check.sample_positions(1000, 10, 7))
    assert not np.array_equal(pos, check.sample_positions(1000, 10, 8))
    np.testing.assert_array_equal(check.sample_positions(5, 10, 1),
                                  np.arange(5))
    assert len(check.sample_positions(0, 10, 1)) == 0


def test_malformed_answers():
    idx = np.array([[3, 1, 2], [3, 3, 2], [3, 1, 9], [3, 1, 2], [3, 1, 2]])
    vals = np.array([[3., 2., 1.], [3., 2., 1.], [3., 2., 1.],
                     [3., np.nan, 1.], [1., 2., 3.]])
    np.testing.assert_array_equal(check.malformed(idx, vals, 3, 9),
                                  [False, True, True, True, True])
    assert check.malformed(idx[:, :2], vals[:, :2], 3, 9).all()


def test_numbers_by_hand():
    idx = np.array([[0, 1], [2, 3]])
    vals = np.array([[10.0, 8.0], [5.0, 4.0]], np.float32)
    of_served = np.array([[10.0, 8.0], [5.0, 3.5]])
    kth = np.array([8.0, 4.0])
    best = np.array([10.0, 5.0])
    n = check.numbers(idx, vals, of_served, kth, best, 2, 4)
    assert n["bad_answers"] == 0
    assert n["score_gap"] == pytest.approx(0.5 / 5.0)     # 4 against 3.5
    assert n["rank_gap"] == pytest.approx(0.5 / 5.0)      # 3.5 under 4
    ok, lines = check.verdict(n, {"bad_answers": 0, "score_gap": 0.2,
                                  "rank_gap": 0.2})
    assert ok and len(lines) == 3
    ok, lines = check.verdict(n, {"bad_answers": 0, "score_gap": 0.05,
                                  "rank_gap": 0.2})
    assert not ok and "FAIL" in lines[1]


def test_a_nan_number_never_passes():
    n = {"bad_answers": 0, "score_gap": float("nan"), "rank_gap": 0.0}
    ok, _ = check.verdict(n, {"bad_answers": 0, "score_gap": 1.0,
                              "rank_gap": 1.0})
    assert not ok
