"""Percentiles and the window's latency samples, with open gaps and
requests unserved at the window's end."""
import pytest

import stats


def test_bench_percentile_interpolates():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2], 50) == 1.5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_bench_ttft_counts_unserved_to_the_end():
    sends = [(0.5, 1.0),      # before the window: left out
             (1.0, 1.25),     # at the window's start
             (2.0, None),     # no first token: to the end
             (2.5, 4.0),      # first token after the end: to the end
             (3.0, 3.0 + 0.5),
             (3.5, None)]     # sent at the end: left out
    got = stats.ttft_samples(sends, 1.0, 3.5)
    assert got == pytest.approx([0.25, 1.5, 1.0, 0.5])


def test_bench_itl_counts_gaps_inside_and_open_gaps():
    times = [[0.5, 1.0, 1.5, 3.0],    # gaps 0.5 (from 1.0), 1.5
             [1.2, 1.2, 1.4],         # running: 0, 0.2 and open 2.1
             [2.0, 4.0],              # the gap past the end is left out
             [3.5]]                   # running, token at the end: no gap
    running = [False, True, True, True]
    got = stats.itl_samples(times, 1.0, 3.5, running)
    assert sorted(got) == pytest.approx(sorted([0.5, 1.5, 0.0, 0.2, 2.1,
                                                1.5]))

