"""The end-to-end arithmetic: a rate over all of the window's work and
time, percentiles over all samples, so one stall moves both."""

import statistics
from types import SimpleNamespace

from bench.harness import stats


def _req(t_sent, times):
    return SimpleNamespace(t_sent=t_sent, times=list(times))


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 100) == 5.0
    assert abs(stats.percentile(xs, 95) - 4.8) < 1e-12
    assert stats.percentile([], 95) is None
    assert stats.percentile(xs, 25) == statistics.quantiles(xs, n=4, method="inclusive")[0]


def test_window_counts_only_inside():
    recs = [_req(0.0, [0.5, 1.0, 2.0, 3.0]), _req(1.5, [2.5, 3.5, 4.5])]
    assert stats.output_tokens(recs, 1.0, 3.0) == 4
    assert stats.ttfts(recs, 1.0, 3.0) == [1.0]
    assert sorted(stats.itls(recs, 1.0, 3.0)) == [0.5, 1.0, 1.0]


def test_one_stall_moves_the_rate_and_the_tail():
    # 4 clients, a token each every 10 ms over 10 s; then one 500 ms stall
    steady = [_req(0.0, [0.01 * k for k in range(1, 1001)]) for _ in range(4)]
    stalled = [_req(0.0, [0.01 * k + (0.5 if k > 500 else 0.0) for k in range(1, 1001)])
               for _ in range(4)]

    def rate(recs):
        return stats.output_tokens(recs, 0.0, 10.0) / 10.0

    assert rate(stalled) < rate(steady)
    tail = [stats.percentile(stats.itls(r, 0.0, 10.0), 100) for r in (steady, stalled)]
    assert tail[1] > tail[0] + 0.4
