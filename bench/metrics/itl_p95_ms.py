"""95th percentile of every gap between a request's consecutive tokens,
whose later token fell inside the window, over all requests."""

from bench.harness import stats


def read(run):
    p = stats.percentile(stats.itls(run.records, run.window.t0, run.window.t1), 95)
    return None if p is None else p * 1e3
