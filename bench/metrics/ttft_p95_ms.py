"""95th percentile of submission to first token, over every request whose
first token fell inside the window."""

from bench.harness import stats


def read(run):
    p = stats.percentile(stats.ttfts(run.records, run.window.t0, run.window.t1), 95)
    return None if p is None else p * 1e3
