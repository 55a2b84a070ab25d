"""Every token emitted inside the window, over the window's seconds."""

from bench.harness import stats


def read(run):
    w = run.window
    return stats.output_tokens(run.records, w.t0, w.t1) / (w.t1 - w.t0)
