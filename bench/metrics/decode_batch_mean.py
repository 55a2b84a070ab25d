"""Rows of the mean batched decode step: the tokens decode steps emitted in
the window over the engine's steps in it (``stats()["steps"]``)."""

from bench.harness.readings import decode_contexts


def read(run):
    w = run.window
    steps = w.stats1["steps"] - w.stats0["steps"]
    if steps <= 0:
        return None
    return sum(1 for _ in decode_contexts(run.records, w.t0, w.t1)) / steps
