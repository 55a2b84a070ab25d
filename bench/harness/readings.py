"""What a metric reader may read of a run: the configuration and mix, the
requests as sent with the times of their tokens, the engine's counters at
the window's ends, the traced sub-window, and the shapes of the work that
fell inside an interval, worked out from the traffic."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    c: dict             # the configuration file, as run
    mix: dict           # the traffic mix
    records: list       # serve.Served, every request sent
    window: object      # serve.Window
    setup_s: float


def decode_contexts(records, t0: float, t1: float):
    """The keys each decode row attended (its prompt and every earlier
    token, its own input included), for each token a decode step emitted
    inside [t0, t1]; a request's first token comes from its prefill."""
    for r in records:
        for j, t in enumerate(r.times):
            if j and t0 <= t <= t1:
                yield r.n + j


def decode_steps(records, t0: float, t1: float, page: int):
    """``(kv_lens, unique_keys)`` of each decode step whose tokens reached
    their clients inside [t0, t1]: the keys each of its rows attended, and
    how many distinct keys they span, a document's whole pages counted
    once however many rows start with it."""
    steps = {}
    for r in records:
        for j, t in enumerate(r.times):
            if j and t0 <= t <= t1:
                steps.setdefault(t, []).append((r, r.n + j))
    for rows in steps.values():
        shared = {r.item.doc: r.m // page * page for r, _ in rows if r.m}
        own = sum(kv - (r.m // page * page if r.m else 0) for r, kv in rows)
        yield [kv for _, kv in rows], own + sum(shared.values())


def prefill_chunks(records, t0: float, t1: float, chunk: int):
    """``(q_offset, rows)`` of each prefill chunk, of every request whose
    first token fell inside [t0, t1] (its prefill ran in that step): the
    rows past the part its document shares, in chunks of ``chunk``."""
    for r in records:
        if r.times and t0 <= r.times[0] <= t1:
            for off in range(r.m, r.n, chunk):
                yield off, min(chunk, r.n - off)
