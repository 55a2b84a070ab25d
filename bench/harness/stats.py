"""End-to-end arithmetic over a window: a rate over all of the window's
work and time, and percentiles over all of its samples.  Times are the
benchmark's own: when a client sent a request (``t_sent``) and when each
token reached it (``times``)."""

from __future__ import annotations

import math


def percentile(values, p: float) -> float | None:
    """The ``p``-th percentile (0-100) of every value, interpolated
    linearly between the closest ranks; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def in_window(t: float, t0: float, t1: float) -> bool:
    return t0 <= t <= t1


def output_tokens(records, t0: float, t1: float) -> int:
    """Tokens emitted inside [t0, t1], over every request."""
    return sum(1 for r in records for t in r.times if in_window(t, t0, t1))


def ttfts(records, t0: float, t1: float) -> list:
    """Sending to first token, of every request whose first token reached
    its client inside [t0, t1]."""
    return [r.times[0] - r.t_sent for r in records if r.times and in_window(r.times[0], t0, t1)]


def itls(records, t0: float, t1: float) -> list:
    """Every gap between a request's consecutive tokens whose later token
    fell inside [t0, t1]."""
    out = []
    for r in records:
        ts = r.times
        out += [b - a for a, b in zip(ts, ts[1:]) if in_window(b, t0, t1)]
    return out
