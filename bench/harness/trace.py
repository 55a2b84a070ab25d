"""The traced sub-window: ``torch.profiler`` over engine steps, its events
reduced in memory (no trace file is written).

The window is the profiler's own span ``bench.window``, which opens and
closes on a synchronised device.  From the device's events inside it
(kernels, copies, fills) come the busy time (their union), each kernel
name's total time, and the idle gaps; a gap is named by the harness span
the host was in when it opened (``bench.step``, ``bench.submit``, or
``bench.client`` between them) and, for gaps of 50 us or more, the
innermost host operation then running.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"
LONG_GAP_NS = 50_000


@dataclasses.dataclass
class Summary:
    t0: float          # host clock, window open (after a sync)
    t1: float          # host clock, window closed (after a sync)
    window_s: float    # the profiler's window span
    busy_s: float      # union of device activity inside it
    kernels: dict      # device event name -> seconds inside the window
    gaps: dict         # label -> idle seconds inside the window

    def kernel_s(self, fragment: str) -> float:
        """Seconds of every device event whose name contains ``fragment``."""
        return sum(s for name, s in self.kernels.items() if fragment in name)

    def top_ops(self, n: int = 10) -> list:
        by = collections.defaultdict(float)
        for name, s in self.kernels.items():
            by[short_name(name)] += s
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.gaps.items()), key=lambda kv: -kv[1])[:n]


def _activities(device):
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def warm(device) -> None:
    """Start and stop the profiler once, so that its first start (the
    device tracer's set-up) happens in set-up and not in the window."""
    with profile(activities=_activities(device)):
        _sync(device)


def profile_steps(loop, device, seconds: float, now) -> Summary:
    """Run ``loop.step()`` for ``seconds`` under the profiler."""
    loop.spans = True
    with profile(activities=_activities(device)) as prof:
        with record_function(WINDOW):
            _sync(device)
            t0 = now()
            while now() - t0 < seconds:
                loop.step()
            _sync(device)
            t1 = now()
    loop.spans = False
    return reduce(prof, t0, t1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every profiler event; the
    device-side copies of host annotations (``record_function`` ranges)
    are not device work and are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        dev = "CUDA" in str(e.device_type())
        annotation = getattr(e, "is_user_annotation", None)
        if dev and (name.startswith("bench.") or (annotation is not None and annotation())):
            continue
        out.append((name, dev, start, start + e.duration_ns()))
    return out


def short_name(name: str) -> str:
    """A device event's name without its return type, namespaces of its
    own and parameter list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:120]


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(prof, t0: float, t1: float) -> Summary:
    events = _events(prof)
    win = [(s, e) for name, dev, s, e in events if name == WINDOW and not dev]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = win[0]
    device, host_spans, host_ops = [], [], []
    kernels = collections.defaultdict(float)
    for name, dev, s, e in events:
        if dev:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                device.append((s, e))
                kernels[name] += (e - s) * 1e-9
        elif name in ("bench.step", "bench.submit"):
            host_spans.append((s, e, name))
        elif name != WINDOW and w0 <= s <= w1:
            host_ops.append((s, e, name))
    busy = _union(device)
    busy_ns = sum(e - s for s, e in busy)
    host_spans.sort()
    host_ops.sort()
    span_starts = [s for s, _, _ in host_spans]
    op_starts = [s for s, _, _ in host_ops]
    gaps = collections.defaultdict(float)
    prev = w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps[_label(prev, s - prev, host_spans, span_starts, host_ops, op_starts)] += (s - prev) * 1e-9
        prev = max(prev, e)
    return Summary(t0, t1, (w1 - w0) * 1e-9, busy_ns * 1e-9, dict(kernels), dict(gaps))


def _label(t, length, spans, span_starts, ops, op_starts) -> str:
    i = bisect.bisect_right(span_starts, t) - 1
    span = spans[i][2] if i >= 0 and spans[i][1] >= t else "bench.client"
    if length < LONG_GAP_NS:
        return f"{span}/gaps under 50 us"
    j = bisect.bisect_right(op_starts, t) - 1
    inner = None
    for k in range(j, max(-1, j - 64), -1):
        if ops[k][1] >= t:  # the latest to start of those still running
            inner = ops[k][2]
            break
    return f"{span}/{inner or 'python'}"
