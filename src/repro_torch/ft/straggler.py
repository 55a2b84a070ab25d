"""Straggler detection + mitigation.

Detection is generic: feed per-node step durations into
``StragglerMonitor``; nodes persistently slower than ``threshold`` x the
cluster median get flagged.

Mitigation is the paper's: *reconfigure* rather than wait or drop —

  * cluster plans are re-balanced with :func:`repro_torch.core.scheduler.
    rebalance` (slow nodes get fewer op-slices / later pipeline stages),
  * on a device mesh, persistent stragglers trigger the elastic path
    instead (checkpoint -> reform mesh without the sick host -> resume;
    ``ft.elastic`` and ``ft.supervisor``), since SPMD steps are
    collectively synchronized and one slow chip gates every step.

The port's copy of ``repro.ft.straggler`` (pure Python): the planner it
re-cuts is the port's own ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque

from repro_torch.core.graph import Graph
from repro_torch.core.scheduler import rebalance
from repro_torch.core.strategies import ClusterPlan


@dataclasses.dataclass
class Ewma:
    """Exponentially-weighted moving average with a sample count.

    The smoother behind the heartbeat monitor's per-host inter-beat
    interval estimate (ft/health.py): the first sample seeds the value
    directly (no zero-bias warmup), ``count`` lets consumers gate
    decisions on a minimum history — a miss verdict off one sample
    would fire on ordinary jitter.
    """

    alpha: float = 0.3
    value: float = 0.0
    count: int = 0

    def update(self, x: float) -> float:
        self.count += 1
        self.value = (x if self.count == 1
                      else (1.0 - self.alpha) * self.value + self.alpha * x)
        return self.value


@dataclasses.dataclass
class StragglerReport:
    rates: dict[int, float]  # node -> relative speed (1.0 = median)
    stragglers: list[int]


def _median(values) -> float:
    """True median: mean of the two middle elements for even counts (the
    upper-middle shortcut biases the baseline toward the slow half of a
    small cluster, masking real stragglers and flagging healthy nodes)."""
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


class StragglerMonitor:
    """Sliding-window per-node step-duration tracker.

    ``min_samples`` gates both the per-node mean and the verdict: a node
    is only compared against the cluster median once it has that many
    recorded steps, so a single hiccup (GC pause, page fault) can never
    trigger a cluster reconfiguration.
    """

    def __init__(self, window: int = 16, threshold: float = 1.3,
                 min_samples: int = 4):
        self.window = window
        self.threshold = threshold
        self.min_samples = max(2, min(min_samples, window))
        self._hist: dict[int, deque] = defaultdict(lambda: deque(maxlen=window))

    def record(self, node: int, duration_s: float) -> None:
        self._hist[node].append(duration_s)

    def reset(self) -> None:
        """Drop all history — call after a reconfiguration, when old
        per-node timings no longer describe the new plan."""
        self._hist.clear()

    def report(self) -> StragglerReport:
        means = {
            n: sum(h) / len(h)
            for n, h in self._hist.items()
            if len(h) >= self.min_samples
        }
        if not means:
            return StragglerReport(rates={}, stragglers=[])
        med = _median(means.values())
        rates = {n: med / m for n, m in means.items()}  # slow node -> <1
        stragglers = [
            n for n, m in means.items() if m > self.threshold * med
        ]
        return StragglerReport(rates=rates, stragglers=sorted(stragglers))


def mitigate(graph: Graph, plan: ClusterPlan, report: StragglerReport) -> ClusterPlan:
    """Reconfigure the plan so flagged stragglers get the least work."""
    if not report.stragglers:
        return plan
    return rebalance(graph, plan, report.rates)
