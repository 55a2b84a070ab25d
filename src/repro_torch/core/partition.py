"""Cost-driven contiguous partitioning (the planner's stage balancer).

The paper's headline knob is that the cluster can "manually allocate
greater resources to the most computationally intensive layers of the
NN graph".  This module automates that allocation for the pipeline
strategy: given the cost model's per-layer estimates, cut the layer
stack into contiguous stages that minimize the *maximum* stage cost
(the pipeline's steady-state bottleneck), optionally weighting stages
by observed node speed so a straggling node receives a short stage.

Pure python, no backend — importable from the planner
(:mod:`repro_torch.core.scheduler`, :mod:`repro_torch.core.placement`).
The port's copy of ``repro.core.partition``.
"""

from __future__ import annotations

import re
from typing import Sequence

__all__ = [
    "partition_layers",
    "even_boundaries",
    "stage_depths",
    "stage_costs",
    "layer_costs",
    "layer_boundaries_from_plan",
    "pipeline_bubble_counts",
]


def partition_layers(
    costs: Sequence[float],
    stages: int,
    *,
    stage_weights: Sequence[float] | None = None,
) -> tuple[int, ...]:
    """Cut ``costs`` into ``stages`` contiguous non-empty segments,
    minimizing the maximum (weighted) stage cost.

    Classic linear-partition DP — the exact counterpart of
    :meth:`repro_torch.core.graph.Graph.cut_segments`, but over a bare cost
    vector (per-layer FLOP/byte estimates) instead of graph ops, so the
    runtime can consume it without a Graph in hand.

    ``stage_weights[s]`` is the relative speed of the node executing
    stage ``s`` (1.0 = nominal): segment cost is divided by it, so a
    half-speed straggler is assigned roughly half the work — the
    :func:`repro_torch.core.scheduler.rebalance` reconfiguration rule.

    Returns ``stages + 1`` boundaries ``(0, b1, ..., len(costs))`` with
    every stage non-empty; stage ``s`` holds layers
    ``[boundaries[s], boundaries[s + 1])``.
    """
    n = len(costs)
    if stages < 1:
        raise ValueError("need at least one stage")
    if stages > n:
        raise ValueError(f"{stages} stages > {n} layers: stages would be empty")
    if stage_weights is not None and len(stage_weights) != stages:
        raise ValueError("stage_weights must have one entry per stage")
    rates = [1.0] * stages if stage_weights is None else [
        max(float(w), 1e-9) for w in stage_weights
    ]
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + max(float(c), 0.0))

    INF = float("inf")
    # dp[j][s]: minimal max weighted-stage-cost covering costs[:j] with s
    # stages; stage order is fixed (stage s runs on node s), so the rate
    # of the segment ending at j in state s is rates[s - 1].
    dp = [[INF] * (stages + 1) for _ in range(n + 1)]
    back = [[0] * (stages + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for s in range(1, stages + 1):
        for j in range(s, n + 1 - (stages - s)):
            for i in range(s - 1, j):
                if dp[i][s - 1] == INF:
                    continue
                cand = max(dp[i][s - 1], (prefix[j] - prefix[i]) / rates[s - 1])
                if cand < dp[j][s]:
                    dp[j][s] = cand
                    back[j][s] = i
    bounds = [n]
    j, s = n, stages
    while s > 0:
        j = back[j][s]
        bounds.append(j)
        s -= 1
    bounds.reverse()
    return tuple(bounds)


def even_boundaries(num_layers: int, stages: int) -> tuple[int, ...]:
    """Layer-count-balanced boundaries (the pre-cost-model default):
    uniform costs make the DP place ``ceil``/``floor`` sized stages."""
    return partition_layers([1.0] * num_layers, stages)


def stage_depths(boundaries: Sequence[int]) -> tuple[int, ...]:
    """Per-stage layer counts of a boundary vector."""
    b = tuple(boundaries)
    if len(b) < 2 or b[0] != 0 or any(x >= y for x, y in zip(b, b[1:])):
        raise ValueError(f"boundaries must be strictly increasing from 0: {b}")
    return tuple(y - x for x, y in zip(b, b[1:]))


def stage_costs(
    costs: Sequence[float], boundaries: Sequence[int]
) -> tuple[float, ...]:
    """Summed cost per stage under ``boundaries`` (imbalance reporting)."""
    b = tuple(boundaries)
    if b[-1] != len(costs):
        raise ValueError("boundaries do not cover the cost vector")
    return tuple(sum(costs[x:y]) for x, y in zip(b, b[1:]))


def pipeline_bubble_counts(
    stages: int, num_microbatches: int, schedule: str = "gpipe"
) -> tuple[int, int, int]:
    """Analytic ``(rounds, busy, idle)`` stage-round accounting for one
    pipelined step — the oracle for the schedule tests and
    ``benchmarks/pipeline_bench.py`` (mirroring ``flash_tile_counts`` in
    the kernel suite).  Pure schedule arithmetic, so it lives with the
    planner; the reference's ``repro.dist.pipeline`` re-exports it.

    A *round* is one iteration of the SPMD round loop; a stage-round is
    *busy* when that stage performs at least one microbatch unit of work
    (a forward or a backward) in that round, else *idle* (it executes
    masked compute — the lockstep price of shard_map pipelining).

    ``forward``: fill-and-drain inference, ``m + S - 1`` rounds, idle
    ``S(S - 1)``.  ``gpipe`` train: backward fills only after the
    forward drains — ``2(m + S - 1)`` rounds, idle ``2S(S - 1)``.
    ``1f1b`` train: the backward stream lags the forward by only
    ``S - 1`` rounds, overlapping the forward drain with the backward
    fill — ``m + 2(S - 1)`` rounds and, once the pipe reaches steady
    state (``m >= 2(S - 1)``), idle ``S(S - 1)``: HALF of gpipe's.
    """
    m, s = num_microbatches, stages
    if m < 1 or s < 1:
        raise ValueError("need >= 1 microbatch and >= 1 stage")
    if schedule == "forward":
        rounds = m + s - 1
        busy = s * m
        return rounds, busy, s * rounds - busy
    if schedule == "gpipe":
        lag = m + s - 1
    elif schedule == "1f1b":
        lag = s - 1
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    rounds = lag + m + s - 1
    busy = 0
    for k in range(s):
        fw = set(range(k, k + m))
        bw = set(range(lag + (s - 1 - k), lag + (s - 1 - k) + m))
        busy += len(fw | bw)
    return rounds, busy, s * rounds - busy


_LAYER_RE = re.compile(r"^layer(\d+)\.")


def layer_costs(graph, num_layers: int | None = None) -> list[float]:
    """Per-layer MAC totals from a planner Graph whose ops follow the
    ``layer{i}.*`` naming of :func:`repro_torch.core.graph.transformer_graph`
    (embed / lm_head book-end ops are excluded — they run outside the
    pipe)."""
    acc: dict[int, float] = {}
    for op in graph.ops:
        m = _LAYER_RE.match(op.name)
        if m:
            li = int(m.group(1))
            acc[li] = acc.get(li, 0.0) + op.macs
    if not acc:
        raise ValueError(f"graph {graph.name!r} has no layer{{i}}.* ops")
    n = num_layers if num_layers is not None else max(acc) + 1
    return [acc.get(i, 0.0) for i in range(n)]


def plan_num_layers(plan) -> int | None:
    """Layer count implied by a plan's ``layer{i}.*`` op names (None for
    non-transformer graphs) — lets ``to_placement`` recover boundaries
    from a bare plan without the graph in hand."""
    layers = [
        int(m.group(1))
        for names in (st.ops for st in plan.stages)
        for m in (_LAYER_RE.match(nm) for nm in names)
        if m
    ]
    return max(layers) + 1 if layers else None


def layer_boundaries_from_plan(plan, num_layers: int) -> tuple[int, ...] | None:
    """Recover *layer* boundaries from a pipeline ``ClusterPlan`` whose
    stages were cut at op granularity.

    A layer is assigned to the stage holding its FIRST op (an op-level
    cut that lands between a layer's attn and ffn rounds the whole layer
    down); book-end ops (embed / lm_head) are ignored — they run outside
    the pipe.  Returns None when the mapping is not a partition into
    non-empty contiguous stages (e.g. a stage holding only book-end
    ops), in which case callers fall back to :func:`partition_layers`.
    """
    stage_of: dict[int, int] = {}
    for s, st in enumerate(plan.stages):
        for nm in st.ops:
            m = _LAYER_RE.match(nm)
            if m:
                stage_of.setdefault(int(m.group(1)), s)
    if set(stage_of) != set(range(num_layers)):
        return None
    counts = [0] * len(plan.stages)
    prev = 0
    for li in range(num_layers):
        s = stage_of[li]
        if s < prev:
            return None  # stages out of graph order
        prev = s
        counts[s] += 1
    if any(c == 0 for c in counts):
        return None  # a stage would be empty (depth-0 stages can't run)
    bounds = [0]
    for c in counts:
        bounds.append(bounds[-1] + c)
    return tuple(bounds)
