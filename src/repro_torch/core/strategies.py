"""The paper's four distributed scheduling strategies.

Each strategy maps a computation :class:`~repro_torch.core.graph.Graph` onto a
cluster of ``num_nodes`` accelerator nodes and yields a
:class:`ClusterPlan`.  Plans are *backend neutral*: the FPGA discrete-event
simulator executes them against board/network models to reproduce the
paper's tables, and :mod:`repro_torch.core.placement` turns the same plans
into pipeline cut points.  The port's copy of ``repro.core.strategies``.

Strategy semantics (paper §II-C):

* ``scatter_gather``   — replicate the whole graph on every node and
  round-robin input frames across them; gather ordered outputs.
* ``ai_core_assignment`` — split *operators* across nodes, giving the
  bottleneck (highest-MAC) operators the most nodes.  Consumers of a split
  op receive the producer's slices (broadcast/reshard traffic — the
  paper's observed small-N penalty).
* ``pipeline``        — cut the graph into cost-balanced contiguous
  segments, one node per segment; images stream through the pipe.
* ``fused``           — pipeline whose *stage widths* are chosen by the
  AI-core rule: heavier segments get more nodes, and ops inside a stage
  are split across the stage's nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.graph import Graph, Op

STRATEGIES = ("scatter_gather", "ai_core_assignment", "pipeline", "fused")


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """A contiguous graph segment bound to a set of nodes."""

    ops: tuple[str, ...]
    nodes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    strategy: str
    num_nodes: int
    graph_name: str
    #: data-parallel replicas (scatter-gather); 1 otherwise
    replicas: int
    #: pipeline stages (1 stage == no pipelining)
    stages: tuple[StagePlan, ...]
    #: per-op node assignment (op name -> node ids computing its slices)
    assignment: dict[str, tuple[int, ...]]
    #: images batched per op visit when a node multiplexes several split
    #: ops (the 'maintain order of subsequent computations' schedule knob)
    op_batch: int = 1
    #: how multi-node stages use their nodes: "split" slices each op
    #: across the stage (AI-core), "replicate" round-robins whole images
    #: across stage replicas (fused schedule)
    stage_mode: str = "split"

    def nodes_of(self, op_name: str) -> tuple[int, ...]:
        return self.assignment[op_name]

    def way_split(self, op: Op) -> int:
        return min(len(self.assignment[op.name]), max(op.divisible, 1))

    def validate(self, graph: Graph) -> None:
        missing = [o.name for o in graph.ops if o.name not in self.assignment]
        if missing:
            raise ValueError(f"plan misses ops: {missing[:4]}...")
        used = {n for nodes in self.assignment.values() for n in nodes}
        if used and max(used) >= self.num_nodes * self.replicas:
            raise ValueError("plan references nodes beyond the cluster")
        for st in self.stages:
            for name in st.ops:
                if set(self.assignment[name]) - set(st.nodes):
                    raise ValueError(f"{name} assigned outside its stage")


# ---------------------------------------------------------------------------
# Allocation helpers
# ---------------------------------------------------------------------------


def _largest_remainder(weights: Sequence[float], total: int, floors: Sequence[int]) -> list[int]:
    """Apportion ``total`` units proportionally to ``weights`` with per-item
    minimums ``floors`` (classic largest-remainder method)."""
    n = len(weights)
    floors = list(floors)
    spare = total - sum(floors)
    if spare < 0:
        raise ValueError("floors exceed total")
    wsum = sum(weights) or 1.0
    quotas = [w / wsum * spare for w in weights]
    alloc = [f + int(q) for f, q in zip(floors, quotas)]
    rem = sorted(
        range(n), key=lambda i: (quotas[i] - int(quotas[i])), reverse=True
    )
    leftover = total - sum(alloc)
    for i in rem[:leftover]:
        alloc[i] += 1
    return alloc


# ---------------------------------------------------------------------------
# The four planners
# ---------------------------------------------------------------------------


def plan_scatter_gather(graph: Graph, num_nodes: int) -> ClusterPlan:
    assignment = {op.name: (0,) for op in graph.ops}  # per-replica node 0
    return ClusterPlan(
        strategy="scatter_gather",
        num_nodes=1,
        replicas=num_nodes,
        graph_name=graph.name,
        stages=(StagePlan(tuple(o.name for o in graph.ops), (0,)),),
        assignment=assignment,
    )


def plan_ai_core_assignment(
    graph: Graph, num_nodes: int, op_batch: int = 4
) -> ClusterPlan:
    """Split operators across nodes, widest for the bottlenecks.

    Following the paper (and its ref. [4], multi-FPGA CNN partitioning),
    an op is split *channel-wise* across a node group; consumers then
    need the full input feature map, so producer slices are all-gathered
    across the group — that reshard traffic is exactly the small-N
    penalty the paper measured.  Ops wide enough to use every node get
    the full cluster; ops whose divisibility caps the split co-locate on
    the first nodes, which keeps consecutive light ops local.
    """
    ops = graph.ops
    assignment: dict[str, tuple[int, ...]] = {}
    for op in ops:
        k = max(1, min(num_nodes, max(op.divisible, 1)))
        assignment[op.name] = tuple(range(k))
    return ClusterPlan(
        strategy="ai_core_assignment",
        num_nodes=num_nodes,
        replicas=1,
        graph_name=graph.name,
        stages=(StagePlan(tuple(o.name for o in ops), tuple(range(num_nodes))),),
        assignment=assignment,
        op_batch=op_batch,
    )


def plan_pipeline(graph: Graph, num_nodes: int) -> ClusterPlan:
    segments = graph.cut_segments(num_nodes)
    stages = []
    assignment: dict[str, tuple[int, ...]] = {}
    for s, seg in enumerate(segments):
        names = tuple(op.name for op in seg)
        stages.append(StagePlan(names, (s,)))
        for name in names:
            assignment[name] = (s,)
    return ClusterPlan(
        strategy="pipeline",
        num_nodes=len(segments),
        replicas=1,
        graph_name=graph.name,
        stages=tuple(stages),
        assignment=assignment,
    )


def plan_fused(
    graph: Graph, num_nodes: int, num_stages: int | None = None, op_batch: int = 2
) -> ClusterPlan:
    """Pipeline whose stage *widths* follow the AI-core rule.

    'Allocating more compute units to the highest demanding segment'
    (§II-C): the graph is cut into cost-balanced segments, each segment
    gets nodes proportional to its cost, and a multi-node stage
    round-robins whole images across its replicas — pipeline throughput
    without the operator-splitting reshard traffic.
    """
    if num_nodes <= 1:
        return plan_pipeline(graph, num_nodes)
    if num_stages is None:
        num_stages = max(2, num_nodes // 2)
    num_stages = min(num_stages, num_nodes, len(graph.ops))
    segments = graph.cut_segments(num_stages)
    seg_macs = graph.segment_macs(segments)
    widths = _largest_remainder(seg_macs, num_nodes, [1] * len(segments))
    stages = []
    assignment: dict[str, tuple[int, ...]] = {}
    base = 0
    for seg, w in zip(segments, widths):
        nodes = tuple(range(base, base + w))
        names = tuple(op.name for op in seg)
        stages.append(StagePlan(names, nodes))
        for op in seg:
            assignment[op.name] = nodes
        base += w
    return ClusterPlan(
        strategy="fused",
        num_nodes=num_nodes,
        replicas=1,
        graph_name=graph.name,
        stages=tuple(stages),
        assignment=assignment,
        op_batch=op_batch,
        stage_mode="replicate",
    )


def make_plan(graph: Graph, strategy: str, num_nodes: int, **kw) -> ClusterPlan:
    if strategy == "scatter_gather":
        plan = plan_scatter_gather(graph, num_nodes)
    elif strategy == "ai_core_assignment":
        plan = plan_ai_core_assignment(graph, num_nodes, **kw)
    elif strategy == "pipeline":
        plan = plan_pipeline(graph, num_nodes)
    elif strategy == "fused":
        plan = plan_fused(graph, num_nodes, **kw)
    else:
        raise ValueError(f"unknown strategy {strategy!r}; choose from {STRATEGIES}")
    plan.validate(graph)
    return plan
