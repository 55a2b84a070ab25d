"""Strategy selection, prediction, and reconfiguration.

The cluster's headline property is *reconfigurability*: the best schedule
depends on the workload and the cluster size (the paper's tables show the
winner flipping from scatter-gather to AI-core-assignment around N=7).
This module is the piece that exploits it:

* :func:`predict` — closed-form latency estimate per strategy (fast inner
  loop for planning; the DES in :mod:`repro_torch.core.simulator` is ground
  truth).
* :func:`auto_schedule` — pick the best plan for (graph, cluster) by
  simulating candidate plans.
* :func:`rebalance` — straggler mitigation: given observed per-node rates,
  re-cut pipeline stages / re-apportion AI-core slots so slow nodes get
  proportionally less work.  This is the fault-tolerance hook the runtime
  calls when the monitor flags a straggler.

The port's copy of ``repro.core.scheduler`` (pure Python).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.cost_model import BoardModel, NetworkModel, GBE
from repro_torch.core.graph import Graph
from repro_torch.core.simulator import SimResult, graph_service_time, simulate
from repro_torch.core.strategies import (
    STRATEGIES,
    ClusterPlan,
    make_plan,
)


def predict(
    graph: Graph,
    strategy: str,
    num_nodes: int,
    board: BoardModel,
    net: NetworkModel = GBE,
) -> float:
    """Cheap closed-form per-image seconds (planning heuristic)."""
    t1 = graph_service_time(board, graph)
    in_t = net.xfer_time(graph.ops[0].bytes_in)
    out_t = net.xfer_time(graph.ops[-1].bytes_out, board.cpu_net_s_per_byte)
    if strategy == "scatter_gather":
        return max(t1 / num_nodes, in_t) + out_t / num_nodes
    if strategy == "pipeline":
        segs = graph.cut_segments(num_nodes)
        stage_t = [
            sum(sum(board.op_time_parts(op, 1, False)) for op in seg) for seg in segs
        ]
        bounds = graph.boundary_bytes(segs)
        xfer = [net.xfer_time(b, board.cpu_net_s_per_byte) for b in bounds]
        per_stage = [
            stage_t[i] + (xfer[i] if i < len(xfer) else 0.0)
            for i in range(len(stage_t))
        ]
        return max(per_stage + [in_t])
    if strategy in ("ai_core_assignment", "fused"):
        plan = make_plan(graph, strategy, num_nodes)
        # service time of the busiest node + its share of reshard traffic
        node_t: dict[int, float] = {}
        for op in graph.ops:
            nodes = plan.assignment[op.name][: plan.way_split(op)]
            k = len(nodes)
            for nd in nodes:
                g, a, w, f = board.op_time_parts(op, k, False)
                if plan.op_batch > 1:
                    w, f = w / plan.op_batch, f / plan.op_batch
                node_t[nd] = node_t.get(nd, 0.0) + g + a + w + f
        reshard = sum(
            net.xfer_time(op.bytes_out, board.cpu_net_s_per_byte)
            for op in graph.ops[:-1]
        ) / max(num_nodes, 1)
        return max(node_t.values()) + reshard
    raise ValueError(strategy)


@dataclasses.dataclass
class ScheduleChoice:
    plan: ClusterPlan
    result: SimResult
    alternatives: dict[str, float]  # strategy -> avg_ms


def auto_schedule(
    graph: Graph,
    num_nodes: int,
    board: BoardModel,
    net: NetworkModel = GBE,
    strategies: Sequence[str] = STRATEGIES,
    slowdown: Mapping[int, float] | None = None,
) -> ScheduleChoice:
    """Simulate every candidate strategy; return the fastest plan."""
    best: tuple[float, ClusterPlan, SimResult] | None = None
    alts: dict[str, float] = {}
    for s in strategies:
        plan = make_plan(graph, s, num_nodes)
        r = simulate(graph, plan, board, net, slowdown=slowdown)
        alts[s] = r.avg_ms_per_image
        if best is None or r.avg_ms_per_image < best[0]:
            best = (r.avg_ms_per_image, plan, r)
    assert best is not None
    return ScheduleChoice(plan=best[1], result=best[2], alternatives=alts)


def rebalance(
    graph: Graph,
    plan: ClusterPlan,
    node_rates: Mapping[int, float],
) -> ClusterPlan:
    """Straggler mitigation by reconfiguration.

    ``node_rates`` are observed relative speeds (1.0 = nominal; 0.5 = node
    at half speed).  We re-derive the plan with the *effective* node count
    and remap logical slots onto physical nodes so the slowest nodes hold
    the fewest op-slices — the reconfigurable-cluster answer to
    stragglers, as opposed to dropping the node entirely (which
    the reference's ``repro.ft`` handles via elastic restart).
    """
    if plan.strategy == "scatter_gather":
        return plan  # round-robin already self-balances via FIFO queues

    if plan.strategy == "pipeline":
        # re-CUT the stages so each node's *service time* is balanced:
        # min-max DP over op costs with per-stage rate weights, so a
        # half-speed node is assigned roughly half the MACs (the greedy
        # proportional fill this replaces could overshoot a slow node's
        # target by a whole op; the DP is exactly optimal for the
        # linearized graph).  Unlike graph.cut_segments this optimizes
        # MAC balance only — no boundary-transfer-bytes penalty — so
        # even uniform rates may move cuts relative to the original
        # plan; rebalance is only invoked when rates are skewed.
        from repro_torch.core.partition import partition_layers
        from repro_torch.core.strategies import StagePlan

        n = plan.num_nodes
        rates = [max(node_rates.get(i, 1.0), 1e-3) for i in range(n)]
        ops = list(graph.ops)
        bounds = partition_layers(
            [max(op.macs, 1.0) for op in ops], n, stage_weights=rates
        )
        assignment: dict[str, tuple[int, ...]] = {}
        stage_plans = []
        for s in range(n):
            seg = ops[bounds[s] : bounds[s + 1]]
            names = tuple(op.name for op in seg)
            stage_plans.append(StagePlan(names, (s,)))
            for nm in names:
                assignment[nm] = (s,)
        rebalanced = dataclasses.replace(
            plan, stages=tuple(stage_plans), assignment=assignment
        )
        rebalanced.validate(graph)
        return rebalanced

    # ai_core / fused: permute logical slots so the fastest physical
    # nodes take the most op-slices
    order = sorted(
        range(plan.num_nodes * plan.replicas), key=lambda n: -node_rates.get(n, 1.0)
    )
    load = {nd: 0.0 for nd in range(plan.num_nodes * plan.replicas)}
    for op in graph.ops:
        for nd in plan.assignment[op.name]:
            load[nd] += op.macs / max(len(plan.assignment[op.name]), 1)
    logical_by_load = sorted(load, key=lambda nd: -load[nd])
    remap = {logical: order[i] for i, logical in enumerate(logical_by_load)}
    new_assignment = {
        name: tuple(remap[nd] for nd in nodes)
        for name, nodes in plan.assignment.items()
    }
    new_stages = tuple(
        dataclasses.replace(st, nodes=tuple(remap[nd] for nd in st.nodes))
        for st in plan.stages
    )
    rebalanced = dataclasses.replace(
        plan, assignment=new_assignment, stages=new_stages
    )
    rebalanced.validate(graph)
    return rebalanced


def recut_boundaries(cfg, seq_len: int, stages: int, node_rates) -> tuple:
    """Straggler-driven pipeline re-cut, config -> runtime boundaries.

    The supervisor's replan hook: build the config's per-layer cost
    graph, re-balance a pipeline plan with :func:`rebalance` (rate-
    weighted min-max DP — stage *s*'s cost is divided by
    ``node_rates[s]``, so a half-speed board receives roughly half the
    MACs), and lower the op-granularity cuts back to the layer
    boundaries the runtime executes.  Falls back to cutting the layer
    cost vector directly when the op cuts don't land on layer lines (or
    for ``attn_every`` hybrids, whose cut unit is the group).
    """
    from repro_torch.core.graph import config_graph
    from repro_torch.core.partition import layer_boundaries_from_plan
    from repro_torch.core.placement import pipeline_boundaries

    rates = [max(float(node_rates.get(s, 1.0)), 1e-3) for s in range(stages)]
    if getattr(cfg, "attn_every", 0):
        return pipeline_boundaries(cfg, seq_len, stages, stage_weights=rates)
    graph = config_graph(cfg, seq_len)
    plan = rebalance(graph, make_plan(graph, "pipeline", stages),
                     dict(enumerate(rates)))
    bounds = layer_boundaries_from_plan(plan, cfg.num_layers)
    if bounds is None:  # a stage held only book-end ops
        return pipeline_boundaries(cfg, seq_len, stages, stage_weights=rates)
    return bounds
