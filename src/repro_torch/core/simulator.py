"""Discrete-event simulator of the FPGA cluster.

Reproduces the paper's measurement methodology: a master host PC streams
images through an Ethernet switch to FPGA nodes executing a
:class:`~repro_torch.core.strategies.ClusterPlan`; we report steady-state
average per-image time, exactly what the paper's Fig. 3/4 tables contain
("average inference time ... averaged across the 10 evaluation results").

Modeled mechanisms (each traceable to a paper statement):

* **Blocking sends** ("buffers are sent as blocking call MPI messages"):
  a transfer occupies the *sender's CPU* for its whole duration, plus the
  receiver's RX port; per-message MPI latency included.
* **CPU-mediated NIC** ("the FPGA CPU's need to DMA data buffers from the
  FPGA's logic and transmit them through the network"): per-byte CPU cost
  on the sending node.
* **Master port serialization**: the host PC feeds every node through one
  1 GbE port — scatter traffic serializes there.
* **Weight-buffer residency**: a node whose *total assigned* weight slices
  fit VTA's on-chip weight buffer skips weight DMA entirely; otherwise
  weight DMA is paid per visit, amortized by the plan's ``op_batch`` when
  the schedule batches images per operator visit.
* **Stragglers**: per-node compute slowdown factors (for the fault-
  tolerance experiments; the paper's cluster mixes board generations).

The simulation is a deterministic list-scheduling recurrence: images are
processed FIFO on every resource, so iterating images in order and taking
``max(resource_free, data_ready)`` is an exact FIFO discrete-event
execution.

The port's copy of ``repro.core.simulator`` (pure Python).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Mapping, Sequence

from repro_torch.core.cost_model import BoardModel, NetworkModel, GBE
from repro_torch.core.graph import Graph, Op
from repro_torch.core.strategies import ClusterPlan

# Spatial-split communication constants (calibrated once in
# benchmarks/calibrate.py against the paper's AI-core column).
STAGING_DECAY_K = 8.0  # staging overhead reaches zero at k ~ this + 1
HALO_FRACTION = 0.02  # halo rows as a fraction of a slab slice


@dataclasses.dataclass
class SimResult:
    strategy: str
    num_nodes: int
    images: int
    warmup: int
    avg_ms_per_image: float
    p50_latency_ms: float
    throughput_ips: float
    node_busy_s: dict[int, float]
    energy_j_per_image: float

    @property
    def avg_s(self) -> float:
        return self.avg_ms_per_image * 1e-3


class _Resources:
    """free-at clocks for every serializing resource."""

    def __init__(self) -> None:
        self.t: dict[str, float] = defaultdict(float)

    def acquire(self, key: str, earliest: float, dur: float) -> float:
        start = max(self.t[key], earliest)
        end = start + dur
        self.t[key] = end
        return end


def _input_bytes(graph: Graph) -> float:
    first = graph.ops[0]
    return first.bytes_in


def _output_bytes(graph: Graph) -> float:
    return graph.ops[-1].bytes_out


def simulate(
    graph: Graph,
    plan: ClusterPlan,
    boards: BoardModel | Sequence[BoardModel],
    net: NetworkModel = GBE,
    images: int = 80,
    warmup: int = 24,
    slowdown: Mapping[int, float] | None = None,
) -> SimResult:
    total_nodes = plan.num_nodes * plan.replicas
    if isinstance(boards, BoardModel):
        boards = [boards] * total_nodes
    if len(boards) < total_nodes:
        raise ValueError(f"need {total_nodes} boards, got {len(boards)}")
    slowdown = dict(slowdown or {})

    if plan.strategy == "scatter_gather" or total_nodes == 1:
        # A one-node cluster degenerates to the stock single-board runtime
        # for every strategy (the paper's N=1 row is identical per column).
        return _simulate_scatter_gather(
            graph, plan, boards, net, images, warmup, slowdown
        )
    return _simulate_dataflow(graph, plan, boards, net, images, warmup, slowdown)


# ---------------------------------------------------------------------------
# Scatter-gather: whole graph replicated per node
# ---------------------------------------------------------------------------


def _simulate_scatter_gather(graph, plan, boards, net, images, warmup, slowdown):
    res = _Resources()
    busy: dict[int, float] = defaultdict(float)
    in_b, out_b = _input_bytes(graph), _output_bytes(graph)
    departures: list[float] = []
    latencies: list[float] = []
    n = plan.replicas * plan.num_nodes

    for i in range(images):
        r = i % n
        board = boards[r]
        slow = slowdown.get(r, 1.0)
        # master streams the frame (master TX port + node CPU memcpy)
        t_in = _stream(res, busy, net, None, board, "master.tx",
                       f"node{r}.rx", f"node{r}.cpu", in_b,
                       res.t["master.tx"], None, r)
        start = t_in - net.wire_time(in_b)
        # full-graph inference on the node
        t_c = graph_service_time(board, graph) * slow
        done = res.acquire(f"node{r}.cpu", t_in, t_c)
        busy[r] += t_c
        # gather the result (small logits; node CPU + master RX port)
        end = _stream(res, busy, net, board, None, f"node{r}.cpu",
                      "master.rx", None, out_b, done, r, None)
        departures.append(end)
        latencies.append(end - start)
    return _finalize(plan, boards, busy, departures, latencies, images, warmup)


def graph_service_time(board: BoardModel, graph: Graph) -> float:
    """Whole-graph single-node time, weights resident only if the entire
    model fits on chip."""
    resident = graph.total_param_bytes <= board.vta.weight_buffer_bytes
    t = 0.0
    for op in graph.ops:
        g, a, w, f = board.op_time_parts(op, 1, resident)
        t += g + a + w + f
    return t


# ---------------------------------------------------------------------------
# Dataflow execution: ai_core_assignment / pipeline / fused
# ---------------------------------------------------------------------------


import math as _math


def _send(res, busy, net, board, p_key: str, rx_key: str, nbytes: float,
          data_ready: float, p_node: int | None = None) -> float:
    """One MPI message p -> c.  Returns arrival time at the receiver.

    Eager messages stamp the sender CPU briefly and overlap the wire
    with compute; rendezvous messages hold the sender CPU for the whole
    transfer (the paper's blocking-MPI pain point).
    """
    cpu_rate = board.cpu_net_s_per_byte if board is not None else 0.0
    wire = net.wire_time(nbytes)
    cpu_t = net.sender_cpu_time(nbytes, cpu_rate)
    t_cpu_done = res.acquire(p_key, data_ready, cpu_t)
    if p_node is not None:
        busy[p_node] += cpu_t
    if net.is_blocking(nbytes):
        # rendezvous: wire time already inside the CPU hold
        return res.acquire(rx_key, t_cpu_done - wire, wire)
    # eager: wire departs after the CPU stamp
    return res.acquire(rx_key, t_cpu_done, wire)


def _stream(res, busy, net, board_p, board_c, p_key: str, rx_key: str,
            c_key: str | None, nbytes: float, data_ready: float,
            p_node: int | None = None, c_node: int | None = None) -> float:
    """Chunked streaming transfer (pipeline/fused stage boundaries and
    master scatter/gather).  The wire overlaps with compute on both ends;
    each end's CPU pays the memcpy + per-chunk dispatch cost — the
    paper's 'processor involvement in transmitting data packet streams'.
    """
    chunks = max(1, int(_math.ceil(nbytes / net.eager_threshold_bytes)))
    rate_p = board_p.cpu_net_s_per_byte if board_p is not None else 0.0
    rate_c = board_c.cpu_net_s_per_byte if board_c is not None else 0.0
    tx_cpu = nbytes * rate_p + chunks * net.eager_cpu_s
    t_tx = res.acquire(p_key, data_ready, tx_cpu)
    if p_node is not None:
        busy[p_node] += tx_cpu
    wire = net.wire_time(nbytes)
    t_rx = res.acquire(rx_key, data_ready, wire)
    if c_key is None:
        return max(t_tx, t_rx)
    rx_cpu = nbytes * rate_c + chunks * net.eager_cpu_s
    t_c = res.acquire(c_key, max(t_tx, t_rx) - rx_cpu, rx_cpu)
    if c_node is not None:
        busy[c_node] += rx_cpu
    return t_c


def _simulate_dataflow(graph, plan, boards, net, images, warmup, slowdown):
    res = _Resources()
    busy: dict[int, float] = defaultdict(float)
    departures: list[float] = []
    latencies: list[float] = []

    # Spatial (slab) splits and stage replicas stream full op weights per
    # node; only explicit channel splits (none of the paper's strategies)
    # would shrink the per-node weight slice.
    weights_split = False
    replicate = plan.stage_mode == "replicate"
    stage_of: dict[str, int] = {}
    for si, st in enumerate(plan.stages):
        for name in st.ops:
            stage_of[name] = si

    # Per-node bookkeeping: which ops it hosts and whether its weight
    # slices stay resident in the VTA weight buffer.
    node_ops: dict[int, list[Op]] = defaultdict(list)
    for op in graph.ops:
        for nd in plan.assignment[op.name][: plan.way_split(op)]:
            node_ops[nd].append(op)
    node_weight_bytes = {
        nd: sum(op.param_bytes for op in ops) for nd, ops in node_ops.items()
    }
    resident = {
        nd: node_weight_bytes[nd] <= boards[nd].vta.weight_buffer_bytes
        for nd in node_ops
    }
    multiplexed = {nd: len(ops) > 1 for nd, ops in node_ops.items()}

    in_b, out_b = _input_bytes(graph), _output_bytes(graph)
    first_op, last_op = graph.ops[0], graph.ops[-1]

    for i in range(images):
        # (op_name, node) -> time the node's slice of that op is ready
        ready: dict[tuple[str, int], float] = {}
        start_time = None
        if replicate:
            # fused schedule: image i runs on one replica of each stage
            replica_of_stage = {
                si: st.nodes[i % len(st.nodes)]
                for si, st in enumerate(plan.stages)
            }

        def nodes_for(op):
            if replicate:
                return (replica_of_stage[stage_of[op.name]],)
            return plan.assignment[op.name][: plan.way_split(op)]

        for op in graph.ops:
            nodes = nodes_for(op)
            k = len(nodes)
            arrive: dict[int, float] = {nd: 0.0 for nd in nodes}

            if op is first_op:
                # master scatters frame slices to the first op's nodes
                for nd in nodes:
                    t = _send(res, busy, net, None, "master.tx",
                              f"node{nd}.rx", in_b / k, res.t["master.tx"])
                    arrive[nd] = t
                    if start_time is None:
                        start_time = res.t["master.tx"] - net.wire_time(in_b / k)

            for dep_name in op.deps:
                dep = graph[dep_name]
                dep_nodes = nodes_for(dep)
                kp = len(dep_nodes)
                slice_b = dep.bytes_out / kp
                same_group = tuple(dep_nodes) == tuple(nodes)
                if same_group and kp > 1:
                    # Spatial slab split (paper ref [4]): steady state only
                    # needs halo rows from ring neighbours (eager-sized),
                    # plus a *staging* term: with few nodes the slab slices
                    # are large, ride the blocking rendezvous path, and get
                    # re-staged through the producer CPUs — the measured
                    # small-N penalty.  The staging fraction decays
                    # quadratically and vanishes by k~9 (slices below the
                    # eager threshold stream in place).
                    f_stage = max(0.0, 1.0 - (kp - 1) / STAGING_DECAY_K) ** 2
                    halo_b = HALO_FRACTION * slice_b
                    for p in dep_nodes:
                        t_ready = ready[(dep_name, p)]
                        arrive[p] = max(arrive[p], t_ready)
                        right = nodes[(nodes.index(p) + 1) % kp]
                        left = nodes[(nodes.index(p) - 1) % kp]
                        if f_stage > 0.0:
                            t = _send(res, busy, net, boards[p],
                                      f"node{p}.cpu", f"node{right}.rx",
                                      slice_b * f_stage, t_ready, p)
                            arrive[right] = max(arrive[right], t)
                        for c in (left, right):
                            if c == p:
                                continue
                            t = _send(res, busy, net, boards[p],
                                      f"node{p}.cpu", f"node{c}.rx",
                                      halo_b, t_ready, p)
                            arrive[c] = max(arrive[c], t)
                else:
                    # reshard between different node groups (stage
                    # boundaries): streamed, chunked, overlapped — every
                    # consumer needs its input slab from each producer
                    for p in dep_nodes:
                        t_ready = ready[(dep_name, p)]
                        for c in nodes:
                            if c == p:
                                arrive[c] = max(arrive[c], t_ready)
                                continue
                            t = _stream(res, busy, net, boards[p], boards[c],
                                        f"node{p}.cpu", f"node{c}.rx",
                                        f"node{c}.cpu",
                                        slice_b / len(nodes), t_ready, p, c)
                            arrive[c] = max(arrive[c], t)

            # --- compute the slice on each node -------------------------
            for nd in nodes:
                board = boards[nd]
                g, a, w, f = board.op_time_parts(op, k, resident[nd], weights_split)
                if multiplexed[nd] and plan.op_batch > 1:
                    # the schedule batches op visits across images, so
                    # weight reloads and fixed dispatch amortize
                    w, f = w / plan.op_batch, f / plan.op_batch
                t_c = (g + a + w + f) * slowdown.get(nd, 1.0)
                end = res.acquire(f"node{nd}.cpu", arrive[nd], t_c)
                busy[nd] += t_c
                ready[(op.name, nd)] = end

        # --- gather: last op's slice-holders send to the master ----------
        gnodes = nodes_for(last_op)
        end_all = 0.0
        for nd in gnodes:
            t = _send(res, busy, net, boards[nd], f"node{nd}.cpu",
                      "master.rx", out_b / len(gnodes),
                      ready[(last_op.name, nd)], nd)
            end_all = max(end_all, t)
        departures.append(end_all)
        latencies.append(end_all - (start_time or 0.0))

    return _finalize(plan, boards, busy, departures, latencies, images, warmup)


# ---------------------------------------------------------------------------


def _finalize(plan, boards, busy, departures, latencies, images, warmup):
    span = departures[-1] - departures[warmup - 1]
    n_measured = images - warmup
    avg_s = span / n_measured
    lat_sorted = sorted(latencies[warmup:])
    p50 = lat_sorted[len(lat_sorted) // 2]
    total_span = departures[-1]
    total_nodes = plan.num_nodes * plan.replicas
    energy = 0.0
    for nd in range(total_nodes):
        b = min(busy.get(nd, 0.0), total_span)
        energy += boards[nd].energy(b, total_span)
    return SimResult(
        strategy=plan.strategy,
        num_nodes=total_nodes,
        images=images,
        warmup=warmup,
        avg_ms_per_image=avg_s * 1e3,
        p50_latency_ms=p50 * 1e3,
        throughput_ips=1.0 / avg_s,
        node_busy_s=dict(busy),
        energy_j_per_image=energy / images,
    )
