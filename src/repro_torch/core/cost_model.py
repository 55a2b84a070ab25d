"""Analytic device + network cost models.

Two families of hardware are modeled:

* **VTA-on-FPGA boards** (Zynq-7020, UltraScale+) — the paper's testbed.
  Used by :mod:`repro_torch.core.simulator` to reproduce the paper's Fig. 3/4
  latency tables and the §IV reconfiguration experiments.

* **TPU v5e** — the JAX package's planning target, kept so that the
  port's planner gives the reference's plans.  Its numbers are a TPU's
  data sheet, not a measurement of this port's card.

Calibration
-----------
A handful of constants cannot be derived from datasheets (effective GEMM
utilization under AutoTVM schedules, CPU driver overhead per DMA chunk,
effective MPI bandwidth on 1 GbE with blocking sends).  Those are fit once
against the paper's own anchor numbers by
``benchmarks/calibrate.py`` and stored in ``CALIBRATED`` below.  The model
structure (what scales with what) is physics; only the coefficients are
fit.  EXPERIMENTS.md reports per-cell error of the calibrated model
against every number in the paper.

The port's copy of ``repro.core.cost_model`` (pure Python; numpy only
inside :class:`RuntimeCostModel`'s fit): same names, same numbers.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.graph import Graph, Op

KIB = 1024.0
MIB = KIB * KIB
GIB = KIB * MIB


# ---------------------------------------------------------------------------
# VTA accelerator configuration (paper Table I)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VTAConfig:
    """The paper's Table I knobs — the 'reconfigurable' in the title."""

    clock_hz: float
    input_width_bits: int = 8
    weight_width_bits: int = 8
    acc_width_bits: int = 32
    batch: int = 1
    block: int = 16  # GEMM tensor intrinsic is (batch, block) x (block, block)
    uop_buffer_bytes: float = 32 * KIB / 8
    input_buffer_bytes: float = 32 * KIB
    weight_buffer_bytes: float = 256 * KIB
    acc_buffer_bytes: float = 128 * KIB

    @property
    def macs_per_cycle(self) -> float:
        return float(self.batch * self.block * self.block)

    @property
    def peak_macs_per_s(self) -> float:
        return self.macs_per_cycle * self.clock_hz

    def with_(self, **kw) -> "VTAConfig":
        return dataclasses.replace(self, **kw)


# Paper Table I: the initial configurations.
VTA_ZYNQ7020 = VTAConfig(clock_hz=100e6)
VTA_ULTRASCALE = VTAConfig(clock_hz=300e6)
# §IV reconfigurations explored on the UltraScale+ stack:
VTA_ULTRASCALE_350 = VTA_ULTRASCALE.with_(clock_hz=350e6)
VTA_ULTRASCALE_BIG = VTAConfig(
    clock_hz=200e6,
    block=32,
    uop_buffer_bytes=64 * KIB / 8,
    input_buffer_bytes=64 * KIB,
    weight_buffer_bytes=512 * KIB,
    acc_buffer_bytes=256 * KIB,
)


# ---------------------------------------------------------------------------
# Board model (PS + PL + DDR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoardModel:
    """One FPGA node: VTA fabric + ARM PS + DDR DMA path.

    ``alpha/beta/gamma`` are the calibrated mixed-regime coefficients:

        T_image = alpha * T_gemm + beta * T_dma + gamma

    alpha  — effective inverse utilization of the GEMM core under the
             AutoTVM schedule (alpha < 1 means the measured anchor beats
             our conservative MAC accounting, e.g. CPU-offloaded stem).
    beta   — fraction of DMA traffic NOT hidden under compute by the
             load/compute/store decoupling (RAW/WAR queues).
    gamma  — fixed per-image PS/driver cost (runtime dispatch, JIT glue).
    """

    name: str
    vta: VTAConfig
    dma_bytes_per_s: float
    alpha: float
    beta: float
    gamma_s: float
    idle_power_w: float
    active_power_w: float
    # CPU cost of pushing one byte through the NIC (paper: 'CPU handling
    # overhead' for DMA-ing buffers from PL and streaming them out).
    cpu_net_s_per_byte: float

    def gemm_time(self, macs: float) -> float:
        return macs / self.vta.peak_macs_per_s

    def dma_bytes(self, op: Op, resident_weights: bool) -> float:
        """DDR traffic for one op: activations always stream; weights
        stream unless the op's slice is resident in the weight buffer.

        Tiles that exceed the on-chip buffers are re-fetched; the refetch
        surplus scales with (working set / buffer), so doubling a buffer
        roughly halves it — this is what makes the §IV big-buffer
        reconfiguration (43.86% speedup) fall out of the model.
        """
        in_ref = 1.0 + min(3.0, 0.5 * op.bytes_in / self.vta.input_buffer_bytes)
        wbytes = 0.0
        if not resident_weights and op.param_bytes:
            wt_ref = 1.0 + min(5.0, 0.5 * op.param_bytes / self.vta.weight_buffer_bytes)
            wbytes = op.param_bytes * wt_ref
        return op.bytes_in * in_ref + op.bytes_out + wbytes

    def op_time(self, op: Op, way_split: int = 1, resident_weights: bool = False) -> float:
        """Time for this node to execute a 1/way_split slice of ``op``."""
        k = max(1, min(way_split, max(op.divisible, 1)))
        macs = op.macs / k
        # ALU-class ops (pool/add/norm) run on the VTA ALU at ~1 lane-op
        # per cycle x block lanes; their 'macs' fields are pre-scaled.
        t_gemm = self.alpha * self.gemm_time(macs)
        sliced = op.scaled(1.0 / k)
        t_dma = self.beta * (self.dma_bytes(sliced, resident_weights) / self.dma_bytes_per_s)
        return t_gemm + t_dma + self.gamma_s / max(1, k)

    def op_time_parts(
        self,
        op: Op,
        way_split: int = 1,
        resident_weights: bool = False,
        weights_split: bool = False,
    ) -> tuple[float, float, float, float]:
        """Decomposed op cost: (gemm, activation-DMA, weight-DMA, fixed).

        ``weights_split=False`` models the spatial (slab) partitioning used
        by AI-core assignment — each node streams the op's *full* weights
        but only 1/k of the activations; ``True`` models channel/pipeline
        splits where the weight slice shrinks with k.  The simulator
        amortizes weight-DMA and fixed parts when a node image-batches
        visits to the same op (``op_batch`` in a ClusterPlan).
        """
        k = max(1, min(way_split, max(op.divisible, 1)))
        t_gemm = self.alpha * self.gemm_time(op.macs / k)
        sliced = op.scaled(1.0 / k)
        act = self.dma_bytes(sliced, True)  # resident => no weight traffic
        w_op = sliced if weights_split else op
        wts = 0.0
        if not resident_weights and op.param_bytes:
            wt_ref = 1.0 + min(
                5.0, 0.5 * w_op.param_bytes / self.vta.weight_buffer_bytes
            )
            wts = w_op.param_bytes * wt_ref
        t_act = self.beta * act / self.dma_bytes_per_s
        t_wts = self.beta * wts / self.dma_bytes_per_s
        return t_gemm, t_act, t_wts, self.gamma_s / max(1, k)

    def graph_time(self, graph: Graph) -> float:
        """Single-node, whole-graph, steady-state per-image time."""
        t = 0.0
        for op in graph.ops:
            # Single node multiplexes every op: weights never stay resident
            # unless the *entire* model fits the weight buffer.
            resident = graph.total_param_bytes <= self.vta.weight_buffer_bytes
            t += self.op_time(op, 1, resident)
        return t

    def energy(self, busy_s: float, total_s: float) -> float:
        return busy_s * self.active_power_w + (total_s - busy_s) * self.idle_power_w


# Calibrated constants (see benchmarks/calibrate.py; anchors = paper's own
# single-node + reconfiguration numbers).  DDR3 on Zynq-7020 vs DDR4 on
# UltraScale+; power draws from board datasheets (typical inference load).
ZYNQ7020 = BoardModel(
    name="zynq7020",
    vta=VTA_ZYNQ7020,
    dma_bytes_per_s=600e6,
    alpha=0.2494,
    beta=5.158e-05,
    gamma_s=3.592e-4,
    idle_power_w=2.2,
    active_power_w=4.6,
    cpu_net_s_per_byte=1.974e-9,
)
ULTRASCALE = BoardModel(
    name="ultrascale",
    vta=VTA_ULTRASCALE,
    dma_bytes_per_s=1.6e9,
    alpha=0.3157,
    beta=0.3968,
    gamma_s=3.858e-6,
    idle_power_w=4.5,
    active_power_w=9.8,
    cpu_net_s_per_byte=5.745e-9,
)


def board_with_vta(board: BoardModel, vta: VTAConfig) -> BoardModel:
    return dataclasses.replace(board, vta=vta)


# ---------------------------------------------------------------------------
# Network model (paper: 1 GbE switch, RJ-45, blocking MPI, CPU-driven)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Star topology through one switch; each node has one full-duplex
    port.

    MPI semantics per the paper §III ("buffers are sent as blocking call
    MPI messages ... affect the overall node message-passing handshake"):
    messages above the eager threshold use a *rendezvous* protocol that
    blocks the sender's CPU for the whole transfer; small messages go out
    eagerly, costing the sender only a fixed CPU stamp while the wire
    time overlaps with compute.
    """

    port_bytes_per_s: float = 125e6  # 1 Gb/s
    efficiency: float = 0.72  # TCP/MPI framing
    eager_threshold_bytes: float = 64 * KIB
    eager_cpu_s: float = 8e-6  # sender-side cost of an eager send
    rendezvous_s: float = 260e-6  # handshake latency of a blocking send

    def wire_time(self, nbytes: float) -> float:
        return nbytes / (self.port_bytes_per_s * self.efficiency)

    def is_blocking(self, nbytes: float) -> bool:
        return nbytes >= self.eager_threshold_bytes

    def sender_cpu_time(self, nbytes: float, cpu_s_per_byte: float = 0.0) -> float:
        """CPU time the *sender* is blocked for."""
        if self.is_blocking(nbytes):
            return self.rendezvous_s + self.wire_time(nbytes) + nbytes * cpu_s_per_byte
        return self.eager_cpu_s + nbytes * cpu_s_per_byte

    def xfer_time(self, nbytes: float, sender_cpu_s_per_byte: float = 0.0) -> float:
        """End-to-end message time (latency + wire + sender CPU share)."""
        lat = self.rendezvous_s if self.is_blocking(nbytes) else self.eager_cpu_s
        return lat + self.wire_time(nbytes) + nbytes * sender_cpu_s_per_byte


GBE = NetworkModel()


# ---------------------------------------------------------------------------
# TPU v5e model (the reference's planning target; a TPU's data sheet)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPUModel:
    name: str = "tpu_v5e"
    peak_flops_bf16: float = 197e12
    peak_flops_int8: float = 394e12
    hbm_bytes_per_s: float = 819e9
    hbm_bytes: float = 16 * GIB
    ici_link_bytes_per_s: float = 50e9
    ici_links: int = 4  # 2D torus, 2 axes x 2 directions
    vmem_bytes: float = 128 * MIB
    mxu_dim: int = 128
    chip_power_w: float = 200.0

    def compute_term(self, flops: float, chips: int) -> float:
        return flops / (chips * self.peak_flops_bf16)

    def memory_term(self, hbm_bytes: float, chips: int) -> float:
        return hbm_bytes / (chips * self.hbm_bytes_per_s)

    def collective_term(self, coll_bytes: float, chips: int) -> float:
        return coll_bytes / (chips * self.ici_link_bytes_per_s)


TPU_V5E = TPUModel()


# ---------------------------------------------------------------------------
# RuntimeCostModel — fitted to a measured runtime
# ---------------------------------------------------------------------------

#: bump when feature definitions change — persisted models refuse to load
RUNTIME_MODEL_SCHEMA = 1


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def flash_tile_work(
    s: int, t: int, *, block_q: int, block_k: int,
    q_offset: int = 0, kv_len: int | None = None,
    bidirectional: bool = False,
) -> tuple[int, int]:
    """(executed, total) KV-tile counts for one (batch, head) grid slice —
    the pure-python twin of ``kernels.flash_attention.flash_tile_counts``
    (no window support; the measurement grid is window-free), so the cost
    model can featurize without a backend."""
    qc, kc = min(block_q, s), min(block_k, t)
    nq, nk = _ceil_div(s, qc), _ceil_div(t, kc)
    kvlen = min(t if kv_len is None else int(kv_len), t)
    executed = 0
    for iq in range(nq):
        if bidirectional:
            last = (kvlen - 1) // kc
        else:
            q_hi = q_offset + iq * qc + qc - 1
            last = min(q_hi, kvlen - 1) // kc
        executed += max(0, min(last, nk - 1) + 1)
    return executed, nq * nk


def decode_partition_work(t: int, fill: int, *, block_k: int) -> tuple[int, int]:
    """(live, total) split-KV partitions for a dense decode over a padded
    T-buffer with ``fill`` live positions."""
    kc = min(block_k, t)
    return _ceil_div(max(min(fill, t), 1), kc), _ceil_div(t, kc)


#: feature names per kind (documentation; the fit is name-agnostic)
RUNTIME_FEATURES = {
    "flash_prefill": ("tile_macs", "tiles", "grid_cells", "const"),
    "decode": ("live_rows", "live_parts", "total_parts", "buf_rows", "const"),
    "paged_decode": ("live_rows", "live_pages", "table_rows", "const"),
    "gemm_int8": ("padded_macs", "tiles", "const"),
    "prefill_chunk": ("tokens", "calls", "attn_work", "const"),
}


def runtime_features(kind: str, p: dict) -> list[float]:
    """Monotone nonnegative features for one measured point.

    Every feature is nondecreasing in the work-size parameters (tokens,
    fill, pages, matrix dims), so a nonnegative-weight fit yields a
    monotone predictor by construction — the planner can never be told
    that more work is cheaper.
    """
    batch = int(p.get("batch", 1))
    heads = int(p.get("heads", 1))
    d = int(p.get("head_dim", 64))
    if kind == "flash_prefill":
        s = int(p["seq"])
        t = int(p.get("kv", s))
        bq, bk = int(p["block_q"]), int(p["block_k"])
        e, n = flash_tile_work(s, t, block_q=bq, block_k=bk,
                               kv_len=p.get("kv_len"))
        m = batch * heads
        area = min(bq, s) * min(bk, t)
        return [m * e * area * d, m * e, m * n, 1.0]
    if kind == "decode":
        t, fill = int(p["buf"]), int(p["fill"])
        bk = int(p.get("block_k", t))
        live, total = decode_partition_work(t, fill, block_k=bk)
        m = batch * heads
        kc = min(bk, t)
        return [m * live * kc * d, m * live, m * total, m * t * d, 1.0]
    if kind == "paged_decode":
        fill, pg = int(p["fill"]), int(p["page_size"])
        max_pp = int(p.get("max_pp", _ceil_div(int(p.get("max_len", fill)), pg)))
        live = _ceil_div(max(fill, 1), pg)
        m = batch * heads
        return [m * live * pg * d, batch * live, m * max_pp * pg * d, 1.0]
    if kind == "gemm_int8":
        mm, nn, kk = int(p["m"]), int(p["n"]), int(p["k"])
        bm = int(p.get("block_m", 128))
        bn = int(p.get("block_n", 128))
        bk = int(p.get("block_k", 128))
        tm, tn, tk = _ceil_div(mm, bm), _ceil_div(nn, bn), _ceil_div(kk, bk)
        return [float(tm * bm) * (tn * bn) * (tk * bk), float(tm * tn * tk), 1.0]
    if kind == "prefill_chunk":
        tokens, chunk = int(p["tokens"]), int(p["chunk"])
        calls = _ceil_div(tokens, chunk)
        # each chunk pass attends its chunk against the growing cache;
        # sum over calls of chunk * cache_len ~ tokens * chunk-quadratic
        return [batch * float(tokens), float(calls),
                batch * float(tokens) * min(chunk, tokens), 1.0]
    raise ValueError(f"unknown runtime cost kind {kind!r} "
                     f"(known: {sorted(RUNTIME_FEATURES)})")


def _nnls(rows: list[list[float]], ys: list[float],
          iters: int = 2000) -> list[float]:
    """Nonnegative least squares on relative error: rows are scaled by
    1/y so the fit minimizes sum((pred/y - 1)^2) — a MAPE surrogate.
    Lee–Seung multiplicative updates; X >= 0 and y >= 0 guarantee the
    iterates stay nonnegative."""
    import numpy as np

    X = np.asarray(rows, float)
    y = np.asarray(ys, float)
    w_rel = 1.0 / np.maximum(y, 1e-12)
    Xs = X * w_rel[:, None]
    ys_ = np.ones_like(y)
    norms = np.linalg.norm(Xs, axis=0)
    norms[norms == 0] = 1.0
    Xs = Xs / norms
    h = Xs.T @ ys_
    G = Xs.T @ Xs
    w = np.full(Xs.shape[1], 1.0 / max(Xs.shape[1], 1))
    for _ in range(iters):
        denom = G @ w
        w = w * h / np.maximum(denom, 1e-30)
    return list(w / norms)


class RuntimeCostModel:
    """Per-device-kind predictor of measured runtime costs (the
    reference fits it to its JAX/Pallas runtime; the port's measurement
    harness is still to come).

    The VTA :class:`BoardModel` above predicts the paper's FPGA boards
    from datasheet physics plus six calibrated scalars; this is the same
    discipline pointed at our own runtime: ``core.measure`` times the
    real hot paths, :meth:`fit` solves a nonnegative least-squares fit of
    per-kind monotone features (executed flash tiles, live split-KV
    partitions, live pages, padded GEMM MACs, prefill chunk calls) to the
    measured seconds, and :meth:`predict` answers the planner's what-if
    questions (``core.autotune.tune_runtime`` / ``choose_pattern``) about
    configurations that were never timed.

    Nonnegative weights over monotone features make every prediction
    monotone in the work size — more tokens/pages/MACs are never
    predicted cheaper.  BENCH_*.json rows ingest as exact lookups
    (kind ``"bench"``): measured end-to-end numbers beat any fit.
    """

    def __init__(self, device: str = "unknown",
                 coef: dict | None = None,
                 stats: dict | None = None,
                 bench: dict | None = None):
        self.device = device
        self.coef = {k: list(v) for k, v in (coef or {}).items()}
        self.stats = dict(stats or {})
        self.bench = dict(bench or {})

    # -- fitting ------------------------------------------------------------

    @classmethod
    def fit(cls, profile, *, device: str | None = None) -> "RuntimeCostModel":
        """Fit one weight vector per kind to ``profile`` — either a
        ``core.measure`` profile dict or a bare entry list
        (``[{"kind", "params", "t_s"}, ...]``)."""
        if isinstance(profile, dict):
            entries = profile.get("entries", [])
            device = device or profile.get("device", "unknown")
        else:
            entries = list(profile)
        by_kind: dict[str, list] = {}
        for e in entries:
            by_kind.setdefault(e["kind"], []).append(e)
        coef, stats = {}, {}
        for kind, es in by_kind.items():
            rows = [runtime_features(kind, e["params"]) for e in es]
            ys = [float(e["t_s"]) for e in es]
            coef[kind] = _nnls(rows, ys)
            model = cls(device or "unknown", coef)
            stats[kind] = {"n": len(es), "mape": model.mape(es)}
        return cls(device or "unknown", coef, stats)

    def ingest_bench(self, records, source: str = "") -> int:
        """Index BENCH_*.json rows (``[{"name", "us_per_call", ...}]``)
        as exact lookups: ``predict("bench", name=...)``."""
        n = 0
        for r in records:
            us = r.get("us_per_call")
            if r.get("name") and us is not None:
                self.bench[r["name"]] = {"t_s": float(us) * 1e-6,
                                         "derived": r.get("derived", ""),
                                         "source": source}
                n += 1
        return n

    # -- prediction ---------------------------------------------------------

    def predict(self, kind: str, **params) -> float:
        """Predicted seconds for one call of ``kind`` at ``params``."""
        if kind == "bench":
            return self.bench[params["name"]]["t_s"]
        if kind not in self.coef:
            raise KeyError(f"RuntimeCostModel has no fit for {kind!r} "
                           f"(fitted: {sorted(self.coef)})")
        feats = runtime_features(kind, params)
        return float(sum(w * f for w, f in zip(self.coef[kind], feats)))

    def mape(self, entries) -> float:
        """Mean absolute percentage error against measured entries."""
        errs = []
        for e in entries:
            got = self.predict(e["kind"], **e["params"])
            want = float(e["t_s"])
            errs.append(abs(got - want) / max(want, 1e-12))
        return sum(errs) / max(len(errs), 1)

    # -- persistence --------------------------------------------------------

    def to_json(self) -> dict:
        return {"schema": RUNTIME_MODEL_SCHEMA, "device": self.device,
                "coef": self.coef, "stats": self.stats, "bench": self.bench}

    @classmethod
    def from_json(cls, obj: dict) -> "RuntimeCostModel":
        if obj.get("schema") != RUNTIME_MODEL_SCHEMA:
            raise ValueError(
                f"stale RuntimeCostModel schema {obj.get('schema')!r} "
                f"(current {RUNTIME_MODEL_SCHEMA}); re-run core.measure")
        return cls(obj.get("device", "unknown"), obj.get("coef"),
                   obj.get("stats"), obj.get("bench"))


# ---------------------------------------------------------------------------
# Model-FLOPs helpers (roofline 'useful compute' numerator)
# ---------------------------------------------------------------------------


def lm_param_count(
    *,
    num_layers: int,
    d_model: int,
    num_heads: int,
    kv_heads: int,
    d_ff: int,
    vocab: int,
    moe_experts: int = 0,
    moe_top_k: int = 0,
    moe_shared: int = 0,
    ssm_state: int = 0,
    attn_free: bool = False,
    gated_mlp: bool = True,
) -> tuple[float, float]:
    """(total_params, active_params) for 6*N*D model-FLOPs accounting."""
    head_dim = d_model // max(num_heads, 1)
    if attn_free:
        d_inner = 2 * d_model
        mixer = 2 * d_model * d_inner + d_inner * ssm_state
    else:
        mixer = d_model * (num_heads + 2 * kv_heads) * head_dim + num_heads * head_dim * d_model
    ffn_mults = 3 if gated_mlp else 2
    ffn_one = ffn_mults * d_model * d_ff
    if moe_experts:
        ffn_total = ffn_one * (moe_experts + moe_shared)
        ffn_active = ffn_one * (moe_top_k + moe_shared)
    else:
        ffn_total = ffn_active = ffn_one
    embed = vocab * d_model
    total = num_layers * (mixer + ffn_total) + 2 * embed
    active = num_layers * (mixer + ffn_active) + 2 * embed
    return float(total), float(active)
