"""Computation-graph IR.

The paper schedules NN computation graphs (DFGs) across a cluster of
accelerator nodes.  This module is the graph representation those
schedulers consume: a topologically ordered list of ``Op`` nodes, each
annotated with the analytic quantities every scheduling decision needs —
MACs/FLOPs, activation bytes in/out, and parameter bytes.

The IR is deliberately *coarse* (one node per NN layer / fused operator,
not per HLO instruction): the paper's strategies reason at layer
granularity ("assign more FPGAs to the bottleneck convolution"), and so do
we.  The same graphs drive

  * :mod:`repro_torch.core.simulator`  — the FPGA-cluster discrete-event model
    that reproduces the paper's Fig. 3/4 tables, and
  * :mod:`repro_torch.core.placement`  — the pipeline cut points a
    ``ClusterPlan`` implies for a model's layer stack.

The port's copy of ``repro.core.graph`` (pure Python): same names, same
numbers.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Callable, Iterable, Sequence


# ---------------------------------------------------------------------------
# Op / Graph
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Op:
    """One schedulable operator in a NN computation graph.

    Attributes:
      name: unique name within the graph ("layer2.0.conv1").
      kind: operator family; drives device-model lookup. One of
        {"conv2d", "dense", "matmul", "attention", "moe_ffn", "ssm",
         "norm", "act", "pool", "add", "embed", "softmax", "io"}.
      macs: multiply-accumulate count for one sample (batch=1).
      bytes_in: activation input bytes (batch=1, accelerator dtype).
      bytes_out: activation output bytes (batch=1).
      param_bytes: weight/parameter bytes touched by this op.
      deps: names of producer ops.
      divisible: the maximum way-split this op supports for AI-core
        assignment (e.g. output channels for conv, heads for attention).
        1 means "cannot be split across nodes".
      meta: free-form annotations (shapes, window, experts ...).
    """

    name: str
    kind: str
    macs: float
    bytes_in: float
    bytes_out: float
    param_bytes: float
    deps: tuple[str, ...] = ()
    divisible: int = 1
    meta: dict = dataclasses.field(default_factory=dict, hash=False, compare=False)

    @property
    def flops(self) -> float:
        return 2.0 * self.macs

    def scaled(self, factor: float) -> "Op":
        """Return a copy with compute/bytes scaled (used for way-splits)."""
        return dataclasses.replace(
            self,
            macs=self.macs * factor,
            bytes_out=self.bytes_out * factor,
            param_bytes=self.param_bytes * factor,
        )


class Graph:
    """A topologically ordered computation graph."""

    def __init__(self, name: str, ops: Sequence[Op]):
        self.name = name
        self.ops: list[Op] = list(ops)
        self._by_name = {op.name: op for op in self.ops}
        if len(self._by_name) != len(self.ops):
            raise ValueError(f"duplicate op names in graph {name!r}")
        for op in self.ops:
            for dep in op.deps:
                if dep not in self._by_name:
                    raise ValueError(f"{op.name} depends on unknown op {dep!r}")
        self._check_topological()

    # -- basic accessors ----------------------------------------------------

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)

    def __getitem__(self, name: str) -> Op:
        return self._by_name[name]

    def _check_topological(self) -> None:
        seen: set[str] = set()
        for op in self.ops:
            for dep in op.deps:
                if dep not in seen:
                    raise ValueError(
                        f"graph {self.name!r} not topologically ordered: "
                        f"{op.name} before its dep {dep}"
                    )
            seen.add(op.name)

    # -- aggregate metrics ---------------------------------------------------

    @property
    def total_macs(self) -> float:
        return sum(op.macs for op in self.ops)

    @property
    def total_flops(self) -> float:
        return 2.0 * self.total_macs

    @property
    def total_param_bytes(self) -> float:
        return sum(op.param_bytes for op in self.ops)

    @property
    def total_activation_bytes(self) -> float:
        return sum(op.bytes_out for op in self.ops)

    def bottlenecks(self, top_k: int = 1) -> list[Op]:
        """Ops sorted by MACs, descending — the paper's 'most computationally
        intensive layers of the NN graph'."""
        return sorted(self.ops, key=lambda o: o.macs, reverse=True)[:top_k]

    # -- partitioning --------------------------------------------------------

    def cut_segments(
        self, num_segments: int, boundary_macs_per_byte: float = 256.0
    ) -> list[list[Op]]:
        """Cut the (linearized) graph into ``num_segments`` contiguous
        segments with approximately balanced cost.

        Classic linear-partition DP (minimize the maximum segment cost) —
        the paper balances stages by hand; we automate it.  Segment cost
        includes a penalty for the activation bytes crossing its trailing
        boundary (``boundary_macs_per_byte`` converts bytes to
        MAC-equivalents ~ accelerator_rate / network_rate), so cuts land
        where feature maps are small — the difference between a pipeline
        that streams and one that chokes on 1 GbE.
        """
        n = len(self.ops)
        k = min(num_segments, n)
        if k <= 1:
            return [list(self.ops)]
        bnd = [op.bytes_out * boundary_macs_per_byte for op in self.ops]
        costs = [max(op.macs, 1.0) for op in self.ops]
        prefix = [0.0]
        for c in costs:
            prefix.append(prefix[-1] + c)

        def seg_cost(i: int, j: int) -> float:  # cost of ops[i:j]
            c = prefix[j] - prefix[i]
            if j < n:  # trailing boundary transfer penalty
                c += bnd[j - 1]
            return c

        INF = float("inf")
        # dp[j][s] = minimal max-segment-cost for first j ops in s segments
        dp = [[INF] * (k + 1) for _ in range(n + 1)]
        back = [[0] * (k + 1) for _ in range(n + 1)]
        dp[0][0] = 0.0
        for s in range(1, k + 1):
            for j in range(s, n + 1):
                for i in range(s - 1, j):
                    cand = max(dp[i][s - 1], seg_cost(i, j))
                    if cand < dp[j][s]:
                        dp[j][s] = cand
                        back[j][s] = i
        # reconstruct
        bounds = [n]
        j, s = n, k
        while s > 0:
            i = back[j][s]
            bounds.append(i)
            j, s = i, s - 1
        bounds.reverse()
        return [self.ops[bounds[t] : bounds[t + 1]] for t in range(k)]

    def segment_macs(self, segments: Iterable[Sequence[Op]]) -> list[float]:
        return [sum(op.macs for op in seg) for seg in segments]

    def boundary_bytes(self, segments: Sequence[Sequence[Op]]) -> list[float]:
        """Activation bytes crossing each stage boundary (len = segments-1)."""
        out = []
        for seg in segments[:-1]:
            out.append(seg[-1].bytes_out if seg else 0.0)
        return out

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "name": self.name,
                "ops": [
                    {
                        "name": o.name,
                        "kind": o.kind,
                        "macs": o.macs,
                        "bytes_in": o.bytes_in,
                        "bytes_out": o.bytes_out,
                        "param_bytes": o.param_bytes,
                        "deps": list(o.deps),
                        "divisible": o.divisible,
                    }
                    for o in self.ops
                ],
            }
        )

    @staticmethod
    def from_json(text: str) -> "Graph":
        d = json.loads(text)
        return Graph(
            d["name"],
            [
                Op(
                    name=o["name"],
                    kind=o["kind"],
                    macs=o["macs"],
                    bytes_in=o["bytes_in"],
                    bytes_out=o["bytes_out"],
                    param_bytes=o["param_bytes"],
                    deps=tuple(o["deps"]),
                    divisible=o.get("divisible", 1),
                )
                for o in d["ops"]
            ],
        )


# ---------------------------------------------------------------------------
# Graph builders
# ---------------------------------------------------------------------------


def _conv_op(
    name: str,
    deps: tuple[str, ...],
    h: int,
    w: int,
    cin: int,
    cout: int,
    k: int,
    stride: int = 1,
    dtype_bytes: int = 1,
) -> tuple[Op, int, int, int]:
    """Conv2d op (int8 path by default — the VTA datapath)."""
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    macs = float(ho * wo * cout * cin * k * k)
    op = Op(
        name=name,
        kind="conv2d",
        macs=macs,
        bytes_in=float(h * w * cin * dtype_bytes),
        bytes_out=float(ho * wo * cout * dtype_bytes),
        param_bytes=float(k * k * cin * cout * dtype_bytes),
        deps=deps,
        divisible=cout,
        meta={"h": h, "w": w, "cin": cin, "cout": cout, "k": k, "stride": stride},
    )
    return op, ho, wo, cout


def resnet18_graph(
    image_hw: int = 224, num_classes: int = 1000, dtype_bytes: int = 1
) -> Graph:
    """ResNet-18 at (N, 224, 224, 3) — the paper's evaluation workload.

    Per the standard VTA/TVM deployment (and the paper's AutoTVM setup),
    the stem conv runs on the accelerator too; ops are emitted at layer
    granularity with residual adds explicit so the scheduler sees the true
    dataflow.  ~1.8 GFLOP (0.9 GMAC) per image at 224x224.
    """
    ops: list[Op] = []
    h = w = image_hw

    op, h, w, c = _conv_op("stem.conv", (), h, w, 3, 64, 7, 2, dtype_bytes)
    ops.append(op)
    # 3x3/2 maxpool
    h, w = math.ceil(h / 2), math.ceil(w / 2)
    ops.append(
        Op(
            "stem.pool",
            "pool",
            macs=float(h * w * c * 9) / 16.0,  # ALU ops, not MACs; tiny
            bytes_in=float(4 * h * w * c * dtype_bytes),
            bytes_out=float(h * w * c * dtype_bytes),
            param_bytes=0.0,
            deps=("stem.conv",),
            divisible=c,
        )
    )
    prev = "stem.pool"

    stage_defs = [  # (blocks, cout, stride of first block)
        (2, 64, 1),
        (2, 128, 2),
        (2, 256, 2),
        (2, 512, 2),
    ]
    cin = 64
    for si, (blocks, cout, stride0) in enumerate(stage_defs):
        for bi in range(blocks):
            stride = stride0 if bi == 0 else 1
            base = f"layer{si + 1}.{bi}"
            shortcut_dep = prev
            op, h2, w2, _ = _conv_op(
                f"{base}.conv1", (prev,), h, w, cin, cout, 3, stride, dtype_bytes
            )
            ops.append(op)
            op2, h2, w2, _ = _conv_op(
                f"{base}.conv2", (f"{base}.conv1",), h2, w2, cout, cout, 3, 1, dtype_bytes
            )
            ops.append(op2)
            add_deps = [f"{base}.conv2"]
            if stride != 1 or cin != cout:
                opd, _, _, _ = _conv_op(
                    f"{base}.downsample", (shortcut_dep,), h, w, cin, cout, 1, stride, dtype_bytes
                )
                ops.append(opd)
                add_deps.append(f"{base}.downsample")
            else:
                add_deps.append(shortcut_dep)
            ops.append(
                Op(
                    f"{base}.add",
                    "add",
                    macs=float(h2 * w2 * cout) / 16.0,
                    bytes_in=float(2 * h2 * w2 * cout * dtype_bytes),
                    bytes_out=float(h2 * w2 * cout * dtype_bytes),
                    param_bytes=0.0,
                    deps=tuple(add_deps),
                    divisible=cout,
                )
            )
            prev = f"{base}.add"
            h, w, cin = h2, w2, cout

    ops.append(
        Op(
            "head.avgpool",
            "pool",
            macs=float(h * w * cin) / 16.0,
            bytes_in=float(h * w * cin * dtype_bytes),
            bytes_out=float(cin * dtype_bytes),
            param_bytes=0.0,
            deps=(prev,),
            divisible=cin,
        )
    )
    ops.append(
        Op(
            "head.fc",
            "dense",
            macs=float(cin * num_classes),
            bytes_in=float(cin * dtype_bytes),
            bytes_out=float(num_classes * 4),  # logits back to host as f32
            param_bytes=float(cin * num_classes * dtype_bytes),
            deps=("head.avgpool",),
            divisible=num_classes,
        )
    )
    return Graph("resnet18", ops)


def config_graph(cfg, seq_len: int = 4096) -> "Graph":
    """Planner graph for a :class:`repro_torch.configs.base.ModelConfig` — the
    per-layer cost source for pipeline balancing in the launchers."""
    return transformer_graph(
        cfg.name,
        num_layers=cfg.num_layers,
        d_model=cfg.d_model,
        num_heads=max(cfg.num_heads, 1),
        kv_heads=max(cfg.kv_heads, 1),
        d_ff=cfg.d_ff,
        vocab=cfg.vocab,
        seq_len=seq_len,
        moe_experts=cfg.moe_experts,
        moe_top_k=cfg.moe_top_k,
        moe_shared=cfg.moe_shared_experts,
        ssm_state=cfg.ssm_state,
        attn_free=cfg.is_attention_free,
    )


def transformer_graph(
    name: str,
    *,
    num_layers: int,
    d_model: int,
    num_heads: int,
    kv_heads: int,
    d_ff: int,
    vocab: int,
    seq_len: int,
    moe_experts: int = 0,
    moe_top_k: int = 0,
    moe_shared: int = 0,
    ssm_state: int = 0,
    attn_free: bool = False,
    dtype_bytes: int = 2,
) -> Graph:
    """Coarse per-layer graph of an LM transformer for scheduler planning.

    One 'attention' + one 'ffn' (or moe_ffn / ssm) op per layer; embeddings
    and the LM head at the ends.  MAC counts are per *token sequence*
    (batch=1, given seq_len) — matching how the FPGA simulator accounts a
    unit of work.
    """
    ops: list[Op] = []
    head_dim = d_model // max(num_heads, 1) if not attn_free else 0
    act_bytes = float(seq_len * d_model * dtype_bytes)

    ops.append(
        Op(
            "embed",
            "embed",
            macs=0.0,
            bytes_in=float(seq_len * 4),
            bytes_out=act_bytes,
            param_bytes=float(vocab * d_model * dtype_bytes),
            divisible=vocab,
        )
    )
    prev = "embed"
    for li in range(num_layers):
        if attn_free or ssm_state and name.startswith("mamba"):
            pass  # handled below per-layer kind
        if attn_free:
            d_inner = 2 * d_model
            macs = float(seq_len * (2 * d_model * d_inner + d_inner * ssm_state * 2))
            mixer = Op(
                f"layer{li}.ssm",
                "ssm",
                macs=macs,
                bytes_in=act_bytes,
                bytes_out=act_bytes,
                param_bytes=float((2 * d_model * d_inner + d_inner) * dtype_bytes),
                deps=(prev,),
                divisible=max(d_inner // 128, 1),
            )
        else:
            qkv_macs = seq_len * d_model * (num_heads + 2 * kv_heads) * head_dim
            attn_macs = 2 * seq_len * seq_len * num_heads * head_dim / 2  # causal
            out_macs = seq_len * num_heads * head_dim * d_model
            mixer = Op(
                f"layer{li}.attn",
                "attention",
                macs=float(qkv_macs + attn_macs + out_macs),
                bytes_in=act_bytes,
                bytes_out=act_bytes,
                param_bytes=float(
                    (d_model * (num_heads + 2 * kv_heads) * head_dim + num_heads * head_dim * d_model)
                    * dtype_bytes
                ),
                deps=(prev,),
                divisible=num_heads,
            )
        ops.append(mixer)
        if moe_experts:
            active = moe_top_k + moe_shared
            ffn = Op(
                f"layer{li}.moe",
                "moe_ffn",
                macs=float(seq_len * 3 * d_model * d_ff * active),
                bytes_in=act_bytes,
                bytes_out=act_bytes,
                param_bytes=float(3 * d_model * d_ff * (moe_experts + moe_shared) * dtype_bytes),
                deps=(mixer.name,),
                divisible=moe_experts,
                meta={"experts": moe_experts, "top_k": moe_top_k},
            )
        elif d_ff:
            ffn = Op(
                f"layer{li}.ffn",
                "dense",
                macs=float(seq_len * 3 * d_model * d_ff),
                bytes_in=act_bytes,
                bytes_out=act_bytes,
                param_bytes=float(3 * d_model * d_ff * dtype_bytes),
                deps=(mixer.name,),
                divisible=d_ff,
            )
        else:
            prev = mixer.name
            continue
        ops.append(ffn)
        prev = ffn.name

    ops.append(
        Op(
            "lm_head",
            "dense",
            macs=float(seq_len * d_model * vocab),
            bytes_in=act_bytes,
            bytes_out=float(seq_len * vocab * dtype_bytes),
            param_bytes=float(d_model * vocab * dtype_bytes),
            deps=(prev,),
            divisible=vocab,
        )
    )
    return Graph(name, ops)
