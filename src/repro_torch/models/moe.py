"""Mixture-of-Experts FFN: top-k routing, shared experts (PyTorch port of
``repro.models.moe``).

Dispatch is the reference's capacity-buffer formulation:

  1. router top-k -> (expert, position-in-buffer) per token choice, the
     positions a cumulative count over the token-major (N*k) order, so
     the same tokens overflow a full expert as in the reference;
  2. scatter the kept tokens into per-expert buffers (E, C, D);
  3. run every expert on its buffer (batched matmuls, or one int8 GEMM
     per expert for quantized experts);
  4. gather the outputs back to token order, gate-weighted.

Three choices keep the result the reference's on the card:

* ties in the router's top-k resolve to the lower expert index, as
  ``jax.lax.top_k`` does: a stable descending sort, not ``torch.topk``
  (whose order among equal values CUDA does not promise);
* the buffer scatter adds each kept token into a slot no other kept token
  shares (a dropped choice adds 0.0), so it is exact in any order;
* the combine is a fixed left-to-right sum over each token's k choices,
  not an atomic ``index_add_``, so two runs on the card are bitwise equal.

Quantized experts (``{"qw" (E, K, N), "qscale" (E, N)}``, each expert's
weight packed K-major by ``optim.quant``) quantize each expert's token
buffer with its own activation scale and run the int8 x int8 -> int32
product through ``kernels.vta_gemm`` (epilogue ``"none"``), one launch per
expert, under ``layers.set_gemm_impl``'s dispatch; the scales are applied
in PyTorch in the reference's order.

Expert parallelism (``dist.tensor``'s ambient model group, expert leaves
holding this rank's ``E / model`` experts): every rank of the model group
routes the same tokens and builds the same buffers, runs its own experts
and gathers the outputs along E, so the combine after that is the
one-process sum.  Shared experts split over their count are gathered and
summed in the same order.

Global routing (``dist.tensor.routing_group``, the data group the train
step sets): the capacity comes from the microbatch's global token count,
and each choice's position adds the per-expert counts of the earlier data
positions (one ``all_gather`` of E ints).  ``collective.shard_rows`` gives
the processes the microbatch's rows in order, so the positions are the
reference's token-major count over the global microbatch and the same
choices overflow.  A process's buffers hold only its own tokens, at most
``min(capacity, N)`` a expert.  The load-balancing loss reads the global
fractions; the sum of the router's probabilities crosses the processes by
``tensor.sum_across``, whose gradient the train step's mean over the
processes turns back into the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import collective
from repro_torch.dist import tensor as tp
from repro_torch.kernels.vta_gemm import gemm_int32, vta_gemm
from repro_torch.models.layers import _normal, quant_dense_apply, use_gemm_kernel
from repro_torch.optim.quant import quant_int8


def _stacked_mlp_init(gen, n: int, d: int, f: int, dtype, device):
    """``n`` gated MLPs stacked on a leading axis: ``{"w_gate"/"w_up":
    {"w": (n, d, f)}, "w_down": {"w": (n, f, d)}}``."""
    return {
        "w_gate": {"w": _normal(gen, (n, d, f), d ** -0.5, dtype, device)},
        "w_up": {"w": _normal(gen, (n, d, f), d ** -0.5, dtype, device)},
        "w_down": {"w": _normal(gen, (n, f, d), f ** -0.5, dtype, device)},
    }


def moe_init(gen, cfg, dtype, device):
    """The router stays f32 whatever ``dtype`` is, as in the reference."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {
        "router": _normal(gen, (d, e), 0.02, torch.float32, device),
        "experts": _stacked_mlp_init(gen, e, d, f, dtype, device),
    }
    if cfg.moe_shared_experts:
        p["shared"] = _stacked_mlp_init(gen, cfg.moe_shared_experts, d, f, dtype, device)
    return p


def _q_expert_mm(qp, x):
    """Quantized batched expert matmul: x (E, C, K) against int8 ``qw``
    (E, K, N).  One activation scale per expert buffer, per-expert
    per-channel weight scales; each expert's int32 product is one VTA GEMM
    launch (or its plain version, by ``set_gemm_impl``)."""
    qx, sx = quant_int8(x, axes=(1, 2), keepdims=True)  # (E, 1, 1)
    qw = qp["qw"]
    gemm = vta_gemm if use_gemm_kernel(x) else gemm_int32
    acc = torch.stack([gemm(qx[i], qw[i]) for i in range(qw.shape[0])])
    return acc.float() * (sx * qp["qscale"].float()[:, None, :])


def _expert_ffn(ep, x):
    """x: (E, C, D) batched over experts; the params' leaves lead with E."""
    if "qw" in ep["w_gate"]:
        g = F.silu(_q_expert_mm(ep["w_gate"], x)).to(x.dtype)
        u = _q_expert_mm(ep["w_up"], x).to(x.dtype)
        return _q_expert_mm(ep["w_down"], g * u).to(x.dtype)
    g = F.silu(torch.bmm(x, ep["w_gate"]["w"]).float()).to(x.dtype)
    u = torch.bmm(x, ep["w_up"]["w"])
    return torch.bmm(g * u, ep["w_down"]["w"])


def top_k(probs, k: int):
    """(values, indices) of the ``k`` largest entries of each row, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity_for(cfg, n: int) -> int:
    """The training capacity: ``moe_capacity_factor * n * k / E``, rounded
    by Python's ``round`` (half to even) exactly as the reference does."""
    return int(max(1, round(cfg.moe_capacity_factor * n * cfg.moe_top_k / cfg.moe_experts)))


def dispatch_slots(exp_flat, n: int, capacity: int | None, cfg):
    """Where each (token, choice) goes: ``(pos, keep, slots, counts, n_all)``.
    ``pos`` is its slot in its expert's buffer (clamped into ``slots``),
    ``keep`` whether it fits the capacity, ``slots`` the buffer length,
    ``counts`` the per-expert choice counts over the routing group and
    ``n_all`` its token count.  Without a routing group the positions are
    the token-major count over these ``n`` tokens; with one, that count
    plus the earlier data positions' counts."""
    onehot = F.one_hot(exp_flat, cfg.moe_experts)  # (N*k, E)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    counts = onehot.sum(0)
    group = tp.routing_group()
    if group is None:
        cap = capacity or capacity_for(cfg, n)
        return pos.clamp(0, cap - 1), pos < cap, cap, counts, n
    every = collective.all_gather_dim(counts[None], 0, group)  # (positions, E)
    n_all = n * group.size
    cap = capacity or capacity_for(cfg, n_all)
    keep = pos + every[:group.rank].sum(0)[exp_flat] < cap
    # a kept choice sits below the capacity and below this process's count
    slots = min(cap, n)
    return pos.clamp(0, slots - 1), keep, slots, every.sum(0), n_all


def _local_experts(ep, e: int):
    """(this rank's expert leaves' count, its first expert): every expert
    when the leaves are whole."""
    held = next(iter(ep["w_gate"].values())).shape[0]
    if not tp.split(held, e):
        return held, 0
    return held, tp.model_rank() * held


def moe_apply(p, cfg, x, capacity: int | None = None):
    """x: (B, S, D) -> (y, aux_loss).  ``capacity`` (slots per expert)
    defaults to :func:`capacity_for`; choices past it are dropped."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    n = b * s
    xt = x.reshape(n, d)

    if isinstance(p["router"], dict):  # quantized router projection
        logits = quant_dense_apply(p["router"], xt.float())
    else:
        logits = xt.float() @ p["router"]  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # position of each (token, choice) within its expert's buffer
    exp_flat = gate_idx.reshape(-1)  # (N*k,)
    pos_c, keep, slots, counts, n_all = dispatch_slots(exp_flat, n, capacity, cfg)

    # scatter the kept tokens into the expert buffers (each rank of a model
    # group builds them all, then runs its own experts on their rows)
    held, first = _local_experts(p["experts"], e)
    xe = tp.copy(xt) if held != e else xt
    tok_flat = torch.arange(n, device=x.device).repeat_interleave(k)
    src = xe[tok_flat] * keep[:, None].to(xt.dtype)
    buffers = torch.zeros((e, slots, d), dtype=xt.dtype, device=x.device)
    buffers.index_put_((exp_flat, pos_c), src, accumulate=True)

    if held != e:
        outputs = tp.gather(_expert_ffn(p["experts"], buffers[first:first + held]), 0)
    else:
        outputs = _expert_ffn(p["experts"], buffers)

    # gather back in token order, gate-weighted, summed over the k choices
    # left to right
    picked = outputs[exp_flat, pos_c]  # (N*k, D)
    w = (gate_vals.reshape(-1) * keep.float()).to(xt.dtype)
    contrib = (picked * w[:, None]).reshape(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    if "shared" in p:
        n_sh, _ = _local_experts(p["shared"], cfg.moe_shared_experts)
        split = n_sh != cfg.moe_shared_experts
        xs = tp.copy(xt) if split else xt
        sh = _expert_ffn(p["shared"], xs[None].expand(n_sh, n, d))
        if split:
            sh = tp.gather(sh, 0)
        y = y + sh.sum(dim=0).to(y.dtype)

    # Switch-style load-balancing auxiliary loss
    frac_tokens = counts.float() / (n_all * k)
    group = tp.routing_group()
    if group is None:
        frac_probs = probs.mean(dim=0)
    else:
        frac_probs = tp.sum_across(probs.sum(dim=0), group) / n_all
    aux = e * (frac_tokens * frac_probs).sum()

    return y.reshape(b, s, d).to(x.dtype), aux
