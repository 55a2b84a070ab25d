"""AdamW + gradient clipping + LR schedule (PyTorch port of
``repro.optim.adamw``).

Plain tensor arithmetic in the reference's order, over the port's param
trees (``repro_torch.tree``), not ``torch.optim.AdamW``: the update, the
clipping and the schedule's f32 values follow the reference op by op, and
``apply`` returns its metrics (``grad_norm``, ``lr``).  Moments are
``moments_dtype`` (f32 by default) whatever the params' dtype; the
update runs in f32 and is cast back to each param's dtype.  Nothing is
updated in place: ``apply`` returns new params and a new state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # bf16 moments halve optimizer-state memory; f32 is the default
    moments_dtype: str = "float32"


class OptState(NamedTuple):
    mu: object
    nu: object
    step: torch.Tensor  # () int32, on the params' device


def init(params, moments_dtype=torch.float32) -> OptState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moments_dtype, device=p.device)

    device = leaves(params)[0].device
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf, summed on the first leaf's device
    (pipeline stages may sit on distinct cards)."""
    flat = leaves(tree)
    dev = flat[0].device
    total = 0
    for leaf in flat:
        total = total + leaf.float().square().sum().to(dev)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, norm_fn=global_norm):
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale.to(g.device), grads), norm


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: OptState, norm_fn=global_norm):
    """One AdamW update.  Returns (new_params, new_state, metrics).
    ``norm_fn`` computes the clipping norm (``dist.collective.global_norm``
    where the grads are FSDP slices held across processes)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm_fn)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2

    mdt = getattr(torch, cfg.moments_dtype)
    mu = tree_map(lambda m, g: (b1 * m.float() + (1 - b1) * g).to(mdt), state.mu, grads)
    nu = tree_map(lambda v, g: (b2 * v.float() + (1 - b2) * g.square()).to(mdt),
                  state.nu, grads)
    stepf = step.float()
    bc1 = 1 - torch.full_like(stepf, b1) ** stepf
    bc2 = 1 - torch.full_like(stepf, b2) ** stepf

    def upd(p, m, v):
        dev = p.device
        mhat = m.float() / bc1.to(dev)
        vhat = v.float() / bc2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr.to(dev) * delta).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, OptState(mu, nu, step), {"grad_norm": gnorm, "lr": lr}
