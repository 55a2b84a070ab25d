"""Plain float32 building blocks shared by the configurations' references.

Every matrix product goes through :func:`matmul`, so one switch sets the
precision of a whole reference run: ``"f32"`` (TF32 off, the reference) or
``"tf32"`` (the control: the card's TF32 tensor-core path, or on a CPU the
same rounding of both operands to TF32's 10-bit mantissa).  Nothing here
imports the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

_PRECISION = "f32"


@contextlib.contextmanager
def precision(mode: str):
    """Run the references inside at ``mode`` ("f32" or "tf32")."""
    global _PRECISION
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision must be 'f32' or 'tf32', got {mode!r}")
    saved = (_PRECISION, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _PRECISION = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_PRECISION, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # the bits, unsigned
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.float(), b.float()
    if _PRECISION == "tf32" and a.device.type != "cuda":
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, ``x`` (T, H, D), the halves of D paired (the
    ``rotate_half`` convention)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return matmul(torch.nn.functional.silu(matmul(x, w_gate)) * matmul(x, w_up), w_down)


def causal_attention(q, k, v, scale: float, block: int = 512) -> torch.Tensor:
    """Causal softmax attention of ``q`` (T, H, D) over ``k`` (T, H, D) and
    ``v`` (T, H, Dv), query rows in blocks so that the (H, rows, T) scores
    of one block are all that is held; returns (T, H, Dv)."""
    t = q.shape[0]
    out = torch.empty((t, q.shape[1], v.shape[-1]), dtype=torch.float32, device=q.device)
    kt = k.float().permute(1, 2, 0)  # (H, D, T)
    vh = v.float().permute(1, 0, 2)  # (H, T, Dv)
    for i0 in range(0, t, block):
        i1 = min(t, i0 + block)
        qb = q[i0:i1].float().permute(1, 0, 2)  # (H, B, D)
        s = matmul(qb, kt[:, :, :i1]) * scale  # (H, B, i1)
        rows = torch.arange(i0, i1, device=q.device)[:, None]
        cols = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, -math.inf)
        p = torch.softmax(s, dim=-1)
        out[i0:i1] = matmul(p, vh[:, :i1]).permute(1, 0, 2)
    return out
