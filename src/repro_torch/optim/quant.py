"""Shared int8 quantization helpers (PyTorch port of
``repro.optim.quant``) — ONE rounding/clamp convention:

    scale = max(|x|, eps) / 127          (symmetric, zero-point free)
    q     = clip(round(x / scale), -127, 127)  as int8
    x'    = q * scale                    (dequantization)

Round half to even (``torch.round``, as ``jnp.round``), clamp to the
symmetric range [-127, 127], ``eps = 1e-12`` guards all-zero tensors.
``x / scale`` is a true f32 division, as in the reference, so codes and
scales are bitwise equal to its.  Granularity is the caller's choice via
``axes``: per tensor (dynamic activations of the serving GEMMs), per
output channel (weights, :func:`quantize_dense`), per page and head (the
int8 KV pools of ``serve/kv_cache``).

:func:`quantize_params` rewrites every dense dict ``{"w"[, "b"]}`` of a
port param tree into ``{"qw" int8, "qscale" f32[, "b"]}``, the form
``models.layers.dense_apply`` sends through the VTA GEMM's dequant
epilogue; ``qw`` is packed K-major (:func:`k_major`).
"""

from __future__ import annotations

import torch

EPS = 1e-12


def _dims(x: torch.Tensor, axes):
    if axes is None:
        return tuple(range(x.dim()))
    return (axes,) if isinstance(axes, int) else tuple(axes)


def scale_from_amax(amax):
    """The amax -> scale step of the convention, shared by every path
    that pre-reduces its own max (e.g. the KV page segment-max)."""
    return torch.clamp_min(amax, EPS) / 127.0


def scale_for(x, axes=None, keepdims: bool = False):
    """Symmetric int8 scale of ``x`` reduced over ``axes`` (None = all)."""
    return scale_from_amax(torch.amax(x.float().abs(), dim=_dims(x, axes),
                                      keepdim=keepdims))


def quant_with_scale(x, scale):
    """f32 -> int8 under a precomputed (broadcastable) scale."""
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def quant_int8(x, axes=None, keepdims: bool = False):
    """Quantize; returns (q int8, scale f32 reduced over ``axes``)."""
    scale = scale_for(x, axes=axes, keepdims=True)
    q = quant_with_scale(x, scale)
    if not keepdims:
        scale = (scale.reshape(()) if axes is None
                 else scale.squeeze(_dims(x, axes)))
    return q, scale


def dequant_int8(q, scale):
    return q.float() * scale


# ---------------------------------------------------------------------------
# weight packing: params -> QuantizedLinear form
# ---------------------------------------------------------------------------


def k_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` (..., K, N) with the same shape and values, laid out K-major:
    a view with strides (..., 1, K) of an (..., N, K)-contiguous tensor,
    the layout the VTA GEMM kernel streams at rate."""
    return w.transpose(-2, -1).contiguous().transpose(-2, -1)


def quantize_dense(p: dict) -> dict:
    """One dense-layer dict ``{"w" (..., K, N)[, "b"]}`` -> int8 form.

    The scale is per OUTPUT channel: the contraction axis (-2) is
    reduced, so a (K, N) weight gets an (N,) scale and a stacked
    (E, K, N) weight gets (E, N).  ``qw`` has the reference's shape and
    values, packed K-major (:func:`k_major`)."""
    w = p["w"].float()
    scale = scale_for(w, axes=(-2,))
    out = {"qw": k_major(quant_with_scale(w, scale.unsqueeze(-2))), "qscale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def is_quantized(p) -> bool:
    return isinstance(p, dict) and "qw" in p


def quantize_params(params):
    """One-shot pack pass over a port param tree (``blocks`` a list of
    per-layer dicts).

    Rewrites every dense dict (``{"w"[, "b"]}`` with a 2D weight, or 3D
    when stacked along an expert axis) and MoE ``router`` arrays into
    QuantizedLinear form.  Left untouched, as in the reference:
    embeddings (a quantized table would corrupt the lookup and the tied
    LM head), norms, 1D leaves and 4D conv weights.  The f32 params are
    not modified."""

    def walk(node, key=None):
        if isinstance(node, dict):
            leaves_ok = all(not isinstance(v, (dict, list)) for v in node.values())
            if ("w" in node and set(node) <= {"w", "b"} and leaves_ok
                    and node["w"].dim() in (2, 3)):
                return quantize_dense(node)
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if key == "router" and isinstance(node, torch.Tensor) and node.dim() >= 2:
            return quantize_dense({"w": node})
        return node

    return walk(params)
