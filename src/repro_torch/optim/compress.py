"""Gradient compression with error feedback (PyTorch port of
``repro.optim.compress``).

For bandwidth-bound meshes, compressing the gradient all-reduce trades a
little fidelity for a lot of wire time.  Two schemes:

* ``Int8Compressor`` — per-leaf symmetric int8 quantization (``optim.quant``'s
  convention), with error feedback: the quantization residual is carried
  to the next step, so the *accumulated* gradient is unbiased.
* ``TopKCompressor`` — magnitude top-k sparsification with EF.

On one device there is no all-reduce; ``train.step.make_train_step(compress=)``
applies the round trip (quantize -> dequantize) to the gradients before
the optimizer, as the reference's data-parallel path does around its
compiler-emitted all-reduce.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.quant import dequant_int8, quant_int8
from repro_torch.tree import leaves, tree_map, unflatten


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _is_payload(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _map_payload(fn, tree):
    """``fn`` applied to every {'q', 'scale'} record of a payload tree."""
    if _is_payload(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_payload(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_payload(fn, v) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """grads -> (int8 payload, scale) -> grads, with error feedback."""

    def init(self, params):
        return _zeros_f32(params)

    def compress(self, grads, ef):
        """Returns (payload tree of {'q', 'scale'}, new_ef)."""
        payload, new_ef = [], []
        for g, e in zip(leaves(grads), leaves(ef)):
            gf = g.float() + e
            q, scale = quant_int8(gf)
            payload.append({"q": q, "scale": scale})
            new_ef.append(gf - dequant_int8(q, scale))
        return unflatten(grads, payload), unflatten(grads, new_ef)

    def decompress(self, payload):
        return _map_payload(lambda r: dequant_int8(r["q"], r["scale"]), payload)

    def roundtrip(self, grads, ef):
        """compress + decompress in one go."""
        payload, new_ef = self.compress(grads, ef)
        return self.decompress(payload), new_ef

    def apply(self, grads, state):
        """train_step hook: the state dict carries 'ef'."""
        ef = state.get("ef")
        if ef is None:
            ef = self.init(grads)
        new_grads, new_ef = self.roundtrip(grads, ef)
        return new_grads, dict(state, ef=new_ef)

    @staticmethod
    def payload_bytes(params) -> int:
        """Wire bytes of one compressed gradient exchange: 1 B/element
        int8 payload PLUS the per-leaf f32 scale."""
        ls = leaves(params)
        return sum(int(p.numel()) for p in ls) + 4 * len(ls)


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    fraction: float = 0.01

    def init(self, params):
        return _zeros_f32(params)

    def apply(self, grads, state):
        ef = state.get("ef")
        if ef is None:
            ef = self.init(grads)
        kept, new_ef = [], []
        for g, e in zip(leaves(grads), leaves(ef)):
            gf = g.float() + e
            flat = gf.reshape(-1)
            k = max(1, int(flat.numel() * self.fraction))
            thresh = torch.topk(flat.abs(), k).values[-1]
            keep = torch.where(flat.abs() >= thresh, flat, 0.0).reshape(gf.shape)
            kept.append(keep)
            new_ef.append(gf - keep)
        return unflatten(grads, kept), dict(state, ef=unflatten(grads, new_ef))
