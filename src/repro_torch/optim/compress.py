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

Both compressors work on the reference's leaves.  The reference stacks a
layer list's leaves on a leading axis, so one of its leaves is every
layer's copy of a port leaf: the port's leaves whose paths differ only in
list indices (``blocks/0/ffn/w_up`` ... ``blocks/L-1/ffn/w_up``) share one
int8 scale (their ``amax`` together) and one top-k threshold (the k-th
largest ``|g + ef|`` of them all, ``k`` of their summed size).

Under tensor parallelism (``model``, one process per mesh position) a
leaf split over 'model' (``model_shards``, ``dist.sharding.model_shards``)
reaches ``apply`` as this rank's slice, and so does its ``ef``: the
``amax`` is taken across the model group too (one ``all_reduce`` MAX for
every split leaf; a max, so the order of operations does not move it),
and the threshold from each rank's own top-k gathered across the group
(one ``all_gather`` for every split leaf).  A leaf the specs leave whole
is compressed whole.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.quant import dequant_int8, quant_with_scale, scale_from_amax
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _split(grads, model, model_shards) -> list:
    """Per leaf of ``grads``: whether it holds a slice split over the
    model group."""
    if model is None or model_shards is None:
        return [False] * len(leaves(grads))
    from repro_torch.dist.collective import _shard_leaves

    return [s is not None for s in _shard_leaves(model_shards)]


def _stacks(grads) -> list:
    """The reference's leaves as lists of port leaf indices: the leaves
    whose paths differ only in list indices (one per layer) form one."""
    out: dict = {}
    for i, (path, _) in enumerate(flatten_with_path(grads)):
        out.setdefault(tuple(p for p in path if not isinstance(p, int)), []).append(i)
    return list(out.values())


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

    def compress(self, grads, ef, model=None, model_shards=None):
        """Returns (payload tree of {'q', 'scale'}, new_ef); each of the
        reference's leaves takes its scale from its whole ``amax``."""
        gfs = [g.float() + e for g, e in zip(leaves(grads), leaves(ef))]
        stacks = _stacks(grads)
        amax = [torch.stack([gfs[i].abs().amax() for i in st]).amax() for st in stacks]
        split = _split(grads, model, model_shards)
        across = [j for j, st in enumerate(stacks) if split[st[0]]]
        if across:
            from repro_torch.dist.collective import all_reduce_max

            for j, a in zip(across, all_reduce_max([amax[j] for j in across], model)):
                amax[j] = a
        of = [None] * len(gfs)
        for j, st in enumerate(stacks):
            for i in st:
                of[i] = amax[j]
        payload, new_ef = [], []
        for gf, a in zip(gfs, of):
            scale = scale_from_amax(a)
            q = quant_with_scale(gf, scale)
            payload.append({"q": q, "scale": scale})
            new_ef.append(gf - dequant_int8(q, scale))
        return unflatten(grads, payload), unflatten(grads, new_ef)

    def decompress(self, payload):
        return _map_payload(lambda r: dequant_int8(r["q"], r["scale"]), payload)

    def roundtrip(self, grads, ef, model=None, model_shards=None):
        """compress + decompress in one go."""
        payload, new_ef = self.compress(grads, ef, model, model_shards)
        return self.decompress(payload), new_ef

    def apply(self, grads, state, model=None, model_shards=None):
        """train_step hook: the state dict carries 'ef'."""
        ef = state.get("ef")
        if ef is None:
            ef = self.init(grads)
        new_grads, new_ef = self.roundtrip(grads, ef, model, model_shards)
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

    def apply(self, grads, state, model=None, model_shards=None):
        """The kept gradients and the state with the new 'ef': each of the
        reference's leaves keeps its top ``k`` (across ``model`` where split)."""
        ef = state.get("ef")
        if ef is None:
            ef = self.init(grads)
        split = _split(grads, model, model_shards)
        flats = [(g.float() + e).reshape(-1) for g, e in zip(leaves(grads), leaves(ef))]
        stacks = _stacks(grads)
        mags = [torch.cat([flats[i].abs() for i in st]) for st in stacks]
        ks = [max(1, int(m.numel() * (model.size if split[st[0]] else 1) * self.fraction))
              for m, st in zip(mags, stacks)]
        tops = [torch.topk(m, min(k, m.numel())).values for m, k in zip(mags, ks)]
        thresh = [t[k - 1] if not split[st[0]] else None
                  for t, k, st in zip(tops, ks, stacks)]
        across = [j for j, st in enumerate(stacks) if split[st[0]]]
        if across:
            # every rank's own top-k of each split leaf, gathered: the whole
            # leaf's top k are among them
            from repro_torch.dist.collective import all_gather_dim

            sizes = [tops[j].numel() for j in across]
            every = all_gather_dim(torch.cat([tops[j] for j in across]), 0, model)
            every = every.reshape(model.size, -1).split(sizes, dim=1)
            for j, vals in zip(across, every):
                thresh[j] = torch.topk(vals.reshape(-1), ks[j]).values[-1]
        of = [None] * len(flats)
        for j, st in enumerate(stacks):
            for i in st:
                of[i] = thresh[j]
        kept, new_ef = [], []
        for g, f, t in zip(leaves(grads), flats, of):
            keep = torch.where(f.abs() >= t, f, 0.0)
            kept.append(keep.reshape(g.shape))
            new_ef.append((f - keep).reshape(g.shape))
        return unflatten(grads, kept), dict(state, ef=unflatten(grads, new_ef))
