"""Carry the JAX package's params over to the port.

The reference stacks every layer's leaves on a leading ``num_layers``
axis (``repro.models.transformer.init``); the port keeps a list of
per-layer dicts.  The caller turns the reference's arrays into numpy
first (``jax.tree.map(np.asarray, params)``), so this module needs no
JAX.

Quantized trees (``optim.quant.quantize_params``) carry over with the
reference's values: integer leaves (``qw``) keep their dtype, ``qw`` is
packed K-major as the port's own ``quantize_params`` packs it, and the
int8 scale leaves (``qscale``, and the KV pools' ``*_scales``) stay f32
whatever ``dtype`` is, as the reference keeps them, and so do an MoE
layer's float ``router`` and a Mamba2 block's ``a_log``, ``d_skip`` and
``dt_bias``.  Stacked expert leaves (L, E, K, N) unstack to (E, K, N), an
int8 ``qw`` among them packed K-major per expert.
``resnet_params_from_numpy`` carries ResNet-18's nested tree (lists of
blocks, no stacked axis), whose batch norm statistics stay f32 as well
(``keeps_f32`` says which leaves).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.quant import k_major


def keeps_f32(key) -> bool:
    """A float leaf that stays f32 in every dtype: an int8 scale leaf
    (``qscale``, ``*_scales``), a batch norm's running ``mean`` / ``var``
    (``resnet._bn_init``), an MoE ``router`` (``moe.moe_init``) or a Mamba2
    block's ``a_log`` / ``d_skip`` / ``dt_bias`` (``ssm.mamba2_init``)."""
    return key in ("qscale", "mean", "var", "router", "a_log", "d_skip", "dt_bias") or (
        isinstance(key, str) and key.endswith("_scales"))


def _to_torch(tree, device, dtype, key=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, device, dtype) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
        leaf_dtype = torch.float32 if keeps_f32(key) else dtype
        return torch.from_numpy(arr).to(device=device, dtype=leaf_dtype)
    out = torch.from_numpy(np.array(arr)).to(device=device)
    return k_major(out) if key == "qw" else out


def _layer(tree, li):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return np.asarray(tree)[li]


def params_from_numpy(tree, cfg, device, dtype=torch.float32):
    """The port's params from the reference's params as a nested dict of
    numpy arrays: the stacked ``blocks`` (an enc-dec config's ``encoder``
    and ``decoder``) are unstacked into lists of per-layer dicts
    (``cfg.encoder_layers`` and ``cfg.num_layers``); a hybrid's unstacked
    ``shared_attn`` carries over as it is; float leaves become ``dtype`` on
    ``device`` (the ``keeps_f32`` leaves f32), integer leaves keep their
    dtype."""
    stacked = ({"encoder": cfg.encoder_layers, "decoder": cfg.num_layers}
               if cfg.is_enc_dec else {"blocks": cfg.num_layers})
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items() if k not in stacked}
    for k, n in stacked.items():
        out[k] = [_to_torch(_layer(tree[k], li), device, dtype) for li in range(n)]
    return out


def resnet_params_from_numpy(tree, device, dtype=torch.float32):
    """The port's ResNet-18 params from the reference's ``{"stem",
    "stages": [[block, ...], ...], "fc"}`` tree of numpy arrays: the same
    nesting (lists stay lists); float leaves become ``dtype`` on
    ``device`` except the batch-norm ``mean`` / ``var`` and int8 scale
    leaves, which stay f32; integer leaves (a packed ``fc``'s ``qw``) keep
    their dtype."""
    return _to_torch(tree, device, dtype)
