"""Carry the JAX package's params over to the port.

The reference stacks every layer's leaves on a leading ``num_layers``
axis (``repro.models.transformer.init``); the port keeps a list of
per-layer dicts.  The caller turns the reference's arrays into numpy
first (``jax.tree.map(np.asarray, params)``), so this module needs no
JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)
    return torch.from_numpy(arr).to(device=device)


def _layer(tree, li):
    if isinstance(tree, dict):
        return {k: _layer(v, li) for k, v in tree.items()}
    return np.asarray(tree)[li]


def params_from_numpy(tree, cfg, device, dtype=torch.float32):
    """The port's params from the reference's params as a nested dict of
    numpy arrays: the stacked ``blocks`` are unstacked into a list of
    ``cfg.num_layers`` per-layer dicts; float leaves become ``dtype`` on
    ``device``."""
    out = {k: _to_torch(v, device, dtype) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_to_torch(_layer(tree["blocks"], li), device, dtype)
                     for li in range(cfg.num_layers)]
    return out
