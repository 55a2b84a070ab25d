"""A configuration file, the program's model configuration built from it,
and the weights the benchmark makes from the seed.

The file holds the published keys (``hidden_size``, ``num_hidden_layers``,
...) as run.  Its ``port`` entry names the program's architecture and the
fields set on it; :func:`port_config` builds that and refuses it unless
every published key that maps to one of its fields agrees with it, so the
file cannot say one thing while the program runs another.  Weights follow
the reference's ``layout``: one normal draw over a single buffer on the
device, from ``--seed``, cut into the leaves and scaled in place.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]

# published key -> the program's ModelConfig field
FIELDS = {
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "kv_heads",
    "num_hidden_layers": "num_layers",
    "vocab_size": "vocab",
    "head_dim": "head_dim",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "attention_bias": "qkv_bias",
    "intermediate_size": "d_ff",
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(c: dict):
    """The plain reference of configuration file ``c``: its
    ``reference_file``, else ``reference/<name>.py``."""
    path = c.get("reference_file") or BENCH / "reference" / f"{c['name']}.py"
    return load_module(Path(path), f"bench_reference_{c['name']}")


def port_config(c: dict):
    """The program's ``ModelConfig`` for configuration file ``c``."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(c["port"]["arch"]), **c["port"].get("set", {}))
    want = {field: c[key] for key, field in FIELDS.items() if key in c}
    for field, value in want.items():
        have = getattr(cfg, field)
        value = 0 if value is None else value
        if (have != value if isinstance(value, (bool, int))
                else not math.isclose(have, value, rel_tol=1e-12)):
            raise ValueError(f"{c['port']['arch']}: the program's {field} is {have}, "
                             f"the configuration file says {value}")
    return cfg


def _aligned(n: int) -> int:
    return -(-n // 64) * 64  # leaves start 256 bytes apart


def make_weights(c: dict, layout: list, seed: int, device, buffer=None):
    """``(tree, buffer)``: every leaf of ``layout`` a view of one buffer in
    the configuration's dtype, drawn from ``seed`` on ``device`` in one
    call (``buffer``, when given, is drawn into again).  A normal leaf is
    scaled to its ``std``, a norm's scale is ``1 + 0.1 N(0, 1)``."""
    dtype = DTYPES[c["dtype"]]
    total = sum(_aligned(math.prod(shape)) for _, shape, _ in layout)
    if buffer is None or buffer.numel() != total:
        buffer = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    buffer.normal_(generator=gen)
    tree, off = {}, 0
    for path, shape, std in layout:
        n = math.prod(shape)
        leaf = buffer[off:off + n].view(shape)
        off += _aligned(n)
        if std is None:
            leaf.mul_(0.1).add_(1.0)
        else:
            leaf.mul_(std)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(nxt, int):
                node = node.setdefault(key, [])
            elif isinstance(key, int):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree, buffer


def leaves(tree, prefix=()):
    """``(path, tensor)`` of every leaf of a nested dict / list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        if isinstance(val, (dict, list)):
            yield from leaves(val, prefix + (key,))
        elif isinstance(val, torch.Tensor):
            yield prefix + (key,), val
