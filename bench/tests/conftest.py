"""Shared pieces of the benchmark's CPU tests: the repository's root on the
path, and tiny configurations and mixes of the cells' shape."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_QWEN3 = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
              "vocab_size": 256}
PORT_FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
               "num_attention_heads": "num_heads", "num_key_value_heads": "kv_heads",
               "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab"}


def tiny_config(name: str) -> dict:
    """Configuration ``name``'s file at a CPU size, its engine's chunk 32."""
    c = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    c["name"] = name
    c.update(TINY_QWEN3)
    c["port"] = copy.deepcopy(c["port"])
    c["port"]["set"].update({PORT_FIELDS[k]: v for k, v in TINY_QWEN3.items()})
    c["engine"] = dict(c["engine"], prefill_chunk=32, pool_gib=0.01)
    return c


def tiny_mix(shared: bool) -> dict:
    return {"loop": "closed", "clients": 3, "max_slots": 3,
            "shared": {"count": 3, "zipf": 1.0, "block": 6,
                       "length": {"dist": "log_normal", "median": 60, "sigma": 0.6,
                                  "min": 40, "max": 90}} if shared else None,
            "prompt": {"dist": "log_normal", "median": 10, "sigma": 1.0, "min": 5, "max": 20}
            if shared else {"dist": "log_uniform", "min": 20, "max": 70},
            "answer": {"dist": "uniform", "min": 3, "max": 9}, "strata": 6,
            "warm_steps": 6, "trace_seconds": 0.3,
            "check": {"served_tokens": 24, "max_requests": 4}}


@pytest.fixture
def tiny():
    return tiny_config, tiny_mix
