"""Mixtral 8x22B [arXiv:2401.04088; hf].

8 experts top-2, GQA kv=8, sliding-window attention.  SWA bounds the KV
cache at the window, so long_500k decode IS runnable (O(window) state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    kv_heads=8,
    d_ff=16384,
    vocab=32_768,
    sliding_window=4096,
    moe_experts=8,
    moe_top_k=2,
)
