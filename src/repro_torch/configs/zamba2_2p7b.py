"""Zamba2 2.7B [arXiv:2411.15242; hf].

Mamba2 backbone + one shared attention(+MLP) block applied every 6
layers.  Sub-quadratic: long_500k runs (SSM state + periodic attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_2p7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    kv_heads=32,
    d_ff=10240,
    vocab=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    attn_every=6,
)
