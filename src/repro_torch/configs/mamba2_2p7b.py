"""Mamba2-2.7B [arXiv:2405.21060; unverified].

Attention-free SSD (state-space duality).  d_ff=0 (no FFN blocks);
64 layers of Mamba2 mixers.  All four shapes run, incl. long_500k
(O(1) decode state).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2_2p7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50_280,
    ssm_state=128,
    ssm_head_dim=64,
)
