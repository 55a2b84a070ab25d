"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf].  qk_norm, GQA, tied
embeddings.  long_500k skipped (full attention)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_0p6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
