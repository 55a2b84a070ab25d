"""Qwen2-72B [arXiv:2407.10671; hf].  GQA with QKV bias.  long_500k
skipped (full attention)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    d_ff=29568,
    vocab=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    skip_shapes=("long_500k",),
)
