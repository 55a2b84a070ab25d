"""StarCoder2-15B [arXiv:2402.19173; hf].  GQA kv=4, RoPE.  long_500k
skipped (full attention)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    kv_heads=4,
    d_ff=24576,
    vocab=49_152,
    qkv_bias=True,
    rope_theta=100_000.0,
    skip_shapes=("long_500k",),
)
