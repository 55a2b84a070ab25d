"""InternVL2-Llama3-76B backbone [arXiv:2404.16821; unverified].

VLM: InternViT frontend is a STUB — input_specs() provides precomputed
patch embeddings (B, 256, D) prepended to token embeddings; the backbone
(Llama-3-70B-shaped) is what we schedule.  long_500k skipped (full attn).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    d_ff=28672,
    vocab=128_256,
    rope_theta=500_000.0,
    frontend="vision",
    frontend_tokens=256,
    skip_shapes=("long_500k",),
)
