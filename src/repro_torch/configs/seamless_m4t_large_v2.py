"""SeamlessM4T-large-v2 backbone [arXiv:2308.11596; hf].

Enc-dec transformer; the speech/text frontend is a STUB (precomputed
frame embeddings feed the encoder).  Decoder decodes with
cross-attention, so decode shapes run; long_500k skipped (full attn).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_large_v2",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    kv_heads=16,
    d_ff=8192,
    vocab=256_206,
    frontend="audio",
    frontend_tokens=1024,
    skip_shapes=("long_500k",),
)
