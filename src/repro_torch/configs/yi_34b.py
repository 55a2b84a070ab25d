"""Yi-34B [arXiv:2403.04652; hf].  Llama-arch GQA.  long_500k skipped."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi_34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    kv_heads=8,
    d_ff=20480,
    vocab=64_000,
    rope_theta=5_000_000.0,
    skip_shapes=("long_500k",),
)
