"""ResNet-18 on the VTA int8 datapath — the paper's own workload.

Not part of the assigned LM pool; used by the paper-reproduction
benchmarks, the quantized-serving example, and the kernel tests.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet18_vta",
    family="cnn",
    num_layers=18,
    d_model=512,
    num_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=1000,  # classes
    skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
