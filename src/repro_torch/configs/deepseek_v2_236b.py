"""DeepSeek-V2 236B [arXiv:2405.04434; hf].

MoE: 2 shared + 160 routed experts, top-6; MLA with kv_lora_rank=512.
The MoE FFN holds ~98% of the weights — the paper's 'bottleneck
operator', which AI-core assignment (expert parallelism) targets.
long_500k skipped: MLA is still full softmax attention (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_v2_236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    kv_heads=128,
    d_ff=1536,
    vocab=102_400,
    kv_lora_rank=512,
    rope_head_dim=64,
    mla_head_dim=128,
    mla_v_head_dim=128,
    moe_experts=160,
    moe_top_k=6,
    moe_shared_experts=2,
    skip_shapes=("long_500k",),
)
