"""Model/run configuration system.

One :class:`ModelConfig` describes every architecture in the assigned
pool; per-arch modules in this package instantiate it with the published
hyperparameters.  ``--arch <id>`` in the launchers resolves through
:func:`get_config`.

Shapes: each architecture is paired with the four assigned input shapes.
``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the prefill
pass; ``decode_32k``/``long_500k`` lower ``serve_step`` (one new token
against a KV cache of the given length).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 -> full attention
    # MLA (deepseek-v2): compressed KV cache
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    q_lora_rank: int = 0
    mla_head_dim: int = 128  # nope-dim per head for MLA
    mla_v_head_dim: int = 128

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    attn_every: int = 0  # hybrid: one shared attention block every N layers

    # encoder-decoder (seamless-m4t)
    encoder_layers: int = 0
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 256  # patch/frame embeddings prepended (vlm)

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 524_288

    # which assigned shapes to skip, with the reason (documented in
    # DESIGN.md §Arch-applicability)
    skip_shapes: tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def scaled_down(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family for CPU smoke tests."""
        small = dict(
            num_layers=max(2, min(4, self.num_layers // 16)),
            d_model=128,
            num_heads=4,
            kv_heads=min(self.kv_heads, 2) if self.kv_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32 if self.num_heads else 0,
            max_seq_len=2048,
        )
        if self.moe_experts:
            small.update(moe_experts=4, moe_top_k=2,
                         moe_shared_experts=min(self.moe_shared_experts, 1))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16)
        if self.kv_lora_rank:
            small.update(kv_lora_rank=32, rope_head_dim=16, mla_head_dim=32,
                         mla_v_head_dim=32, q_lora_rank=0)
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.attn_every:
            small.update(attn_every=2, num_layers=4)
        if self.sliding_window:
            small.update(sliding_window=128)
        small.update(overrides)
        return dataclasses.replace(self, **small)


ARCH_IDS = (
    "deepseek_v2_236b",
    "mixtral_8x22b",
    "zamba2_2p7b",
    "internvl2_76b",
    "yi_34b",
    "qwen2_72b",
    "qwen3_0p6b",
    "starcoder2_15b",
    "seamless_m4t_large_v2",
    "mamba2_2p7b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-2.7b": "zamba2_2p7b",
    "internvl2-76b": "internvl2_76b",
    "yi-34b": "yi_34b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-0.6b": "qwen3_0p6b",
    "starcoder2-15b": "starcoder2_15b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-2.7b": "mamba2_2p7b",
    "resnet18": "resnet18_vta",
    "resnet18-vta": "resnet18_vta",
})


def get_config(arch: str) -> ModelConfig:
    key = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
