"""Input specs for every (architecture x input shape), on the ``meta``
device (the port of ``repro.launch.specs``).

Nothing here allocates memory on a real device: the model, optimizer and
cache trees come from the port's own ``init`` / ``init_state`` /
``init_caches`` with ``device="meta"``, and inputs are ``meta`` tensors.
Where the reference returns ``jax.ShapeDtypeStruct``s, these return
tensors of the same shape and dtype; the trees are the port's (per-layer
lists, host-int cache ``len`` counters, MLA's one latent buffer).

``grad_accum`` per (arch, shape) keeps the per-device live microbatch
small enough for the remat stash to fit 16 GiB of device memory; it
changes the wall-clock shape of a step, not its result.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec, transformer

META = torch.device("meta")

# per-device microbatch target ~8k tokens during training (remat stash
# budget); grad_accum = global_tokens / (dp_shards * 8192) rounded to a
# divisor of the global batch
TRAIN_GRAD_ACCUM = {
    # 16 == one sequence per dp shard per microbatch, the useful maximum
    # on the 16-wide data axis (beyond that shards idle)
    "deepseek_v2_236b": 16,
    "mixtral_8x22b": 16,
    "internvl2_76b": 16,
    "qwen2_72b": 16,
    "yi_34b": 16,
    "starcoder2_15b": 8,
    "zamba2_2p7b": 8,
    "mamba2_2p7b": 8,
    "qwen3_0p6b": 2,
    "seamless_m4t_large_v2": 8,
}

# archs whose Adam moments are held in bf16 (memory fit at 72B-236B scale)
BF16_MOMENTS = {"deepseek_v2_236b", "mixtral_8x22b", "internvl2_76b",
                "qwen2_72b", "yi_34b"}

# encoder frame count for the enc-dec model per shape kind
ENC_FRAMES = {"train": 4096, "prefill": 4096, "decode": 1024}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _moments_dtype(cfg):
    return torch.bfloat16 if cfg.name in BF16_MOMENTS else torch.float32


def train_batch_specs(cfg, shape):
    gb, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((gb, s + 1), torch.int32)}
    if cfg.frontend == "vision":
        batch["embeds"] = _meta((gb, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    if cfg.is_enc_dec:
        batch["frames"] = _meta((gb, ENC_FRAMES["train"], cfg.d_model), torch.bfloat16)
    return batch


def state_shapes(cfg, dtype=torch.bfloat16):
    from repro_torch.train.step import init_state

    return init_state(cfg, generator=torch.Generator(), dtype=dtype,
                      moments_dtype=_moments_dtype(cfg), device=META)


def param_shapes(cfg, dtype=torch.bfloat16):
    model = encdec if cfg.is_enc_dec else transformer
    return model.init(cfg, generator=torch.Generator(), dtype=dtype, device=META)


def pipeline_state_shapes(cfg, boundaries, dtype=torch.bfloat16):
    """Train-state shapes with blocks padded to the pipeline's uneven-cut
    stage layout (``pad_pipeline_params`` works on ``meta`` tensors)."""
    from repro_torch.train.step import init_pipeline_state

    return init_pipeline_state(cfg, boundaries, generator=torch.Generator(), dtype=dtype,
                               moments_dtype=_moments_dtype(cfg), device=META)


def cache_shapes(cfg, batch: int, max_len: int, dtype=torch.bfloat16):
    model = encdec if cfg.is_enc_dec else transformer
    return model.init_caches(cfg, batch, max_len, dtype, META)


def prefill_input_specs(cfg, shape):
    b, s = shape.global_batch, shape.seq_len
    inputs = {"tokens": _meta((b, s), torch.int32)}
    if cfg.frontend == "vision":
        inputs["embeds"] = _meta((b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    if cfg.is_enc_dec:
        inputs["frames"] = _meta((b, ENC_FRAMES["prefill"], cfg.d_model), torch.bfloat16)
    # prefill writes into a cache sized for the prompt
    front = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    inputs["caches"] = cache_shapes(cfg, b, s + front)
    return inputs


def decode_input_specs(cfg, shape):
    """serve_step: ONE new token against a cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    inputs = {"token": _meta((b, 1), torch.int32), "caches": cache_shapes(cfg, b, s)}
    if cfg.is_enc_dec:
        frames = _meta((b, ENC_FRAMES["decode"], cfg.d_model), torch.bfloat16)
        with torch.no_grad():
            inputs["kv"] = encdec.cross_kv(param_shapes(cfg), cfg, frames)
    return inputs


def input_specs(cfg, shape):
    """The step's inputs for the shape's kind: ``{"state", "batch"}`` for
    train, else the prefill or decode inputs."""
    if shape.kind == "train":
        return {"state": state_shapes(cfg), "batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
