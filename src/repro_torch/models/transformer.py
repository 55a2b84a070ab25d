"""Decoder LM, dense family (PyTorch port of ``repro.models.transformer``).

Params are ``{"embed": {"table"}, "blocks": [per-layer dict, ...],
"final_norm": {"scale"}[, "lm_head"]}``: the reference's stacked layer
axis becomes a list, and layers run as a Python loop.  On one device the
reference's sharding hints have nothing to do and are gone.

  init(cfg, *, generator, dtype, device)        -> params
  forward(params, cfg, tokens)                  -> (logits, aux_loss)
  init_caches(cfg, batch, max_len, dtype, device[, cache_layout="paged"])
                                                -> caches
  prefill(params, cfg, tokens, caches)          -> (last_logits, caches)
  decode_step(params, cfg, token, caches)       -> (logits, caches)
  verify_step(params, cfg, tokens, caches)      -> (logits, caches)  (paged)

MoE, MLA, SSM, hybrid, enc-dec, VLM and CNN configs raise
``NotImplementedError``: they are later slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    embedding_apply,
    embedding_init,
    embedding_logits,
    gated_mlp_apply,
    gated_mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)


def check_supported(cfg) -> None:
    """Raise for the families this slice of the port does not run."""
    unported = {
        "MoE": cfg.moe_experts > 0,
        "MLA": cfg.uses_mla,
        "SSM/hybrid": cfg.ssm_state > 0 or cfg.attn_every > 0,
        "enc-dec": cfg.is_enc_dec,
        "VLM/audio frontend": cfg.frontend is not None,
        "CNN": cfg.family == "cnn",
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}; {', '.join(missing) or 'not dense'}) is "
            "not ported yet: ROADMAP.md queue 1, items 8-9")


# ---------------------------------------------------------------------------
# per-layer block and init
# ---------------------------------------------------------------------------


def block_init(gen, cfg, dtype, device):
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "mixer": attn.gqa_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "ffn": gated_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def block_apply(p, cfg, x, positions, cache=None):
    h, new_cache = attn.gqa_apply(p["mixer"], cfg,
                                  rmsnorm_apply(p["norm1"], x, cfg.norm_eps),
                                  positions, cache)
    x = x + h
    x = x + gated_mlp_apply(p["ffn"], rmsnorm_apply(p["norm2"], x, cfg.norm_eps))
    return x, new_cache


def init(cfg, *, generator: torch.Generator, dtype=torch.bfloat16, device="cuda"):
    """Random params from ``generator`` (on ``device``); the values differ
    from the reference's PRNG init, whose params ``convert`` carries over."""
    check_supported(cfg)
    params = {
        "embed": embedding_init(generator, cfg.vocab, cfg.d_model, dtype, device),
        "blocks": [block_init(generator, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, dtype, device)
    return params


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens):
    return embedding_apply(params["embed"], tokens)


def _head(params, cfg, x):
    x = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return embedding_logits(params["embed"], x)
    return dense_apply(params["lm_head"], x)


def _apply_stack(params, cfg, x, positions, caches):
    new_layers = []
    for li, p in enumerate(params["blocks"]):
        cache = caches["blocks"][li] if caches is not None else None
        x, nc = block_apply(p, cfg, x, positions, cache)
        new_layers.append(nc)
    return x, ({"blocks": new_layers} if caches is not None else None)


def _positions(start: int, tokens):
    b, s = tokens.shape
    return (start + torch.arange(s, device=tokens.device)).expand(b, s)


def forward(params, cfg, tokens):
    """Full causal forward.  tokens: (B, S) int64.  Returns (logits, aux)
    with aux the (zero) auxiliary loss of the dense family."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    x, _ = _apply_stack(params, cfg, x, _positions(0, tokens), None)
    return _head(params, cfg, x), torch.zeros((), device=x.device)


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda", *,
                cache_layout: str = "dense", page_size: int = 16,
                num_pages: int | None = None, kv_dtype: str | None = None):
    """Serving caches.  ``cache_layout="dense"`` (default): one
    (B, max_len, Hkv, D) K/V pair per layer.  ``"paged"``: the
    serve/kv_cache pool layout (shared pages + block tables +
    per-sequence lens) that ``decode_step`` and ``verify_step`` serve
    through the paged kernel — decode-only, engine-managed; ``kv_dtype``
    ("f32"/"bf16"/"int8") sets the pools' precision, and int8 pools carry
    per-page-per-head scales."""
    check_supported(cfg)
    if cache_layout == "paged":
        from repro_torch.serve.kv_cache import init_paged_caches

        return init_paged_caches(cfg, batch, max_len, dtype, page_size=page_size,
                                 num_pages=num_pages, kv_dtype=kv_dtype, device=device)
    if cache_layout != "dense":
        raise ValueError(f"cache_layout must be 'dense' or 'paged', got {cache_layout!r}")
    return {"blocks": [attn.gqa_cache_init(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.num_layers)]}


def _cache_len(cfg, caches) -> int:
    return caches["blocks"][0]["len"]


def prefill(params, cfg, tokens, caches, *, logit_index: int | None = None):
    """Run ``tokens`` (B, S) into the caches from their current length;
    returns the head at position ``logit_index`` (default: the last) —
    how a right-padded chunk returns its last real token's logits."""
    x = _embed(params, cfg, tokens)
    positions = _positions(_cache_len(cfg, caches), tokens)
    x, caches = _apply_stack(params, cfg, x, positions, caches)
    last = x[:, -1:] if logit_index is None else x[:, logit_index:logit_index + 1]
    return _head(params, cfg, last), caches


def decode_step(params, cfg, token, caches):
    """token: (B, 1).  One autoregressive step."""
    if "block_tables" in caches:
        return _paged_decode_step(params, cfg, token, caches)
    x = _embed(params, cfg, token)
    positions = _positions(_cache_len(cfg, caches), token)
    x, caches = _apply_stack(params, cfg, x, positions, caches)
    return _head(params, cfg, x), caches


def _paged_stack(params, cfg, tokens, caches):
    """Run ``tokens`` (B, S) at per-sequence positions ``lens .. lens+S-1``
    through every layer against the paged pools.  The write coordinates
    are computed once and shared by all layers; every pool is updated in
    place.  Returns (hidden, blocks)."""
    x = _embed(params, cfg, tokens)
    lens, bt = caches["lens"], caches["block_tables"]
    s = tokens.shape[1]
    positions = lens.long()[:, None] + torch.arange(s, device=lens.device)[None, :]
    coords = attn._paged_token_coords(
        {"block_tables": bt, "len": lens, "k_pages": caches["blocks"][0]["k_pages"]},
        "k_pages", s)
    new_blocks = []
    for p, pool in zip(params["blocks"], caches["blocks"]):
        cache_i = dict(pool, block_tables=bt, len=lens, coords=coords)
        x, nc = block_apply(p, cfg, x, positions, cache_i)
        new_blocks.append(nc)
    return x, new_blocks


def _paged_decode_step(params, cfg, token, caches):
    """One decode step against paged caches (serve/kv_cache layout).

    Positions are PER-SEQUENCE (``lens``, on the device), so one batched
    step serves requests at different fill levels — the continuous-
    batching contract.  Active slots' ``lens`` advance by one."""
    x, blocks = _paged_stack(params, cfg, token, caches)
    lens, bt = caches["lens"], caches["block_tables"]
    active = bt[:, 0] >= 0
    new_caches = {"blocks": blocks, "block_tables": bt,
                  "lens": torch.where(active, lens + 1, lens)}
    return _head(params, cfg, x), new_caches


def verify_step(params, cfg, tokens, caches):
    """Speculative-decoding verify: score ``tokens`` (B, S) — the slot's
    last emitted token followed by S-1 draft proposals — in ONE
    multi-token paged step, writing their K/V at ``lens .. lens+S-1``
    and returning all S head positions.  ``lens`` is returned UNCHANGED:
    the engine owns advancement, and rejected positions need no rollback
    (their rows sit at/after the advanced ``lens``, masked out of every
    later attend and overwritten once decoding reaches them)."""
    x, blocks = _paged_stack(params, cfg, tokens, caches)
    new_caches = {"blocks": blocks, "block_tables": caches["block_tables"],
                  "lens": caches["lens"]}
    return _head(params, cfg, x), new_caches
