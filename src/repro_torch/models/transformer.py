"""Decoder LM, dense and MoE families (PyTorch port of
``repro.models.transformer``).

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

The mixer is GQA (with q/k/v biases, qk-norm and SWA as the config
says) or MLA; the FFN a gated MLP or an MoE layer, whose auxiliary
load-balancing loss ``forward`` sums over the layers.  SSM, hybrid,
enc-dec, VLM and CNN configs raise ``NotImplementedError``: they are a
later slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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
        "SSM/hybrid": cfg.ssm_state > 0 or cfg.attn_every > 0,
        "enc-dec": cfg.is_enc_dec,
        "VLM/audio frontend": cfg.frontend is not None,
        "CNN": cfg.family == "cnn",
    }
    missing = [name for name, hit in unported.items() if hit]
    if missing or cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}; {', '.join(missing) or cfg.family}) is "
            "not ported yet: ROADMAP.md queue 1, item 9")


# ---------------------------------------------------------------------------
# per-layer block and init
# ---------------------------------------------------------------------------


def _mixer_init(gen, cfg, dtype, device):
    if cfg.uses_mla:
        return attn.mla_init(gen, cfg, dtype, device)
    return attn.gqa_init(gen, cfg, dtype, device)


def _mixer_apply(p, cfg, x, positions, cache):
    if cfg.uses_mla:
        return attn.mla_apply(p, cfg, x, positions, cache)
    return attn.gqa_apply(p, cfg, x, positions, cache)


def _ffn_init(gen, cfg, dtype, device):
    if cfg.moe_experts:
        return moe_mod.moe_init(gen, cfg, dtype, device)
    return gated_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)


def _ffn_apply(p, cfg, x, dropless: bool = False, cap: int | None = None):
    """(y, aux), aux None for a gated MLP.  MoE serving capacity
    (``dropless``, any call with a cache): exactly dropless (cap = tokens)
    up to 4096 tokens, above that a 2x-balanced bound ``ceil(2 n k / E)``;
    an explicit ``cap`` overrides both, clamped to the call's token count."""
    if cfg.moe_experts:
        n = x.shape[0] * x.shape[1]
        if cap is not None:
            cap = min(cap, n)
        elif dropless:
            generous = -(-2 * n * cfg.moe_top_k // cfg.moe_experts)
            cap = n if n <= 4096 else min(n, generous)
        return moe_mod.moe_apply(p, cfg, x, capacity=cap)
    return gated_mlp_apply(p, x), None


def block_init(gen, cfg, dtype, device):
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "mixer": _mixer_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "ffn": _ffn_init(gen, cfg, dtype, device),
    }


def block_apply(p, cfg, x, positions, cache=None, moe_cap: int | None = None):
    """Returns (x, new_cache, aux); aux is None without an MoE layer."""
    h, new_cache = _mixer_apply(p["mixer"], cfg,
                                rmsnorm_apply(p["norm1"], x, cfg.norm_eps),
                                positions, cache)
    x = x + h
    h, aux = _ffn_apply(p["ffn"], cfg, rmsnorm_apply(p["norm2"], x, cfg.norm_eps),
                        dropless=cache is not None, cap=moe_cap)
    return x + h, new_cache, aux


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
    """Returns (x, new caches, aux summed over the layers: a zero for the
    dense family)."""
    new_layers = []
    aux = torch.zeros((), device=x.device)
    for li, p in enumerate(params["blocks"]):
        cache = caches["blocks"][li] if caches is not None else None
        x, nc, a = block_apply(p, cfg, x, positions, cache)
        if a is not None:
            aux = aux + a
        new_layers.append(nc)
    return x, ({"blocks": new_layers} if caches is not None else None), aux


def _positions(start: int, tokens):
    b, s = tokens.shape
    return (start + torch.arange(s, device=tokens.device)).expand(b, s)


def forward(params, cfg, tokens):
    """Full causal forward.  tokens: (B, S) int64.  Returns (logits, aux)
    with aux the MoE load-balancing loss summed over the layers (zero for
    the dense family)."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    x, _, aux = _apply_stack(params, cfg, x, _positions(0, tokens), None)
    return _head(params, cfg, x), aux


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda", *,
                cache_layout: str = "dense", page_size: int = 16,
                num_pages: int | None = None, kv_dtype: str | None = None):
    """Serving caches.  ``cache_layout="dense"`` (default): one
    (B, max_len, Hkv, D) K/V pair per layer (an SWA config's holds
    ``min(max_len, window)`` rows and rolls; MLA's is one (B, max_len,
    r + dr) latent buffer).  ``"paged"``: the
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
    one = attn.mla_cache_init if cfg.uses_mla else attn.gqa_cache_init
    return {"blocks": [one(cfg, batch, max_len, dtype, device)
                       for _ in range(cfg.num_layers)]}


def _cache_len(cfg, caches) -> int:
    return caches["blocks"][0]["len"]


def prefill(params, cfg, tokens, caches, *, logit_index: int | None = None):
    """Run ``tokens`` (B, S) into the caches from their current length;
    returns the head at position ``logit_index`` (default: the last) —
    how a right-padded chunk returns its last real token's logits."""
    x = _embed(params, cfg, tokens)
    positions = _positions(_cache_len(cfg, caches), tokens)
    x, caches, _ = _apply_stack(params, cfg, x, positions, caches)
    last = x[:, -1:] if logit_index is None else x[:, logit_index:logit_index + 1]
    return _head(params, cfg, last), caches


def decode_step(params, cfg, token, caches):
    """token: (B, 1).  One autoregressive step."""
    if "block_tables" in caches:
        return _paged_decode_step(params, cfg, token, caches)
    x = _embed(params, cfg, token)
    positions = _positions(_cache_len(cfg, caches), token)
    x, caches, _ = _apply_stack(params, cfg, x, positions, caches)
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
    key = "kv_pages" if cfg.uses_mla else "k_pages"
    coords = attn._paged_token_coords(
        {"block_tables": bt, "len": lens, key: caches["blocks"][0][key]}, key, s)
    new_blocks = []
    for p, pool in zip(params["blocks"], caches["blocks"]):
        cache_i = dict(pool, block_tables=bt, len=lens, coords=coords)
        x, nc, _ = block_apply(p, cfg, x, positions, cache_i)
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
