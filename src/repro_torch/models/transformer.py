"""Decoder LM: dense, MoE, SSM, hybrid and VLM backbones (PyTorch port of
``repro.models.transformer``).

Params are ``{"embed": {"table"}, "blocks": [per-layer dict, ...],
"final_norm": {"scale"}[, "lm_head"][, "shared_attn"]}``: the
reference's stacked layer axis becomes a list, and layers run as a
Python loop.  On one device the reference's sharding hints have nothing
to do and are gone.

  init(cfg, *, generator, dtype, device)        -> params
  forward(params, cfg, tokens, embeds=None, *, remat=False)
                                                -> (logits, aux_loss)
  forward_hidden(params, cfg, tokens, embeds=None, *, remat=False)
                                                -> (final-normed hidden, aux)
  head_logits(params, cfg, hidden)              -> logits
  init_caches(cfg, batch, max_len, dtype, device[, cache_layout="paged"])
                                                -> caches
  prefill(params, cfg, tokens, caches, embeds=None) -> (last_logits, caches)
  decode_step(params, cfg, token, caches)       -> (logits, caches)
  verify_step(params, cfg, tokens, caches)      -> (logits, caches)  (paged)

The mixer is GQA (with q/k/v biases, qk-norm and SWA as the config
says), MLA or a Mamba2 block (SSM and hybrid configs); the FFN a gated
MLP or an MoE layer, whose auxiliary load-balancing loss ``forward``
sums over the layers, and none for mamba2 (``d_ff == 0``) or a hybrid's
backbone blocks.  A hybrid (zamba2) runs groups of ``attn_every`` Mamba2
layers, each followed by the one ``shared_attn`` block (GQA + its MLP):
one set of weights, one KV cache per group.  A VLM's ``embeds`` (the
stubbed frontend's patch embeddings) are prepended to the token
embeddings.  The enc-dec model lives in ``encdec.py`` and ResNet-18 in
``resnet.py``; a CNN config raises ``NotImplementedError`` here.

Under ``dist.tensor``'s ambient model group (one process per mesh
position) every family runs tensor parallel (the MoE family also expert
parallel): the embedding vocab-parallel, an untied ``lm_head`` split over
the vocabulary, every head gathering its logits whole, so each rank of a
model group reads the same logits; Mamba2 blocks on this rank's heads
(``models.ssm``), the hybrid's shared block and MLP on its heads and
columns, a VLM's ``embeds`` prepended to the summed lookup.  The caches
hold this rank's KV heads (:func:`cache_kv_heads`) and SSM state heads
(:func:`cache_ssm_heads`).

``remat=True`` (training) recomputes each block in the backward pass
(``torch.utils.checkpoint`` around every block, the hybrid's shared
block included), as the reference wraps its scanned blocks in
``jax.checkpoint``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import tensor as tp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    width,
    embedding_apply,
    embedding_init,
    embedding_logits,
    gated_mlp_apply,
    gated_mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)


def check_supported(cfg) -> None:
    """Raise for a CNN config, whose model is ``models/resnet``."""
    if cfg.family == "cnn":
        raise NotImplementedError(
            f"{cfg.name} is a CNN: its model is repro_torch.models.resnet")


# ---------------------------------------------------------------------------
# per-layer block and init
# ---------------------------------------------------------------------------


def _mixer_is_ssm(cfg):
    # pure SSM (mamba2) and hybrid (zamba2) backbone blocks are Mamba2; the
    # hybrid's attention lives in the shared block only
    return cfg.ssm_state > 0


def _mixer_init(gen, cfg, dtype, device):
    if _mixer_is_ssm(cfg):
        return ssm_mod.mamba2_init(gen, cfg, dtype, device)
    if cfg.uses_mla:
        return attn.mla_init(gen, cfg, dtype, device)
    return attn.gqa_init(gen, cfg, dtype, device)


def _mixer_apply(p, cfg, x, positions, cache):
    if _mixer_is_ssm(cfg):
        return ssm_mod.mamba2_apply(p, cfg, x, cache)
    if cfg.uses_mla:
        return attn.mla_apply(p, cfg, x, positions, cache)
    return attn.gqa_apply(p, cfg, x, positions, cache)


def _ffn_init(gen, cfg, dtype, device):
    if cfg.moe_experts:
        return moe_mod.moe_init(gen, cfg, dtype, device)
    if cfg.d_ff:
        return gated_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return None


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
    return gated_mlp_apply(p, x, cfg.d_ff), None


def block_init(gen, cfg, dtype, device):
    p = {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "mixer": _mixer_init(gen, cfg, dtype, device),
    }
    # a hybrid's Mamba2 backbone blocks carry no FFN: the MLP lives in the
    # shared attention block
    ffn = None if cfg.attn_every else _ffn_init(gen, cfg, dtype, device)
    if ffn is not None:
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["ffn"] = ffn
    return p


def block_apply(p, cfg, x, positions, cache=None, moe_cap: int | None = None):
    """Returns (x, new_cache, aux); aux is None without an MoE layer."""
    h, new_cache = _mixer_apply(p["mixer"], cfg,
                                rmsnorm_apply(p["norm1"], x, cfg.norm_eps),
                                positions, cache)
    x = x + h
    aux = None
    if "ffn" in p:
        h, aux = _ffn_apply(p["ffn"], cfg, rmsnorm_apply(p["norm2"], x, cfg.norm_eps),
                            dropless=cache is not None, cap=moe_cap)
        x = x + h
    return x, new_cache, aux


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
    if cfg.attn_every:  # hybrid: one shared attention (+ MLP) block
        params["shared_attn"] = {
            "norm": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn.gqa_init(generator, cfg, dtype, device),
            "mlp_norm": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": gated_mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, device),
        }
    return params


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------


def _embed(params, cfg, tokens, embeds=None):
    x = embedding_apply(params["embed"], tokens, cfg.vocab)
    if embeds is not None:
        # the modality frontend's stub: precomputed patch embeddings are
        # prepended to the token embeddings (the VLM backbone contract)
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def _head(params, cfg, x):
    return head_logits(params, cfg, rmsnorm_apply(params["final_norm"], x, cfg.norm_eps))


def _hybrid_groups(cfg) -> int:
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"num_layers {cfg.num_layers} % attn_every {cfg.attn_every} != 0")
    return cfg.num_layers // cfg.attn_every


def _shared_block(sa, cfg, x, positions, cache):
    """The hybrid's shared attention block and its MLP: (x, new cache)."""
    h, na = attn.gqa_apply(sa["attn"], cfg, rmsnorm_apply(sa["norm"], x, cfg.norm_eps),
                           positions, cache)
    x = x + h
    x = x + gated_mlp_apply(sa["mlp"], rmsnorm_apply(sa["mlp_norm"], x, cfg.norm_eps), cfg.d_ff)
    return x, na


def _remat(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False)


def _apply_stack(params, cfg, x, positions, caches, *, remat: bool = False):
    """Returns (x, new caches, aux summed over the layers: a zero without
    MoE).  A hybrid runs each group of ``attn_every`` Mamba2 layers, then
    the shared attention block and its MLP against the group's KV cache.
    ``remat`` (no caches) recomputes every block in the backward."""
    new_layers, new_attn = [], []
    aux = torch.zeros((), device=x.device)
    per = cfg.attn_every or cfg.num_layers
    run = _remat if remat and caches is None else (lambda fn, *a: fn(*a))
    for gi in range(cfg.num_layers // per):
        for li in range(gi * per, (gi + 1) * per):
            cache = caches["blocks"][li] if caches is not None else None
            x, nc, a = run(block_apply, params["blocks"][li], cfg, x, positions, cache)
            if a is not None:
                aux = aux + a
            new_layers.append(nc)
        if cfg.attn_every:
            acache = caches["shared_attn"][gi] if caches is not None else None
            x, na = run(_shared_block, params["shared_attn"], cfg, x, positions, acache)
            new_attn.append(na)
    if caches is None:
        return x, None, aux
    new_caches = {"blocks": new_layers}
    if cfg.attn_every:
        new_caches["shared_attn"] = new_attn
    return x, new_caches, aux


def _positions(start: int, x):
    b, s = x.shape[:2]
    return (start + torch.arange(s, device=x.device)).expand(b, s)


def forward(params, cfg, tokens, embeds=None, *, remat: bool = False):
    """Full causal forward.  tokens: (B, S) int64; ``embeds`` (B, E, D)
    prepended (VLM).  Returns (logits over E + S positions, aux) with aux
    the MoE load-balancing loss summed over the layers (zero without MoE)."""
    x, aux = forward_hidden(params, cfg, tokens, embeds, remat=remat)
    return head_logits(params, cfg, x), aux


def forward_hidden(params, cfg, tokens, embeds=None, *, remat: bool = False):
    """Like :func:`forward` but stops at the final-normed hidden states —
    used with the chunked fused CE so (B, S, vocab) logits never
    materialize."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens, embeds)
    x, _, aux = _apply_stack(params, cfg, x, _positions(0, x), None, remat=remat)
    return rmsnorm_apply(params["final_norm"], x, cfg.norm_eps), aux


def head_logits(params, cfg, x):
    """LM head only (no final norm) — pairs with :func:`forward_hidden`.
    A head split over the vocabulary gathers the whole logits."""
    if cfg.tie_embeddings:
        return embedding_logits(params["embed"], x, cfg.vocab)
    return lm_head_logits(params["lm_head"], cfg, x)


def lm_head_logits(head, cfg, x):
    """An untied head: split over the vocabulary, this rank's slice of the
    logits gathered whole."""
    if "w" in head and tp.split(width(head), cfg.vocab):
        return tp.gather(dense_apply(head, tp.copy(x)), -1)
    return dense_apply(head, x)


def cache_kv_heads(params, cfg) -> int | None:
    """The KV heads a GQA config's dense caches hold on this rank (its
    share under tensor parallelism; a hybrid's shared block's), None for
    the others."""
    if cfg.attn_every:
        return attn.cache_kv_heads(params["shared_attn"]["attn"], cfg)
    if cfg.uses_mla or _mixer_is_ssm(cfg) or not cfg.num_heads:
        return None
    return attn.cache_kv_heads(params["blocks"][0]["mixer"], cfg)


def cache_ssm_heads(cfg, model=None) -> int | None:
    """The SSM state heads an SSM or hybrid config's caches hold on a rank
    of ``model`` (a ``collective.ModelGroup``; ``cache_specs`` splits them
    over 'model'), None without a group or an SSM."""
    if model is None or not _mixer_is_ssm(cfg):
        return None
    return ssm_mod.cache_heads(cfg, model.size)


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda", *,
                cache_layout: str = "dense", page_size: int = 16,
                num_pages: int | None = None, kv_dtype: str | None = None,
                kv_heads: int | None = None, ssm_heads: int | None = None):
    """Serving caches.  ``cache_layout="dense"`` (default): one
    (B, max_len, Hkv, D) K/V pair per layer (an SWA config's holds
    ``min(max_len, window)`` rows and rolls; MLA's is one (B, max_len,
    r + dr) latent buffer).  ``"paged"``: the
    serve/kv_cache pool layout (shared pages + block tables +
    per-sequence lens) that ``decode_step`` and ``verify_step`` serve
    through the paged kernel — decode-only, engine-managed; ``kv_dtype``
    ("f32"/"bf16"/"int8") sets the pools' precision, and int8 pools carry
    per-page-per-head scales.  ``kv_heads``: the heads a GQA layer's dense
    cache holds (this rank's share under tensor parallelism,
    :func:`cache_kv_heads`; a hybrid's shared block's), ``ssm_heads`` the
    SSM state heads (:func:`cache_ssm_heads`)."""
    check_supported(cfg)
    if cache_layout == "paged":
        from repro_torch.serve.kv_cache import init_paged_caches

        return init_paged_caches(cfg, batch, max_len, dtype, page_size=page_size,
                                 num_pages=num_pages, kv_dtype=kv_dtype, device=device)
    if cache_layout != "dense":
        raise ValueError(f"cache_layout must be 'dense' or 'paged', got {cache_layout!r}")
    if _mixer_is_ssm(cfg):
        # O(1) recurrent state: no max_len
        blocks = [ssm_mod.mamba2_cache_init(cfg, batch, dtype, device, ssm_heads)
                  for _ in range(cfg.num_layers)]
    else:
        one = attn.mla_cache_init if cfg.uses_mla else attn.gqa_cache_init
        kw = {} if cfg.uses_mla else {"kv_heads": kv_heads}
        blocks = [one(cfg, batch, max_len, dtype, device, **kw) for _ in range(cfg.num_layers)]
    caches = {"blocks": blocks}
    if cfg.attn_every:
        caches["shared_attn"] = [attn.gqa_cache_init(cfg, batch, max_len, dtype, device,
                                                     kv_heads=kv_heads)
                                 for _ in range(_hybrid_groups(cfg))]
    return caches


def _cache_len(cfg, caches) -> int:
    if cfg.attn_every:  # hybrid: the Mamba2 caches carry no position
        return caches["shared_attn"][0]["len"]
    if cfg.is_attention_free:  # pure SSM: positions are unused downstream
        return 0
    return caches["blocks"][0]["len"]


def prefill(params, cfg, tokens, caches, embeds=None, *, logit_index: int | None = None):
    """Run ``tokens`` (B, S), after ``embeds`` (B, E, D) where given, into
    the caches from their current length; returns the head at position
    ``logit_index`` of the E + S rows (default: the last) — how a
    right-padded chunk returns its last real token's logits."""
    x = _embed(params, cfg, tokens, embeds)
    positions = _positions(_cache_len(cfg, caches), x)
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
