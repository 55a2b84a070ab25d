"""Encoder-decoder transformer backbone, seamless-m4t-large-v2 (PyTorch port
of ``repro.models.encdec``).

The modality frontend is a stub, as in the reference: ``encode`` takes
precomputed frame embeddings (B, T_enc, D) and runs the transformer
encoder (bidirectional self-attention: flash from 512 frames).  The
decoder is a causal LM with cross-attention, whose K/V over the encoder
output are computed once per request (``cross_kv``, the enc-dec
'cache').

Params: ``{"embed", "encoder": [per-layer dict, ...], "enc_norm",
"decoder": [per-layer dict, ...], "final_norm", "lm_head"}``, the
reference's stacked layer axes as lists.  Caches: ``{"blocks":
[per-layer GQA dense cache, ...]}`` (the reference stacks one dict);
cross K/V: a list of per-layer ``{"k", "v"}`` (B, T, H, D).

  init(cfg, *, generator, dtype, device)        -> params
  forward(params, cfg, frames, tokens, *, remat=False) -> (logits, aux = 0)
  forward_hidden(params, cfg, frames, tokens, *, remat=False)
                                                -> (final-normed hidden, aux = 0)
  head_logits(params, cfg, hidden)              -> logits
  init_caches(cfg, batch, max_len, dtype, device) -> caches
  prefill(params, cfg, frames, tokens, caches)  -> (last_logits, caches, kv)
  decode_step(params, cfg, token, caches, kv)   -> (logits, caches)

``remat=True`` (training) recomputes every encoder and decoder block in
the backward pass, as the reference's ``jax.checkpoint`` does.

Under ``dist.tensor``'s ambient model group (one process per mesh
position) the encoder's and decoder's attention, cross-attention and MLPs
run on this rank's heads and columns (``models.attention``,
``models.layers``), the embedding vocab-parallel and the untied
``lm_head`` split over the vocabulary and gathered
(``transformer.lm_head_logits``); a vocabulary the model size does not
divide (seamless's 256,206 at 4) leaves both whole, and they compute
whole.  The caches and cross K/V hold this rank's heads
(:func:`cache_kv_heads`).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    dense_init,
    embedding_apply,
    embedding_init,
    gated_mlp_apply,
    gated_mlp_init,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.models.transformer import _positions, _remat, lm_head_logits


def _enc_block_init(gen, cfg, dtype, device):
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "attn": attn.gqa_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": gated_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def _dec_block_init(gen, cfg, dtype, device):
    return {
        "norm1": rmsnorm_init(cfg.d_model, dtype, device),
        "self_attn": attn.gqa_init(gen, cfg, dtype, device),
        "norm_x": rmsnorm_init(cfg.d_model, dtype, device),
        "cross_attn": attn.cross_attn_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(cfg.d_model, dtype, device),
        "mlp": gated_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init(cfg, *, generator: torch.Generator, dtype=torch.bfloat16, device="cuda"):
    """Random params from ``generator`` (on ``device``); the values differ
    from the reference's PRNG init, whose params ``convert`` carries over."""
    return {
        "embed": embedding_init(generator, cfg.vocab, cfg.d_model, dtype, device),
        "encoder": [_enc_block_init(generator, cfg, dtype, device)
                    for _ in range(cfg.encoder_layers)],
        "enc_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "decoder": [_dec_block_init(generator, cfg, dtype, device)
                    for _ in range(cfg.num_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab, dtype, device),
    }


def _enc_block(p, cfg, x, positions):
    h, _ = attn.gqa_apply(p["attn"], cfg, rmsnorm_apply(p["norm1"], x, cfg.norm_eps),
                          positions, None, bidirectional=True)
    x = x + h
    return x + gated_mlp_apply(p["mlp"], rmsnorm_apply(p["norm2"], x, cfg.norm_eps), cfg.d_ff)


def encode(params, cfg, frame_embeds, *, remat: bool = False):
    """frame_embeds: (B, T_enc, D) from the (stubbed) frontend."""
    x = frame_embeds
    positions = _positions(0, x)
    for p in params["encoder"]:
        x = _remat(_enc_block, p, cfg, x, positions) if remat else _enc_block(p, cfg, x, positions)
    return rmsnorm_apply(params["enc_norm"], x, cfg.norm_eps)


def cross_kv(params, cfg, enc_out):
    """Every decoder layer's cross-attention K/V over ``enc_out``."""
    return [attn.cross_attn_kv(p["cross_attn"], cfg, enc_out) for p in params["decoder"]]


def _dec_block(p, cfg, x, positions, layer_kv, cache):
    h, nc = attn.gqa_apply(p["self_attn"], cfg,
                           rmsnorm_apply(p["norm1"], x, cfg.norm_eps), positions, cache)
    x = x + h
    x = x + attn.cross_attn_apply(p["cross_attn"], cfg,
                                  rmsnorm_apply(p["norm_x"], x, cfg.norm_eps), layer_kv)
    return x + gated_mlp_apply(p["mlp"], rmsnorm_apply(p["norm2"], x, cfg.norm_eps),
                               cfg.d_ff), nc


def _dec_stack(params, cfg, x, positions, kv, caches, *, remat: bool = False):
    """The decoder stack; the self-attention caches update in place.
    ``remat`` (no caches) recomputes every block in the backward."""
    new_layers = []
    for li, p in enumerate(params["decoder"]):
        cache = caches["blocks"][li] if caches is not None else None
        if remat and caches is None:
            x, nc = _remat(_dec_block, p, cfg, x, positions, kv[li], None)
        else:
            x, nc = _dec_block(p, cfg, x, positions, kv[li], cache)
        new_layers.append(nc)
    return x, ({"blocks": new_layers} if caches is not None else None)


def _head(params, cfg, x):
    return head_logits(params, cfg, rmsnorm_apply(params["final_norm"], x, cfg.norm_eps))


def forward(params, cfg, frame_embeds, tokens, *, remat: bool = False):
    """Encoder + teacher-forced decoder -> (logits (B, S, V), aux = 0)."""
    x, aux = forward_hidden(params, cfg, frame_embeds, tokens, remat=remat)
    return head_logits(params, cfg, x), aux


def forward_hidden(params, cfg, frame_embeds, tokens, *, remat: bool = False):
    """Final-normed decoder states (the chunked fused CE's entry point)
    and aux = 0."""
    kv = cross_kv(params, cfg, encode(params, cfg, frame_embeds, remat=remat))
    x = embedding_apply(params["embed"], tokens, cfg.vocab)
    x, _ = _dec_stack(params, cfg, x, _positions(0, x), kv, None, remat=remat)
    return (rmsnorm_apply(params["final_norm"], x, cfg.norm_eps),
            torch.zeros((), device=x.device))


def head_logits(params, cfg, x):
    """LM head only (no final norm) — pairs with :func:`forward_hidden`."""
    return lm_head_logits(params["lm_head"], cfg, x)


def cache_kv_heads(params, cfg) -> int:
    """The KV heads the decoder's self-attention caches hold on this rank."""
    return attn.cache_kv_heads(params["decoder"][0]["self_attn"], cfg)


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
                kv_heads: int | None = None):
    """``kv_heads``: this rank's share under tensor parallelism
    (:func:`cache_kv_heads`); the config's by default."""
    return {"blocks": [attn.gqa_cache_init(cfg, batch, max_len, dtype, device,
                                           kv_heads=kv_heads)
                       for _ in range(cfg.num_layers)]}


def prefill(params, cfg, frame_embeds, tokens, caches):
    """Encode once and run the prompt through the decoder from position 0
    (as the reference; the chunked path in ``serve.step`` resumes from the
    cache's ``len``).  Returns (last_logits, caches, kv)."""
    kv = cross_kv(params, cfg, encode(params, cfg, frame_embeds))
    x = embedding_apply(params["embed"], tokens, cfg.vocab)
    x, caches = _dec_stack(params, cfg, x, _positions(0, x), kv, caches)
    return _head(params, cfg, x[:, -1:]), caches, kv


def decode_step(params, cfg, token, caches, kv):
    x = embedding_apply(params["embed"], token, cfg.vocab)
    positions = _positions(caches["blocks"][0]["len"], x)
    x, caches = _dec_stack(params, cfg, x, positions, kv, caches)
    return _head(params, cfg, x), caches
