"""Serving steps: chunked prefill, greedy decode, generate (PyTorch port
of ``repro.serve.step``, static shapes).

``make_prefill_step(cfg, chunk)`` runs prompts longer than ``chunk`` as
sequential chunk passes against the growing KV cache.  A ragged final
chunk is right-padded to ``chunk`` for attention caches: its logits are
read at the last real token (``logit_index``) and every cache ``len`` is
rewound past the pad, so the pad rows are masked out of every later
attend and overwritten as decode proceeds.  Recurrent or rolling-buffer
state cannot absorb pad rows (an SSM's recurrence would take them in, an
SWA buffer would push real keys out of its window), so SSM, hybrid and
SWA configs run the remainder as one exact-size pass instead.  An
enc-dec config encodes its frames once; above one chunk its decoder
prefills over the chunk grid against the cross K/V and the LM head runs
once, after the final chunk.

``n_tokens`` (a host int) is the DYNAMIC-length contract the serving
engine uses: ``tokens`` arrives right-padded and only its first
``n_tokens`` are real.  The logits are read at the real last token and
``len`` rewinds to the real count, so a call with the next piece resumes
exactly where the last one stopped.  The reference traces ``n_tokens``;
here it is a host int, as the dense ``len``.  It takes neither an
enc-dec config nor ``embeds``, as the reference's assert.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor as tp
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import embedding_apply


def _unpad_cache_len(caches, n_pad: int):
    """Rewind every layer's ``len`` past the right-pad of a ragged final
    prefill chunk (a decoder-only or enc-dec decoder's attention caches)."""
    for c in caches["blocks"]:
        c["len"] -= n_pad
    return caches


def make_prefill_step(cfg, chunk: int = 4096, *, return_logits: bool = False):
    """Returns ``prefill_step(params, tokens, caches, embeds=None,
    frames=None, n_tokens=None)`` -> ``(next_tok (B,), caches)``, or
    ``(next_tok, logits (B, 1, V), caches)`` with ``return_logits``; an
    enc-dec config takes ``frames`` and appends the cross K/V:
    ``(next_tok, [logits,] caches, kv)``.  A VLM's ``embeds`` ride on the
    first chunk only.  The chunk is exposed as ``prefill_step.chunk``."""
    if chunk < 1:
        raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
    transformer.check_supported(cfg)
    pad_ok = not (cfg.ssm_state or cfg.sliding_window)

    def run_chunks(tokens, caches, apply_chunk):
        """Drive ``apply_chunk(piece, caches, logit_index, i)`` over the
        (possibly right-padded) chunk grid; returns (last out, caches)."""
        s = tokens.shape[1]
        full, rem = divmod(s, chunk)
        toks, n_pad = tokens, 0
        if rem and pad_ok:
            n_pad = chunk - rem
            toks = F.pad(tokens, (0, n_pad))
        out = None
        n_chunks = toks.shape[1] // chunk
        for i in range(n_chunks):
            piece = toks[:, i * chunk:(i + 1) * chunk]
            li = rem - 1 if (n_pad and i == n_chunks - 1) else None
            out, caches = apply_chunk(piece, caches, li, i)
        if rem and not pad_ok:
            out, caches = apply_chunk(tokens[:, full * chunk:], caches, None, n_chunks)
        if n_pad:
            caches = _unpad_cache_len(caches, n_pad)
        return out, caches

    def dynamic_prefill(params, tokens, caches, n: int):
        """Right-padded tokens with ``n`` real: every chunk reads its head
        at the clamped real-last position, the chunk that holds token
        ``n - 1`` gives the logits, and ``len`` rewinds past the pad."""
        if not pad_ok or cfg.is_enc_dec:
            raise ValueError(
                "dynamic-length prefill needs a pad-tolerant decoder-only attention "
                "cache; SSM, hybrid, SWA and enc-dec configs take the exact-shape "
                "call (no n_tokens)")
        s = tokens.shape[1]
        if not 1 <= n <= s:
            raise ValueError(f"n_tokens={n} outside [1, {s}]")
        if s <= chunk:
            logits, caches = transformer.prefill(params, cfg, tokens, caches,
                                                 logit_index=n - 1)
        else:
            if s % chunk:
                raise ValueError(f"a padded prompt of {s} tokens is not a multiple "
                                 f"of the chunk {chunk}")
            logits = None
            for i in range(s // chunk):
                piece = tokens[:, i * chunk:(i + 1) * chunk]
                li = min(max(n - 1 - i * chunk, 0), chunk - 1)
                lg, caches = transformer.prefill(params, cfg, piece, caches,
                                                 logit_index=li)
                if (n - 1) // chunk == i:
                    logits = lg
        return logits, _unpad_cache_len(caches, s - n)

    def encdec_prefill(params, tokens, caches, frames):
        if tokens.shape[1] <= chunk:
            return encdec.prefill(params, cfg, frames, tokens, caches)
        kv = encdec.cross_kv(params, cfg, encdec.encode(params, cfg, frames))
        last_h, caches = run_chunks(
            tokens, caches,
            lambda piece, c, li, i: _encdec_chunk(params, cfg, piece, c, kv, logit_index=li))
        # the LM head only matters after the final chunk
        return encdec._head(params, cfg, last_h), caches, kv

    def prefill_step(params, tokens, caches, embeds=None, frames=None,
                     n_tokens: int | None = None):
        kv = None
        if n_tokens is not None:
            if embeds is not None:
                raise ValueError("dynamic-length prefill takes no embeds")
            logits, caches = dynamic_prefill(params, tokens, caches, int(n_tokens))
        elif cfg.is_enc_dec:
            logits, caches, kv = encdec_prefill(params, tokens, caches, frames)
        elif tokens.shape[1] <= chunk:
            logits, caches = transformer.prefill(params, cfg, tokens, caches, embeds)
        else:
            logits, caches = run_chunks(
                tokens, caches,
                lambda piece, c, li, i: transformer.prefill(
                    params, cfg, piece, c, embeds if i == 0 else None, logit_index=li))
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        out = (next_tok, logits, caches) if return_logits else (next_tok, caches)
        return out if kv is None else (*out, kv)

    prefill_step.chunk = chunk
    return prefill_step


def _encdec_chunk(params, cfg, piece, caches, kv, *, logit_index: int | None = None):
    """One decoder prefill chunk against precomputed cross K/V, from the
    cache's ``len``.  Returns (hidden state at the chunk's last [real]
    position, caches); the head runs once, after the final chunk."""
    x = embedding_apply(params["embed"], piece, cfg.vocab)
    positions = transformer._positions(caches["blocks"][0]["len"], x)
    x, caches = encdec._dec_stack(params, cfg, x, positions, kv, caches)
    last = x[:, -1:] if logit_index is None else x[:, logit_index:logit_index + 1]
    return last, caches


def make_verify_step(cfg):
    """Speculative verify: ``(params, tokens (B, S), caches)`` ->
    ``(greedy (B, S), caches)``.  Column j is the target model's greedy
    token AFTER seeing ``tokens[:, :j+1]``.  Paged caches only (the
    engine's layout)."""
    transformer.check_supported(cfg)

    def verify(params, tokens, caches):
        logits, caches = transformer.verify_step(params, cfg, tokens, caches)
        return torch.argmax(logits, dim=-1), caches

    return verify


def make_serve_step(cfg, *, return_logits: bool = False):
    """One decode step: ``(params, token (B, 1), caches)`` ->
    ``(token (B, 1), caches)``, or ``(token, logits (B, 1, V), caches)``
    with ``return_logits``.  An enc-dec config's step also takes the cross
    K/V: ``(params, token, caches, kv)``."""
    transformer.check_supported(cfg)

    def serve_step(params, token, caches, kv=None):
        if cfg.is_enc_dec:
            logits, caches = encdec.decode_step(params, cfg, token, caches, kv)
        else:
            logits, caches = transformer.decode_step(params, cfg, token, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if return_logits:
            return tok, logits, caches
        return tok, caches

    return serve_step


@torch.inference_mode()
def generate(params, cfg, prompt, max_new: int, max_len: int,
             dtype=torch.bfloat16, chunk: int = 4096, frames=None, embeds=None, model=None):
    """Greedy generation: prompt (B, S) -> (B, max_new) tokens; an enc-dec
    config takes the encoder's ``frames`` (B, T, D), a VLM the ``embeds``
    (B, E, D) prepended to the prompt.  The caches live on the prompt's
    device.  With ``model`` (a ``collective.ModelGroup``: one process per
    mesh position, the params this position's 'model' slices) it runs
    tensor parallel under ``dist.tensor.parallel``, the caches and cross
    K/V at this rank's heads; every rank reads the same gathered logits
    and takes the same greedy token."""
    if model is None:
        return _generate(params, cfg, prompt, max_new, max_len, dtype, chunk, frames, embeds)
    with tp.parallel(model=model):
        return _generate(params, cfg, prompt, max_new, max_len, dtype, chunk, frames, embeds)


def _generate(params, cfg, prompt, max_new, max_len, dtype, chunk, frames, embeds):
    b = prompt.shape[0]
    if cfg.is_enc_dec:
        caches = encdec.init_caches(cfg, b, max_len, dtype, prompt.device,
                                    kv_heads=encdec.cache_kv_heads(params, cfg))
    else:
        caches = transformer.init_caches(
            cfg, b, max_len, dtype, prompt.device, kv_heads=transformer.cache_kv_heads(params, cfg),
            ssm_heads=transformer.cache_ssm_heads(cfg, tp.model_group()))
    prefill = make_prefill_step(cfg, chunk)
    step = make_serve_step(cfg)
    kv = None
    if cfg.is_enc_dec:
        tok, caches, kv = prefill(params, prompt, caches, frames=frames)
    else:
        tok, caches = prefill(params, prompt, caches, embeds=embeds)
    out = [tok[:, None]]
    for _ in range(max_new - 1):
        tok, caches = step(params, out[-1], caches, kv)
        out.append(tok)
    return torch.cat(out, dim=1)
