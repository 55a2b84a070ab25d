"""Serving steps: chunked prefill, greedy decode, generate (PyTorch port
of ``repro.serve.step``, decoder-only, static shapes).

``make_prefill_step(cfg, chunk)`` runs prompts longer than ``chunk`` as
sequential chunk passes against the growing KV cache.  A ragged final
chunk is right-padded to ``chunk`` for attention caches: its logits are
read at the last real token (``logit_index``) and every cache ``len`` is
rewound past the pad, so the pad rows are masked out of every later
attend and overwritten as decode proceeds.  An SWA rolling buffer cannot
absorb pad rows (they would push real keys out of the window), so an SWA
config runs the remainder as one exact-size pass instead.

``n_tokens`` (a host int) is the DYNAMIC-length contract the serving
engine uses: ``tokens`` arrives right-padded and only its first
``n_tokens`` are real.  The logits are read at the real last token and
``len`` rewinds to the real count, so a call with the next piece resumes
exactly where the last one stopped.  The reference traces ``n_tokens``;
here it is a host int, as the dense ``len``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import transformer


def _unpad_cache_len(caches, n_pad: int):
    """Rewind every layer's ``len`` past the right-pad of a ragged final
    prefill chunk."""
    for c in caches["blocks"]:
        c["len"] -= n_pad
    return caches


def make_prefill_step(cfg, chunk: int = 4096, *, return_logits: bool = False):
    """Returns ``prefill_step(params, tokens, caches)`` ->
    ``(next_tok (B,), caches)``, or ``(next_tok, logits (B, 1, V), caches)``
    with ``return_logits``.  The chunk is exposed as ``prefill_step.chunk``."""
    if chunk < 1:
        raise ValueError(f"prefill chunk must be >= 1, got {chunk}")
    transformer.check_supported(cfg)
    pad_ok = not (cfg.ssm_state or cfg.sliding_window)

    def run_chunks(params, tokens, caches):
        s = tokens.shape[1]
        full, rem = divmod(s, chunk)
        toks, n_pad = tokens, 0
        if rem and pad_ok:
            n_pad = chunk - rem
            toks = F.pad(tokens, (0, n_pad))
        logits = None
        n_chunks = toks.shape[1] // chunk
        for i in range(n_chunks):
            piece = toks[:, i * chunk:(i + 1) * chunk]
            li = rem - 1 if (n_pad and i == n_chunks - 1) else None
            logits, caches = transformer.prefill(params, cfg, piece, caches,
                                                 logit_index=li)
        if rem and not pad_ok:
            logits, caches = transformer.prefill(params, cfg, tokens[:, full * chunk:],
                                                 caches)
        if n_pad:
            caches = _unpad_cache_len(caches, n_pad)
        return logits, caches

    def dynamic_prefill(params, tokens, caches, n: int):
        """Right-padded tokens with ``n`` real: every chunk reads its head
        at the clamped real-last position, the chunk that holds token
        ``n - 1`` gives the logits, and ``len`` rewinds past the pad."""
        if not pad_ok:
            raise ValueError(
                "dynamic-length prefill needs a pad-tolerant attention cache; "
                "an SWA rolling buffer takes the exact-shape call (no n_tokens)")
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

    def prefill_step(params, tokens, caches, n_tokens: int | None = None):
        if n_tokens is not None:
            logits, caches = dynamic_prefill(params, tokens, caches, int(n_tokens))
        elif tokens.shape[1] <= chunk:
            logits, caches = transformer.prefill(params, cfg, tokens, caches)
        else:
            logits, caches = run_chunks(params, tokens, caches)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        if return_logits:
            return next_tok, logits, caches
        return next_tok, caches

    prefill_step.chunk = chunk
    return prefill_step


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
    with ``return_logits``."""
    transformer.check_supported(cfg)

    def serve_step(params, token, caches):
        logits, caches = transformer.decode_step(params, cfg, token, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if return_logits:
            return tok, logits, caches
        return tok, caches

    return serve_step


@torch.inference_mode()
def generate(params, cfg, prompt, max_new: int, max_len: int,
             dtype=torch.bfloat16, chunk: int = 4096):
    """Greedy generation: prompt (B, S) -> (B, max_new) tokens.  The
    caches live on the prompt's device."""
    caches = transformer.init_caches(cfg, prompt.shape[0], max_len, dtype,
                                     prompt.device)
    prefill = make_prefill_step(cfg, chunk)
    step = make_serve_step(cfg)
    tok, caches = prefill(params, prompt, caches)
    out = [tok[:, None]]
    for _ in range(max_new - 1):
        tok, caches = step(params, out[-1], caches)
        out.append(tok)
    return torch.cat(out, dim=1)
