"""Mamba2: state-space duality (SSD) blocks (PyTorch port of
``repro.models.ssm``).

Prefill runs the chunked SSD dual form (arXiv:2405.21060): the sequence is
cut into chunks; within a chunk the recurrence is a masked attention-like
matmul, and a loop over the chunks carries the (N x P) state.  Decode is
the O(1) recurrence.  ``ssd_reference`` is the naive per-token recurrence,
the oracle of the tests.  The reference's SSD is plain ``jnp`` with no
kernel, and so is this one: plain PyTorch.

The SSD internals, ``dt`` and the ``"ssm"`` state are f32 in every dtype
(f64 for f64 inputs: ``ssd_reference`` on f64 tensors is the exact
yardstick of the f32 form on the card); ``y`` returns in ``x.dtype``.

Shapes: x (B, L, H, P), dt (B, L, H), B/C (B, L, N) shared across heads
(single group), state (B, H, N, P).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_apply, dense_init, rmsnorm_apply, rmsnorm_init


def _compute_dtype(x):
    return torch.promote_types(x.dtype, torch.float32)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_reference(x, dt, a_log, b, c, initial_state=None):
    """Naive recurrence oracle.  Returns (y, final_state)."""
    bsz, L, h, p = x.shape
    n = b.shape[-1]
    cd = _compute_dtype(x)
    a = -torch.exp(a_log.to(cd))  # (H,)
    state = (initial_state.to(cd) if initial_state is not None
             else torch.zeros((bsz, h, n, p), dtype=cd, device=x.device))
    xf, dtf, bf, cf = x.to(cd), dt.to(cd), b.to(cd), c.to(cd)
    ys = []
    for t in range(L):
        decay = torch.exp(a[None, :] * dtf[:, t])  # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], bf[:, t], xf[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], state))
    y = torch.stack(ys, dim=1)  # (B, L, H, P)
    return y.to(x.dtype), state


def _segsum(logdecay):
    """logdecay: (..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = sum_{j < t <= i} logdecay[t], -inf above the diagonal (so
    that ``exp`` gives exactly 0 there)."""
    q = logdecay.shape[-1]
    cs = torch.cumsum(logdecay, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum (j, i]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=logdecay.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, chunk: int = 128, initial_state=None):
    """Chunked dual form.  Returns (y, final_state)."""
    bsz, L, h, p = x.shape
    n = b.shape[-1]
    if L % chunk:
        raise ValueError(f"seq {L} % chunk {chunk} != 0")
    nck = L // chunk
    cd = _compute_dtype(x)
    a = -torch.exp(a_log.to(cd))

    xf = x.to(cd).reshape(bsz, nck, chunk, h, p)
    dtf = dt.to(cd).reshape(bsz, nck, chunk, h)
    bf = b.to(cd).reshape(bsz, nck, chunk, n)
    cf = c.to(cd).reshape(bsz, nck, chunk, n)

    logdecay = a[None, None, None, :] * dtf  # (B, K, Q, H)
    ld = logdecay.movedim(-1, 2)  # (B, K, H, Q)
    cum = torch.cumsum(ld, dim=-1)  # (B, K, H, Q)

    # --- intra-chunk (diagonal) term: masked attention-like matmul
    decay_mat = torch.exp(_segsum(ld))  # (B, K, H, Q, Q)
    scores = torch.einsum("bkin,bkjn->bkij", cf, bf)  # (B, K, Q, Q)
    mat = scores[:, :, None] * decay_mat  # (B, K, H, Q, Q)
    xdt = xf * dtf[..., None]  # (B, K, Q, H, P)
    y_diag = torch.einsum("bkhij,bkjhp->bkihp", mat, xdt)

    # --- chunk states: decay-to-end weighted outer products
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (B, K, H, Q)
    s_chunk = torch.einsum("bkhq,bkqn,bkqhp->bkhnp", decay_to_end, bf, xdt)

    # --- inter-chunk recurrence over the K chunks; each chunk sees the
    # state from BEFORE its own update (the reference scan's carry)
    chunk_decay = torch.exp(cum[..., -1])  # (B, K, H)
    state = (initial_state.to(cd) if initial_state is not None
             else torch.zeros((bsz, h, n, p), dtype=cd, device=x.device))
    prev = []
    for k in range(nck):
        prev.append(state)
        state = state * chunk_decay[:, k, :, None, None] + s_chunk[:, k]
    prev_states = torch.stack(prev, dim=1)  # (B, K, H, N, P)

    # --- inter-chunk (off-diagonal) contribution
    in_decay = torch.exp(cum)  # (B, K, H, Q): decay from the chunk's start to i
    y_off = torch.einsum("bkqn,bkhnp,bkhq->bkqhp", cf, prev_states, in_decay)

    y = (y_diag + y_off).reshape(bsz, L, h, p)
    return y.to(x.dtype), state


def ssd_decode_step(state, x, dt, a_log, b, c):
    """One-token recurrence.  x: (B, H, P), dt: (B, H), b/c: (B, N)."""
    cd = _compute_dtype(x)
    a = -torch.exp(a_log.to(cd))
    xf, dtf = x.to(cd), dt.to(cd)
    decay = torch.exp(a[None, :] * dtf)
    upd = torch.einsum("bh,bn,bhp->bhnp", dtf, b.to(cd), xf)
    state = state * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c.to(cd), state)
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> conv -> SSD -> gate -> out_proj)
# ---------------------------------------------------------------------------


def mamba2_init(gen, cfg, dtype, device):
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    h = d_inner // cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n
    width = cfg.ssm_conv_width
    conv_w = torch.randn((width, conv_dim), generator=gen, dtype=torch.float32,
                         device=device) * (1.0 / width)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection: [z | x | B | C | dt]
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * n + h, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        # f32 whatever ``dtype`` is, as the reference's
        "a_log": torch.zeros((h,), **f32),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "out_norm": rmsnorm_init(d_inner, dtype, device),
        "out_proj": dense_init(gen, d_inner, d, dtype, device),
    }


def _mamba2_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    h = d_inner // cfg.ssm_head_dim
    return d_inner, h, cfg.ssm_state


def _causal_depthwise_conv(w, bias, x, conv_state=None):
    """x: (B, L, C); w: (W, C).  The reference's per-tap sum in
    ``x.dtype``.  Returns (y, new_state (B, W-1, C))."""
    width = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, x], dim=1)  # (B, L+W-1, C)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(width))
    new_state = xp[:, -(width - 1):, :]
    return F.silu((y + bias).float()).to(x.dtype), new_state


def mamba2_cache_init(cfg, batch: int, dtype, device):
    d_inner, h, n = _mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "ssm": torch.zeros((batch, h, n, cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba2_apply(p, cfg, x, cache=None, chunk: int = 128):
    """x: (B, L, D) -> (y, new_cache).  cache=None: no state out; L == 1
    with a cache: a decode step.  A length that ``min(chunk, L)`` does not
    divide runs the SSD at chunk 1, as the reference does (the rule sets
    the result's rounding)."""
    bsz, L, _ = x.shape
    d_inner, h, n = _mamba2_dims(cfg)
    proj = dense_apply(p["in_proj"], x)
    z, xs, bmat, cmat, dt = torch.split(proj, [d_inner, d_inner, n, n, h], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, L, H), f32

    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv = _causal_depthwise_conv(p["conv_w"], p["conv_b"], conv_in, conv_state)
    xs, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)
    xh = xs.reshape(bsz, L, h, cfg.ssm_head_dim)

    if cache is not None and L == 1:
        y, new_state = ssd_decode_step(cache["ssm"], xh[:, 0], dt[:, 0], p["a_log"],
                                       bmat[:, 0], cmat[:, 0])
        y = y[:, None]
    else:
        init = cache["ssm"] if cache is not None else None
        eff_chunk = min(chunk, L) if L % min(chunk, L) == 0 else 1
        y, new_state = ssd_chunked(xh, dt, p["a_log"], bmat, cmat, chunk=eff_chunk,
                                   initial_state=init)
    # the reference's rounding order: the skip in y's dtype, then the gate
    # cast to y's dtype, then the norm
    y = y + xh.float().to(y.dtype) * p["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, L, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm_apply(p["out_norm"], y, cfg.norm_eps)
    out = dense_apply(p["out_proj"], y)
    new_cache = {"ssm": new_state, "conv": new_conv} if cache is not None else None
    return out, new_cache
