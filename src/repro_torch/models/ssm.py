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

Tensor parallelism (``dist.tensor``'s ambient model group; the mode read
from the leaves' widths): ``out_proj`` split by rows on head boundaries
gives this rank its heads.  ``in_proj``'s fused ``[z | x | B | C | dt]``
columns split wherever the cut falls (not on segment edges), so its
output is gathered whole (the ``reduce_scatter`` adjoint: the ranks read
it differently); the conv runs on this rank's ``x`` channels and the
shared ``B`` / ``C``, its state kept whole from the gathered input; the
SSD, skip and gate on this rank's heads; ``out_norm`` over the whole
``d_inner`` across the group (``rmsnorm_split_apply``); ``out_proj``
summed over the ranks.  The replicated leaves (``conv_w``, ``conv_b``,
``a_log``, ``d_skip``, ``dt_bias``, ``out_norm``) go through ``copy``, so
their gradients sum the ranks' shares.  A cache holds this rank's heads
of the SSM state (``cache_specs``) and the whole conv state; a layer
that computes whole (an int8 tree, whose ``qw`` stays whole) gathers the
state and keeps its heads' slice of the new one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor as tp
from repro_torch.models.layers import (
    dense_apply,
    dense_init,
    rmsnorm_apply,
    rmsnorm_init,
    rmsnorm_split_apply,
    row_parallel_apply,
    width,
)


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


def _causal_depthwise_conv(w, bias, x, conv_state=None, keep=None):
    """x: (B, L, C); w: (W, C).  The reference's per-tap sum in
    ``x.dtype``.  Returns (y, new_state (B, W-1, C)).  ``keep`` (channel
    slices) convolves those channels only; the new state stays whole."""
    taps = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], taps - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, x], dim=1)  # (B, L+W-1, C)
    new_state = xp[:, -(taps - 1):, :]
    if keep is not None:
        xp = torch.cat([xp[..., s] for s in keep], dim=-1)
        w = torch.cat([w[:, s] for s in keep], dim=-1)
        bias = torch.cat([bias[s] for s in keep], dim=-1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(taps))
    return F.silu((y + bias).float()).to(x.dtype), new_state


def cache_heads(cfg, size: int) -> int:
    """The SSM state heads a cache holds on one of ``size`` model ranks:
    ``cache_specs`` splits them where ``size`` divides them."""
    h = _mamba2_dims(cfg)[1]
    return h // size if h % size == 0 else h


def mamba2_cache_init(cfg, batch: int, dtype, device, heads: int | None = None):
    """``heads``: the SSM state heads this rank's cache holds (its share
    under tensor parallelism, :func:`cache_heads`); all by default."""
    d_inner, h, n = _mamba2_dims(cfg)
    conv_dim = d_inner + 2 * n
    return {
        "ssm": torch.zeros((batch, heads or h, n, cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def _tp_heads(p, cfg) -> int | None:
    """This rank's heads under tensor parallelism, or None where
    ``out_proj`` is whole (the layer computes whole)."""
    d_inner = _mamba2_dims(cfg)[0]
    op = p["out_proj"]
    rows = (op["w"] if "w" in op else op["qw"]).shape[0]
    if not tp.split(rows, d_inner):
        return None
    if rows % cfg.ssm_head_dim:
        raise NotImplementedError(f"{cfg.name}: Mamba2 heads split inside a head")
    return rows // cfg.ssm_head_dim


def _in_proj(p, cfg, x, heads_split: bool):
    """The fused input projection, whole on every rank: a column slice is
    gathered (where the ranks read it for their own heads, the gradients'
    sum is scattered back)."""
    d_inner, h, n = _mamba2_dims(cfg)
    ip = p["in_proj"]
    if tp.split(width(ip), 2 * d_inner + 2 * n + h):
        return tp.gather(dense_apply(ip, tp.copy(x)), -1, reduce_grad=heads_split)
    if heads_split:
        # no config's model split leaves in_proj whole beside a split out_proj
        raise NotImplementedError(f"{cfg.name}: in_proj whole beside a split out_proj")
    return dense_apply(ip, x)


def _held_state(cache, h: int, held: int):
    """(initial SSM state for ``held`` heads, slice of the new state this
    rank's cache keeps or None): a cache of this rank's heads under a
    layer that computes all of them is gathered (serving only)."""
    if cache is None:
        return None, None
    state = cache["ssm"]
    hs = state.shape[1]
    if hs == held:
        return state, None
    if held != h or not tp.split(hs, h):
        raise ValueError(f"an SSM cache of {hs} heads for a layer computing {held} of {h}")
    first = tp.model_rank() * hs
    return tp.gather(state, 1), slice(first, first + hs)


def mamba2_apply(p, cfg, x, cache=None, chunk: int = 128):
    """x: (B, L, D) -> (y, new_cache).  cache=None: no state out; L == 1
    with a cache: a decode step.  A length that ``min(chunk, L)`` does not
    divide runs the SSD at chunk 1, as the reference does (the rule sets
    the result's rounding).  Under tensor parallelism this rank runs its
    heads (module docstring)."""
    bsz, L, _ = x.shape
    d_inner, h, n = _mamba2_dims(cfg)
    hp = cfg.ssm_head_dim
    hl = _tp_heads(p, cfg)
    proj = _in_proj(p, cfg, x, hl is not None)
    z, xs, bmat, cmat, dt = torch.split(proj, [d_inner, d_inner, n, n, h], dim=-1)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    a_log, d_skip, dt_bias = p["a_log"], p["d_skip"], p["dt_bias"]
    if hl is None:
        held, keep, norm = h, None, p["out_norm"]
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    else:
        held = hl
        first = tp.model_rank() * hl
        heads, cols = slice(first, first + hl), slice(first * hp, (first + hl) * hp)
        keep = [cols, slice(d_inner, d_inner + 2 * n)]
        a_log, d_skip, dt_bias = (tp.copy(t)[heads] for t in (a_log, d_skip, dt_bias))
        norm = {"scale": tp.copy(p["out_norm"]["scale"])[cols]}
        conv_w, conv_b = tp.copy(p["conv_w"]), tp.copy(p["conv_b"])
        z, dt = z[..., cols], dt[..., heads]
    dt = F.softplus(dt.float() + dt_bias)  # (B, L, H), f32

    conv_out, new_conv = _causal_depthwise_conv(conv_w, conv_b, conv_in, conv_state, keep)
    xs, bmat, cmat = torch.split(conv_out, [held * hp, n, n], dim=-1)
    xh = xs.reshape(bsz, L, held, hp)

    init, kept = _held_state(cache, h, held)
    if cache is not None and L == 1:
        y, new_state = ssd_decode_step(init, xh[:, 0], dt[:, 0], a_log,
                                       bmat[:, 0], cmat[:, 0])
        y = y[:, None]
    else:
        eff_chunk = min(chunk, L) if L % min(chunk, L) == 0 else 1
        y, new_state = ssd_chunked(xh, dt, a_log, bmat, cmat, chunk=eff_chunk,
                                   initial_state=init)
    if kept is not None:
        new_state = new_state[:, kept].contiguous()
    # the reference's rounding order: the skip in y's dtype, then the gate
    # cast to y's dtype, then the norm
    y = y + xh.float().to(y.dtype) * d_skip.to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, L, held * hp)
    y = y * F.silu(z.float()).to(y.dtype)
    if hl is None:
        y = rmsnorm_apply(norm, y, cfg.norm_eps)
        out = dense_apply(p["out_proj"], y)
    else:
        y = rmsnorm_split_apply(norm, y, d_inner, cfg.norm_eps)
        out = row_parallel_apply(p["out_proj"], y)
    new_cache = {"ssm": new_state, "conv": new_conv} if cache is not None else None
    return out, new_cache
