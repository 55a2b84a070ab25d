"""Flash attention: the CUDA kernel's wrapper, its plain version and its
tile-accounting oracle.

``flash_attention`` takes the contract of ``repro.kernels.flash_attention``
(q (B, S, H, D), k/v (B, T, Hkv, D[v]), dynamic ``q_offset`` and
``kv_len``, causal / sliding-window / bidirectional masking, an optional
(B, Hkv, nq, nk) execution map).  On a CUDA tensor it launches
``csrc/flash_attention.cu`` or raises; on a CPU tensor it runs the plain
version, ``flash_attention_ref``.  ``q_offset`` and ``kv_len`` are host
ints here: the serving cache keeps its length on the host, so no launch
waits on the device to read them.

The wrapper writes its output through a raw pointer, so autograd sees no
path from it to q, k and v; it refuses inputs that require grad while
grad is enabled.  ``flash_attention_diff`` is the differentiable route,
the reference's ``custom_vjp`` (``repro.kernels.flash_attention._flash_diff``):
the forward is the kernel (the plain version on the CPU), the backward
recomputes through ``flash_attention_ref`` and differentiates that.  There
is no backward kernel, as the reference has none.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Finite stand-in for -inf on masked logits, as the TPU kernel uses.
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# Hopper tiles: a (G * 64)-row query panel against 64-key K/V tiles, two
# K/V stages in flight; at D = 128, G = 2 the f32 panel and stages take
# 198 KiB of shared memory.
DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64
SMEM_LIMIT = 232_448  # bytes of shared memory one CTA may use on Hopper
MAX_DV = 128  # the kernel keeps a 16-row slab's output in registers

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _tile_bounds(q_lo: int, kvlen: int, *, qc: int, kc: int, window: int,
                 bidirectional: bool) -> tuple[int, int]:
    """First/last live KV tile index for the Q tile starting at absolute
    position ``q_lo``; empty when last < first (the kernel computes the
    same in C)."""
    if bidirectional:
        return 0, (kvlen - 1) // kc
    last = min(q_lo + qc - 1, kvlen - 1) // kc
    first = 0
    if window > 0:
        # tile [k_lo, k_lo+kc-1] is visible iff its last key is inside the
        # widest window of the tile's query rows: k_lo + kc - 1 > q_lo - window
        c = q_lo - window + 2 - kc
        first = max(0, -((-c) // kc))
    return first, last


def _grid(s: int, t: int, block_q: int, block_k: int):
    qc, kc = min(block_q, s), min(block_k, t)
    return qc, kc, -(-s // qc), -(-t // kc)


def flash_tile_map(s: int, t: int, *, block_q: int = DEFAULT_BLOCK_Q,
                   block_k: int = DEFAULT_BLOCK_K, q_offset: int = 0,
                   window: int = 0, bidirectional: bool = False,
                   kv_len: int | None = None) -> torch.Tensor:
    """The (nq, nk) int32 execution map of one (batch, kv-head) slice."""
    qc, kc, nq, nk = _grid(s, t, block_q, block_k)
    kvlen = min(t if kv_len is None else int(kv_len), t)
    out = torch.zeros((nq, nk), dtype=torch.int32)
    for iq in range(nq):
        first, last = _tile_bounds(q_offset + iq * qc, kvlen, qc=qc, kc=kc,
                                   window=window, bidirectional=bidirectional)
        last = min(last, nk - 1)
        if last >= first:
            out[iq, first:last + 1] = 1
    return out


def flash_tile_counts(s: int, t: int, *, block_q: int = DEFAULT_BLOCK_Q,
                      block_k: int = DEFAULT_BLOCK_K, q_offset: int = 0,
                      window: int = 0, bidirectional: bool = False,
                      kv_len: int | None = None) -> tuple[int, int]:
    """Analytic (executed, total) KV-tile counts for one (batch, kv-head)
    slice of the grid (``repro.kernels.flash_attention.flash_tile_counts``
    with plain ints)."""
    m = flash_tile_map(s, t, block_q=block_q, block_k=block_k,
                       q_offset=q_offset, window=window,
                       bidirectional=bidirectional, kv_len=kv_len)
    return int(m.sum()), m.numel()


def _pick_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def flash_attention_ref(q, k, v, *, q_offset: int = 0, window: int = 0,
                        bidirectional: bool = False,
                        scale: float | None = None, q_chunk: int = 1024,
                        kv_chunk: int = 1024, kv_len: int | None = None):
    """Plain version: the two-level online-softmax loop of
    ``repro.models.layers.flash_attend_ref`` in f32 (every KV chunk is
    computed, masked ones included)."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    qc, kc = _pick_chunk(s, q_chunk), _pick_chunk(t, kv_chunk)
    dev = q.device

    qf = (q.float() * scale).reshape(b, s, hkv, g, d)
    kf, vf = k.float(), v.float()
    outs = []
    for qi in range(s // qc):
        q_tile = qf[:, qi * qc:(qi + 1) * qc]
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, hkv, g, qc), float("-inf"), device=dev)
        l = torch.zeros((b, hkv, g, qc), device=dev)
        acc = torch.zeros((b, hkv, g, qc, dv), device=dev)
        for kj in range(t // kc):
            k_tile = kf[:, kj * kc:(kj + 1) * kc]
            v_tile = vf[:, kj * kc:(kj + 1) * kc]
            kv_pos = kj * kc + torch.arange(kc, device=dev)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_tile, k_tile)
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if not bidirectional:
                mask &= kv_pos[None, :] <= q_pos[:, None]
                if window:
                    mask &= kv_pos[None, :] > (q_pos[:, None] - window)
            if kv_len is not None:
                mask &= (kv_pos < kv_len)[None, :]
            logits = logits.masked_fill(~mask, -1e30)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_tile)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (b,hkv,g,qc,dv)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (b,qc,hkv,g,dv)
    return torch.cat(outs, dim=1).reshape(b, s, h, dv).to(q.dtype)


def attention_f64(q, k, v, *, q_offset: int = 0, kv_len: int | None = None,
                  window: int = 0):
    """Exact causal (optionally windowed) masked-softmax attention in f64
    over the first ``kv_len`` keys: the yardstick of the kernel's f32
    accuracy (a single TF32 pass is ~1e-4 to 1e-3 from it, 3xTF32 ~1e-6)."""
    b, s, h, d = q.shape
    kv_len = k.shape[1] if kv_len is None else kv_len
    g = h // k.shape[2]
    kd = k[:, :kv_len].double().repeat_interleave(g, dim=2)
    vd = v[:, :kv_len].double().repeat_interleave(g, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.double() * d ** -0.5, kd)
    pos = q_offset + torch.arange(s, device=q.device)[:, None]
    key = torch.arange(kv_len, device=q.device)[None, :]
    mask = key <= pos
    if window:
        mask &= key > pos - window
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vd)


def _check(q, k, v, block_q, block_k):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q is (B, S, H, D), k/v are (B, T, Hkv, D[v])")
    b, s, h, d = q.shape
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of Hkv={k.shape[2]}")
    if block_q < 1 or block_k < 1:
        raise ValueError("block sizes must be positive")


def flash_attention(q, k, v, *, q_offset: int = 0, kv_len: int | None = None,
                    window: int = 0, bidirectional: bool = False,
                    scale: float | None = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    return_counts: bool = False):
    """Flash attention over q (B, S, H, D) and k/v (B, T, Hkv, D[v]).

    ``q_offset``: absolute position of query row 0; ``kv_len``: live
    prefix of a padded KV buffer (keys at or after it are masked).
    Returns (B, S, H, Dv) in q's dtype, plus the (B, Hkv, nq, nk) int32
    execution map with ``return_counts``.
    """
    _check(q, k, v, block_q, block_k)
    b, s, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    q_offset = int(q_offset)
    kvlen = t if kv_len is None else min(int(kv_len), t)
    qc, kc, nq, nk = _grid(s, t, block_q, block_k)

    if q.device.type == "cpu":
        out = flash_attention_ref(q, k, v, q_offset=q_offset, window=window,
                                  bidirectional=bidirectional, scale=scale,
                                  kv_len=kvlen)
        if not return_counts:
            return out
        tile_map = flash_tile_map(s, t, block_q=block_q, block_k=block_k,
                                  q_offset=q_offset, window=window,
                                  bidirectional=bidirectional, kv_len=kvlen)
        return out, tile_map.expand(b, hkv, nq, nk).contiguous()
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _build.refuse_grad("flash_attention", q, k, v)

    _build.check_rows4("flash_attention", q, k, v)
    if dv > MAX_DV:
        raise ValueError(f"flash_attention's kernel takes Dv <= {MAX_DV}, got {dv}")
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(_DTYPES[q.dtype], h // hkv, qc, kc, d, dv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a (G*block_q={h // hkv * qc})-row panel at D={d}, "
                         f"Dv={dv}, block_k={kc} needs {smem} B of shared "
                         f"memory (> {SMEM_LIMIT}); lower block_q or block_k")
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=q.device)
    counts = (torch.zeros((b, hkv, nq, nk), dtype=torch.int32, device=q.device)
              if return_counts else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        _DTYPES[q.dtype], b, s, h, t, hkv, d, dv,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        q_offset, kvlen, int(window), int(bool(bidirectional)),
        float(scale if scale is not None else d ** -0.5), qc, kc, stream)
    _build.check(rc, "flash_attention", lib.flash_attention_error_string)
    flash_attention.launches += 1
    return (out, counts) if return_counts else out


flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with a gradient: forward through
    :func:`flash_attention` (the kernel on the card), backward by
    recomputing the plain version and differentiating it, as the
    reference's vjp does.  ``q_offset``, ``kv_len`` and the masking
    options are constants with no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, kv_len, window, bidirectional, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(q_offset=q_offset, kv_len=kv_len, window=window,
                        bidirectional=bidirectional, scale=scale)
        return flash_attention(q, k, v, **ctx.opts)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = flash_attention_ref(*leaves, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_diff(q, k, v, *, q_offset: int = 0, kv_len: int | None = None,
                         window: int = 0, bidirectional: bool = False,
                         scale: float | None = None):
    """:func:`flash_attention` with a gradient to q, k and v
    (:class:`FlashAttentionFunction`)."""
    return FlashAttentionFunction.apply(q, k, v, int(q_offset), kv_len, window,
                                        bidirectional, scale)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_fwd.argtypes = (
            [P] * 5 + [I] * 8 + [L] * 12 + [I] * 4 + [ctypes.c_float]
            + [I] * 2 + [P])
        lib.flash_attention_fwd.restype = I
        lib.flash_attention_smem_bytes.argtypes = [I] * 6
        lib.flash_attention_smem_bytes.restype = L
        lib.flash_attention_error_string.argtypes = [I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
