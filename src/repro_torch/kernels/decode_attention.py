"""Split-KV decode attention: the CUDA kernel's wrapper, its plain version
and its partition-accounting oracle.

``decode_attention`` takes the contract of
``repro.kernels.decode_attention.decode_attention``: q (B, 1, H, D) is the
new token's queries, k/v (B, T, Hkv, D[v]) the padded cache after the new
K/V were written, so the query sits at position ``kv_len - 1``.  On a CUDA
tensor it launches ``csrc/decode_attention.cu`` (partitions, then the
max / logsumexp combine) or raises; on a CPU tensor it runs the plain
version, ``decode_attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import MASK_VALUE

DEFAULT_BLOCK_K = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _partition_live(k_lo: int, kc: int, kvlen: int, window: int) -> bool:
    live = k_lo < kvlen
    if window > 0:
        live = live and (k_lo + kc - 1) > (kvlen - 1 - window)
    return live


def decode_partition_map(t: int, kv_len: int, *,
                         block_k: int = DEFAULT_BLOCK_K,
                         window: int = 0) -> torch.Tensor:
    """The (P,) int32 execution map of one (batch, kv-head) decode step."""
    kc = min(block_k, t)
    kvlen = min(kv_len, t)
    return torch.tensor(
        [int(_partition_live(ip * kc, kc, kvlen, window))
         for ip in range(-(-t // kc))], dtype=torch.int32)


def decode_partition_counts(t: int, kv_len: int, *,
                            block_k: int = DEFAULT_BLOCK_K,
                            window: int = 0) -> tuple[int, int]:
    """Analytic (executed, total) partition counts for one (batch,
    kv-head) decode step."""
    m = decode_partition_map(t, kv_len, block_k=block_k, window=window)
    return int(m.sum()), m.numel()


def combine_partitions(o_part, m_part, l_part):
    """Cross-partition max / logsumexp merge on (B, Hkv, P, G[, Dv])."""
    m_glob = m_part.amax(dim=2, keepdim=True)
    # dead partitions carry m = -inf; exp(-inf - finite) = 0 kills them
    alpha = torch.exp(m_part - torch.clamp(m_glob, min=MASK_VALUE))
    den = (alpha * l_part).sum(dim=2)                 # (B, Hkv, G)
    num = (alpha[..., None] * o_part).sum(dim=2)      # (B, Hkv, G, Dv)
    return num / torch.clamp(den, min=1e-30)[..., None]


def decode_attention_ref(q, k, v, *, kv_len: int, window: int = 0,
                         scale: float | None = None,
                         block_k: int = DEFAULT_BLOCK_K,
                         return_counts: bool = False):
    """Plain version of the kernel: per-partition partial (o, m, l) with
    neutral statistics for dead partitions, then the combine."""
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"decode attention takes S=1, got S={s}")
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    kc = min(block_k, t)
    np_ = -(-t // kc)
    kvlen = min(int(kv_len), t)
    dev = q.device

    pad = np_ * kc - t
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.reshape(b, np_, kc, hkv, d)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    vp = vp.reshape(b, np_, kc, hkv, dv)
    qf = q.float().reshape(b, hkv, g, d)
    s_ = torch.einsum("bhgd,bpkhd->bhpgk", qf, kf) * scale
    cols = torch.arange(np_ * kc, device=dev).reshape(np_, kc)
    row_pos = kvlen - 1
    mask = cols <= row_pos
    if window > 0:
        mask &= cols > row_pos - window
    s_ = s_.masked_fill(~mask[None, None, :, None, :], MASK_VALUE)
    m = s_.amax(-1)                                    # (b, hkv, p, g)
    p = torch.exp(s_ - m[..., None])
    l = p.sum(-1)
    # P is rounded to the value dtype before the PV product, as the kernel
    pv = torch.einsum("bhpgk,bpkhd->bhpgd", p.to(v.dtype).float(), vp.float())
    live = decode_partition_map(t, kvlen, block_k=kc, window=window).to(dev)
    lv = live.bool()[None, None, :, None]
    o_part = pv.masked_fill(~lv[..., None], 0.0)
    m_part = m.masked_fill(~lv, float("-inf"))
    l_part = l.masked_fill(~lv, 0.0)
    out = combine_partitions(o_part, m_part, l_part)
    out = out.reshape(b, 1, h, dv).to(q.dtype)
    if return_counts:
        return out, live.expand(b, hkv, np_).contiguous()
    return out


def _check(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/k/v of "
                        f"one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q is (B, 1, H, D), k/v are (B, T, Hkv, D[v])")
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"decode_attention is an S=1 kernel, got S={s}")
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or k.shape[3] != d:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"H={h} is not a multiple of Hkv={k.shape[2]}")


def decode_attention(q, k, v, *, kv_len: int, window: int = 0,
                     scale: float | None = None,
                     block_k: int = DEFAULT_BLOCK_K,
                     return_counts: bool = False):
    """Split-KV decode attention.  Returns (B, 1, H, Dv) in q's dtype,
    plus the (B, Hkv, P) int32 partition execution map with
    ``return_counts``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len=kv_len, window=window,
                                    scale=scale, block_k=block_k,
                                    return_counts=return_counts)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    b, _, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    kc = min(block_k, t)
    np_ = -(-t // kc)
    kvlen = min(int(kv_len), t)

    _build.check_rows4("decode_attention", q, k, v)
    lib = _lib()
    dev = q.device
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=dev)
    o_part = torch.empty((b, hkv, np_, g, dv), dtype=torch.float32, device=dev)
    m_part = torch.empty((b, hkv, np_, g), dtype=torch.float32, device=dev)
    l_part = torch.empty((b, hkv, np_, g), dtype=torch.float32, device=dev)
    counts = (torch.zeros((b, hkv, np_), dtype=torch.int32, device=dev)
              if return_counts else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        _DTYPES[q.dtype], b, h, t, hkv, d, dv,
        q.stride(0), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(2),
        kvlen, int(window), float(scale if scale is not None else d ** -0.5),
        kc, stream)
    _build.check(rc, "decode_attention", lib.decode_attention_error_string)
    decode_attention.launches += 1
    return (out, counts) if return_counts else out


decode_attention.launches = 0


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attention_fwd.argtypes = (
            [P] * 8 + [I] * 7 + [L] * 10 + [I] * 2 + [ctypes.c_float]
            + [I] + [P])
        lib.decode_attention_fwd.restype = I
        lib.decode_attention_error_string.argtypes = [I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
