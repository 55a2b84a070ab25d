"""Split-KV decode attention, dense and paged: the CUDA kernels' wrappers,
their plain versions and their partition-accounting oracles.

``decode_attention`` takes the contract of
``repro.kernels.decode_attention.decode_attention``: q (B, 1, H, D) is the
new token's queries, k/v (B, T, Hkv, D[v]) the padded cache after the new
K/V were written, so the query sits at position ``kv_len - 1``.  On a CUDA
tensor it launches ``csrc/decode_attention.cu`` (spans of keys chosen by
``decode_plan``, merged in the same launch) or raises; on a CPU tensor it
runs the plain version, ``decode_attention_ref``.

``paged_decode_attention`` takes the contract of the reference's
``paged_decode_attention``: K/V in shared page pools addressed through
per-sequence block tables, per-sequence ``kv_lens`` on the device, S = 1
decode or S > 1 speculative verify, float or int8 pages.  On a CUDA tensor
it launches ``csrc/paged_decode_attention.cu`` or raises; on a CPU tensor
it runs ``paged_decode_attention_ref``.  ``paged_partition_counts`` is the
oracle of its per-page execution map.

On a ``meta`` tensor (the dry-run stand-in, ``launch.dryrun``) each wrapper
runs everything but the launch: its checks, its plan (at an H100's SM
count) and the allocation of its output and split-KV partials, and it
tells ``launch.counters`` the call's analytic work (:func:`decode_work`,
:func:`paged_work`, as it does where it launches); it counts no launch.
The arrival counters (``_arrive``) are made once per stream and kept, so
a ``meta`` call makes none.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import MASK_VALUE

DEFAULT_BLOCK_K = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory a CTA may opt in to on Hopper (232,448 bytes)
_MAX_SMEM = 227 * 1024
_SM_SMEM = 228 * 1024   # shared memory of an SM; a CTA also reserves 1 KiB
ROW_TILE = 16           # query rows of a warp's tile at most
_ARRIVE: dict[tuple, torch.Tensor] = {}


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


def decode_work(b, h, hkv, d, dv, kv_len, esize, shared=False, window=0) -> tuple[int, int]:
    """Operations and bytes one dense decode call needs: each query head
    scores the live keys (the last ``window`` of them with a window; 2*D +
    2*Dv a key); q and the live K/V rows are read once (a ``shared``
    cache, V the leading columns of K's rows, once: D columns a key), the
    output written once."""
    keys = min(kv_len, window) if window else kv_len
    flops = b * h * keys * 2 * (d + dv)
    nbytes = esize * (b * h * d + b * keys * hkv * (d if shared else d + dv) + b * h * dv)
    return flops, nbytes


def paged_work(b, s, h, hkv, d, dv, kv_lens, esize, pages_per_seq, kv_esize=None,
               shared=False, pg=16) -> tuple[int, int]:
    """Operations and bytes one paged call needs: each query row scores
    every key of its sequence's live span; q, the live K/V rows, the
    block table and lengths are read once, the output written once.
    ``kv_esize`` is the pages' element size where it is not q's (int8
    pages also read two f32 scales a live page and head); a ``shared`` pool
    (MLA's keys and values in one) is read once, D columns a key."""
    kv_esize = esize if kv_esize is None else kv_esize
    keys = sum(kv_lens)
    flops = s * h * keys * 2 * (d + dv)
    pages = sum(-(-n // pg) for n in kv_lens) if kv_esize == 1 else 0
    nbytes = (esize * (b * s * h * d + b * s * h * dv)
              + kv_esize * keys * hkv * (d if shared else d + dv)
              + 4 * (b * pages_per_seq + b) + 8 * hkv * pages)
    return flops, nbytes


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


def _round16(x: int) -> int:
    return (x + 15) // 16 * 16


def _row_cap(dv: int) -> int:
    """Rows of a warp's tile at most: a lane holds rows x (dv / 128 passes)
    float4 accumulators, in the kernels' shapes 16 x 1, 4 x 4 or 2 x 8."""
    passes = -(-dv // 128)
    for rows, most in ((16, 1), (4, 4), (2, 8)):
        if passes <= most:
            return rows
    raise ValueError(f"decode attention: dv={dv} exceeds the 1024 value columns "
                     f"a warp accumulates")


def _arrive(capture_id, dev, stream: int, n: int) -> torch.Tensor:
    """A decode kernel's arrival counters for a launch on ``stream``: at
    least ``n`` int32 zeros (``capture_id`` is the kernel library's id of
    the graph capture in progress on a stream, 0 when none is).  Each
    launch leaves them zero, and the launches that share a buffer never
    run at once (the dense and paged kernels share them too):

    * eager calls share one buffer per (device, stream), and the launches
      of a stream run one after another;
    * the calls captured in one graph on one stream share a buffer of that
      capture, zeroed by a memset the graph replays before them, so two
      graphs replayed at once on two streams each count in their own.

    A launch that faults leaves the context unusable (CUDA's kernel errors
    are sticky), so no later call sees its counters.  The buffers of
    captures that have ended are dropped: the graph's pool keeps the
    memory for its replays."""
    cap = capture_id(stream) if torch.cuda.is_current_stream_capturing() else 0
    if cap == 0 and len(_ARRIVE) > 1:
        for key in [k for k in _ARRIVE if k[2] and capture_id(k[1]) != k[2]]:
            del _ARRIVE[key]
    key = (dev, stream, cap)
    buf = _ARRIVE.get(key)
    if buf is None or buf.numel() < n:
        buf = _ARRIVE[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return buf


def _check_rows16(what: str, rows) -> None:
    """The kernels copy each K row of D and V row of Dv elements with
    16-byte bulk copies: those rows (``rows``: (name, tensor, elements))
    must be 16-byte multiples at 16-byte aligned addresses."""
    for name, x, n in rows:
        e = x.element_size()
        if (x.stride(-1) != 1 or (n * e) % 16 or x.data_ptr() % 16
                or any((st * e) % 16 for st, sz in zip(x.stride()[:-1], x.shape[:-1])
                       if sz > 1)):
            raise ValueError(f"{what}: the kernel copies {name} rows of {n} "
                             f"elements as 16-byte multiples from 16-byte aligned addresses; "
                             f"got {x.dtype} shape {tuple(x.shape)}, strides {x.stride()}")


DECODE_WARPS = 4        # key warps of a CTA whose rows fit in one warp's tile
DECODE_ROW_WARPS = 8    # row warps of a CTA, at most, where they do not
CHUNK_KEYS = 16         # keys of a chunk, at most
CHUNK_BYTES = 40 * 1024  # a key group's slots, at most, before the chunk halves
DECODE_CTAS_PER_SM = 3   # CTAs an SM is planned to hold, at most
_DECODE_PLANS: dict[tuple, dict] = {}


def _key_lanes(chunk: int) -> int:
    """QK lanes a key of a chunk (a power of two): T with T * chunk <= 32."""
    lanes = 1
    while lanes * 2 * chunk <= 32:
        lanes *= 2
    return lanes


def decode_smem_bytes(rows_tile: int, d: int, dv: int, chunk: int, esize: int,
                      key_warps: int, row_warps: int, shared_kv: bool) -> int:
    """Shared memory one CTA of ``csrc/decode_attention.cu`` needs (its
    ``layout``): 128 bytes of mbarriers; a key group's slots (a chunk's K
    rows then its V rows, or two chunks of K rows where V is K's leading
    columns; rows 16-byte multiples, K rows skewed by 16 bytes a QK lane
    where fewer than 8 lanes take a key), at least the key groups' (o, m,
    l) for their merge (more than one group) and the spans' per-row max and
    denominator; the CTA's f32 query rows; a warp's chunk of logits and its
    rows' (m, l, factor); the last-CTA flag."""
    lanes = _key_lanes(chunk)
    krow = _round16(d * esize) + (16 * lanes if lanes < 8 else 0)
    vrow = _round16(dv * esize)
    stage = 2 * chunk * krow if shared_kv else chunk * (krow + vrow)
    rows_cta, warps = row_warps * rows_tile, key_warps * row_warps
    merge = key_warps * rows_cta * (dv + 2) * 4 if key_warps > 1 else 0
    return (128 + _round16(max(key_warps * stage, merge, rows_cta * 2 * 4))
            + _round16(rows_cta * d * 4) + _round16(warps * rows_tile * chunk * 4)
            + _round16(warps * rows_tile * 3 * 4) + 16)


def decode_plan(b: int, h: int, hkv: int, t: int, d: int, dv: int, esize: int,
                shared_kv: bool, sms: int) -> dict:
    """The grid of one dense decode call, from host-known shapes only
    (``kv_len`` does not size it):

    * rows: the G query heads of a kv-head in warp tiles of ``rows_tile``
      (at most ``ROW_TILE``, fewer at wide Dv, ``_row_cap``).  G in one tile
      takes ``DECODE_WARPS`` key warps, each computing every n-th chunk; more
      tiles take up to ``DECODE_ROW_WARPS`` row warps over one key group's
      chunks, in ``groups`` row groups of CTAs;
    * ``chunk``: ``CHUNK_KEYS`` keys, halved while a key group's slots pass
      ``CHUNK_BYTES``; key warps, row warps, then the chunk shrink further
      while the CTA does not fit in the 227 KiB it may opt in to;
    * ``span``: the keys of T split evenly (in whole chunks) so that the
      grid of B x Hkv x groups x spans CTAs is about one wave: the CTAs an SM
      holds by shared memory, at most ``DECODE_CTAS_PER_SM``, on every SM.
      On the card an even wave beat power-of-two spans (a CTA more on some
      SMs) and more, shorter spans (each CTA's prologue and merge).

    Returns the plan with its shared-memory bytes and grid size.  Raises
    ``ValueError`` when one key's rows do not fit."""
    g = h // hkv
    cap = min(ROW_TILE, _row_cap(dv))
    if g <= cap:
        rows_tile, row_warps, key_warps = g, 1, DECODE_WARPS
    else:
        tiles = -(-g // cap)
        rows_tile, row_warps, key_warps = -(-g // tiles), min(DECODE_ROW_WARPS, tiles), 1
    chunk = CHUNK_KEYS
    while chunk > 1 and decode_smem_bytes(1, d, dv, chunk, esize, 1, 1,
                                          shared_kv) > CHUNK_BYTES:
        chunk //= 2

    def smem():
        return decode_smem_bytes(rows_tile, d, dv, chunk, esize, key_warps, row_warps,
                                 shared_kv)

    while smem() > _MAX_SMEM and key_warps > 1:
        key_warps -= 1
    while smem() > _MAX_SMEM and row_warps > 1:
        row_warps -= 1
    while smem() > _MAX_SMEM and chunk > 1:
        chunk //= 2
    need = smem()
    if need > _MAX_SMEM:
        raise ValueError(f"decode_attention: one key of G={g} query heads at D={d}, Dv={dv} "
                         f"needs {need} B of shared memory, over the 227 KiB ({_MAX_SMEM} B) "
                         f"a CTA may opt in to on Hopper")
    groups = -(-g // (row_warps * rows_tile))
    wave = sms * max(1, min(DECODE_CTAS_PER_SM, _SM_SMEM // (need + 1024)))
    spans = max(1, wave // (b * hkv * groups))
    span = -(-t // spans)
    span = -(-span // chunk) * chunk
    nspan = -(-t // span)
    return dict(rows_tile=rows_tile, row_warps=row_warps, key_warps=key_warps,
                groups=groups, chunk=chunk, span=span, nspan=nspan, smem=need,
                threads=32 * key_warps * row_warps, ctas=b * hkv * groups * nspan,
                wave=wave)


def _shares_rows(k, v) -> bool:
    """v is the leading columns of k's own rows (MLA's one latent cache):
    the kernel reads the values from the copied K rows.  A ``meta`` tensor
    has no address: its storage and offset stand in."""
    if k.device.type == "meta":
        same = (v.untyped_storage()._cdata == k.untyped_storage()._cdata
                and v.storage_offset() == k.storage_offset())
    else:
        same = v.data_ptr() == k.data_ptr()
    return same and v.stride() == k.stride() and v.shape[-1] <= k.shape[-1]


def decode_attention(q, k, v, *, kv_len: int, window: int = 0,
                     scale: float | None = None,
                     block_k: int = DEFAULT_BLOCK_K,
                     return_counts: bool = False):
    """Split-KV decode attention.  Returns (B, 1, H, Dv) in q's dtype,
    plus the (B, Hkv, P) int32 partition execution map over ``block_k``
    partitions with ``return_counts``.  The kernel's own spans are
    ``decode_plan``'s; one launch a call, which may run on several streams
    and inside CUDA graphs (``_arrive``)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len=kv_len, window=window,
                                    scale=scale, block_k=block_k,
                                    return_counts=return_counts)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    _build.refuse_grad("decode_attention", q, k, v)
    b, _, h, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    kc = min(block_k, t)
    np_ = -(-t // kc)
    kvlen = min(int(kv_len), t)

    _build.check_rows4("decode_attention", q)
    _check_rows16("decode_attention", (("k", k, d), ("v", v, dv)))
    shared = _shares_rows(k, v)
    dev = q.device
    key = (dev, b, h, hkv, t, d, dv, q.element_size(), shared)
    plan = _DECODE_PLANS.get(key)
    if plan is None:
        plan = _DECODE_PLANS[key] = decode_plan(b, h, hkv, t, d, dv, q.element_size(),
                                                shared, _build.sm_count(dev))
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=dev)
    part = torch.empty(b * hkv * plan["nspan"] * g * (dv + 2), dtype=torch.float32, device=dev)
    counts = (torch.empty((b, hkv, np_), dtype=torch.int32, device=dev)
              if return_counts else None)
    work = decode_work(b, h, hkv, d, dv, kvlen, q.element_size(), shared, int(window))
    if dev.type == "meta":
        _build.note_work("decode_attention", *work)
        return (out, counts) if return_counts else out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrive = _arrive(lib.decode_attention_capture_id, dev, stream, b * hkv * plan["groups"])
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
        counts.data_ptr() if counts is not None else None, arrive.data_ptr(),
        _DTYPES[q.dtype], b, h, t, hkv, d, dv, plan["span"], plan["chunk"],
        plan["rows_tile"], plan["row_warps"], plan["key_warps"], int(shared),
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(2),
        kvlen, int(window), kc, float(scale if scale is not None else d ** -0.5), stream)
    _build.check(rc, "decode_attention", lib.decode_attention_error_string)
    decode_attention.launches += 1
    _build.note_work("decode_attention", *work)
    return (out, counts) if return_counts else out


decode_attention.launches = 0


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_attention_fwd.argtypes = (
            [P] * 7 + [I] * 13 + [L] * 10 + [I] * 3 + [ctypes.c_float, P])
        lib.decode_attention_fwd.restype = I
        lib.decode_attention_smem_bytes.argtypes = [I] * 8
        lib.decode_attention_smem_bytes.restype = ctypes.c_size_t
        lib.decode_attention_capture_id.argtypes = [P]
        lib.decode_attention_capture_id.restype = ctypes.c_ulonglong
        lib.decode_attention_error_string.argtypes = [I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# ---------------------------------------------------------------------------
# paged variant: KV read through per-sequence block tables
# ---------------------------------------------------------------------------

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PAGED_WARPS = 4     # pages one CTA computes at once, a warp each
SPAN_KEYS = (128, 256)  # keys of one CTA's span: the span the plan shrinks to, the most
MAX_CTAS_PER_SM = 8     # CTAs an SM is counted to hold at most (registers)
_PLANS: dict[tuple, dict] = {}


def paged_partition_counts(pages_per_seq: int, kv_lens, *, page_size: int,
                           window: int = 0):
    """Per-sequence analytic (executed, total) page counts for one
    batched paged decode step — ``decode_partition_counts`` evaluated
    at each sequence's own fill level.  Returns (list[int], total)."""
    t = pages_per_seq * page_size
    executed = [decode_partition_counts(t, int(n), block_k=page_size,
                                        window=window)[0]
                for n in kv_lens]
    return executed, pages_per_seq


def _paged_live(kv_lens, max_pp: int, pg: int, window: int, s: int):
    """(B, max_pp) bool: page ``ip`` is live iff it starts before the
    sequence's length and, with a window, ends inside the OLDEST query
    row's window (the reference's ``executed`` predicate with ``qs``)."""
    k_lo = torch.arange(max_pp, device=kv_lens.device) * pg
    lens = kv_lens.long()[:, None]
    live = k_lo[None, :] < lens
    if window > 0:
        live &= (k_lo[None, :] + pg - 1) > (lens - s - window)
    return live


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, kv_lens, *,
                               window: int = 0, scale: float | None = None,
                               dv: int | None = None, k_scales=None,
                               v_scales=None, return_counts: bool = False):
    """Plain version of the kernel, one partition per page as in the
    reference: gather every block-table page (-1 read as page 0), score
    the position-major rows with the causal / window mask at each row's
    position, per-page partial (o, m, l) with neutral statistics for dead
    pages, then the combine.  P is rounded to the page dtype before the
    PV product for float pages; int8 page scales fold in after the QK
    dot and after the PV dot."""
    b, s, h, d = q.shape
    hkv, num_pages, pg, _ = k_pages.shape
    g, rows = h // hkv, s * (h // hkv)
    dv = v_pages.shape[-1] if dv is None else dv
    scale = scale if scale is not None else d ** -0.5
    max_pp = block_tables.shape[1]
    quantized = k_pages.dtype == torch.int8
    bt = block_tables.long().clamp(0, num_pages - 1)              # (B, P)
    kd = k_pages[:, bt][..., :d].float()                           # (Hkv, B, P, pg, d)
    vd = v_pages[:, bt][..., :dv]
    q3 = (q.float().reshape(b, s, hkv, g, d).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, rows, d))
    s_ = torch.einsum("bhrd,hbpkd->bhprk", q3, kd) * scale
    if quantized:
        s_ = s_ * k_scales[:, bt].permute(1, 0, 2)[..., None, None]
    lens = kv_lens.long()
    cols = torch.arange(max_pp * pg, device=q.device).reshape(max_pp, pg)
    row_pos = (lens[:, None] - s
               + torch.arange(rows, device=q.device)[None, :] // g)  # (B, R)
    mask = cols[None, :, None, :] <= row_pos[:, None, :, None]      # (B, P, R, pg)
    if window > 0:
        mask &= cols[None, :, None, :] > (row_pos[:, None, :, None] - window)
    s_ = s_.masked_fill(~mask[:, None], MASK_VALUE)
    m = s_.amax(-1)                                                # (B, Hkv, P, R)
    p = torch.exp(s_ - m[..., None])
    l = p.sum(-1)
    if quantized:
        pv = torch.einsum("bhprk,hbpkd->bhprd", p, vd.float())
        pv = pv * v_scales[:, bt].permute(1, 0, 2)[..., None, None]
    else:
        pv = torch.einsum("bhprk,hbpkd->bhprd", p.to(vd.dtype).float(), vd.float())
    live = _paged_live(kv_lens, max_pp, pg, window, s)             # (B, P)
    lv = live[:, None, :, None]
    o_part = pv.masked_fill(~lv[..., None], 0.0)
    m_part = m.masked_fill(~lv, float("-inf"))
    l_part = l.masked_fill(~lv, 0.0)
    out = combine_partitions(o_part, m_part, l_part)               # (B, Hkv, R, dv)
    out = (out.reshape(b, hkv, s, g, dv).permute(0, 2, 1, 3, 4)
           .reshape(b, s, h, dv).to(q.dtype))
    if return_counts:
        return out, live.int()[:, None, :].expand(b, hkv, max_pp).contiguous()
    return out


def _check_paged(q, k_pages, v_pages, block_tables, kv_lens, dv, k_scales, v_scales):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode_attention takes float32 or bfloat16 q, got {q.dtype}")
    if k_pages.dtype not in _KV_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must share one of float32, bfloat16, int8; got "
                        f"{k_pages.dtype}/{v_pages.dtype}")
    quantized = k_pages.dtype == torch.int8
    if quantized != (k_scales is not None) or quantized != (v_scales is not None):
        raise ValueError("int8 pools need k_scales AND v_scales; float pools must "
                         "not pass them")
    tensors = [q, k_pages, v_pages, block_tables, kv_lens]
    tensors += [x for x in (k_scales, v_scales) if x is not None]
    if any(x.device != q.device for x in tensors):
        raise ValueError("every input of paged_decode_attention must be on one device")
    if q.dim() != 4 or k_pages.dim() != 4 or v_pages.shape[:3] != k_pages.shape[:3]:
        raise ValueError(f"q is (B, S, H, D), pages (Hkv, num_pages, page, W); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, _, h, d = q.shape
    hkv = k_pages.shape[0]
    if h % hkv or k_pages.shape[3] < d or not 0 < dv <= v_pages.shape[3]:
        raise ValueError(f"H={h}, Hkv={hkv}, D={d}, dv={dv} do not fit pages "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or kv_lens.shape != (b,):
        raise ValueError(f"block_tables is (B, pages_per_seq) and kv_lens (B,); got "
                         f"{tuple(block_tables.shape)}, {tuple(kv_lens.shape)}")
    if quantized and (k_scales.shape != k_pages.shape[:2]
                      or v_scales.shape != k_pages.shape[:2]):
        raise ValueError(f"scales are (Hkv, num_pages) = {tuple(k_pages.shape[:2])}")


def paged_smem_bytes(rows_tile: int, d: int, dv: int, pg: int, span_pages: int,
                     kv_esize: int, warps: int) -> int:
    """Shared memory one CTA of ``csrc/paged_decode_attention.cu`` needs
    (its ``layout``) with ``warps`` page warps: 128 bytes of mbarriers; a
    page slot a warp, its K rows then its V rows (16-byte multiples), at
    least the warps' (o, m, l) for their merge; the f32 query tile; a warp's
    page of logits and its rows' (m, l, factor); the span's page ids and
    scales; the last-CTA flag."""
    krow = _round16(d * kv_esize)
    vrow = _round16(dv * kv_esize)
    slots = warps * pg * (krow + vrow)
    merge = warps * rows_tile * (dv + 2) * 4
    return (128 + _round16(max(slots, merge)) + _round16(rows_tile * d * 4)
            + _round16(warps * rows_tile * pg * 4)
            + _round16(warps * rows_tile * 3 * 4) + 3 * _round16(span_pages * 4) + 16)


def paged_plan(b: int, s: int, h: int, hkv: int, d: int, dv: int, pg: int, max_pp: int,
               kv_esize: int, sms: int) -> dict:
    """The grid of one paged call, from host-known shapes only (the lengths
    stay on the device):

    * ``rows_tile``: the S x G rows split into ``tiles`` of at most
      ``ROW_TILE`` (fewer at wide Dv, ``_row_cap``), so shared memory and
      registers do not grow with the rows;
    * ``warps``: pages a CTA computes at once, a warp each taking every
      ``warps``-th live page of the span: ``PAGED_WARPS``, fewer where their
      slots would not fit in the 227 KiB a CTA may opt in to;
    * ``span_pages``: from ``SPAN_KEYS[1]`` keys of pages a CTA, halved
      while the grid of B x Hkv x tiles x spans CTAs still fits in one wave
      (the CTAs the SMs hold at once, by shared memory) and the span keeps
      ``SPAN_KEYS[0]`` keys, or the grid has fewer than two CTAs an SM.

    Returns the plan with its shared-memory bytes and grid size.  Raises
    ``ValueError`` when one page of K and V does not fit."""
    rows = s * (h // hkv)
    cap = min(ROW_TILE, _row_cap(dv))
    tiles = -(-rows // cap)
    rows_tile = -(-rows // tiles)

    def plan(span):
        warps = min(PAGED_WARPS, span)
        while warps > 1 and paged_smem_bytes(rows_tile, d, dv, pg, span, kv_esize,
                                             warps) > _MAX_SMEM:
            warps -= 1
        smem = paged_smem_bytes(rows_tile, d, dv, pg, span, kv_esize, warps)
        nspan = -(-max_pp // span)
        ctas = b * hkv * tiles * nspan
        wave = sms * max(1, min(MAX_CTAS_PER_SM, _SM_SMEM // (smem + 1024)))
        return dict(rows_tile=rows_tile, tiles=tiles, span_pages=span, nspan=nspan,
                    warps=warps, smem=smem, ctas=ctas, wave=wave)

    cur = plan(max(1, min(max_pp, SPAN_KEYS[1] // pg)))
    while cur["span_pages"] > 1:
        nxt = plan(cur["span_pages"] // 2)
        if nxt["ctas"] > nxt["wave"] or (nxt["span_pages"] * pg < SPAN_KEYS[0]
                                         and cur["ctas"] >= 2 * sms):
            break
        cur = nxt
    if cur["smem"] > _MAX_SMEM:
        raise ValueError(f"paged_decode_attention: one page of {pg} keys at D={d}, Dv={dv} "
                         f"for {rows_tile} rows needs {cur['smem']} B of shared memory, over "
                         f"the 227 KiB ({_MAX_SMEM} B) a CTA may opt in to on Hopper")
    return cur


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_lens, *,
                           window: int = 0, scale: float | None = None,
                           dv: int | None = None, k_scales=None, v_scales=None,
                           return_counts: bool = False):
    """Split-KV decode attention over a paged KV pool.

    q (B, S, H, D): the new tokens' queries (S = 1 decode, S > 1
    speculative verify), their K/V already written, so sequence b's last
    query sits at position ``kv_lens[b] - 1``; k_pages / v_pages
    (Hkv, num_pages, page_size, W); block_tables (B, pages_per_seq) int32,
    -1 past a sequence's pages and for inactive slots; kv_lens (B,) int32
    live counts on the device (0 = inactive slot, output exactly zero).
    ``dv`` reads the leading ``dv`` columns of ``v_pages``.  int8 pools
    pass (Hkv, num_pages) f32 ``k_scales``/``v_scales``.  Returns
    (B, S, H, dv) in q's dtype, plus the (B, Hkv, pages_per_seq) int32
    per-page execution map with ``return_counts``.  Nothing here reads
    the device back: the lengths stay on the device.  Calls may run on
    several streams and inside CUDA graphs (``_arrive``)."""
    dv = v_pages.shape[-1] if dv is None else dv
    _check_paged(q, k_pages, v_pages, block_tables, kv_lens, dv, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, kv_lens, window=window, scale=scale,
            dv=dv, k_scales=k_scales, v_scales=v_scales, return_counts=return_counts)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")
    _build.refuse_grad("paged_decode_attention", q, k_pages, v_pages, k_scales, v_scales)
    b, s, h, d = q.shape
    hkv, num_pages, pg, _ = k_pages.shape
    rows = s * (h // hkv)
    max_pp = block_tables.shape[1]
    if dv % 4:
        raise ValueError(f"paged_decode_attention: dv={dv} must be a multiple of 4")
    _build.check_rows4("paged_decode_attention", q)
    _check_rows16("paged_decode_attention", (("k_pages", k_pages, d),
                                             ("v_pages", v_pages, dv)))
    dev = q.device
    key = (dev, b, s, h, hkv, d, dv, pg, max_pp, k_pages.element_size())
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = paged_plan(b, s, h, hkv, d, dv, pg, max_pp,
                                        k_pages.element_size(), _build.sm_count(dev))
    bt = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    scales = [x.float().contiguous() if x is not None else None
              for x in (k_scales, v_scales)]
    nspan = plan["nspan"]
    out = torch.empty((b, s, h, dv), dtype=q.dtype, device=dev)
    o_part = torch.empty((b, hkv, nspan, rows, dv), dtype=torch.float32, device=dev)
    m_part = torch.empty((b, hkv, nspan, rows), dtype=torch.float32, device=dev)
    l_part = torch.empty((b, hkv, nspan, rows), dtype=torch.float32, device=dev)
    counts = (torch.empty((b, hkv, max_pp), dtype=torch.int32, device=dev)
              if return_counts else None)
    # the lengths stay on the device (reading them would synchronise): the
    # work is counted with every sequence at its table's capacity
    work = paged_work(b, s, h, hkv, d, dv, [max_pp * pg] * b, q.element_size(), max_pp,
                      k_pages.element_size(), _shares_rows(k_pages, v_pages), pg)
    if dev.type == "meta":
        _build.note_work("paged_decode_attention", *work)
        return (out, counts) if return_counts else out
    lib = _paged_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    arrive = _arrive(lib.paged_decode_attention_capture_id, dev, stream,
                     b * hkv * plan["tiles"])
    rc = lib.paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), bt.data_ptr(),
        lens.data_ptr(), *(x.data_ptr() if x is not None else None for x in scales),
        out.data_ptr(), o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
        counts.data_ptr() if counts is not None else None, arrive.data_ptr(),
        _DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype], b, s, h, hkv, d, dv, pg,
        num_pages, max_pp, plan["span_pages"], plan["rows_tile"], plan["warps"],
        q.stride(0), q.stride(1), q.stride(2),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2), bt.stride(0),
        out.stride(0), out.stride(1), out.stride(2),
        int(window), float(scale if scale is not None else d ** -0.5), stream)
    _build.check(rc, "paged_decode_attention", lib.paged_decode_attention_error_string)
    paged_decode_attention.launches += 1
    _build.note_work("paged_decode_attention", *work)
    return (out, counts) if return_counts else out


paged_decode_attention.launches = 0


def _paged_lib():
    lib = _build.load("paged_decode_attention")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.paged_decode_attention_fwd.argtypes = (
            [P] * 13 + [I] * 14 + [L] * 13 + [I, ctypes.c_float, P])
        lib.paged_decode_attention_fwd.restype = I
        lib.paged_decode_attention_smem_bytes.argtypes = [I] * 7
        lib.paged_decode_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_decode_attention_capture_id.argtypes = [P]
        lib.paged_decode_attention_capture_id.restype = ctypes.c_ulonglong
        lib.paged_decode_attention_error_string.argtypes = [I]
        lib.paged_decode_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
