"""Foundational layers (PyTorch port of ``repro.models.layers``).

Params are plain dicts of tensors with the JAX package's names and
layouts (dense weights (d_in, d_out), embedding table (vocab, d)), so
``repro_torch.convert`` carries the reference's params over unchanged.
Matmuls run in the params' dtype; normalisation statistics, RoPE, SiLU
and softmax in f32.  Initialisers take an explicit ``torch.Generator``
and ``device``.

Attention dispatch (``set_attention_impl``):
  "auto"   — the CUDA kernel for a CUDA tensor, its plain version for a
             CPU tensor (the default; the launcher never changes it)
  "kernel" — the CUDA kernel; a CPU tensor raises
  "ref"    — the plain version on any device (reference runs on the card)
There is no environment switch: the tensor's device decides under "auto".

Tensor parallelism (one process per mesh position, ``dist.tensor``'s
ambient model group): a vocab-split embedding looks up this rank's rows
and sums the ranks' lookups, its tied readout and an untied head give
each rank's vocabulary slice and gather it; a gated MLP with ``w_gate`` /
``w_up`` split by columns and ``w_down`` by rows sums its ranks' outputs,
a row-split layer's bias added once after the sum.  Whether a layer is
split is read from its leaves' widths against the config's.

Quantized dense layers (``{"qw", "qscale"}`` dicts from
``optim.quant.quantize_params``) dispatch the same way through
``set_gemm_impl``: "auto" sends a CUDA tensor to the VTA GEMM kernel
(dequant epilogue) and a CPU tensor to its plain version; "kernel" on a
CPU tensor raises; "ref" runs the plain version on any device.

Measured tuning (``set_tuning``): a ``core.autotune.TuningTable`` whose
``flash_prefill`` entry gives ``flash_attend`` its ``block_q`` /
``block_k`` where the caller leaves them unset, and whose ``serving``
entry gives ``serve.engine.ServingEngine`` its ``page_size`` /
``prefill_chunk``.  A table comes in only through ``set_tuning``, which
the launchers call (``--autotune``, ``--tuning-file``); there is no
environment switch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor as tp
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_ref,
    paged_decode_attention,
    paged_decode_attention_ref,
)
from repro_torch.kernels.flash_attention import (
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    flash_attention,
    flash_attention_diff,
    flash_attention_ref,
)
from repro_torch.kernels.ops import dense_int8
from repro_torch.kernels.vta_gemm import vta_gemm_ref
from repro_torch.optim.quant import quant_int8

# ---------------------------------------------------------------------------
# attention implementation dispatch
# ---------------------------------------------------------------------------

_ATTN_IMPLS = ("auto", "kernel", "ref")
_ATTN_IMPL = "auto"


def set_attention_impl(impl: str) -> str:
    """Select the attention backend; returns the previous setting."""
    global _ATTN_IMPL
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"impl must be one of {_ATTN_IMPLS}, got {impl!r}")
    prev, _ATTN_IMPL = _ATTN_IMPL, impl
    return prev


def attention_impl() -> str:
    return _ATTN_IMPL


def _to_wrapper(impl: str, what: str, x: torch.Tensor) -> bool:
    """True when the call goes to the kernel's wrapper under ``impl``.  A
    ``meta`` tensor (shapes only: the dry-run stand-in) takes the plain
    version."""
    if impl == "ref" or x.device.type == "meta":
        return False
    if impl == "kernel" and x.device.type != "cuda":
        raise RuntimeError(f"{what} impl 'kernel' needs a CUDA tensor, "
                           f"got one on {x.device}")
    return True


def _use_kernel(x: torch.Tensor) -> bool:
    return _to_wrapper(_ATTN_IMPL, "attention", x)


# ---------------------------------------------------------------------------
# quantized-GEMM implementation dispatch (same contract)
# ---------------------------------------------------------------------------

_GEMM_IMPL = "auto"


def set_gemm_impl(impl: str) -> str:
    """Select the quantized-GEMM backend; returns the previous setting."""
    global _GEMM_IMPL
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"impl must be one of {_ATTN_IMPLS}, got {impl!r}")
    prev, _GEMM_IMPL = _GEMM_IMPL, impl
    return prev


def gemm_impl() -> str:
    return _GEMM_IMPL


def use_gemm_kernel(x: torch.Tensor) -> bool:
    """True when an int8 GEMM on ``x`` goes to the VTA GEMM's wrapper
    under ``set_gemm_impl``; False sends it to the plain version."""
    return _to_wrapper(_GEMM_IMPL, "gemm", x)


# ---------------------------------------------------------------------------
# measured-cost tuning dispatch
# ---------------------------------------------------------------------------

# The active ``core.autotune.TuningTable`` (``tune_runtime``'s output), or
# None for the kernels' own defaults.  Explicit call-site arguments always
# win over the table.  Only ``flash_prefill`` and ``serving`` are read:
# the dense decode kernel and the GEMM pick their own tiles.
_TUNING = None


def set_tuning(table) -> object:
    """Install a ``TuningTable`` (or None to untune); returns the
    previous table so callers can restore it."""
    global _TUNING
    prev, _TUNING = _TUNING, table
    return prev


def tuning_table():
    """The active ``TuningTable`` (None = defaults)."""
    return _TUNING


def tuned(kind: str) -> dict:
    """Tuned knobs for one cost kind ({} when untuned)."""
    return _TUNING.get(kind) if _TUNING is not None else {}


# ---------------------------------------------------------------------------
# initializers and linear maps
# ---------------------------------------------------------------------------


def _normal(gen, shape, std, dtype, device):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype, device, bias: bool = False,
               scale: float | None = None):
    if scale is None:
        scale = 1.0 / (d_in ** 0.5)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p, x):
    if "qw" in p:
        return quant_dense_apply(p, x)
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def width(p) -> int:
    """The output width of a dense dict (float ``w`` or int8 ``qw``)."""
    return (p["w"] if "w" in p else p["qw"]).shape[-1]


def row_parallel_apply(p, x):
    """A row-split dense layer: this rank's partial product summed over
    the model group, the bias (replicated) added once after the sum."""
    y = tp.reduce(x @ p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def quant_dense_apply(p, x, act: str | None = None):
    """QuantizedLinear forward: int8 weights (per-output-channel scales)
    against dynamically int8-quantized activations, exact int32
    accumulation, fused dequant -> bias -> ``act``.

    The activation scale is ONE per call, over every row of the
    ``(-1, K)`` matrix (pad rows and idle slots included, as in the
    reference), and folds on the device into the per-column weight
    scales; nothing is read back to the host.  Dispatches to the VTA
    GEMM's wrapper or its plain version (``set_gemm_impl``); the result
    is cast back to ``x.dtype``."""
    lead, k = x.shape[:-1], x.shape[-1]
    qx, sx = quant_int8(x.reshape(-1, k))
    scale = p["qscale"].float() * sx
    bias = p["b"].float() if "b" in p else None
    if use_gemm_kernel(x):
        y = dense_int8(qx, p["qw"], scale, bias=bias, act=act)
    else:
        y = vta_gemm_ref(qx, p["qw"], bias, scale, epilogue="dequant", act=act)
    return y.reshape(*lead, -1).to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype, device):
    return {"table": _normal(gen, (vocab, d), 0.02, dtype, device)}


def embedding_apply(p, ids, vocab: int | None = None):
    """The rows of ``ids``.  A table holding this rank's slice of
    ``vocab`` rows (vocab-parallel) looks up the ids it holds, zeros for
    the rest, and sums the ranks' lookups: exactly one rank adds a
    nonzero row, so the sum is exact."""
    table = p["table"]
    if vocab is None or not tp.split(table.shape[0], vocab):
        return table[ids]
    rows = table.shape[0]
    local = ids - tp.model_rank() * rows
    hit = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype)
    return tp.reduce(x)


def embedding_logits(p, x, vocab: int | None = None):
    """Tied-softmax readout; a vocab-split table gives this rank's slice of
    the logits and gathers the whole."""
    table = p["table"]
    if vocab is None or not tp.split(table.shape[0], vocab):
        return torch.matmul(x, table.T)
    return tp.gather(torch.matmul(tp.copy(x), table.T), -1)


# ---------------------------------------------------------------------------
# normalization, RoPE, MLP
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-float base: no host-to-device copy (which would synchronise
    # the stream) on every call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Half-split
    convention: the first and second halves of head_dim form the pairs."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs    # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]            # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gated_mlp_init(gen, d: int, d_ff: int, dtype, device):
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype, device),
        "w_up": dense_init(gen, d, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d, dtype, device),
    }


def gated_mlp_apply(p, x, d_ff: int | None = None):
    """``w_down(silu(w_gate x) * w_up x)``.  With ``d_ff`` (the config's
    width) a ``w_gate`` holding this rank's columns of it runs the
    tensor-parallel MLP (module docstring)."""
    if "qw" in p["w_gate"]:
        # quantized: SiLU fuses into the gate GEMM's epilogue
        g = quant_dense_apply(p["w_gate"], x, act="silu")
        u = quant_dense_apply(p["w_up"], x)
        return quant_dense_apply(p["w_down"], g * u)
    split = d_ff is not None and tp.split(width(p["w_gate"]), d_ff)
    if split:
        x = tp.copy(x)
    g = F.silu(dense_apply(p["w_gate"], x).float()).to(x.dtype)
    u = dense_apply(p["w_up"], x)
    if split:
        return row_parallel_apply(p["w_down"], g * u)
    return dense_apply(p["w_down"], g * u)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def causal_mask(q_len: int, kv_len: int, *, window: int = 0,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """Boolean mask (q_len, kv_len): True = attend.  ``q_offset`` is the
    absolute position of query 0; ``window`` > 0 is sliding-window."""
    q_pos = torch.arange(q_len, device=device) + q_offset
    kv_pos = torch.arange(kv_len, device=device)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    return mask


def softmax_attend(q, k, v, mask=None, *, scale: float | None = None):
    """q: (B,S,H,D)  k/v: (B,T,Hkv,D[v]) with H % Hkv == 0 (GQA).
    ``mask``: (S, T) boolean, True = attend; None = full attention.
    f32 softmax; returns (B,S,H,Dv)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def flash_attend(q, k, v, *, q_offset: int = 0, window: int = 0,
                 bidirectional: bool = False, scale: float | None = None,
                 kv_len: int | None = None, block_q: int | None = None,
                 block_k: int | None = None):
    """Tiled online-softmax attention; never materialises (S, T) logits.

    q: (B,S,H,D); k/v: (B,T,Hkv,Dv).  ``q_offset``: absolute position of
    query 0; ``kv_len``: live prefix of a padded cache (host ints).
    ``block_q`` / ``block_k`` set the kernel's grid; left None they
    resolve through the tuning table (``set_tuning``), else the kernel's
    defaults (64 / 64).  The plain version's result does not depend on
    them.  Dispatches to the flash kernel's wrapper or its plain version
    (``set_attention_impl``); with grad enabled and an input that requires
    it, the kernel's route is ``flash_attention_diff`` (the kernel forward,
    the plain version's backward).
    """
    if _use_kernel(q):
        t = tuned("flash_prefill")
        if block_q is None:
            block_q = int(t.get("block_q", DEFAULT_BLOCK_Q))
        if block_k is None:
            block_k = int(t.get("block_k", DEFAULT_BLOCK_K))
        kw = dict(q_offset=q_offset, kv_len=kv_len, window=window,
                  bidirectional=bidirectional, scale=scale, block_q=block_q,
                  block_k=block_k)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_diff(q, k, v, **kw)
        return flash_attention(q, k, v, **kw)
    return flash_attention_ref(q, k, v, q_offset=q_offset, window=window,
                               bidirectional=bidirectional, scale=scale,
                               kv_len=kv_len)


def decode_attend(q, k, v, *, kv_len: int, window: int = 0,
                  scale: float | None = None):
    """Single-token decode attention over a padded KV cache.

    q: (B,1,H,D); k/v: (B,T,Hkv,D[v]) with the new token's K/V already
    written, so the query sits at position ``kv_len - 1`` (a host int).
    Dispatches to the split-KV kernel's wrapper or its plain version
    (``set_attention_impl``).
    """
    if _use_kernel(q):
        return decode_attention(q, k, v, kv_len=kv_len, window=window, scale=scale)
    return decode_attention_ref(q, k, v, kv_len=kv_len, window=window, scale=scale)


def paged_decode_attend(q, k_pages, v_pages, block_tables, kv_lens, *,
                        window: int = 0, scale: float | None = None,
                        dv: int | None = None, k_scales=None, v_scales=None):
    """Decode attention over a paged KV pool (S=1 decode; S>1 verifies
    S consecutive positions per sequence, the speculative-decoding
    verify step).

    q: (B,S,H,D) — query s of sequence b sits at ``kv_lens[b] - S + s``;
    k_pages/v_pages: (Hkv, num_pages, page_size, W) shared pools;
    block_tables: (B, pages_per_seq) int32 page ids (-1 past a
    sequence's pages and for inactive slots); kv_lens: (B,) int32 live
    counts INCLUDING the just-written token(s), on the device (0 =
    inactive slot, output exactly zero).  ``dv`` restricts values to the
    leading columns of ``v_pages``.  Dispatches to the paged kernel's
    wrapper or its plain version (``set_attention_impl``); the plain
    version computes what the reference's ``paged_decode_attend_ref``
    does, page by page as the kernel.
    """
    kw = dict(window=window, scale=scale, dv=dv, k_scales=k_scales, v_scales=v_scales)
    if _use_kernel(q):
        return paged_decode_attention(q, k_pages, v_pages, block_tables, kv_lens, **kw)
    return paged_decode_attention_ref(q, k_pages, v_pages, block_tables, kv_lens, **kw)
