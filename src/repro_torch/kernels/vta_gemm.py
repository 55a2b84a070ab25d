"""The VTA GEMM core: the CUDA kernel's wrapper and its plain version.

``vta_gemm`` takes the contract of ``repro.kernels.vta_gemm.vta_gemm``:
int8 a (M, K) x int8 w (K, N) with exact int32 accumulation, then one of
three epilogues —

* ``"none"``: the int32 (M, N) accumulator;
* ``"requant"``: + int32 bias (N,), arithmetic right shift by ``shift``
  (rounding toward -inf), ReLU when ``relu``, clip to [-128, 127], int8;
* ``"dequant"``: x f32 per-column ``scale`` (N,), + optional f32 bias,
  then ``act`` (None/"none", "relu", "silu", "gelu" — the tanh form, as
  ``jax.nn.gelu``), f32.

On a CUDA tensor it launches ``csrc/vta_gemm.cu`` (pipelined int8
tensor-core MMAs, the epilogue a template parameter of one kernel) or
raises; on a CPU tensor it runs the plain version, ``vta_gemm_ref``.  ``w``
may be K-major — a (K, N) view with strides (1, K) of an (N, K)-contiguous
tensor, as ``optim.quant`` packs the model's weights, the layout the
kernel streams at rate — or N-contiguous (strides (N, 1), as the reference
lays it out), which the kernel takes on a slower path that gathers each
fragment bytewise; the values and results are the same.  The kernel
masks its own ragged edges, so M, N and K are arbitrary: ``block_m``/
``block_n``/``block_k`` are accepted for parity with the reference (whose
Pallas grid needs block multiples) and change nothing.  Shifts are clamped to
[0, 31], where an arithmetic shift of an int32 is all sign bits — the
reference's ``shift_right_arithmetic`` there.

Each epilogue counts its own launches in ``vta_gemm.launches`` (a dict
keyed by epilogue): they replace three ``pl.pallas_call``s.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

EPILOGUES = {"none": 0, "requant": 1, "dequant": 2}
ACTS = {None: 0, "none": 0, "relu": 1, "silu": 2, "gelu": 3}
# the kernel's two CTA tiles (M x N) and its K step
_LARGE_TILE, _SMALL_TILE, _TILE_K = (128, 128), (64, 64), 64
_SPLIT_MIN_STEPS = 16  # K steps a tile needs before split-K pays (K >= 1024)


def apply_act(y, act):
    """The dequant epilogue's nonlinearity (f32 in, f32 out), written out
    step by step in the kernel's order of roundings (silu as PyTorch's
    ``x / (1 + exp(-x))``; gelu in the tanh form, as ``jax.nn.gelu``)."""
    if act is None or act == "none":
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "silu":
        return y / (1.0 + torch.exp(-y))
    if act == "gelu":
        inner = 0.7978845608028654 * (y + 0.044715 * (y * y * y))
        return 0.5 * y * (1.0 + torch.tanh(inner))
    raise ValueError(f"unknown epilogue act {act!r}")


def gemm_int32(a, w):
    """Exact int8 x int8 -> int32 product on any device.  The product runs
    in f64 (there is no int32 matmul on CUDA): every partial sum is an
    integer below 128 * 128 * K < 2**53, so f64 holds it exactly in any
    summation order.  (f32 would not: at K = 3072, 128**2 * K > 2**24.)"""
    return torch.matmul(a.double(), w.double()).to(torch.int32)


def vta_gemm_ref(a, w, bias=None, scale=None, *, epilogue: str = "none",
                 shift: int = 8, relu: bool = True, act=None):
    """Plain version of the kernel: the same product and epilogue, with
    the dequant step rounded as the kernel rounds it (int -> f32, one
    product, one sum)."""
    acc = gemm_int32(a, w)
    if epilogue == "none":
        return acc
    if epilogue == "requant":
        v = (acc + bias.to(torch.int32)[None, :]) >> _shift(shift)
        if relu:
            v = torch.clamp_min(v, 0)
        return torch.clamp(v, -128, 127).to(torch.int8)
    if epilogue == "dequant":
        y = acc.float() * scale.float()[None, :]
        if bias is not None:
            y = y + bias.float()[None, :]
        return apply_act(y, act)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def _shift(shift: int) -> int:
    if shift < 0:
        raise ValueError(f"shift must be >= 0, got {shift}")
    return min(int(shift), 31)


def _check(a, w, bias, scale, epilogue, act):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if act not in ACTS:
        raise ValueError(f"unknown epilogue act {act!r}")
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"vta_gemm takes int8 a and w, got {a.dtype}/{w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"a (M, K) and w (K, N) expected, got {tuple(a.shape)} "
                         f"and {tuple(w.shape)}")
    n = w.shape[1]
    if epilogue == "requant" and (bias is None or bias.shape != (n,)):
        raise ValueError("the requant epilogue needs an int32 bias of shape (N,)")
    if epilogue == "dequant":
        if scale is None or scale.shape != (n,):
            raise ValueError("the dequant epilogue needs an f32 scale of shape (N,)")
        if bias is not None and bias.shape != (n,):
            raise ValueError(f"bias must be (N,) = ({n},), got {tuple(bias.shape)}")
    for x in (w, bias, scale):
        if x is not None and x.device != a.device:
            raise ValueError("vta_gemm's operands must be on one device")


def _tile(m: int, n: int, sms: int) -> tuple[int, int]:
    """The CTA tile: 128 x 128 when those tiles alone fill at least half
    the SMs (M 2048), else 64 x 64 (M 512, decode rows)."""
    bm, bn = _LARGE_TILE
    return _LARGE_TILE if 2 * -(-m // bm) * -(-n // bn) >= sms else _SMALL_TILE


def _splits(m: int, n: int, k: int, sms: int) -> tuple[int, int]:
    """K splits per output tile and the K range of one split (a multiple
    of the kernel's K step): split only when the tiles alone would leave
    more than half the SMs idle (decode's few rows) and each tile has at
    least ``_SPLIT_MIN_STEPS`` K steps to share (a split costs a memset and
    a second launch), aiming at two CTAs per SM."""
    bm, bn = _tile(m, n, sms)
    tiles = -(-m // bm) * -(-n // bn)
    nk = max(1, -(-k // _TILE_K))
    few = 2 * tiles > sms or nk < _SPLIT_MIN_STEPS
    splits = 1 if few else min(nk, -(-2 * sms // tiles))
    per = -(-nk // splits)
    return -(-nk // per), per * _TILE_K


def w_layout(w) -> tuple[bool, int]:
    """(K-major, stride): a K-major (K, N) ``w`` (strides (1, ldw)) or an
    N-contiguous one (strides (ldw, 1)); anything else raises."""
    k, n = w.shape
    if k == 1 or w.stride(0) == 1:
        return True, w.stride(1)
    if n == 1 or w.stride(1) == 1:
        return False, w.stride(0)
    raise ValueError(f"vta_gemm takes w K-major (strides (1, K)) or N-contiguous "
                     f"(strides (N, 1)), got strides {w.stride()}")


def vta_gemm(a, w, bias=None, scale=None, *, block_m: int = 128,
             block_n: int = 128, block_k: int = 128, epilogue: str = "none",
             shift: int = 8, relu: bool = True, act=None):
    """Blocked VTA GEMM with a fused epilogue.  Returns (M, N) int32
    ("none"), int8 ("requant") or f32 ("dequant")."""
    del block_m, block_n, block_k  # the kernel's tile is its own
    _check(a, w, bias, scale, epilogue, act)
    if a.device.type == "cpu":
        return vta_gemm_ref(a, w, bias, scale, epilogue=epilogue, shift=shift,
                            relu=relu, act=act)
    if a.device.type != "cuda":
        raise ValueError(f"vta_gemm runs on cuda or cpu, not {a.device}")
    _build.refuse_grad("vta_gemm", a, w, bias, scale)
    m, k = a.shape
    n = w.shape[1]
    out_dtype = {"none": torch.int32, "requant": torch.int8,
                 "dequant": torch.float32}[epilogue]
    dev = a.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if a.stride(1) != 1 and k > 1:
        raise ValueError(f"vta_gemm takes a with contiguous rows, got strides "
                         f"{a.stride()}")
    kmajor, ldw = w_layout(w)
    if epilogue == "requant":
        bias = bias.to(torch.int32).contiguous()
    elif epilogue == "dequant":
        scale = scale.to(torch.float32).contiguous()
        if bias is not None:
            bias = bias.to(torch.float32).contiguous()
    sms = _build.sm_count(dev)
    splits, per = _splits(m, n, k, sms)
    ws = torch.empty((m, n), dtype=torch.int32, device=dev) if splits > 1 else None
    lib = _lib()
    rc = lib.vta_gemm_fwd(
        a.data_ptr(), w.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        scale.data_ptr() if scale is not None else None,
        out.data_ptr(), ws.data_ptr() if ws is not None else None,
        m, n, k, a.stride(0), ldw, int(kmajor), EPILOGUES[epilogue],
        _shift(shift), int(bool(relu)), ACTS[act],
        int(_tile(m, n, sms) == _LARGE_TILE), splits, per,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "vta_gemm", lib.vta_gemm_error_string)
    vta_gemm.launches[epilogue] += 1
    return out


vta_gemm.launches = {"none": 0, "requant": 0, "dequant": 0}


def _lib():
    lib = _build.load("vta_gemm")
    if not getattr(lib, "_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vta_gemm_fwd.argtypes = [P] * 6 + [I] * 3 + [L] * 2 + [I] * 8 + [P]
        lib.vta_gemm_fwd.restype = I
        lib.vta_gemm_error_string.argtypes = [I]
        lib.vta_gemm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
