"""The VTA ALU: the CUDA kernel's wrapper and its plain version.

``vta_alu`` takes the contract of ``repro.kernels.vta_alu.vta_alu``:
element-wise ops of VTA's register-file datapath on int32 tensors (the
GEMM's accumulators: bias adds, max / min pooling steps, ReLU, the
requantizing shift) —

* binary (``_BINARY``): ``add`` (x + y, wrapping at 2**32 as XLA's int32
  add does), ``max``, ``min``; ``y`` must have ``x``'s shape;
* unary (``_UNARY``): ``add_imm`` (x + imm, wrapping), ``max_imm``
  (max(x, imm)), ``relu`` (max(x, 0)), ``shr`` (arithmetic x >> shift).

An operand is int8 (VTA's input type) or int32 (its accumulator type);
an int8 operand is widened to int32, as the reference's
``astype(jnp.int32)``, by the kernel as it loads it; the output is int32.  A negative shift
raises and a shift past 31 is clamped to 31, where an arithmetic shift of
an int32 is all sign bits (the reference's ``shift_right_arithmetic``
there); an ``imm`` outside the int32 range raises.

On a CUDA tensor it launches ``csrc/vta_alu.cu`` (one flat pass, two
int4 vectors a thread, no loop, the tail in the last CTA, the op a
template parameter) or raises; on a CPU tensor it runs the plain
version, ``vta_alu_ref``.  The kernel covers any shape, so ``block`` is
accepted for parity with the reference (whose Pallas grid needs M a
block multiple) and changes nothing.

Each op counts its own launches in ``vta_alu.launches`` (a dict keyed by
op): they replace the two ``pl.pallas_call``s (binary and unary).

On a ``meta`` tensor (the dry-run stand-in, ``launch.dryrun``) the wrapper
runs everything but the launch: its checks, the operands made contiguous
and the allocation of its output, and it tells ``launch.counters`` the
call's analytic work (:func:`alu_work`, as it does where it launches); it
counts no launch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.vta_gemm import _shift

_BINARY = ("add", "max", "min")
_UNARY = ("add_imm", "max_imm", "relu", "shr")
OPS = {op: i for i, op in enumerate(_BINARY + _UNARY)}  # the kernel's op ids
INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1
DTYPES = (torch.int8, torch.int32)  # the kernel's operand types


def alu_work(n: int, x_esize: int, y_esize: int = 0) -> tuple[int, int]:
    """Operations and bytes one ALU call needs: one operation an element;
    each operand read once (``y_esize`` 0 for a unary op), the int32
    output written once."""
    return n, (x_esize + y_esize + 4) * n


def vta_alu_ref(x, y=None, op: str = "add", imm: int = 0, shift: int = 0):
    """Plain version: the reference's ``alu_ref`` (``repro.kernels.ref``)
    with the int32 wrap of the adds written out (a sum in int64, cast
    back to int32)."""
    xi = x.to(torch.int32)
    yi = y.to(torch.int32) if y is not None else None
    if op == "add":
        return (xi.to(torch.int64) + yi).to(torch.int32)
    if op == "max":
        return torch.maximum(xi, yi)
    if op == "min":
        return torch.minimum(xi, yi)
    if op == "add_imm":
        return (xi.to(torch.int64) + imm).to(torch.int32)
    if op == "max_imm":
        return torch.clamp_min(xi, imm)
    if op == "relu":
        return torch.clamp_min(xi, 0)
    if op == "shr":
        return xi >> _shift(shift)
    raise ValueError(f"unknown ALU op {op!r}")


def _check(x, y, op, imm, shift):
    if op not in OPS:
        raise ValueError(f"unknown ALU op {op!r}")
    for t in (x, y):
        if t is not None and t.dtype not in DTYPES:
            raise TypeError(f"vta_alu takes int8 or int32 tensors, got {t.dtype}")
    if op in _BINARY:
        if y is None or y.shape != x.shape:
            raise ValueError(f"binary ALU op {op!r} needs y of x's shape {tuple(x.shape)}, "
                             f"got {None if y is None else tuple(y.shape)}")
        if y.device != x.device:
            raise ValueError("vta_alu's operands must be on one device")
    if not INT32_MIN <= int(imm) <= INT32_MAX:
        raise ValueError(f"imm must fit in int32, got {imm}")
    _shift(shift)


def vta_alu(x, y=None, *, op: str = "add", imm: int = 0, shift: int = 0,
            block: int = 256):
    """Element-wise VTA ALU op over int tensors (any shape).  Returns int32
    of ``x``'s shape."""
    del block  # the kernel's grid is its own
    _check(x, y, op, imm, shift)
    if op in _UNARY:
        y = None
    if x.device.type == "cpu":
        return vta_alu_ref(x, y, op, imm=imm, shift=shift)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"vta_alu runs on cuda or cpu, not {x.device}")
    x = x.contiguous()
    y = y.contiguous() if y is not None else None
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    n = out.numel()
    if n == 0:
        return out
    work = alu_work(n, x.element_size(), y.element_size() if y is not None else 0)
    if x.device.type == "meta":
        _build.note_work(f"vta_alu_{op}", *work)
        return out
    lib = _lib()
    rc = lib.vta_alu_fwd(x.data_ptr(), y.data_ptr() if y is not None else None,
                         out.data_ptr(), n, OPS[op], x.element_size(),
                         y.element_size() if y is not None else 0, int(imm), _shift(shift),
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "vta_alu", lib.vta_alu_error_string)
    vta_alu.launches[op] += 1
    _build.note_work(f"vta_alu_{op}", *work)
    return out


vta_alu.launches = {op: 0 for op in OPS}


def _lib():
    lib = _build.load("vta_alu")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.vta_alu_fwd.argtypes = [P, P, P, ctypes.c_longlong, I, I, I, I, I, P]
        lib.vta_alu_fwd.restype = I
        lib.vta_alu_error_string.argtypes = [I]
        lib.vta_alu_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
