"""Public wrappers around the VTA GEMM and ALU kernels (PyTorch port of
``repro.kernels.ops``).

Conv-as-GEMM lowering (im2col — how VTA executes 2D convolutions on its
GEMM core), the quantization helper, the dense entry points and the ALU,
with the reference's names and layouts (NHWC activations, HWIO weights,
SAME padding).  The reference pads every operand to block multiples
before its Pallas calls; the port's kernels cover ragged shapes
themselves, so nothing is padded or sliced here.  ``BLOCK_PRESETS`` (the
paper's Table I and §IV accelerator configurations) and ``block`` are
accepted for parity and do not change the result: the CUDA kernels'
tiles are their own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.vta_alu import vta_alu
from repro_torch.kernels.vta_gemm import vta_gemm

BLOCK_PRESETS = {
    "table1": dict(block_m=128, block_n=128, block_k=128),
    "section4_big": dict(block_m=128, block_n=256, block_k=256),
}


def quantize(x, scale):
    """f32 -> int8 symmetric quantization (clips to [-128, 127], unlike
    ``optim.quant``'s symmetric [-127, 127])."""
    return torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)


def matmul_int8(a, w, *, preset: str = "table1", **block_overrides):
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, arbitrary shapes."""
    blocks = dict(BLOCK_PRESETS[preset], **block_overrides)
    return vta_gemm(a, w, **blocks)


def dense_int8(a, w, scale, bias=None, *, act=None, preset: str = "table1",
               **block_overrides):
    """Quantized dense layer with the fused dequant -> bias -> act
    epilogue (the serving-path GEMM): (M, N) f32."""
    blocks = dict(BLOCK_PRESETS[preset], **block_overrides)
    return vta_gemm(a, w, bias=bias, scale=scale, epilogue="dequant", act=act,
                    **blocks)


def dense_requant_int8(a, w, bias, *, shift: int = 8, relu: bool = True,
                       preset: str = "table1"):
    """Fully int8 pipeline: GEMM + bias + shift-requant (+ReLU) -> int8."""
    return vta_gemm(a, w, bias=bias, epilogue="requant", shift=shift, relu=relu,
                    **BLOCK_PRESETS[preset])


def _im2col(x, kh: int, kw: int, stride: int):
    """NHWC -> (N*HO*WO, KH*KW*C) patches, SAME padding (the reference's
    split of the padding: the smaller half before)."""
    n, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    ph, pw = (ho - 1) * stride + kh - h, (wo - 1) * stride + kw - w
    pt, pb = max(ph // 2, 0), max(ph - ph // 2, 0)
    pl_, pr = max(pw // 2, 0), max(pw - pw // 2, 0)
    xp = F.pad(x, (0, 0, pl_, pr, pt, pb))
    cols = [xp[:, i:i + (ho - 1) * stride + 1:stride, j:j + (wo - 1) * stride + 1:stride]
            for i in range(kh) for j in range(kw)]
    patches = torch.cat(cols, dim=-1)  # (N, HO, WO, KH*KW*C)
    return patches.reshape(n * ho * wo, kh * kw * c), ho, wo


def pack_conv_weight(w):
    """An HWIO (KH, KW, C, F) int8 conv weight with the same shape and
    values, laid out so that :func:`vta_conv2d`'s ``(KH*KW*C, F)`` view
    of it is K-major (strides (1, K)), the layout the VTA GEMM kernel
    streams at rate: a permuted view of an (F, KH, KW, C)-contiguous
    tensor.  Pack a weight once, where it is made."""
    return w.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


def vta_conv2d(x, w, *, stride: int = 1, preset: str = "table1"):
    """2D convolution on the VTA GEMM core via im2col (SAME padding).
    x (N, H, W, C) int8, w (KH, KW, C, F) int8; returns int32 NHWC.
    A weight from :func:`pack_conv_weight` reaches the kernel K-major; a
    contiguous HWIO weight takes its slower N-contiguous path."""
    n = x.shape[0]
    kh, kw, c, f = w.shape
    patches, ho, wo = _im2col(x, kh, kw, stride)
    out = matmul_int8(patches, w.reshape(kh * kw * c, f), preset=preset)
    return out.reshape(n, ho, wo, f)


def alu(x, y=None, **kw):
    """The VTA ALU over (M, N) int8 or int32 tensors (``vta_alu``'s ops, ``imm`` and
    ``shift``).  The kernel covers any M, so nothing is padded; ``block``
    is accepted and changes nothing."""
    return vta_alu(x, y, **kw)


__all__ = [
    "BLOCK_PRESETS",
    "alu",
    "dense_int8",
    "dense_requant_int8",
    "matmul_int8",
    "pack_conv_weight",
    "quantize",
    "vta_conv2d",
]
