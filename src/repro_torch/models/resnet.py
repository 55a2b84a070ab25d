"""ResNet-18 — the paper's evaluation workload (PyTorch port of
``repro.models.resnet``).

Params are the reference's tree of plain dicts, ``{"stem": {"conv",
"bn"}, "stages": [[block, ...], ...], "fc": {"w", "b"}}``, with its
layouts: conv weights HWIO, images NHWC ``(B, H, W, 3)``, logits
``(B, num_classes)``.  ``repro_torch.convert.resnet_params_from_numpy``
carries the reference's params over.

* Convolutions are ``F.conv2d`` (cuDNN on the card), as the reference
  leaves them to ``lax.conv_general_dilated`` outside any Pallas kernel;
  the NHWC activations and HWIO weights are permuted to its layout at use.
  Padding is the reference's ``"SAME"``: ``total = max((ceil(h / s) - 1)
  * s + k - h, 0)``, the smaller half before.  That split is asymmetric
  where ``total`` is odd (the 224 x 224 stem pads (2, 3), a 3x3 / 2 conv
  (0, 1)), which ``F.conv2d``'s symmetric ``padding=`` cannot express, so
  such inputs are padded explicitly.
* f32 convolutions run in full f32: cuDNN takes TF32 for them by default
  (``torch.backends.cudnn.allow_tf32``), so ``_conv`` switches it off
  around an f32 convolution on the card and restores it (bf16 and f64
  convolutions have no TF32 mode and leave it alone).
* The 3x3 / 2 max-pool pads with -inf by the same SAME rule ((0, 1) at
  112), which ``F.max_pool2d(padding=1)`` would not give.
* Batch norm is inference-mode with running statistics: ``mean`` / ``var``
  stay f32 in every dtype, the arithmetic is f32 (f64 for an f64 model, so
  that an f64 run can serve as a reference), the result is cast back.
* The fc head is ``layers.dense_apply``, so a tree packed by
  ``optim.quant.quantize_params`` (which packs ``fc`` only: convs are 4-D,
  BN leaves 1-D) runs it on the VTA GEMM's dequant kernel.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_apply

STAGES = [(2, 64, 1), (2, 128, 2), (2, 256, 2), (2, 512, 2)]


def _conv_init(gen, k, cin, cout, dtype, device):
    fan_in = k * k * cin
    w = torch.randn((k, k, cin, cout), generator=gen, dtype=torch.float32, device=device)
    return {"w": (w * (2.0 / fan_in) ** 0.5).to(dtype)}


def _bn_init(c, dtype, device):
    return {
        "scale": torch.ones((c,), dtype=dtype, device=device),
        "bias": torch.zeros((c,), dtype=dtype, device=device),
        "mean": torch.zeros((c,), dtype=torch.float32, device=device),
        "var": torch.ones((c,), dtype=torch.float32, device=device),
    }


def init(generator: torch.Generator, num_classes: int = 1000, dtype=torch.float32,
         device="cuda"):
    """Random params from ``generator`` (on ``device``), in the reference's
    tree, shapes and dtypes; the values differ from its PRNG init."""
    fc = torch.randn((512, num_classes), generator=generator, dtype=torch.float32,
                     device=device) * 0.01
    params = {
        "stem": {"conv": _conv_init(generator, 7, 3, 64, dtype, device),
                 "bn": _bn_init(64, dtype, device)},
        "stages": [],
        "fc": {"w": fc.to(dtype), "b": torch.zeros((num_classes,), dtype=dtype, device=device)},
    }
    cin = 64
    for blocks, cout, stride0 in STAGES:
        stage = []
        for bi in range(blocks):
            stride = stride0 if bi == 0 else 1
            blk = {
                "conv1": _conv_init(generator, 3, cin, cout, dtype, device),
                "bn1": _bn_init(cout, dtype, device),
                "conv2": _conv_init(generator, 3, cout, cout, dtype, device),
                "bn2": _bn_init(cout, dtype, device),
            }
            if stride != 1 or cin != cout:
                blk["down"] = _conv_init(generator, 1, cin, cout, dtype, device)
                blk["down_bn"] = _bn_init(cout, dtype, device)
            stage.append(blk)
            cin = cout
        params["stages"].append(stage)
    return params


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of one spatial axis under the reference's
    ``"SAME"``: the output is ``ceil(size / stride)`` long and the smaller
    half of the total goes before."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _ieee_f32(x):
    """cuDNN convolutions of ``x`` in full f32 inside the block: TF32 is
    switched off (and back) for an f32 ``x`` on the card only, the one
    case where cuDNN would take it."""
    cudnn = torch.backends.cudnn
    if x.dtype != torch.float32 or not x.is_cuda or not cudnn.allow_tf32:
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


def _conv(p, x, stride):
    """SAME convolution of NHWC ``x`` with the HWIO weight ``p["w"]``."""
    w = p["w"]
    (pt, pb), (pl, pr) = (same_pads(x.shape[1], w.shape[0], stride),
                          same_pads(x.shape[2], w.shape[1], stride))
    xn = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels-last)
    padding = (pt, pl)
    if (pt, pl) != (pb, pr):
        xn, padding = F.pad(xn, (pl, pr, pt, pb)), 0
    with _ieee_f32(xn):
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def _bn(p, x, eps: float = 1e-5):
    """Inference batch norm in f32 (f64 for an f64 run), cast back."""
    ct = torch.promote_types(x.dtype, torch.float32)
    y = (x.to(ct) - p["mean"].to(ct)) * torch.rsqrt(p["var"].to(ct) + eps)
    return (y * p["scale"].to(ct) + p["bias"].to(ct)).to(x.dtype)


def _max_pool(x):
    """3x3 / 2 max-pool of NHWC ``x`` with SAME padding of -inf."""
    (pt, pb), (pl, pr) = same_pads(x.shape[1], 3, 2), same_pads(x.shape[2], 3, 2)
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(xn, 3, 2).permute(0, 2, 3, 1)


def forward(params, images):
    """images (B, H, W, 3) NHWC -> logits (B, num_classes)."""
    x = _conv(params["stem"]["conv"], images, 2)
    x = torch.relu(_bn(params["stem"]["bn"], x))
    x = _max_pool(x)
    for stage in params["stages"]:
        for blk in stage:
            # in ResNet-18 a block downsamples (stride 2) iff it has a
            # projection shortcut (stages 2-4, first block)
            stride = 2 if "down" in blk else 1
            shortcut = x
            h = torch.relu(_bn(blk["bn1"], _conv(blk["conv1"], x, stride)))
            h = _bn(blk["bn2"], _conv(blk["conv2"], h, 1))
            if "down" in blk:
                shortcut = _bn(blk["down_bn"], _conv(blk["down"], x, stride))
            x = torch.relu(h + shortcut)
    x = x.mean(dim=(1, 2))
    # dense_apply, so a quantize_params-packed fc head runs the dequant kernel
    return dense_apply(params["fc"], x)
