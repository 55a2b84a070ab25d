"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a wrapper,
a plain PyTorch version and an execution-map oracle.

* ``flash_attention`` — causal / sliding-window / bidirectional flash
  prefill with dead-tile skipping (replaces the Pallas ``flash_attention``).
* ``decode_attention`` — split-KV flash decoding for S=1 steps over a
  padded cache (replaces the Pallas ``decode_attention``).
* ``paged_decode_attention`` — split-KV decode (S=1) and speculative
  verify (S>1) over paged pools through block tables (replaces the
  Pallas ``paged_decode_attention``).
* ``vta_gemm`` — the VTA GEMM core: int8 x int8 with exact int32 sums on
  the int8 tensor cores and the ``none`` / ``requant`` / ``dequant``
  epilogues (replaces the Pallas ``vta_gemm``);
* ``vta_alu`` — the VTA ALU: element-wise int32 add / max / min and their
  immediate, ReLU and shift forms in one flat pass (replaces the Pallas
  ``vta_alu``).

``ops`` wraps the two VTA kernels as the reference's ``kernels.ops`` does.

Model code reaches them through ``repro_torch.models.layers.flash_attend``,
``decode_attend``, ``paged_decode_attend`` and ``quant_dense_apply``.
"""

from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_partition_counts,
    paged_decode_attention,
    paged_decode_attention_ref,
    paged_partition_counts,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_tile_counts
from repro_torch.kernels.vta_alu import vta_alu, vta_alu_ref
from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref

__all__ = [
    "decode_attention",
    "decode_partition_counts",
    "flash_attention",
    "flash_tile_counts",
    "paged_decode_attention",
    "paged_decode_attention_ref",
    "paged_partition_counts",
    "vta_alu",
    "vta_alu_ref",
    "vta_gemm",
    "vta_gemm_ref",
]
