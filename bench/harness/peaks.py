"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its 700 W limit).

Operations in float32 are held against the TF32 tensor-core rate, the
highest rate at which anything multiplies float32 inputs on this card, so
no share of it can pass 100 % whichever path (SIMT, 3xTF32, TF32) a
kernel takes; the SIMT rate is kept for the record.
"""

FLOPS = {"float32": 495e12, "bfloat16": 989e12}
SIMT_FP32_FLOPS = 67e12
BYTES = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(ops / FLOPS[dtype], nbytes / BYTES)
