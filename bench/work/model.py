"""The model's operations per token, for the whole step's share of the
chip's peak.

Counted once, from the configuration's widths (a dense grouped-query
decoder): two operations per weight of every matrix a token passes
through, attention over the token's context (``2 * heads * context *
(Dqk + Dv)``), and the head for each token whose logits are read.
"""

from __future__ import annotations


def per_token(c: dict) -> tuple[int, int]:
    """(operations of one token outside attention's scores, operations per
    key of its context), summed over the layers, the head left out."""
    d, h, hkv, hd = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
    layer = 2 * d * h * hd + 2 * d * hkv * hd + 3 * d * c["intermediate_size"]
    n = c["num_hidden_layers"]
    return 2 * n * layer, 2 * n * h * 2 * hd


def head(c: dict) -> int:
    return 2 * c["hidden_size"] * c["vocab_size"]


def tokens(c: dict, first_ctx: int, count: int) -> int:
    """Operations of ``count`` consecutive tokens whose contexts are
    ``first_ctx .. first_ctx + count - 1`` keys, no head."""
    flat, per_key = per_token(c)
    ctx_sum = count * first_ctx + count * (count - 1) // 2
    return count * flat + per_key * ctx_sum
