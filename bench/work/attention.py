"""Operations and bytes of the two attention kernels, from the traffic's
shapes and the configuration's widths (grouped-query attention).

Counted once, as the algorithm needs them for these inputs: every
visible (query, key) pair costs ``2 * (D + Dv)`` operations per head; the
queries, the live keys and values and the output are each moved once.
Rows that the program pads a chunk with are not counted, nor are idle
decode slots; a document's whole pages, which every row that starts with
it reads from the same pool pages, count once in a decode call.
"""

from __future__ import annotations

ESIZE = {"float32": 4, "bfloat16": 2}


def paged_decode(c: dict, kv_lens: list, unique_keys: int) -> tuple[int, int]:
    """(operations, bytes) of one batched decode call in one layer: rows
    attending ``kv_lens`` keys each, over ``unique_keys`` distinct keys
    (rows that share a document's pages read them once)."""
    e, h, d = ESIZE[c["dtype"]], c["num_attention_heads"], c["head_dim"]
    key_bytes = unique_keys * c["num_key_value_heads"] * 2 * d
    ops = h * sum(kv_lens) * 2 * 2 * d
    return ops, e * (len(kv_lens) * h * 2 * d + key_bytes)


def flash_prefill(c: dict, q_offset: int, rows: int) -> tuple[int, int]:
    """(operations, bytes) of ``rows`` causal query rows at positions
    ``q_offset .. q_offset + rows - 1`` in one layer."""
    e, h, d = ESIZE[c["dtype"]], c["num_attention_heads"], c["head_dim"]
    hkv = c["num_key_value_heads"]
    pairs = rows * q_offset + rows * (rows + 1) // 2
    keys = q_offset + rows
    ops = h * pairs * 2 * 2 * d
    return ops, e * (rows * h * d + keys * hkv * 2 * d + rows * h * d)
