"""The operation and byte counts agree with hand counts at small shapes."""

from bench.work import attention, model

GQA = {"dtype": "float32", "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8}


def test_flash_gqa_by_hand():
    # 3 rows at positions 5, 6, 7 see 6, 7, 8 keys: 21 pairs
    ops, nbytes = attention.flash_prefill(GQA, 5, 3)
    assert ops == 4 * 21 * 2 * (8 + 8)
    assert nbytes == 4 * (3 * 4 * 8 + 8 * 2 * 16 + 3 * 4 * 8)


def test_flash_sums_pairs_like_a_loop():
    ops, _ = attention.flash_prefill(GQA, 37, 11)
    one, _ = attention.flash_prefill(GQA, 0, 1)  # one pair
    assert ops == one * sum(p + 1 for p in range(37, 48))


def test_paged_by_hand():
    ops, nbytes = attention.paged_decode(GQA, [10, 20], 25)
    assert ops == 4 * 30 * 2 * 16
    assert nbytes == 4 * (2 * 4 * 16 + 25 * 2 * 16)


def test_model_ops_by_hand():
    c = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
         "intermediate_size": 16, "num_hidden_layers": 3, "vocab_size": 50}
    flat, per_key = model.per_token(c)
    weights = 3 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    assert flat == 2 * weights
    assert per_key == 2 * 3 * 2 * 8
    assert model.tokens(c, 5, 3) == 3 * flat + per_key * (5 + 6 + 7)
    assert model.head(c) == 2 * 8 * 50
