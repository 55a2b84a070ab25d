"""PyTorch port vs the JAX reference: layers, GQA attention, dispatch.

Inputs come from numpy seeds (or the reference's own PRNG init turned
into numpy) and go through both packages on the CPU.  f32 throughout;
the tolerance is 1e-5 for single layers (one f32 rounding chain apart)
unless a test states otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def test_dense_embedding_and_tied_logits():
    w, b = _rand(0, 16, 24), _rand(1, 24)
    x = _rand(2, 3, 5, 16)
    pj = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    pt = _to_torch({"w": w, "b": b})
    np.testing.assert_allclose(_np(jl.dense_apply(pj, jnp.asarray(x))),
                               tl.dense_apply(pt, torch.from_numpy(x)).numpy(),
                               atol=ATOL)
    table = _rand(3, 50, 16)
    ids = np.random.default_rng(4).integers(0, 50, (2, 7))
    ej = jl.embedding_apply({"table": jnp.asarray(table)}, jnp.asarray(ids))
    et = tl.embedding_apply({"table": torch.from_numpy(table)}, torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(ej), et.numpy())
    lj = jl.embedding_logits({"table": jnp.asarray(table)}, jnp.asarray(x))
    lt = tl.embedding_logits({"table": torch.from_numpy(table)}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(lj), lt.numpy(), atol=ATOL)


def test_rmsnorm_and_gated_mlp():
    x = _rand(0, 2, 9, 32) * 3
    scale = _rand(1, 32)
    xj, xt = _pair(x)
    np.testing.assert_allclose(
        _np(jl.rmsnorm_apply({"scale": jnp.asarray(scale)}, xj, 1e-6)),
        tl.rmsnorm_apply({"scale": torch.from_numpy(scale)}, xt, 1e-6).numpy(),
        atol=ATOL)
    p = {k: {"w": _rand(i, *shape) * 0.2} for i, (k, shape) in enumerate(
        [("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32))])}
    pj = jax.tree.map(jnp.asarray, p)
    np.testing.assert_allclose(_np(jl.gated_mlp_apply(pj, xj)),
                               tl.gated_mlp_apply(_to_torch(p), xt).numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("theta,max_pos", [(10_000.0, 64), (1_000_000.0, 2100)])
def test_rope_half_split(theta, max_pos):
    x = _rand(0, 2, 7, 3, 16)
    pos = np.random.default_rng(1).integers(0, max_pos, (2, 7))
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(want), got.numpy(), atol=ATOL)
    np.testing.assert_allclose(_np(jl.rope_frequencies(16, theta)),
                               tl.rope_frequencies(16, theta).numpy(), rtol=1e-6)


@pytest.mark.parametrize("q_offset,window", [(0, 0), (5, 0), (3, 4)])
def test_causal_mask(q_offset, window):
    want = jl.causal_mask(6, 11, window=window, q_offset=q_offset)
    got = tl.causal_mask(6, 11, window=window, q_offset=q_offset)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_softmax_attend_gqa():
    q, k, v = _rand(0, 2, 5, 4, 8), _rand(1, 2, 9, 2, 8), _rand(2, 2, 9, 2, 8)
    mask = np.array(jl.causal_mask(5, 9, q_offset=4))
    want = jl.softmax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask))
    got = tl.softmax_attend(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(want), got.numpy(), atol=ATOL)


def test_attention_dispatch_rules():
    with pytest.raises(ValueError):
        tl.set_attention_impl("pallas")
    assert tl.attention_impl() == "auto"
    q = torch.zeros(1, 512, 2, 8)
    k = torch.zeros(1, 512, 2, 8)
    prev = tl.set_attention_impl("kernel")
    try:
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            tl.flash_attend(q, k, k)
        with pytest.raises(RuntimeError, match="CUDA tensor"):
            tl.decode_attend(q[:, :1], k, k, kv_len=4)
    finally:
        tl.set_attention_impl(prev)


def test_gqa_prefill_then_decode_matches_reference():
    """qwen3-style GQA (qk-norm, RoPE) through the dense cache: a
    short prefill (softmax branch), a 512-row chunk (flash branch) and
    an S=1 step (decode branch), cache contents and ``len`` included."""
    cfg = get_config("qwen3_0p6b").scaled_down()
    pj = jattn.gqa_init(jax.random.PRNGKey(0), cfg, jnp.float32)
    pt = _to_torch(_tree_np(pj))
    b, t = 2, 600
    cj = jattn.gqa_cache_init(cfg, b, t, jnp.float32)
    ct = tattn.gqa_cache_init(cfg, b, t, torch.float32, "cpu")
    x = _rand(7, b, 8 + 512 + 1, cfg.d_model)
    start = 0
    for s in (8, 512, 1):
        xs = x[:, start:start + s]
        pos = np.broadcast_to(np.arange(start, start + s), (b, s))
        yj, cj = jattn.gqa_apply(pj, cfg, jnp.asarray(xs), jnp.asarray(pos), cj)
        yt, ct = tattn.gqa_apply(pt, cfg, torch.from_numpy(np.ascontiguousarray(xs)),
                                 torch.from_numpy(np.ascontiguousarray(pos)), ct)
        np.testing.assert_allclose(_np(yj), yt.numpy(), atol=1e-4)
        start += s
        assert int(cj["len"]) == ct["len"] == start
    np.testing.assert_allclose(_np(cj["k"]), ct["k"].numpy(), atol=1e-5)
    np.testing.assert_allclose(_np(cj["v"]), ct["v"].numpy(), atol=1e-5)


def test_gqa_no_cache_flash_branch():
    cfg = get_config("qwen3_0p6b").scaled_down()
    pj = jattn.gqa_init(jax.random.PRNGKey(1), cfg, jnp.float32)
    pt = _to_torch(_tree_np(pj))
    x = _rand(3, 1, 512, cfg.d_model)
    pos = np.arange(512)[None]
    yj, _ = jattn.gqa_apply(pj, cfg, jnp.asarray(x), jnp.asarray(pos))
    yt, _ = tattn.gqa_apply(pt, cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(yj), yt.numpy(), atol=1e-4)


def test_cache_overflow_raises():
    cfg = get_config("qwen3_0p6b").scaled_down()
    pt = _to_torch(_tree_np(jattn.gqa_init(jax.random.PRNGKey(1), cfg, jnp.float32)))
    cache = tattn.gqa_cache_init(cfg, 1, 4, torch.float32, "cpu")
    x = torch.zeros(1, 5, cfg.d_model)
    with pytest.raises(ValueError, match="overflow"):
        tattn.gqa_apply(pt, cfg, x, torch.arange(5)[None], cache)
