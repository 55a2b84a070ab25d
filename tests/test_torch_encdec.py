"""The port's enc-dec family (seamless_m4t_large_v2) vs the JAX reference.

* ``layers.layernorm_apply``; ``cross_attn_kv`` / ``cross_attn_apply``
  within 1e-5: S 8 against 24 frames (no flash), S 8 against 520 frames
  (the plain flash route, bidirectional with S != T) and a decode step's
  S 1 against 512 frames (flash too, as the reference dispatches it);
* ``encode`` (bidirectional self-attention, flash from 512 frames) and
  the enc-dec ``forward`` within 1e-4;
* greedy tokens equal to the reference's ``generate``, and through a
  chunked prefill whose ragged final chunk is right-padded (encode and
  cross K/V once, the head once), with the decoder caches equal where
  filled and their ``len`` rewound past the pad; ``dynamic_prefill``
  refuses an enc-dec config, as the reference's assert.

Model: ``seamless_m4t_large_v2.scaled_down()`` (2 + 2 layers, d_model 128,
4 heads of 32 on 2 KV heads, cross-attention on all 4 heads) in f32,
params from the reference's init carried over by
``convert.params_from_numpy``; frames and tokens made with numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from test_torch_ssm import _rand, _t, _tokens  # noqa: E402

ATOL = 1e-5
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-4  # K/V after a layer's residual stream, as the dense slice's check


@pytest.fixture(scope="module")
def model():
    cfg = get_config("seamless_m4t_large_v2").scaled_down()
    tcfg = t_get_config("seamless_m4t_large_v2").scaled_down()
    jp = jed.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jp, tcfg, tp


def test_layernorm_matches_reference():
    x = _rand(0, 3, 5, 48) * 3 + 1
    scale, bias = _rand(1, 48), _rand(2, 48)
    want = jl.layernorm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                              jnp.asarray(x))
    got = tl.layernorm_apply({"scale": _t(scale), "bias": _t(bias)}, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    init = tl.layernorm_init(48, torch.bfloat16, "cpu")
    assert init["scale"].dtype == torch.bfloat16 and not init["bias"].any()
    xb = _t(x).bfloat16()
    got_b = tl.layernorm_apply({"scale": _t(scale), "bias": _t(bias)}, xb)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), np.asarray(want), atol=5e-2)


def test_param_tree_unstacks_encoder_and_decoder(model):
    cfg, jp, tcfg, tp = model
    assert len(tp["encoder"]) == cfg.encoder_layers and len(tp["decoder"]) == cfg.num_layers
    np.testing.assert_array_equal(tp["decoder"][1]["cross_attn"]["wk"]["w"].numpy(),
                                  np.asarray(jp["decoder"]["cross_attn"]["wk"]["w"][1]))
    own = ted.init(tcfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                   device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, own)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, tp))


@pytest.mark.parametrize("s,t", [(8, 24), (8, 520), (1, 512)],
                         ids=["softmax", "flash_s8_t520", "flash_s1_t512"])
def test_cross_attention_matches_reference(model, s, t):
    cfg, jp, tcfg, tp = model
    jca = jax.tree.map(lambda a: a[0], jp["decoder"]["cross_attn"])
    tca = tp["decoder"][0]["cross_attn"]
    enc, x = _rand(3, 2, t, cfg.d_model), _rand(4, 2, s, cfg.d_model)
    jkv = jattn.cross_attn_kv(jca, cfg, jnp.asarray(enc))
    tkv = tattn.cross_attn_kv(tca, tcfg, _t(enc))
    assert tkv["k"].shape == (2, t, cfg.num_heads, cfg.head_dim)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]), atol=ATOL)
    want = jattn.cross_attn_apply(jca, cfg, jnp.asarray(x), jkv)
    got = tattn.cross_attn_apply(tca, tcfg, _t(x), tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("t", [24, 520], ids=["softmax", "flash_bidirectional"])
def test_encode_and_forward_match_reference(model, t):
    cfg, jp, tcfg, tp = model
    frames, toks = _rand(5, 2, t, cfg.d_model), _tokens(6, 2, 40, cfg.vocab)
    want = jed.encode(jp, cfg, jnp.asarray(frames))
    got = ted.encode(tp, tcfg, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    want, _ = jed.forward(jp, cfg, jnp.asarray(frames), jnp.asarray(toks))
    got, aux = ted.forward(tp, tcfg, _t(frames), torch.from_numpy(toks).long())
    assert got.shape == (2, 40, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_generate_greedy_tokens_equal_reference(model):
    cfg, jp, tcfg, tp = model
    frames, prompt = _rand(7, 2, 24, cfg.d_model), _tokens(8, 2, 30, cfg.vocab)
    want = jstep.generate(jp, cfg, jnp.asarray(prompt), 6, 40, jnp.float32,
                          frames=jnp.asarray(frames))
    got = tstep.generate(tp, tcfg, torch.from_numpy(prompt).long(), 6, 40, torch.float32,
                         frames=_t(frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_prefill_tokens_and_caches_equal_reference(model):
    """Prompt 40 at chunk 16 against 24 frames: two full chunks and a
    right-padded third; tokens, the decoder caches where filled and ``len``
    equal, then four decode steps against the same cross K/V."""
    cfg, jp, tcfg, tp = model
    frames, prompt = _rand(9, 2, 24, cfg.d_model), _tokens(10, 2, 40, cfg.vocab)
    max_len = 48 + 5
    jc = jed.init_caches(cfg, 2, max_len, jnp.float32)
    jtok, jc, jkv = jstep.make_prefill_step(cfg, chunk=16)(
        jp, jnp.asarray(prompt), jc, frames=jnp.asarray(frames))
    tc = ted.init_caches(tcfg, 2, max_len, torch.float32, "cpu")
    ttok, tlogits, tc, tkv = tstep.make_prefill_step(tcfg, chunk=16, return_logits=True)(
        tp, torch.from_numpy(prompt).long(), tc, frames=_t(frames))
    assert tlogits.shape == (2, 1, cfg.vocab) and len(tkv) == cfg.num_layers
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for li in range(cfg.num_layers):
        assert tc["blocks"][li]["len"] == int(jc["len"][li]) == 40
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][li][name][:, :40].numpy(),
                                       np.asarray(jc[name][li][:, :40]), atol=CACHE_ATOL)
            np.testing.assert_allclose(tkv[li][name].numpy(), np.asarray(jkv[name][li]),
                                       atol=CACHE_ATOL)
    jserve, tserve = jstep.make_serve_step(cfg), tstep.make_serve_step(tcfg)
    jt, tt = jnp.asarray(jtok)[:, None], ttok[:, None]
    for _ in range(4):
        jt, jc = jserve(jp, jt, jc, jkv)
        tt, tc = tserve(tp, tt, tc, tkv)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["blocks"][0]["len"] == int(jc["len"][0]) == 44


def test_dynamic_prefill_refuses_enc_dec(model):
    cfg, jp, tcfg, tp = model
    caches = ted.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    with pytest.raises(ValueError, match="enc-dec"):
        tstep.make_prefill_step(tcfg, chunk=16)(tp, torch.zeros((1, 16), dtype=torch.long),
                                                caches, n_tokens=10)
