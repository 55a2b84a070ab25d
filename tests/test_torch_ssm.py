"""The port's SSM family (mamba2_2p7b) vs the JAX reference.

* ``ssd_chunked`` against the reference's ``ssd_chunked`` and
  ``ssd_reference``, with and without an initial state, and at a length
  that falls to chunk 1; ``ssd_decode_step`` and the causal depthwise conv
  with a carried state; ``_segsum``'s -inf above the diagonal;
* ``mamba2_apply`` with no cache, with a prefill cache and in decode
  (f32 within 1e-5, bf16 within 1e-2);
* ``forward`` logits within 1e-4; greedy tokens equal through a chunked
  prefill with an exact-size ragged remainder, and the SSM and conv
  states equal after it; ``generate``; int8 (``quantize_params``) tokens
  equal to the reference run op by op (``jax.disable_jit``);
* ``convert`` at bf16 keeps ``a_log`` / ``d_skip`` / ``dt_bias`` f32.

Model: ``mamba2_2p7b.scaled_down()`` (2 layers, d_model 128, 16 heads of
16, state 16) in f32, params from the reference's init carried over by
``convert.params_from_numpy``; inputs made with numpy from seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

ATOL = 1e-5  # one f32 layer, summed in another order
LOGIT_ATOL = 1e-4
BF16_ATOL = 1e-2


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _ssd_inputs(seed, b=2, L=64, h=4, p=8, n=6):
    x = _rand(seed, b, L, h, p)
    dt = np.log1p(np.exp(_rand(seed + 1, b, L, h)))  # positive, as softplus gives
    a_log = _rand(seed + 2, h, scale=0.5)
    bm, cm = _rand(seed + 3, b, L, n), _rand(seed + 4, b, L, n)
    s0 = _rand(seed + 5, b, h, n, p)
    return x, dt.astype(np.float32), a_log, bm, cm, s0


@pytest.fixture(scope="module")
def model():
    cfg = get_config("mamba2_2p7b").scaled_down()
    tcfg = t_get_config("mamba2_2p7b").scaled_down()
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    # a_log 0 / dt_bias 0 / d_skip 1 at init: draw them, so decays differ per head
    blocks = dict(jp["blocks"])
    mixer = dict(blocks["mixer"])
    h = mixer["a_log"].shape[-1]
    mixer["a_log"] = jnp.asarray(_rand(11, cfg.num_layers, h, scale=0.5))
    mixer["dt_bias"] = jnp.asarray(_rand(12, cfg.num_layers, h, scale=0.5))
    mixer["d_skip"] = jnp.asarray(_rand(13, cfg.num_layers, h))
    blocks["mixer"] = mixer
    jp = dict(jp, blocks=blocks)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jp, tcfg, tp


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,chunk,init", [(64, 16, False), (64, 16, True), (48, 48, True),
                                          (37, 1, True)],
                         ids=["chunk16", "chunk16_state", "one_chunk_state", "ragged_chunk1"])
def test_ssd_chunked_matches_reference(L, chunk, init):
    x, dt, a_log, bm, cm, s0 = _ssd_inputs(1, L=L)
    s0 = s0 if init else None
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, a_log, bm, cm)), chunk=chunk,
                              initial_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = tssm.ssd_chunked(*map(_t, (x, dt, a_log, bm, cm)), chunk=chunk,
                              initial_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=1e-5)
    # and the per-token recurrence, in both packages
    ry, rs = jssm.ssd_reference(*map(jnp.asarray, (x, dt, a_log, bm, cm)),
                                initial_state=None if s0 is None else jnp.asarray(s0))
    qy, qs = tssm.ssd_reference(*map(_t, (x, dt, a_log, bm, cm)),
                                initial_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(qy.numpy(), np.asarray(ry), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(qs.numpy(), np.asarray(rs), atol=ATOL, rtol=1e-5)


def test_ssd_chunked_rejects_a_ragged_chunk():
    x, dt, a_log, bm, cm, _ = _ssd_inputs(2, L=40)
    with pytest.raises(ValueError, match="% chunk"):
        tssm.ssd_chunked(*map(_t, (x, dt, a_log, bm, cm)), chunk=16)


def test_ssd_reference_in_f64_is_the_f32_forms_yardstick():
    """f64 inputs run the recurrence in f64 (the card's gate); f32 inputs
    in f32, as the reference's."""
    x, dt, a_log, bm, cm, s0 = _ssd_inputs(3, L=32)
    y64, s64 = tssm.ssd_reference(*(_t(a).double() for a in (x, dt, a_log, bm, cm)),
                                  initial_state=_t(s0).double())
    assert y64.dtype == s64.dtype == torch.float64
    y32, _ = tssm.ssd_chunked(*map(_t, (x, dt, a_log, bm, cm)), chunk=8, initial_state=_t(s0))
    assert y32.dtype == torch.float32
    err = (y32.double() - y64).abs().max().item()
    assert err <= 1e-4 * y64.abs().max().item()


def test_segsum_is_minus_inf_above_the_diagonal():
    ld = _t(_rand(4, 3, 5))
    seg = tssm._segsum(ld)
    want = np.asarray(jssm._segsum(jnp.asarray(ld.numpy())))
    np.testing.assert_allclose(seg.numpy(), want, atol=ATOL)
    e = torch.exp(seg)
    assert not torch.isnan(e).any()
    assert (e.triu(1) == 0).all()


def test_ssd_decode_step_matches_reference():
    x, dt, a_log, bm, cm, s0 = _ssd_inputs(5, L=1)
    args = (x[:, 0], dt[:, 0], a_log, bm[:, 0], cm[:, 0])
    jy, js = jssm.ssd_decode_step(jnp.asarray(s0), *map(jnp.asarray, args))
    ty, ts = tssm.ssd_decode_step(_t(s0), *map(_t, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)


@pytest.mark.parametrize("carried", [False, True], ids=["zero_state", "carried_state"])
def test_causal_depthwise_conv_matches_reference(carried):
    w, bias, x = _rand(6, 4, 12), _rand(7, 12), _rand(8, 2, 9, 12)
    st = _rand(9, 2, 3, 12) if carried else None
    jy, jst = jssm._causal_depthwise_conv(jnp.asarray(w), jnp.asarray(bias), jnp.asarray(x),
                                          None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_depthwise_conv(_t(w), _t(bias), _t(x), None if st is None else _t(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    assert tst.shape == (2, 3, 12) and tst.dtype == torch.float32


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["no_cache", "prefill_then_decode"])
def test_mamba2_apply_matches_reference(model, mode, dtype):
    """No cache: L 48 (chunk 48); with a cache: a 40-token prefill from a
    drawn state (chunk 40), then two decode steps."""
    cfg, jp, tcfg, tp = model
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    atol = ATOL if dtype == "float32" else BF16_ATOL
    jmix = {k: v if k in ("a_log", "d_skip", "dt_bias") else jax.tree.map(
        lambda a: a.astype(jdt), v) for k, v in _layer0(jp["blocks"]["mixer"]).items()}
    tmix = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu",
                                     tdt)["blocks"][0]["mixer"]
    assert tmix["a_log"].dtype == torch.float32 and tmix["in_proj"]["w"].dtype == tdt
    x = _rand(20, 2, 48 if mode == "no_cache" else 40, cfg.d_model)
    if mode == "no_cache":
        want, _ = jssm.mamba2_apply(jmix, cfg, jnp.asarray(x, jdt))
        got, nc = tssm.mamba2_apply(tmix, tcfg, _t(x).to(tdt))
        assert nc is None
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)
        return
    jc = jssm.mamba2_cache_init(cfg, 2, jdt)
    tc = tssm.mamba2_cache_init(tcfg, 2, tdt, "cpu")
    s0 = _rand(21, *tc["ssm"].shape, scale=0.1)
    jc["ssm"], tc["ssm"] = jnp.asarray(s0), _t(s0)
    seq = [x] + [_rand(22 + i, 2, 1, cfg.d_model) for i in range(2)]
    for xi in seq:
        want, jc = jssm.mamba2_apply(jmix, cfg, jnp.asarray(xi, jdt), jc)
        got, tc = tssm.mamba2_apply(tmix, tcfg, _t(xi).to(tdt), tc)
        assert got.dtype == tdt and tc["ssm"].dtype == torch.float32 and tc["conv"].dtype == tdt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)
        np.testing.assert_allclose(tc["ssm"].numpy(), np.asarray(jc["ssm"]),
                                   atol=atol, rtol=1e-5 if dtype == "float32" else 1e-2)
        np.testing.assert_allclose(tc["conv"].float().numpy(),
                                   np.asarray(jc["conv"], np.float32), atol=atol)


# ---------------------------------------------------------------------------
# the model: forward, chunked prefill, decode, int8
# ---------------------------------------------------------------------------


def test_forward_logits_match_reference(model):
    cfg, jp, tcfg, tp = model
    toks = _tokens(1, 2, 96, cfg.vocab)
    want, _ = jtf.forward(jp, cfg, jnp.asarray(toks))
    got, aux = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert got.shape == (2, 96, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_block_has_no_ffn_and_cache_has_no_len(model):
    cfg, jp, tcfg, tp = model
    assert set(tp["blocks"][0]) == {"norm1", "mixer"} == set(jp["blocks"])
    caches = ttf.init_caches(tcfg, 2, 10 ** 9, torch.float32, "cpu")  # max_len unused
    assert set(caches) == {"blocks"} and set(caches["blocks"][0]) == {"ssm", "conv"}
    assert ttf._cache_len(tcfg, caches) == 0


def _greedy(step_mod, params, cfg, prompt, chunk, new, to_dev):
    caches = to_dev["init"](cfg, prompt.shape[0], prompt.shape[1] + new)
    tok, caches = step_mod.make_prefill_step(cfg, chunk=chunk)(params, to_dev["in"](prompt),
                                                             caches)
    out = [np.asarray(tok).reshape(-1, 1)]
    serve = step_mod.make_serve_step(cfg)
    tok = to_dev["in"](out[-1])
    for _ in range(new - 1):
        tok, caches = serve(params, tok, caches)
        out.append(np.asarray(tok).reshape(-1, 1))
    return np.concatenate(out, axis=1), caches


JAX_IO = {"init": lambda c, b, n: jtf.init_caches(c, b, n, jnp.float32),
          "in": lambda a: jnp.asarray(np.asarray(a, np.int32))}
TORCH_IO = {"init": lambda c, b, n: ttf.init_caches(c, b, n, torch.float32, "cpu"),
            "in": lambda a: torch.from_numpy(np.asarray(a)).long()}


def test_chunked_prefill_tokens_and_states_equal_reference(model):
    """Prompt 100 at chunk 32: three chunks and an exact-size 4-token
    remainder (an SSM cannot absorb pad tokens), at chunk 1 by the SSD's
    rule; SSM and conv states equal after the prefill, then decode."""
    cfg, jp, tcfg, tp = model
    prompt = _tokens(2, 2, 100, cfg.vocab)
    jc = jtf.init_caches(cfg, 2, 0, jnp.float32)
    jtok, jc = jstep.make_prefill_step(cfg, chunk=32)(jp, jnp.asarray(prompt), jc)
    tc = ttf.init_caches(tcfg, 2, 0, torch.float32, "cpu")
    ttok, tc = tstep.make_prefill_step(tcfg, chunk=32)(tp, torch.from_numpy(prompt).long(), tc)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for li in range(cfg.num_layers):
        np.testing.assert_allclose(tc["blocks"][li]["ssm"].numpy(),
                                   np.asarray(jc["blocks"]["ssm"][li]), atol=ATOL, rtol=1e-4)
        np.testing.assert_allclose(tc["blocks"][li]["conv"].numpy(),
                                   np.asarray(jc["blocks"]["conv"][li]), atol=ATOL)
    want, _ = _greedy(jstep, jp, cfg, prompt, 32, 5, JAX_IO)
    got, _ = _greedy(tstep, tp, tcfg, prompt, 32, 5, TORCH_IO)
    np.testing.assert_array_equal(got, want)


def test_generate_greedy_tokens_equal_reference(model):
    cfg, jp, tcfg, tp = model
    prompt = _tokens(3, 2, 64, cfg.vocab)
    want = jstep.generate(jp, cfg, jnp.asarray(prompt), 6, 70, jnp.float32)
    got = tstep.generate(tp, tcfg, torch.from_numpy(prompt).long(), 6, 70, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_tokens_equal_reference_run_op_by_op(model):
    """``quantize_params``: in_proj / out_proj / lm_head on the VTA GEMM's
    plain version (``conv_w`` a bare leaf, left float); prompt 40 at chunk
    16 (an exact 8-token remainder), three decode steps."""
    cfg, jp, tcfg, tp = model
    qtp = tq.quantize_params(tp)
    assert "qw" in qtp["blocks"][0]["mixer"]["in_proj"] and "qw" in qtp["lm_head"]
    assert qtp["blocks"][0]["mixer"]["conv_w"].dtype == torch.float32
    prompt = _tokens(4, 2, 40, cfg.vocab)
    with jax.disable_jit():
        want, _ = _greedy(jstep, jq.quantize_params(jp), cfg, prompt, 16, 4, JAX_IO)
    got, _ = _greedy(tstep, qtp, tcfg, prompt, 16, 4, TORCH_IO)
    np.testing.assert_array_equal(got, want)


def test_convert_keeps_ssm_leaves_f32_at_bf16(model):
    cfg, jp, tcfg, _ = model
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.bfloat16)
    mix = tp["blocks"][1]["mixer"]
    for k in ("a_log", "d_skip", "dt_bias"):
        assert mix[k].dtype == torch.float32
        np.testing.assert_array_equal(mix[k].numpy(), np.asarray(jp["blocks"]["mixer"][k][1]))
    assert mix["conv_w"].dtype == mix["in_proj"]["w"].dtype == torch.bfloat16


def test_launcher_static_path_on_cpu(capsys):
    from repro_torch.launch import serve as tlaunch

    res = tlaunch.main(["--arch", "mamba2_2p7b", "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt", "40", "--new-tokens", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "decode 2 steps" in capsys.readouterr().out
