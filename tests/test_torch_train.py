"""The port's single-device training against the JAX reference.

* ``layers.flash_attend`` with grad enabled goes through
  ``FlashAttentionFunction``; its dq / dk / dv equal ``jax.grad`` through
  the reference's Pallas flash (interpret mode, its ``custom_vjp``) within
  1e-5, causal, windowed, bidirectional, at a ``q_offset`` and a ``kv_len``.
* ``train.step.make_loss_fn`` (remat on, chunked CE): loss within 1e-5
  (relative) and every gradient leaf within 1e-4 of that leaf's max|grad|
  of the reference's ``jax.value_and_grad``, for one config of each family
  at ``scaled_down(num_layers=2, d_model=64, vocab=256)`` (qwen3_0p6b also
  at seq 512, where attention runs flash); the reference's gradients are
  carried over by ``convert.params_from_numpy`` as its params are.
* ``optim.adamw.apply`` on the reference's gradients within 1e-6 over three
  updates; ``grad_accum`` 2 against 1; three train steps' losses within
  1e-4 of the reference's (with and without a compressor); ``chunked_ce``
  against ``cross_entropy`` and the reference's; ``SyntheticLM`` /
  ``MemmapCorpus`` batches bitwise; the compressors.

Inputs are made with numpy from seeds; params from the reference's init.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SMALL = dict(num_layers=2, d_model=64, vocab=256)
ARCHS = {  # arch -> extra scaled_down overrides
    "qwen3_0p6b": {},
    "deepseek_v2_236b": {},
    "mixtral_8x22b": {},
    "mamba2_2p7b": {},
    "zamba2_2p7b": {"attn_every": 1},  # two groups in two layers
    "seamless_m4t_large_v2": {},
    "internvl2_76b": {"frontend_tokens": 4},
}
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _configs(arch):
    kw = dict(SMALL, **ARCHS[arch])
    return get_config(arch).scaled_down(**kw), t_get_config(arch).scaled_down(**kw)


def _params(cfg, tcfg, seed=0):
    mod = jencdec if cfg.is_enc_dec else jtf
    jp = mod.init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _batch(cfg, b, s, seed=0):
    """A numpy batch: tokens (B, S + 1), and frames / embeds as the config
    needs them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)}
    if cfg.is_enc_dec:
        out["frames"] = rng.standard_normal((b, 24, cfg.d_model)).astype(np.float32)
    if cfg.frontend:
        out["embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def _grads_close(tgrads, jgrads, tcfg, tol=GRAD_TOL):
    """Every port gradient leaf within ``tol`` of the reference leaf's
    max|grad|; returns the worst such ratio."""
    ref = convert.params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg, "cpu")
    worst = 0.0
    for (path, g), (_, r) in zip(_walk(tgrads), _walk(ref)):
        scale = float(r.abs().max())
        err = float((g - r).abs().max())
        assert err <= tol * max(scale, 1e-30), (path, err, scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# flash through autograd
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "causal": dict(s=48, t=48, opts={}),
    "window": dict(s=48, t=48, opts=dict(window=16)),
    "bidirectional": dict(s=32, t=48, opts=dict(bidirectional=True)),
    "q_offset": dict(s=16, t=48, opts=dict(q_offset=32)),
    "kv_len": dict(s=16, t=64, opts=dict(q_offset=24, kv_len=40)),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_function_grads_match_reference_pallas_vjp(name):
    c = FLASH_CASES[name]
    rng = np.random.default_rng(1)
    b, h, hkv, d = 2, 4, 2, 16
    q = rng.standard_normal((b, c["s"], h, d)).astype(np.float32)
    k = rng.standard_normal((b, c["t"], hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, c["t"], hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, c["s"], h, d)).astype(np.float32)

    prev = jlayers.set_attention_impl("pallas")
    try:
        def loss(q_, k_, v_):
            return jnp.sum(jlayers.flash_attend(q_, k_, v_, **c["opts"]) * w)

        want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v))
    finally:
        jlayers.set_attention_impl(prev)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tlayers.flash_attend(tq, tk, tv, **c["opts"])
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_flash_without_grad_skips_the_function():
    q = torch.randn(1, 8, 2, 8)
    k = torch.randn(1, 8, 2, 8)
    assert tlayers.flash_attend(q, k, k).grad_fn is None
    with torch.no_grad():
        assert tlayers.flash_attend(q.requires_grad_(), k, k).grad_fn is None


# ---------------------------------------------------------------------------
# loss and gradients, every family
# ---------------------------------------------------------------------------

LOSS_CASES = [(arch, 32) for arch in ARCHS] + [("qwen3_0p6b", 512)]


@pytest.mark.parametrize("arch,seq", LOSS_CASES, ids=[f"{a}-s{s}" for a, s in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, seq):
    cfg, tcfg = _configs(arch)
    jp, tp = _params(cfg, tcfg)
    batch = _batch(cfg, 2, seq)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg, remat=True),
                                                 has_aux=True))(jp, _jbatch(batch))
    (tloss, tm), tg = tstep.value_and_grad(tstep.make_loss_fn(tcfg, remat=True), tp,
                                           _tbatch(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=LOSS_RTOL, atol=1e-7)
    _grads_close(tg, jg, tcfg)


def test_remat_changes_nothing():
    """remat recomputes; the values and gradients are the same bits."""
    cfg, tcfg = _configs("zamba2_2p7b")
    _, tp = _params(cfg, tcfg)
    batch = _tbatch(_batch(cfg, 2, 32))
    runs = [tstep.value_and_grad(tstep.make_loss_fn(tcfg, remat=r), tp, batch)
            for r in (False, True)]
    assert torch.equal(runs[0][0][0], runs[1][0][0])
    for (_, a), (_, b) in zip(_walk(runs[0][1]), _walk(runs[1][1])):
        assert torch.equal(a, b)
    hidden, _ = ttf.forward_hidden(tp, tcfg, batch["tokens"][:, :-1], remat=True)
    logits, _ = ttf.forward(tp, tcfg, batch["tokens"][:, :-1])
    assert torch.equal(ttf.head_logits(tp, tcfg, hidden), logits)


# ---------------------------------------------------------------------------
# AdamW, grad accumulation, train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg, tcfg = _configs("qwen3_0p6b")
    jp, tp = _params(cfg, tcfg)
    return cfg, tcfg, jp, tp


def test_adamw_matches_reference_on_its_grads(qwen):
    cfg, tcfg, jp, tp = qwen
    batch = _batch(cfg, 2, 32)
    (_, _), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg), has_aux=True))(
        jp, _jbatch(batch))
    tg = convert.params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, "cpu")
    ocfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5)
    tocfg = tadamw.AdamWConfig(**dataclasses.asdict(ocfg))
    jstate, tstate = jadamw.init(jp), tadamw.init(tp)
    japply = jax.jit(jadamw.apply, static_argnums=0)
    for _ in range(3):
        jp, jstate, jm = japply(ocfg, jp, jg, jstate)
        tp, tstate, tm = tadamw.apply(tocfg, tp, tg, tstate)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 3
    for mine, ref in ((tp, jp), (tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
        ref = convert.params_from_numpy(jax.tree.map(np.asarray, ref), tcfg, "cpu")
        for (path, a), (_, b) in zip(_walk(mine), _walk(ref)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6, err_msg=str(path))


def test_schedule_matches_reference():
    ocfg = jadamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=50)
    tocfg = tadamw.AdamWConfig(**dataclasses.asdict(ocfg))
    for s in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(float(tadamw.schedule(tocfg, torch.tensor(s))),
                                   float(jadamw.schedule(ocfg, jnp.int32(s))), rtol=1e-6)


def _train(step_fn, state, batches, tensors):
    losses = []
    for bt in batches:
        state, m = step_fn(state, tensors(bt))
        losses.append(float(m["loss"]))
    return state, losses


def test_grad_accum_two_matches_one(qwen):
    cfg, tcfg, _, tp = qwen
    batch = _tbatch(_batch(cfg, 4, 32, seed=3))
    ocfg = tadamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    outs = []
    for ga in (1, 2):
        state, m = tstep.make_train_step(tcfg, ocfg, grad_accum=ga)(tstep.make_state(tp), batch)
        outs.append((state, m))
    (s1, m1), (s2, m2) = outs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    # the first moment is (1 - b1) x the clipped gradient: the accumulated
    # gradient, held to the one-batch gradient within 1e-5 of each leaf's max
    # (Adam's first update, ~lr x sign(g), is no measure of a gradient near 0)
    for (path, a), (_, b) in zip(_walk(s1["opt"].mu), _walk(s2["opt"].mu)):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max()), path


@pytest.mark.parametrize("compress", [None, "int8", "topk"])
def test_three_steps_match_reference(qwen, compress):
    cfg, tcfg, jp, tp = qwen
    batches = [_batch(cfg, 4, 32, seed=10 + i) for i in range(3)]
    ocfg = jadamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    jc = {"int8": jcompress.Int8Compressor(), "topk": jcompress.TopKCompressor(0.1)}.get(compress)
    tc = {"int8": tcompress.Int8Compressor(), "topk": tcompress.TopKCompressor(0.1)}.get(compress)
    jfn = jax.jit(jstep.make_train_step(cfg, ocfg, grad_accum=2, compress=jc))
    tfn = tstep.make_train_step(tcfg, tadamw.AdamWConfig(**dataclasses.asdict(ocfg)),
                                grad_accum=2, compress=tc)
    jstate = {"params": jp, "opt": jadamw.init(jp), "step": jnp.zeros((), jnp.int32)}
    if jc is not None:
        jstate["ef"] = jc.init(jp)
    _, jl = _train(jfn, jstate, batches, _jbatch)
    tstate, tl = _train(tfn, tstep.make_state(tp), batches, _tbatch)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(tstate["step"]) == 3 and tl[-1] < tl[0]


def test_init_state_is_f32_moments_and_zero_step():
    _, tcfg = _configs("qwen3_0p6b")
    st = tstep.init_state(tcfg, generator=torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16, device="cpu")
    assert st["params"]["embed"]["table"].dtype == torch.bfloat16
    assert st["opt"].mu["embed"]["table"].dtype == torch.float32
    assert int(st["step"]) == 0 and int(st["opt"].step) == 0


# ---------------------------------------------------------------------------
# chunked CE, data, compressors
# ---------------------------------------------------------------------------


def test_chunked_ce_matches_cross_entropy_and_reference():
    rng = np.random.default_rng(2)
    b, s, d, v = 2, 600, 16, 64  # 600 = 2 chunks of 300 (largest divisor <= 512)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    t = rng.integers(0, v, (b, s)).astype(np.int32)
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w)
    tt = torch.from_numpy(t).long()
    got = tstep.chunked_ce(lambda x: x @ tw, th, tt)
    full = tstep.cross_entropy(th.detach() @ tw, tt)
    (gh,) = torch.autograd.grad(got, th)
    ref, rgh = jax.value_and_grad(
        lambda x: jstep.chunked_ce(lambda y: y @ jnp.asarray(w), x, jnp.asarray(t)))(
            jnp.asarray(h))
    got = float(got.detach())
    np.testing.assert_allclose(got, float(full), rtol=1e-6)
    np.testing.assert_allclose(got, float(ref), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(rgh), rtol=0, atol=1e-7)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        float(tstep.cross_entropy(th.detach() @ tw, tt, torch.from_numpy(mask))),
        float(jstep.cross_entropy(h @ w, t, mask)), rtol=1e-6)


def test_synthetic_and_memmap_batches_are_the_reference_bits(tmp_path):
    for kw in (dict(seed=0), dict(seed=3, host_id=1, num_hosts=2)):
        a = tdata.SyntheticLM(1000, 64, 8, **kw)
        r = jdata.SyntheticLM(1000, 64, 8, **kw)
        for step in (0, 1, 17):
            got, want = a.batch(step)["tokens"], r.batch(step)["tokens"]
            assert got.dtype == want.dtype and np.array_equal(got, want)
    path = tmp_path / "corpus.bin"
    np.arange(10_000, dtype=np.int32).tofile(path)
    for host in (0, 1):
        a = tdata.MemmapCorpus(str(path), 15, 4, host_id=host, num_hosts=2)
        r = jdata.MemmapCorpus(str(path), 15, 4, host_id=host, num_hosts=2)
        for step in (0, 3, a.num_steps + 1):
            assert np.array_equal(a.batch(step)["tokens"], r.batch(step)["tokens"])
    pf = tdata.Prefetcher(tdata.SyntheticLM(100, 8, 2), start_step=5)
    try:
        for step in (5, 6, 7):
            assert np.array_equal(pf.next()["tokens"],
                                  jdata.SyntheticLM(100, 8, 2).batch(step)["tokens"])
    finally:
        pf.close()
    with pytest.raises(ValueError, match="num_hosts"):
        tdata.SyntheticLM(100, 8, 3, num_hosts=2)


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((8, 16)).astype(np.float32)},
            "b": [rng.standard_normal((33,)).astype(np.float32)]}


def _to_t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.asarray(x).copy()), tree)


def test_int8_compressor_matches_reference_bitwise():
    jc, tc = jcompress.Int8Compressor(), tcompress.Int8Compressor()
    jstate, tstate = {}, {}
    for step in range(3):
        g = _grad_tree(step)
        jg, jstate = jc.apply(jax.tree.map(jnp.asarray, g), jstate)
        tg, tstate = tc.apply(_to_t(g), tstate)
        for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(jax.tree.map(np.asarray, tg))):
            assert np.array_equal(np.asarray(a), b)
        for a, b in zip(jax.tree.leaves(jstate["ef"]),
                        jax.tree.leaves(jax.tree.map(np.asarray, tstate["ef"]))):
            assert np.array_equal(np.asarray(a), b)
    payload, _ = tc.compress(_to_t(_grad_tree(0)), tc.init(_to_t(_grad_tree(0))))
    assert payload["a"]["w"]["q"].dtype == torch.int8
    assert tcompress.Int8Compressor.payload_bytes({"w": torch.zeros(1000)}) == 1004


def test_int8_error_feedback_unbiased():
    comp, state = tcompress.Int8Compressor(), {}
    acc = torch.zeros(64)
    for _ in range(50):
        g_hat, state = comp.apply({"w": torch.full((64,), 0.001234)}, state)
        acc = acc + g_hat["w"]
    np.testing.assert_allclose(float(acc.mean()), 50 * 0.001234, rtol=0.02)


def test_topk_compressor_matches_reference():
    jc, tc = jcompress.TopKCompressor(0.1), tcompress.TopKCompressor(0.1)
    g = _grad_tree(5)
    jg, jstate = jc.apply(jax.tree.map(jnp.asarray, g), {})
    tg, tstate = tc.apply(_to_t(g), {})
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(jax.tree.map(np.asarray, tg))):
        assert np.array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(jstate["ef"]),
                    jax.tree.leaves(jax.tree.map(np.asarray, tstate["ef"]))):
        assert np.array_equal(np.asarray(a), b)
    kept, st = tc.apply({"w": torch.arange(100, dtype=torch.float32)}, {})
    assert int((kept["w"] != 0).sum()) == 10 and float(kept["w"][-1]) == 99.0
    assert float(st["ef"]["w"].sum()) > 0
