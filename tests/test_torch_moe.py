"""The port's MoE family vs the JAX reference: ``models.moe``, the
``deepseek_v2_236b`` (MLA, routed and shared experts) and
``mixtral_8x22b`` (SWA rolling buffer) models end to end, and their
int8 and bf16 trees (serving: ``tests/test_torch_moe_serve.py``).

* ``moe_apply`` at capacity factor 1.25 (tokens dropped) and dropless:
  output and aux within 1e-5, routing equal; int8 experts through the
  VTA GEMM's plain version; ties in the router's top-k to the lower index;
* ``forward`` logits within 1e-4 (S 40 and S 520, the flash branch) and
  the aux loss within 1e-5; chunked prefill (ragged final chunk, and
  the exact remainder of an SWA config past its window) and greedy
  decode tokens equal;
* the SWA rolling buffer at ``sliding_window=64`` (as
  ``tests/test_models.py``) over a 150-token prompt in chunks: buffer
  rows, ``len`` and logits;
* the ``quantize_params`` tree bitwise (experts quantized per expert)
  and ``convert`` at bf16 keeping the router f32.

Models: the ``scaled_down`` configs at 2 layers in f32, params from the
reference's init carried over by ``convert.params_from_numpy``; inputs
made with numpy from seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

ARCHS = ("deepseek_v2_236b", "mixtral_8x22b")
# f32 logits after a few layers, summed in another order (as the dense slice)
LOGIT_ATOL = 1e-4
MOE_ATOL = 1e-5


def _cfgs(arch, **kw):
    kw.setdefault("num_layers", 2)
    return get_config(arch).scaled_down(**kw), t_get_config(arch).scaled_down(**kw)


def _carry(jp, tcfg, dtype=torch.float32):
    return convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", dtype)


def reference_int8(jp):
    """The reference's ``quantize_params`` with the routed and shared
    experts quantized too, per expert, by its own ``quantize_dense``: its
    stacked tree holds them as (L, E, K, N), which its 2D/3D test leaves
    f32; the port's per-layer tree holds (E, K, N) and packs them."""
    qp = jq.quantize_params(jp)
    ffn = dict(qp["blocks"]["ffn"])
    for part in ("experts", "shared"):
        if part in ffn:
            ffn[part] = {k: jq.quantize_dense(v) for k, v in ffn[part].items()}
    return dict(qp, blocks=dict(qp["blocks"], ffn=ffn))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg, tcfg = _cfgs(request.param)
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, jp, tcfg, _carry(jp, tcfg)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["blocks"]["ffn"])


@pytest.mark.parametrize("mode", ["capacity_1.25", "dropless", "int8"])
def test_moe_apply_matches_reference(model, mode):
    """32 tokens at k 2 of 4 experts: capacity 20 per expert at factor
    1.25, which this routing overflows (drops checked); dropless is the
    serving capacity, cap = tokens."""
    cfg, jp, tcfg, tp = model
    jffn, tffn = _layer0(jp), tp["blocks"][0]["ffn"]
    if mode == "int8":
        jffn = _layer0(reference_int8(jp))
        tffn = tq.quantize_params(tp)["blocks"][0]["ffn"]
    x = np.random.default_rng(8).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    n = x.shape[0] * x.shape[1]
    cap = n if mode == "dropless" else None
    want, jaux = jmoe.moe_apply(jffn, cfg, jnp.asarray(x), capacity=cap)
    got, taux = tmoe.moe_apply(tffn, tcfg, torch.from_numpy(x), capacity=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOE_ATOL)
    assert abs(float(taux) - float(jaux)) <= MOE_ATOL
    # routing: the same experts chosen for every token, in the same order
    if isinstance(tffn["router"], dict):
        return
    logits = x.reshape(n, -1) @ np.asarray(jffn["router"])
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, jidx = jax.lax.top_k(probs, cfg.moe_top_k)
    _, tidx = tmoe.top_k(torch.softmax(torch.from_numpy(logits), -1), cfg.moe_top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    load = np.bincount(np.asarray(jidx).ravel(), minlength=cfg.moe_experts)
    if mode == "capacity_1.25":
        assert tmoe.capacity_for(tcfg, n) == 20 and load.max() > 20, "some choices drop"


def test_moe_top_k_ties_to_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    vals, idx = tmoe.top_k(probs, 2)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[0, 1], [1, 3], [0, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_moe_capacity_rounds_half_to_even():
    cfg = t_get_config("mixtral_8x22b").scaled_down()  # 4 experts, top-2
    # 1.25 * n * 2 / 4 = 0.625 n: n 4 -> 2.5 -> 2 (half to even), n 12 -> 7.5 -> 8
    assert [tmoe.capacity_for(cfg, n) for n in (1, 4, 12)] == [1, 2, 8]


# ---------------------------------------------------------------------------
# model: forward, prefill, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [40, 520])
def test_forward_logits_and_aux_match_reference(model, s):
    cfg, jp, tcfg, tp = model
    toks = _tokens(1, 2, s, cfg.vocab)
    want, jaux = jtf.forward(jp, cfg, jnp.asarray(toks))
    got, taux = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    assert float(taux) > 0 and abs(float(taux) - float(jaux)) <= MOE_ATOL


def _greedy(step_mod, params, cfg, prompt, chunk, new, max_len, to_dev):
    """Chunked prefill, then ``new - 1`` greedy decode steps; tokens (B, new)."""
    caches = to_dev["init"](cfg, prompt.shape[0], max_len)
    tok, caches = step_mod.make_prefill_step(cfg, chunk=chunk)(params, to_dev["in"](prompt),
                                                             caches)
    out = [np.asarray(tok).reshape(-1, 1)]
    serve = step_mod.make_serve_step(cfg)
    tok = to_dev["in"](out[-1])
    for _ in range(new - 1):
        tok, caches = serve(params, tok, caches)
        out.append(np.asarray(tok).reshape(-1, 1))
    return np.concatenate(out, axis=1)


JAX_IO = {"init": lambda c, b, n: jtf.init_caches(c, b, n, jnp.float32),
          "in": lambda a: jnp.asarray(np.asarray(a, np.int32))}
TORCH_IO = {"init": lambda c, b, n: ttf.init_caches(c, b, n, torch.float32, "cpu"),
            "in": lambda a: torch.from_numpy(np.asarray(a)).long()}


def test_chunked_prefill_and_decode_tokens_equal_reference(model):
    """Prompt 300 at chunk 128: deepseek pads the final chunk; mixtral's
    128-token window makes its cache a rolling buffer, so the remainder
    runs as one exact pass and decode attends over the buffer."""
    cfg, jp, tcfg, tp = model
    prompt = _tokens(2, 2, 300, cfg.vocab)
    want = _greedy(jstep, jp, cfg, prompt, 128, 5, 392, JAX_IO)
    got = _greedy(tstep, tp, tcfg, prompt, 128, 5, 392, TORCH_IO)
    np.testing.assert_array_equal(got, want)


def test_swa_rolling_buffer_past_the_window_matches_reference():
    """``sliding_window=64``: a 150-token prompt in 48-token chunks (the
    last an exact 6-token pass) wraps the 64-row buffer twice; the
    buffer's rows (ordered snapshot), ``len`` and each step's logits
    equal the reference's through three decode steps."""
    cfg, tcfg = _cfgs("mixtral_8x22b", sliding_window=64)
    jp = jtf.init(jax.random.PRNGKey(1), cfg, jnp.float32)
    tp = _carry(jp, tcfg)
    prompt = _tokens(3, 1, 150, cfg.vocab)
    jc = jtf.init_caches(cfg, 1, 200, jnp.float32)
    tc = ttf.init_caches(tcfg, 1, 200, torch.float32, "cpu")
    assert tc["blocks"][0]["k"].shape[1] == jc["blocks"]["k"].shape[2] == 64
    jpre = jstep.make_prefill_step(cfg, chunk=48)
    tpre = tstep.make_prefill_step(tcfg, chunk=48, return_logits=True)
    jt, jc = jpre(jp, jnp.asarray(prompt), jc)
    tt, tl, tc = tpre(tp, torch.from_numpy(prompt).long(), tc)
    assert tt.tolist() == np.asarray(jt).tolist()
    for step in range(4):
        for li in range(cfg.num_layers):
            assert tc["blocks"][li]["len"] == int(jc["blocks"]["len"][li]) == 150 + step
            for key in ("k", "v"):
                np.testing.assert_allclose(tc["blocks"][li][key].numpy(),
                                           np.asarray(jc["blocks"][key][li]), atol=1e-5)
        if step == 3:
            break
        tok = np.asarray(jt).reshape(1, 1).astype(np.int32)
        jl, jc = jtf.decode_step(jp, cfg, jnp.asarray(tok), jc)
        tl, tc = ttf.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
        jt = np.asarray(jl)[:, -1].argmax(-1)


# ---------------------------------------------------------------------------
# int8 and bf16 trees
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_quantize_params_tree_bitwise(model):
    cfg, jp, tcfg, tp = model
    want = _carry(reference_int8(jp), tcfg)
    got = tq.quantize_params(tp)
    wl, gl = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    n_q = 0
    for (path, w), (_, g) in zip(wl, gl):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path
        if path[-1] == "qw":
            n_q += 1
            assert g.stride()[-2:] == (1, g.shape[-2]), f"{path}: K-major"
    ffn = got["blocks"][0]["ffn"]
    assert ffn["experts"]["w_gate"]["qw"].shape == (cfg.moe_experts, cfg.d_model, cfg.d_ff)
    assert ffn["router"]["qscale"].shape == (cfg.moe_experts,)
    assert n_q > 0


def test_convert_keeps_router_f32_and_carries_moe_mla_trees(model):
    cfg, jp, tcfg, _ = model
    got = _carry(jp, tcfg, torch.bfloat16)
    jl = {p: a for p, a in _leaves(jax.tree.map(np.asarray, jp))}
    n = 0
    for li, block in enumerate(got["blocks"]):
        for path, leaf in _leaves(block):
            n += 1
            ref = jl[("blocks",) + path][li]
            assert tuple(leaf.shape) == ref.shape, path
            want = torch.float32 if path[-1] == "router" else torch.bfloat16
            assert leaf.dtype == want, path
            np.testing.assert_array_equal(
                leaf.float().numpy(), torch.from_numpy(np.array(ref)).to(want).float().numpy())
    assert n == sum(1 for p in jl if p[0] == "blocks") * cfg.num_layers
    mixer = set(got["blocks"][0]["mixer"])
    assert mixer == ({"wq", "wdkv", "ckv_norm", "wuk", "wuv", "wo"} if cfg.uses_mla
                     else {"wq", "wk", "wv", "wo"})
