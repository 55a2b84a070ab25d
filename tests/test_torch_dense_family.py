"""The rest of the dense family vs the JAX reference: ``qwen2_72b`` and
``starcoder2_15b`` (q/k/v biases), ``yi_34b``, all three with an untied
LM head and no qk-norm, at ``scaled_down`` (2 layers) and at the GQA
group of each full-width config — G 8, 7 and 12 query heads per KV head,
by ``num_heads`` / ``kv_heads`` overrides passed to both packages
(``scaled_down`` alone has G 2).

* ``forward`` logits within 1e-4 at S 40 and at S 520 (the flash
  branch), and greedy tokens through chunked prefill and decode equal;
* one pinned engine trace with the prefix cache: tokens,
  ``stats()`` and audits equal;
* the ``quantize_params`` tree bitwise, biases included (the dequant
  epilogue's bias rides on it).

The reference initialises biases to zero; here every bias is set to
seeded random values first, so that the bias paths are exercised.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from test_torch_engine import _serve, _trace  # noqa: E402
from test_torch_moe import JAX_IO, TORCH_IO, _greedy, _leaves, _tokens  # noqa: E402

LOGIT_ATOL = 1e-4
# the full-width configs' query heads per KV head, at 2 KV heads
FULL_G = {"qwen2_72b": 8, "yi_34b": 7, "starcoder2_15b": 12}
CASES = [(arch, g) for arch in FULL_G for g in (None, FULL_G[arch])]


def _random_biases(tree, rng):
    if isinstance(tree, dict):
        return {k: (jnp.asarray(0.1 * rng.standard_normal(v.shape).astype(np.float32))
                    if k == "b" else _random_biases(v, rng)) for k, v in tree.items()}
    return tree


@functools.lru_cache(maxsize=None)
def _build(arch, g):
    kw = dict(num_layers=2)
    if g:
        kw.update(num_heads=2 * g, kv_heads=2)
    cfg = get_config(arch).scaled_down(**kw)
    tcfg = t_get_config(arch).scaled_down(**kw)
    assert cfg.num_heads // cfg.kv_heads == (g or 2)
    jp = _random_biases(jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32),
                        np.random.default_rng(9))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=CASES, ids=[f"{a}-G{g or 2}" for a, g in CASES])
def model(request):
    return _build(*request.param)


def test_family_traits(model):
    cfg, _, tcfg, tp = model
    assert not cfg.qk_norm and not cfg.tie_embeddings and "lm_head" in tp
    assert ("b" in tp["blocks"][0]["mixer"]["wq"]) == cfg.qkv_bias
    if cfg.qkv_bias:
        assert tp["blocks"][0]["mixer"]["wk"]["b"].abs().max() > 0


@pytest.mark.parametrize("s", [40, 520])
def test_forward_logits_match_reference(model, s):
    cfg, jp, tcfg, tp = model
    toks = _tokens(1, 2, s, cfg.vocab)
    want, _ = jtf.forward(jp, cfg, jnp.asarray(toks))
    got, aux = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_greedy_tokens_equal_reference(model):
    """Prompt 530 at chunk 512 (flash, then a padded 18-token chunk), then
    five decode steps through the split-KV path at the config's G."""
    cfg, jp, tcfg, tp = model
    prompt = _tokens(2, 2, 530, cfg.vocab)
    want = _greedy(jstep, jp, cfg, prompt, 512, 6, 1040, JAX_IO)
    got = _greedy(tstep, tp, tcfg, prompt, 512, 6, 1040, TORCH_IO)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", list(FULL_G))
def test_engine_trace_matches_reference(arch):
    cfg, jp, tcfg, tp = _build(arch, None)
    reqs = _trace(cfg.vocab)[:4]
    jeng_, jdone, jrep = _serve(jeng, jp, cfg, reqs, None, prefix_cache=True)
    teng_, tdone, trep = _serve(teng, tp, tcfg, reqs, None, prefix_cache=True)
    assert {r: d.tokens for r, d in tdone.items()} == {r: d.tokens for r, d in jdone.items()}
    assert teng_.stats() == jeng_.stats() and trep == jrep
    assert teng_.stats()["prefix_hits"] >= 1


def test_quantize_params_tree_bitwise(model):
    cfg, jp, tcfg, tp = model
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jq.quantize_params(jp)),
                                     tcfg, "cpu")
    got = tq.quantize_params(tp)
    wl, gl = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, w), (_, g) in zip(wl, gl):
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert "qw" in got["lm_head"] and ("b" in got["blocks"][0]["mixer"]["wv"]) == cfg.qkv_bias
