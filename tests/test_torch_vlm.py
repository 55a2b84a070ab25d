"""The port's VLM family (internvl2_76b) vs the JAX reference: the stubbed
vision frontend's patch embeddings (B, E, D) prepended to the token
embeddings of a GQA decoder.

* ``forward`` logits within 1e-4 over E + S rows, at S 40 and at S 512
  (520 rows: the flash branch);
* greedy tokens equal to the reference's ``generate(embeds=)``, and
  through a chunked prefill whose first chunk carries the embeddings and
  whose ragged final chunk is right-padded, with the caches equal where
  filled (E + S rows) and ``len`` rewound past the pad;
* ``dynamic_prefill`` refuses ``embeds``, as the reference's assert.

Model: ``internvl2_76b.scaled_down()`` (2 layers, d_model 128, 4 heads of
32 on 2 KV heads) in f32, params from the reference's init carried over
by ``convert.params_from_numpy``; embeddings and tokens made with numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from test_torch_ssm import _rand, _t, _tokens  # noqa: E402

LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-4
E = 8  # patch embeddings (the config's 256, cut for the CPU)


@pytest.fixture(scope="module")
def model():
    cfg = get_config("internvl2_76b").scaled_down()
    tcfg = t_get_config("internvl2_76b").scaled_down()
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jp, tcfg, tp


@pytest.mark.parametrize("s", [40, 512])
def test_forward_with_embeds_matches_reference(model, s):
    cfg, jp, tcfg, tp = model
    emb, toks = _rand(1, 2, E, cfg.d_model), _tokens(2, 2, s, cfg.vocab)
    want, _ = jtf.forward(jp, cfg, jnp.asarray(toks), jnp.asarray(emb))
    got, aux = ttf.forward(tp, tcfg, torch.from_numpy(toks).long(), _t(emb))
    assert got.shape == (2, E + s, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_generate_greedy_tokens_equal_reference(model):
    cfg, jp, tcfg, tp = model
    emb, prompt = _rand(3, 2, E, cfg.d_model), _tokens(4, 2, 30, cfg.vocab)
    want = jstep.generate(jp, cfg, jnp.asarray(prompt), 6, E + 36, jnp.float32,
                          embeds=jnp.asarray(emb))
    got = tstep.generate(tp, tcfg, torch.from_numpy(prompt).long(), 6, E + 36, torch.float32,
                         embeds=_t(emb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_prefill_with_embeds_equal_reference(model):
    """Prompt 40 at chunk 16 after 8 embeddings: a 24-row first chunk, a
    full second and a right-padded third; tokens, the E + 40 cache rows and
    ``len`` equal, then four decode steps."""
    cfg, jp, tcfg, tp = model
    emb, prompt = _rand(5, 2, E, cfg.d_model), _tokens(6, 2, 40, cfg.vocab)
    max_len = E + 48 + 5
    jc = jtf.init_caches(cfg, 2, max_len, jnp.float32)
    jtok, jc = jstep.make_prefill_step(cfg, chunk=16)(jp, jnp.asarray(prompt), jc,
                                                      embeds=jnp.asarray(emb))
    tc = ttf.init_caches(tcfg, 2, max_len, torch.float32, "cpu")
    ttok, tc = tstep.make_prefill_step(tcfg, chunk=16)(tp, torch.from_numpy(prompt).long(),
                                                      tc, embeds=_t(emb))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    n = E + 40
    for li in range(cfg.num_layers):
        assert tc["blocks"][li]["len"] == int(jc["blocks"]["len"][li]) == n
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][li][name][:, :n].numpy(),
                                       np.asarray(jc["blocks"][name][li][:, :n]),
                                       atol=CACHE_ATOL)
    jserve, tserve = jstep.make_serve_step(cfg), tstep.make_serve_step(tcfg)
    jt, tt = jnp.asarray(jtok)[:, None], ttok[:, None]
    for _ in range(4):
        jt, jc = jserve(jp, jt, jc)
        tt, tc = tserve(tp, tt, tc)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_dynamic_prefill_refuses_embeds(model):
    cfg, jp, tcfg, tp = model
    caches = ttf.init_caches(tcfg, 1, 64, torch.float32, "cpu")
    with pytest.raises(ValueError, match="embeds"):
        tstep.make_prefill_step(tcfg, chunk=16)(
            tp, torch.zeros((1, 16), dtype=torch.long), caches,
            embeds=torch.zeros((1, E, cfg.d_model)), n_tokens=10)
