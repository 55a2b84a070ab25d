"""The port's serving slice vs the JAX reference: params carried over by
``convert.params_from_numpy``, ``transformer.forward`` logits, chunked
prefill (ragged final chunk), greedy ``generate``, and the launcher.
Every config's copy equals the reference's; every family but the CNN
inits, forwards and builds caches through its own model module; the SSM,
hybrid, enc-dec and frontend families refuse paged caches, as the
reference does.

Model: ``qwen3_0p6b.scaled_down()`` in f32, with prompts of at least 512
tokens so that the flash branch of both packages runs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

# f32 logits after a few layers: the two libraries sum matmuls and
# softmaxes in different orders, ~1e-6 relative per op
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3_0p6b").scaled_down()
    jparams = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tcfg = t_get_config("qwen3_0p6b").scaled_down()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCH_IDS + ("resnet18_vta",))
def test_config_copy_matches_reference(arch):
    assert get_config(arch).__dict__ == t_get_config(arch).__dict__
    assert (get_config(arch).scaled_down().__dict__
            == t_get_config(arch).scaled_down().__dict__)


NO_PAGES = ("mamba2_2p7b", "zamba2_2p7b", "seamless_m4t_large_v2", "internvl2_76b")


@pytest.mark.parametrize("arch", NO_PAGES)
def test_recurrent_encdec_and_frontend_families_refuse_pages(arch):
    """As the reference: the paged engine and ``init_paged_caches`` refuse
    SSM, hybrid, enc-dec and frontend configs; the launcher's paged engine
    refuses the SSM and hybrid configs, and it exits for an enc-dec or
    frontend config with the reference's message (their entry point is
    ``serve.step.generate``)."""
    tcfg = t_get_config(arch).scaled_down()
    assert not tkv.supports_paged(tcfg) and not jkv.supports_paged(get_config(arch))
    with pytest.raises(NotImplementedError, match="not paged"):
        tkv.init_paged_caches(tcfg, 1, 32, torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="not paged"):
        ttf.init_caches(tcfg, 1, 32, torch.float32, "cpu", cache_layout="paged")
    with pytest.raises(NotImplementedError, match="use the static loop"):
        teng.ServingEngine({}, tcfg, max_slots=1, max_len=32)
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--engine", "paged", "--batch", "1",
            "--prompt", "16", "--new-tokens", "2"]
    if tcfg.is_enc_dec or tcfg.frontend:
        with pytest.raises(SystemExit, match="use examples/serve_batched.py variants for "
                                             "frontend/enc-dec archs"):
            tlaunch.main(argv)
    else:
        with pytest.raises(NotImplementedError, match="use the static loop"):
            tlaunch.main(argv)


@pytest.mark.parametrize("arch", ARCH_IDS + ("resnet18_vta",))
def test_only_the_cnn_config_is_refused(arch):
    """Every ``ARCH_IDS`` entry inits and builds caches through its own
    model module (``encdec`` for the enc-dec config, ``transformer`` for
    the rest); ``transformer.check_supported`` refuses only the CNN."""
    tcfg = t_get_config(arch)
    if tcfg.family == "cnn":
        with pytest.raises(NotImplementedError, match="models.resnet"):
            ttf.check_supported(tcfg)
        return
    tcfg = tcfg.scaled_down()
    mod = ted if tcfg.is_enc_dec else ttf
    ttf.check_supported(tcfg)
    params = mod.init(tcfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                      device="cpu")
    caches = mod.init_caches(tcfg, 1, 16, torch.float32, "cpu")
    assert len(caches["blocks"]) == tcfg.num_layers
    toks = torch.zeros((1, 4), dtype=torch.long)
    if tcfg.is_enc_dec:
        logits, _ = ted.forward(params, tcfg, torch.zeros((1, 6, tcfg.d_model)), toks)
    else:
        logits, _ = ttf.forward(params, tcfg, toks)
    assert logits.shape == (1, 4, tcfg.vocab) and bool(torch.isfinite(logits).all())


def test_params_from_numpy_unstacks_layers(model):
    cfg, jparams, tcfg, tparams = model
    assert len(tparams["blocks"]) == cfg.num_layers
    for li in range(cfg.num_layers):
        np.testing.assert_array_equal(
            np.asarray(jparams["blocks"]["mixer"]["wq"]["w"][li]),
            tparams["blocks"][li]["mixer"]["wq"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(jparams["embed"]["table"]),
                                  tparams["embed"]["table"].numpy())


def test_forward_logits_match_reference(model):
    cfg, jparams, tcfg, tparams = model
    toks = _tokens(1, 2, 512, cfg.vocab)
    want, _ = jtf.forward(jparams, cfg, jnp.asarray(toks))
    got, aux = ttf.forward(tparams, tcfg, torch.from_numpy(toks).long())
    assert got.shape == (2, 512, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_generate_greedy_tokens_equal_reference(model):
    """Prompt 520 under the default 4096 chunk: one flash prefill call,
    then S=1 decode steps through the split-KV path."""
    cfg, jparams, tcfg, tparams = model
    prompt = _tokens(2, 2, 520, cfg.vocab)
    want = jstep.generate(jparams, cfg, jnp.asarray(prompt), 6, 540, jnp.float32)
    got = tstep.generate(tparams, tcfg, torch.from_numpy(prompt).long(), 6, 540,
                         torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ragged_chunked_prefill_matches_reference(model):
    """Prompt 1100 at chunk 512: two full chunks and a right-padded
    third, all flash calls at S=512; next tokens, cache contents and
    ``len`` equal the reference's.  max_len 1540 >= 1536 + 4 keeps the
    padded write inside the buffer, where the reference would clamp it."""
    cfg, jparams, tcfg, tparams = model
    b, s, max_len = 2, 1100, 1540
    prompt = _tokens(3, b, s, cfg.vocab)
    jc = jtf.init_caches(cfg, b, max_len, jnp.float32)
    jtok, jc = jstep.make_prefill_step(cfg, chunk=512)(jparams, jnp.asarray(prompt), jc)
    tc = ttf.init_caches(tcfg, b, max_len, torch.float32, "cpu")
    prefill = tstep.make_prefill_step(tcfg, chunk=512, return_logits=True)
    ttok, tlogits, tc = prefill(tparams, torch.from_numpy(prompt).long(), tc)
    assert tlogits.shape == (b, 1, cfg.vocab)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    for li in range(cfg.num_layers):
        assert tc["blocks"][li]["len"] == int(jc["blocks"]["len"][li]) == s
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][li][name][:, :s].numpy(),
                                       np.asarray(jc["blocks"][name][li][:, :s]),
                                       atol=1e-4)
    # decode continues from the rewound length in both packages
    jstep_fn = jstep.make_serve_step(cfg)
    tstep_fn = tstep.make_serve_step(tcfg)
    jt, tt = jnp.asarray(jtok)[:, None], ttok[:, None]
    for _ in range(3):
        jt, jc = jstep_fn(jparams, jt, jc)
        tt, tc = tstep_fn(tparams, tt, tc)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tc["blocks"][0]["len"] == int(jc["blocks"]["len"][0]) == s + 3


def test_launcher_runs_on_cpu_when_asked(capsys):
    res = tlaunch.main(["--device", "cpu", "--smoke", "--batch", "2",
                        "--prompt", "64", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill 2x64" in out and "decode 3 steps" in out and "on cpu" in out
    assert res["tokens"].shape == (2, 4)


def test_launcher_refuses_unported_options(capsys, tmp_path):
    # every option of the reference's launcher is ported; a tuning table
    # measured on another device is refused
    from repro_torch.core.autotune import TuningTable

    TuningTable(device="tpu/TPU v5 lite/attn=auto,gemm=auto").save(str(tmp_path / "t.json"))
    with pytest.raises(SystemExit, match="re-run with --autotune"):
        tlaunch.main(["--device", "cpu", "--smoke", "--tuning-file", str(tmp_path / "t.json")])
    # the static path ignores --kv-dtype, as the reference's does
    argv = ["--device", "cpu", "--smoke", "--batch", "1", "--prompt", "16",
            "--new-tokens", "3"]
    plain = tlaunch.main(argv)
    res = tlaunch.main(argv + ["--kv-dtype", "int8"])
    assert torch.equal(res["tokens"], plain["tokens"])
    assert "decode 2 steps" in capsys.readouterr().out


def test_launcher_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--smoke", "--engine", "paged", "--supervise"])
    from repro_torch.launch import train as ttrain

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])
