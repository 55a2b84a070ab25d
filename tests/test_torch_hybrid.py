"""The port's hybrid family (zamba2_2p7b) vs the JAX reference: groups of
``attn_every`` Mamba2 layers, each followed by the one shared GQA block and
its MLP (one set of weights, one KV cache per group).

* the param tree (no FFN in the backbone blocks, one ``shared_attn``) and
  the caches (Mamba2 states per layer, a GQA cache per group, ``len`` read
  from the first group's);
* ``forward`` logits within 1e-4 at S 48 and at S 520 (the shared block on
  the flash branch);
* greedy tokens equal through a chunked prefill with an exact-size ragged
  remainder, with the Mamba2 states and every group's K/V equal where
  filled; ``generate``; int8 (``quantize_params``, the shared block's seven
  projections too) tokens equal to the reference run op by op;
* the paged engine and ``init_paged_caches`` refuse it (tested with the
  other families in ``tests/test_torch_serve.py``).

Model: ``zamba2_2p7b.scaled_down()`` (4 layers, ``attn_every`` 2: two
groups; d_model 128, 4 heads of 32 on 2 KV heads) in f32, params from the
reference's init carried over by ``convert.params_from_numpy``.  The two
slowest reference runs (the chunked prefill and the int8 run op by op,
both eager) run in subprocesses of their own, started with the module,
beside its other tests.
"""

import os
import subprocess
import sys

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
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from test_torch_ssm import TORCH_IO, _greedy, _tokens  # noqa: E402

LOGIT_ATOL = 1e-4
ATOL = 1e-5
# K/V after several layers (values ~2), as the dense slice's cache check
CACHE_ATOL = 1e-4


#: the reference's runs in subprocesses: each writes an npz of its results
_REF_SCRIPT = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import get_config
from repro.models import transformer as jtf
from repro.optim import quant as jq
from repro.serve import step as jstep
from test_torch_ssm import JAX_IO, _greedy, _tokens

cfg = get_config("zamba2_2p7b").scaled_down()
jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
out = {}
if sys.argv[2] == "chunked":
    prompt = _tokens(2, 2, 100, cfg.vocab)
    jc = jtf.init_caches(cfg, 2, 110, jnp.float32)
    jtok, jc = jstep.make_prefill_step(cfg, chunk=32)(jp, jnp.asarray(prompt), jc)
    out["prefill_tokens"] = np.asarray(jtok)
    for name in ("ssm", "conv"):
        out[name] = np.asarray(jc["blocks"][name])
    for name in ("k", "v", "len"):
        out["shared_" + name] = np.asarray(jc["shared_attn"][name])
    out["tokens"], _ = _greedy(jstep, jp, cfg, prompt, 32, 5, JAX_IO)
else:
    # int8: the reference run op by op (its jitted steps fuse FMAs that can
    # move an activation code)
    with jax.disable_jit():
        out["tokens"], _ = _greedy(jstep, jq.quantize_params(jp), cfg,
                                   _tokens(4, 2, 40, cfg.vocab), 16, 4, JAX_IO)
np.savez(sys.argv[1], **out)
"""
#: the limit on each reference subprocess, near its measured time
REF_TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def reference_runs(tmp_path_factory):
    """The chunked-prefill and int8 reference runs, one subprocess each,
    started with the module.  Yields {name: (process, results path, log)}."""
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tmp_path_factory.mktemp("ref_hybrid")
    procs = {}
    try:
        for name in ("chunked", "int8"):
            out, log = tmp / f"{name}.npz", tmp / f"{name}.log"
            with open(log, "w") as f:
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-c", _REF_SCRIPT, str(out), name], stdout=f,
                    stderr=subprocess.STDOUT, text=True, cwd=here,
                    env={"PYTHONPATH": os.pathsep.join([os.path.join(here, "..", "src"), here]),
                         "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                         "HOME": os.environ.get("HOME", "/tmp"),
                         "JAX_PLATFORMS": "cpu"}), out, log)
        yield procs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)


def _reference(runs, name):
    proc, out, log = runs[name]
    assert proc.wait(REF_TIMEOUT) == 0, log.read_text()
    return dict(np.load(out))


@pytest.fixture(scope="module")
def model():
    cfg = get_config("zamba2_2p7b").scaled_down()
    tcfg = t_get_config("zamba2_2p7b").scaled_down()
    assert cfg.num_layers // cfg.attn_every == 2
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jp, tcfg, tp


def test_param_tree_and_caches(model):
    cfg, jp, tcfg, tp = model
    assert set(tp["blocks"][0]) == {"norm1", "mixer"} == set(jp["blocks"])
    assert set(tp["shared_attn"]) == {"norm", "attn", "mlp_norm", "mlp"}
    np.testing.assert_array_equal(tp["shared_attn"]["attn"]["wq"]["w"].numpy(),
                                  np.asarray(jp["shared_attn"]["attn"]["wq"]["w"]))
    own = ttf.init(tcfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                   device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: 0, own)) == jax.tree.structure(
        jax.tree.map(lambda a: 0, tp))
    caches = ttf.init_caches(tcfg, 2, 64, torch.float32, "cpu")
    assert len(caches["blocks"]) == 4 and set(caches["blocks"][0]) == {"ssm", "conv"}
    assert len(caches["shared_attn"]) == 2
    assert caches["shared_attn"][1]["k"].shape == (2, 64, cfg.kv_heads, cfg.head_dim)
    caches["shared_attn"][0]["len"] = 7
    assert ttf._cache_len(tcfg, caches) == 7


@pytest.mark.parametrize("s", [48, 520])
def test_forward_logits_match_reference(model, s):
    cfg, jp, tcfg, tp = model
    toks = _tokens(1, 2, s, cfg.vocab)
    want, _ = jtf.forward(jp, cfg, jnp.asarray(toks))
    got, aux = ttf.forward(tp, tcfg, torch.from_numpy(toks).long())
    assert got.shape == (2, s, cfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


def test_chunked_prefill_tokens_and_caches_equal_reference(model, reference_runs):
    """Prompt 100 at chunk 32: three chunks, then an exact-size 4-token
    remainder; every Mamba2 state and each group's K/V rows equal, ``len``
    100 in every group; then decode."""
    cfg, jp, tcfg, tp = model
    prompt = _tokens(2, 2, 100, cfg.vocab)
    tc = ttf.init_caches(tcfg, 2, 110, torch.float32, "cpu")
    ttok, tc = tstep.make_prefill_step(tcfg, chunk=32)(tp, torch.from_numpy(prompt).long(), tc)
    got, _ = _greedy(tstep, tp, tcfg, prompt, 32, 5, TORCH_IO)
    ref = _reference(reference_runs, "chunked")
    np.testing.assert_array_equal(ttok.numpy(), ref["prefill_tokens"])
    for li in range(cfg.num_layers):
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tc["blocks"][li][name].numpy(), ref[name][li],
                                       atol=ATOL, rtol=1e-4)
    for gi in range(2):
        assert tc["shared_attn"][gi]["len"] == int(ref["shared_len"][gi]) == 100
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["shared_attn"][gi][name][:, :100].numpy(),
                                       ref["shared_" + name][gi][:, :100], atol=CACHE_ATOL)
    np.testing.assert_array_equal(got, ref["tokens"])


def test_generate_greedy_tokens_equal_reference(model):
    """Prompt 520 in one call: the shared block's flash branch, then the
    decode path on every group's cache."""
    cfg, jp, tcfg, tp = model
    prompt = _tokens(3, 2, 520, cfg.vocab)
    want = jstep.generate(jp, cfg, jnp.asarray(prompt), 5, 530, jnp.float32)
    got = tstep.generate(tp, tcfg, torch.from_numpy(prompt).long(), 5, 530, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_tokens_equal_reference_run_op_by_op(model, reference_runs):
    """Every Mamba2 in/out projection, the shared block's seven and the
    LM head on the VTA GEMM's plain version; prompt 40 at chunk 16,
    against the reference run op by op (its subprocess)."""
    cfg, jp, tcfg, tp = model
    qtp = tq.quantize_params(tp)
    sa = qtp["shared_attn"]
    assert all("qw" in sa["attn"][w] for w in ("wq", "wk", "wv", "wo"))
    assert all("qw" in sa["mlp"][w] for w in ("w_gate", "w_up", "w_down"))
    prompt = _tokens(4, 2, 40, cfg.vocab)
    got, _ = _greedy(tstep, qtp, tcfg, prompt, 16, 4, TORCH_IO)
    np.testing.assert_array_equal(got, _reference(reference_runs, "int8")["tokens"])
