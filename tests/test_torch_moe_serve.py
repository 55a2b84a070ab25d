"""The port's MoE family served vs the JAX reference: int8 greedy tokens,
the ``ServingEngine`` and the launcher, for ``deepseek_v2_236b`` (MLA,
routed and shared experts) and ``mixtral_8x22b`` (SWA rolling buffer).

* int8 weights (experts quantized per expert, through the VTA GEMM's
  plain version) through chunked prefill and decode: tokens equal to the
  reference run op by op (``jax.disable_jit``);
* one pinned engine trace per model under one fake clock, auditing every
  step (deepseek on MLA pools with the prefix cache and a copy-on-write
  fork, mixtral past a 32-token window): tokens, ``stats()`` and audits
  equal;
* bf16: ``forward`` no further from the f32 reference than the
  reference's own bf16 run is (the two libraries round bf16 apart, and a
  bf16 router input can flip an expert), and a paged engine on bf16
  params and pools;
* the SWA refusals of ``prefill_budget`` and ``prefix_cache``;
* the launcher's static and paged paths on the CPU, f32 / bf16 / int8
  pools.

Models and inputs as ``tests/test_torch_moe.py``'s.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402
from test_torch_engine import _serve, _trace  # noqa: E402
from test_torch_moe import (JAX_IO, TORCH_IO, _greedy, _tokens,  # noqa: E402,F401
                            model, reference_int8)


def test_int8_tokens_equal_reference_run_op_by_op(model):
    """int8 weights (experts through the VTA GEMM's plain version), prompt
    12 at chunk 8 (a padded final chunk; mixtral's exact remainder) then
    three decode steps, against the reference run op by op (its jitted
    steps fuse FMAs that can move an activation code)."""
    cfg, jp, tcfg, tp = model
    prompt = _tokens(6, 2, 12, cfg.vocab)
    jq8 = reference_int8(jp)
    with jax.disable_jit():
        want = _greedy(jstep, jq8, cfg, prompt, 8, 4, 24, JAX_IO)
    got = _greedy(tstep, tq.quantize_params(tp), tcfg, prompt, 8, 4, 24, TORCH_IO)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the engine and the launcher
# ---------------------------------------------------------------------------


ENGINE_CASES = {
    "deepseek_v2_236b": dict(prefix_cache=True),
    "mixtral_8x22b": dict(),
}


def test_engine_trace_matches_reference(model, monkeypatch):
    """Four requests on two slots.  deepseek on MLA pools with the prefix
    cache (a shared tail page is forked); mixtral at a 32-token window, so
    its prompts of 45, 52 and 33 tokens prefill past the window into
    rolling buffers and its decode attends through the paged kernel's
    window."""
    cfg, jp, tcfg, tp = model
    if cfg.sliding_window:
        cfg = dataclasses.replace(cfg, sliding_window=32)
        tcfg = dataclasses.replace(tcfg, sliding_window=32)
    forks = []
    fork = teng.kv_cache.fork_page
    monkeypatch.setattr(teng.kv_cache, "fork_page", lambda *a: forks.append(a[1:]) or fork(*a))
    reqs = _trace(cfg.vocab)[:4]
    kw = ENGINE_CASES[cfg.name]
    jeng_, jdone, jrep = _serve(jeng, jp, cfg, reqs, None, **kw)
    teng_, tdone, trep = _serve(teng, tp, tcfg, reqs, None, **kw)
    assert {r: d.tokens for r, d in tdone.items()} == {r: d.tokens for r, d in jdone.items()}
    assert teng_.stats() == jeng_.stats() and trep == jrep
    if cfg.uses_mla:
        assert set(teng_.blocks[0]) == {"kv_pages"} and forks
    else:
        assert teng_.stats()["prefilled_tokens"] == teng_.stats()["prompt_tokens"]
    assert teng_.allocator.num_free + (len(teng_.prefix.pages()) if teng_.prefix else 0) \
        == teng_.num_pages


def test_bf16_serves_within_the_references_bf16_drift(model):
    cfg, jp, tcfg, tp = model
    toks = _tokens(1, 2, 40, cfg.vocab)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    jb["blocks"]["ffn"]["router"] = jp["blocks"]["ffn"]["router"]  # f32, as init makes it
    want32 = np.asarray(jtf.forward(jp, cfg, jnp.asarray(toks))[0])
    drift = np.abs(np.asarray(jtf.forward(jb, cfg, jnp.asarray(toks))[0], np.float32)
                   - want32).max()
    tb = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu", torch.bfloat16)
    assert tb["blocks"][0]["ffn"]["router"].dtype == torch.float32
    got = ttf.forward(tb, tcfg, torch.from_numpy(toks).long())[0]
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want32).max() <= 1.5 * drift
    eng = teng.ServingEngine(tb, tcfg, max_slots=2, max_len=64, page_size=8,
                             prefill_chunk=16, dtype=torch.bfloat16)
    assert eng.kv_dtype == "bf16" and next(iter(eng.blocks[0].values())).dtype == torch.bfloat16
    for prompt, m in _trace(cfg.vocab)[:3]:
        eng.submit(prompt, m)
    done = eng.run()
    eng.audit()
    assert sorted(len(r.tokens) for r in done) == sorted(m for _, m in _trace(cfg.vocab)[:3])


def test_swa_engine_refuses_budget_and_prefix_cache(model):
    cfg, _, tcfg, tp = model
    swa = dataclasses.replace(tcfg, sliding_window=16)
    with pytest.raises(NotImplementedError, match="SWA"):
        teng.ServingEngine(tp, swa, prefill_budget=8)
    with pytest.raises(NotImplementedError, match="prefix cache"):
        teng.ServingEngine(tp, swa, prefix_cache=True)


@pytest.mark.parametrize("engine,kv_dtype", [("static", "f32"), ("paged", "f32"),
                                             ("paged", "bf16"), ("paged", "int8")])
def test_launcher_runs_moe_configs_on_cpu(model, engine, kv_dtype, capsys):
    cfg = model[0]
    flags = ["--engine", engine, "--device", "cpu", "--smoke", "--batch", "2",
             "--prompt", "40", "--new-tokens", "4", "--arch", cfg.name, "--kv-dtype", kv_dtype]
    if engine == "paged" and not cfg.sliding_window:
        flags.append("--prefix-cache")
    res = tlaunch.main(flags)
    out = capsys.readouterr().out
    if engine == "static":
        assert "prefill 2x40" in out and res["tokens"].shape == (2, 4)
    else:
        assert "paged engine: 4 requests" in out and f"({kv_dtype}, " in out
        assert len(res["done"]) == 4
        res["engine"].audit()
