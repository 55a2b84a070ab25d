"""A whole run of a cell on the CPU, the look for a chip skipped: the
program's served tokens pass the check, and with a served token altered
where the engine produces it the check comes out false."""

import pytest
import torch

from bench.harness import cell
from conftest import tiny_config, tiny_mix

E2E = ("output_tokens_per_s", "ttft_p95_ms", "itl_p95_ms", "setup_s")


def _spec(name, shared):
    return {"c": tiny_config(name), "mix": tiny_mix(shared),
            "limits": {"max_logit_gap": {"limit": 1e-3}},
            "end_to_end": [{"name": n, "unit": "u"} for n in E2E], "per_layer": []}


@pytest.mark.parametrize("shared", [True, False])
def test_run_is_correct(shared):
    out = cell.run(_spec("qwen3_0p6b", shared), seed=2 ** 31 + 99, seconds=0.8, traced=False,
                   device=torch.device("cpu"), t_start=0.0)
    assert out["correct"], out["compared"]
    assert out["compared"]["max_logit_gap"]["value"] <= 1e-3
    assert set(out["metrics"]) == set(E2E)
    assert list(cell.ordered(out))[-1] == "compared"


def test_an_altered_token_is_caught(monkeypatch):
    from repro_torch.serve import engine

    make = engine.make_serve_step

    def broken(cfg, **kw):
        step = make(cfg, **kw)
        calls = {"n": 0}

        def serve_step(params, token, caches, kv=None):
            tok, caches = step(params, token, caches, kv)
            calls["n"] += 1
            if calls["n"] % 3 == 0:  # every third step, one slot's token is off by one
                tok = tok.clone()
                tok[0, 0] = (tok[0, 0] + 1) % cfg.vocab
            return tok, caches

        return serve_step

    monkeypatch.setattr(engine, "make_serve_step", broken)
    out = cell.run(_spec("qwen3_0p6b", True), seed=4242, seconds=0.8, traced=False,
                   device=torch.device("cpu"), t_start=0.0)
    assert not out["correct"]
    assert out["compared"]["max_logit_gap"]["value"] > 1e-3


def test_the_control_is_judged_where_the_program_is():
    """The control's reading covers the same requests and positions as the
    program's: one gap a served token, for both."""
    out = cell.run(_spec("qwen3_0p6b", True), seed=31337, seconds=0.8, traced=False,
                   device=torch.device("cpu"), t_start=0.0, control=True)
    got = out["readings"]
    checked = out["compared"]["requests_checked"]["value"]
    assert len(got["control"]) == len(got["program"]) == checked
    assert got["tokens"] > 0 and 0 <= got["control_flips"] <= got["tokens"]
