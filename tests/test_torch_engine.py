"""The port's ``ServingEngine`` vs the JAX reference engine, and the paged
launcher.

Both engines serve the same pinned traces under one fake ``_now`` clock
(installed in both packages), with ``audit()`` on every step: FIFO
admission; the prefix cache with a copy-on-write fork of a partly filled
shared page; ``prefill_budget`` with priority preemption under a small
pool; speculative decoding with a foreign draft (rejections) and with
the target as its own draft (full acceptance).  Tokens must be equal
request by request, and so must every ``stats()`` counter,
``latency_stats`` and ``phase_breakdown``.

Model: ``qwen3_0p6b.scaled_down()`` in f32, params carried over by
``convert.params_from_numpy``; prompts made with numpy from seeds.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3_0p6b").scaled_down()
    tcfg = t_get_config("qwen3_0p6b").scaled_down()
    params = {}
    for name, seed in (("target", 0), ("draft", 7)):
        jp = jtf.init(jax.random.PRNGKey(seed), cfg, jnp.float32)
        params[name] = (jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                      tcfg, "cpu"))
    jp, tp = params["target"]
    params["target_int8"] = (jq.quantize_params(jp), tq.quantize_params(tp))
    return cfg, tcfg, params


def _trace(vocab, shared_len=20):
    """Eight requests, prompts 5..60 tokens; every other one longer than
    ``shared_len`` starts with one shared prefix (a hit that ends mid-page
    at page 8, so admission COW-forks the shared tail page)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    reqs = []
    for i, (n, m) in enumerate([(7, 5), (45, 3), (52, 8), (33, 2), (30, 6),
                                (60, 1), (9, 4), (44, 7)]):
        p = rng.integers(0, vocab, n).astype(np.int32)
        if i % 2 and n > shared_len:
            p[:shared_len] = shared
        reqs.append((p, m))
    return reqs


TRACES = {
    "fifo": dict(),
    "prefix_cow": dict(prefix_cache=True),
    "budget_preempt": dict(prefix_cache=True, prefill_budget=8, num_pages=14),
    "spec_foreign_draft": dict(draft="draft", spec_k=3),
    "spec_self_draft": dict(draft="target", spec_k=3),
    "int8_weights": dict(target="target_int8"),
    "int8_weights_int8_pools_prefix": dict(target="target_int8", kv_dtype="int8",
                                           prefix_cache=True),
    "int8_pools_budget_preempt": dict(kv_dtype="int8", prefix_cache=True,
                                      prefill_budget=8, num_pages=14),
}


@contextlib.contextmanager
def _fake_clock(mod):
    """Install a clock ticking 1 ms per read as ``mod._now``."""
    ticks = [0.0]

    def clock():
        ticks[0] += 1e-3
        return ticks[0]

    prev, mod._now = mod._now, clock
    try:
        yield
    finally:
        mod._now = prev


def _serve(mod, params, cfg, reqs, draft, hook=None, **kw):
    """Drive ``mod.ServingEngine`` over ``reqs`` (request i arrives before
    step i, priorities alternating 0/1, so later high-priority arrivals
    meet running low-priority ones) under a fake clock, auditing every
    step.  ``hook(engine)`` runs once the engine is built."""
    with _fake_clock(mod):
        if draft is not None:
            kw.update(draft_params=draft, draft_cfg=cfg)
        eng = mod.ServingEngine(params, cfg, max_slots=2, max_len=128, page_size=8,
                                prefill_chunk=8, **kw)
        if hook is not None:
            hook(eng)
        for t in range(500):
            if t < len(reqs):
                eng.submit(reqs[t][0], reqs[t][1], priority=t % 2)
            elif not eng.pending and eng.active == 0:
                break
            eng.step(debug_audit=True)
        done = eng.run()
        report = eng.audit()
    return eng, {r.rid: r for r in done}, report


# int8 weights on int8 pools: a one-ulp difference in an f32 K/V row (RoPE,
# qk-norm, summed in another order) can land it one int8 code apart in its
# page; when that row holds the page's max the page re-rounds, and the
# decode step batches both slots under one activation scale, so the next
# logits move by up to ~2e-2 at this size (1.6e-2 measured).  A token of
# that trace may differ only where the reference's top-2 margin for it is
# below this bound; everything else (stats, latency, audits) stays exact.
KV_FLIP_MARGIN = 5e-2


def _record_margins(cfg, margins):
    """A hook that swaps the reference engine's decode step for the same
    step keeping, per (rid, token index), the top-2 logit margin of the
    row that emitted the token."""
    def hook(eng):
        def decode(params, token, caches):
            logits, caches = jtf.decode_step(params, cfg, token, caches)
            lg = np.asarray(logits[:, -1])
            top2 = np.sort(lg, axis=-1)[:, -2:]
            for sid, slot in enumerate(eng.slots):
                if slot.decoding:
                    margins[slot.req.rid, len(slot.req.tokens)] = float(
                        top2[sid, 1] - top2[sid, 0])
            return jnp.asarray(lg.argmax(-1).astype(np.int32)[:, None]), caches
        eng._decode = decode
    return hook


@pytest.mark.parametrize("name", list(TRACES))
def test_engine_matches_reference_engine(model, name, monkeypatch):
    cfg, tcfg, params = model
    forks = []
    fork = teng.kv_cache.fork_page
    monkeypatch.setattr(teng.kv_cache, "fork_page",
                        lambda *a: forks.append(a[1:]) or fork(*a))
    kw = dict(TRACES[name])
    draft = kw.pop("draft", None)
    jtarget, ttarget = params[kw.pop("target", "target")]
    reqs = _trace(cfg.vocab)
    jdraft, tdraft = params[draft] if draft else (None, None)
    # int8 weights: the reference runs op by op, as the port does (its jitted
    # steps fuse the dequant into FMAs that can move an activation code)
    quant = jq.is_quantized(jtarget["blocks"]["mixer"]["wq"])
    margins = {}
    hook = _record_margins(cfg, margins) if quant and kw.get("kv_dtype") == "int8" else None
    with jax.disable_jit() if quant else contextlib.nullcontext():
        jeng_, jdone, jrep = _serve(jeng, jtarget, cfg, reqs, jdraft, hook=hook, **kw)
    teng_, tdone, trep = _serve(teng, ttarget, tcfg, reqs, tdraft, **kw)
    assert sorted(tdone) == sorted(jdone) == list(range(len(reqs)))
    for rid, r in jdone.items():
        got = tdone[rid].tokens
        if hook is not None and got != r.tokens:
            j = next(i for i, (a, b) in enumerate(zip(got, r.tokens)) if a != b)
            assert len(got) == len(r.tokens) and margins[rid, j] < KV_FLIP_MARGIN, (rid, j)
        else:
            assert got == r.tokens, rid
        assert tdone[rid].preemptions == r.preemptions
    assert teng_.stats() == jeng_.stats()
    assert trep == jrep
    done_t = [tdone[i] for i in sorted(tdone)]
    done_j = [jdone[i] for i in sorted(jdone)]
    assert teng.latency_stats(done_t) == jeng.latency_stats(done_j)
    assert teng.phase_breakdown(done_t) == jeng.phase_breakdown(done_j)
    # zero leaks: every page not held by the radix tree is free
    held = len(teng_.prefix.pages()) if teng_.prefix is not None else 0
    assert teng_.allocator.num_free + held == teng_.num_pages
    assert (teng_.block_tables == -1).all()
    st = teng_.stats()
    if name == "prefix_cow":
        assert forks and st["prefix_hits"] >= 2
    if name == "budget_preempt":
        assert st["preemptions"] >= 1 and st["prefill_budget"] == 8
    if name == "spec_self_draft":
        assert st["accepted_per_spec_step"] > 2
    if name == "spec_foreign_draft":
        assert st["accepted_per_spec_step"] < 2
    if "int8_pools" in name:
        assert teng_.kv_dtype == "int8" and teng_.prefix.full_pages_only
        assert st["prefix_hits"] >= 1 and not forks, "int8 hits end on a page boundary"
        assert st["prefix_hit_tokens"] % 8 == 0


def test_engine_cancel_and_quarantine_match_reference(model):
    """``cancel`` of a queued and of a running request, then
    ``quarantine_slot`` on the freed lane: same tokens, stats, audits."""
    cfg, tcfg, params = model
    reqs = _trace(cfg.vocab)
    out = []
    for mod, p, c in ((jeng, params["target"][0], cfg), (teng, params["target"][1], tcfg)):
        with _fake_clock(mod):
            eng = mod.ServingEngine(p, c, max_slots=2, max_len=128, page_size=8,
                                    prefill_chunk=8)
            rs = [eng.submit(q, m) for q, m in reqs]
            eng.step()
            eng.step()
            assert eng.cancel(rs[-1]) and eng.cancel(rs[0])
            sid = next(i for i, s in enumerate(eng.slots) if s.req is None)
            eng.quarantine_slot(sid)
            done = eng.run()
            out.append(({r.rid: (r.tokens, r.cancelled) for r in done}, eng.stats(),
                        eng.audit()))
    assert out[0] == out[1]
    assert out[1][1]["cancelled"] == 2 and out[1][1]["slots_quarantined"] == 1


def test_engine_refuses_what_the_port_lacks(model):
    """An SWA config's rolling-buffer prefill cannot pause or resume, so
    the engine refuses a prefill budget and the prefix cache for it, as
    the reference does; it serves it otherwise."""
    _, tcfg, params = model
    swa = dataclasses.replace(tcfg, sliding_window=16)
    with pytest.raises(NotImplementedError, match="SWA rolling buffer cannot pause"):
        teng.ServingEngine(params["target"][1], swa, prefill_budget=8)
    with pytest.raises(NotImplementedError, match="SWA rolling buffer cannot seed"):
        teng.ServingEngine(params["target"][1], swa, prefix_cache=True)
    assert not teng.ServingEngine(params["target"][1], swa)._dyn_prefill
    with pytest.raises(ValueError, match="prefill_budget"):
        teng.ServingEngine(params["target"][1], tcfg, prefill_budget=0)


def test_paged_launcher_runs_on_cpu_when_asked(capsys):
    res = tlaunch.main(["--engine", "paged", "--device", "cpu", "--smoke", "--batch", "2",
                        "--prompt", "64", "--new-tokens", "8", "--prefix-cache"])
    out = capsys.readouterr().out
    assert "paged engine: 4 requests" in out and "on cpu" in out
    assert "token latency p50" in out and "ttft p50" in out
    assert "admitted 4, rejected 0" in out and "prefix cache: " in out
    assert len(res["done"]) == 4
    res["engine"].audit()


def test_paged_launcher_runs_int8_pools_on_cpu(capsys):
    res = tlaunch.main(["--engine", "paged", "--device", "cpu", "--smoke", "--batch", "2",
                        "--prompt", "64", "--new-tokens", "8", "--prefix-cache",
                        "--kv-dtype", "int8"])
    out = capsys.readouterr().out
    assert "paged engine: 4 requests" in out and "(int8, " in out
    eng = res["engine"]
    assert eng.kv_dtype == "int8" and eng.blocks[0]["k_pages"].dtype == torch.int8
    assert eng.prefix.full_pages_only and eng.stats()["prefix_hit_tokens"] % eng.page_size == 0
    assert len(res["done"]) == 4 and all(len(r.tokens) == r.max_new for r in res["done"])
    eng.audit()


def _table_file(path, device, **entries):
    from repro_torch.core.autotune import TuningTable

    t = TuningTable(device=device)
    for kind, knobs in entries.items():
        t.put(kind, **knobs)
    t.save(str(path))
    return str(path)


@pytest.mark.parametrize("case", ["autotune", "load", "foreign"])
def test_launcher_tuning_flags_run_on_cpu(capsys, tmp_path, case):
    """--autotune tunes flash and the paged kernel on the CPU and writes a
    table the engine then takes its page size from; --tuning-file installs
    a table for the run (uninstalled after); one measured on another
    device exits."""
    from repro_torch.core.autotune import TuningTable
    from repro_torch.models.layers import tuning_table

    path = tmp_path / "t.json"
    if case == "autotune":
        flags = ["--autotune", "--tuning-file", str(path)]
    elif case == "load":
        flags = ["--tuning-file", _table_file(path, "cpu/cpu/attn=auto,gemm=auto",
                                              serving=dict(page_size=8))]
    else:
        flags = ["--tuning-file", _table_file(path, "cuda/NVIDIA H100 80GB HBM3/attn=auto,gemm=auto",
                                              serving=dict(page_size=8))]
        with pytest.raises(SystemExit, match="measured on 'cuda/NVIDIA H100"):
            tlaunch.main(["--engine", "paged", "--device", "cpu", "--smoke", *flags])
        assert tuning_table() is None
        return
    res = tlaunch.main(["--engine", "paged", "--device", "cpu", "--smoke", "--batch", "2",
                        "--prompt", "32", "--new-tokens", "4", *flags])
    out = capsys.readouterr().out
    table = TuningTable.load(str(path))
    if case == "autotune":
        assert "tune_runtime[flash_prefill]" in out and "tune_runtime[paged_decode]" in out
        assert f"autotune: saved tuning table to {path}" in out
        assert table.device == "cpu/cpu/attn=auto,gemm=auto"
        assert set(table.entries) == {"flash_prefill", "paged_decode", "serving"}
    else:
        assert f"loaded tuning table {path}" in out
    assert res["engine"].page_size == table.get("serving")["page_size"]
    assert "paged engine: 4 requests" in out
    res["engine"].audit()
    assert tuning_table() is None


@pytest.mark.parametrize("engine,strategy", [
    ("paged", "pipeline"),
    ("static", "scatter_gather"),
    ("static", "ai_core_assignment"),
    ("static", "fused"),
    ("static", "pipeline"),
])
def test_launcher_strategy_runs_on_cpu(capsys, engine, strategy):
    """Every --strategy places the params on make_mesh_for's mesh (one
    CPU: the identity) and serves; the static path's caches go through
    cache_specs."""
    res = tlaunch.main(["--engine", engine, "--device", "cpu", "--smoke", "--batch", "2",
                        "--prompt", "32", "--new-tokens", "4", "--strategy", strategy])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"mesh {{'data': 1, 'model': 1}}  arch qwen3_0p6b  strategy {strategy}"
    if engine == "paged":
        assert out[1].startswith("paged engine: 4 requests")
        res["engine"].audit()
    else:
        assert out[1].startswith("prefill 2x32 in ") and out[2].startswith("decode 3 steps")
        assert res["tokens"].shape == (2, 4)


@pytest.mark.parametrize("flags", [
    ["--supervise"],
    ["--fault-plan", "decode_nan:step=3"],
    ["--deadline-ms", "1e-3"],
], ids=["supervise", "fault_plan", "deadline_ms"])
def test_supervised_launcher_runs_on_cpu(capsys, flags):
    """The reference's supervisor summary: a clean supervised run, an
    injected decode_nan recovered in place, and a deadline every request
    misses (each cancelled within one supervised step)."""
    res = tlaunch.main(["--engine", "paged", "--device", "cpu", "--smoke", "--batch", "2",
                        "--prompt", "64", "--new-tokens", "8", "--prefix-cache", *flags])
    out = capsys.readouterr().out
    sup = res["supervisor"]
    assert f"supervisor: {sup.steps} supervised steps, {sup.recoveries} recoveries" in out
    if flags[0] == "--supervise":
        assert "events {}" in out and sup.events == []
        assert "paged engine: 4 requests" in out
    if flags[0] == "--fault-plan":
        assert "events {'quarantine': 1}" in out and "step 3: quarantine" in out
        assert "paged engine: 4 requests" in out and not sup.degraded
    if flags[0] == "--deadline-ms":
        assert "4 requests cancelled (deadline/shed)" in out
        assert "paged engine: no requests finished" in out
        assert [e.kind for e in sup.events] == ["cancel_deadline"] * 4
    res["engine"].audit()


@pytest.mark.parametrize("case", ["supervise", "fault_plan", "autotune", "load", "foreign"])
def test_train_launcher_supervise_and_tuning_flags_run_on_cpu(capsys, tmp_path, case):
    """--supervise prints the reference's summary; --fault-plan 'nan:step=3'
    one rollback to the start (no --ckpt) and done; --autotune writes a
    flash table that --tuning-file installs; a foreign table exits."""
    from repro_torch.core.autotune import TuningTable
    from repro_torch.launch import train as ttrain
    from repro_torch.models.layers import tuning_table

    path = tmp_path / "t.json"
    base = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4"]
    if case in ("supervise", "fault_plan"):
        flags = ["--supervise"] if case == "supervise" else ["--fault-plan", "nan:step=3"]
        res = ttrain.main([*base, "--steps", "8", *flags])
        out = capsys.readouterr().out.splitlines()
        assert out[-1] == "done" and len(res.losses) == 8
        assert out[-3 if case == "fault_plan" else -2].startswith(
            f"final loss {res.final_loss:.4f}  mean step ")
        if case == "supervise":
            assert res.events == [] and out[-2].endswith("events 0")
        else:
            ev, = res.events
            assert ev.kind == "rollback" and ev.detail == {"skipped_data_index": 3,
                                                           "restored_step": 0}
            assert out[-3].endswith("events 1")
            assert out[-2].startswith("  [rollback] at step 3: lost 3 steps, recovered in ")
            assert "{'skipped_data_index': 3, 'restored_step': 0}" in out[-2]
        return
    if case == "foreign":
        t = TuningTable(device="tpu/TPU v5 lite/attn=auto,gemm=auto")
        t.put("flash_prefill", block_q=128, block_k=128)
        t.save(str(path))
        with pytest.raises(SystemExit, match="not on this process's 'cpu/cpu/"):
            ttrain.main([*base, "--steps", "1", "--tuning-file", str(path)])
        return
    ttrain.main([*base, "--steps", "2", "--autotune", "--tuning-file", str(path)])
    out = capsys.readouterr().out
    assert "tune_runtime[flash_prefill]" in out and out.endswith("done\n")
    table = TuningTable.load(str(path))
    assert set(table.entries) == {"flash_prefill"}
    assert table.device == "cpu/cpu/attn=auto,gemm=auto"
    if case == "load":
        ttrain.main([*base, "--steps", "2", "--tuning-file", str(path)])
        out = capsys.readouterr().out
        assert out.startswith(f"loaded tuning table {path}") and out.endswith("done\n")
    assert tuning_table() is None


@pytest.mark.parametrize("flags,line", [
    (["--strategy", "pipeline"],
     "pipeline stages 1  boundaries (0, 2)  microbatches 1  schedule 1f1b"),
    (["--strategy", "pipeline", "--pipeline-schedule", "gpipe"],
     "pipeline stages 1  boundaries (0, 2)  microbatches 1  schedule gpipe"),
    (["--strategy", "pipeline", "--microbatches", "2"],
     "pipeline stages 1  boundaries (0, 2)  microbatches 2  schedule 1f1b"),
    (["--strategy", "ai_core_assignment"], None),
], ids=["strategy", "pipeline_schedule", "microbatches", "ai_core_assignment"])
def test_train_launcher_distribution_flags_run_on_cpu(capsys, flags, line):
    """The reference's distribution flags on one CPU: a (1, 1) mesh, the
    pipeline's planner cuts and bubble-tuned (or given) microbatches, two
    steps to ``done``."""
    from repro_torch.launch import train as ttrain

    state = ttrain.main(["--device", "cpu", "--smoke", "--steps", "2", "--seq", "32",
                         "--batch", "2", *flags])
    out = capsys.readouterr().out.splitlines()
    strategy = flags[1]
    assert out[0] == (f"device cpu  arch qwen3_0p6b  strategy {strategy}  "
                      f"mesh {{'data': 1, 'model': 1}}")
    if line is not None:
        assert out[1] == line
    assert out[-1] == "done" and int(state["step"]) == 2


def test_train_launcher_production_mesh_needs_256_devices():
    """As the reference's ``jax.make_mesh``: the 16 x 16 mesh refuses a
    host with fewer devices."""
    from repro_torch.launch import train as ttrain

    with pytest.raises(ValueError, match=r"Number of devices 1 must be >= the product of "
                                         r"mesh_shape \(16, 16\)"):
        ttrain.main(["--device", "cpu", "--smoke", "--steps", "1", "--production-mesh"])


def test_train_launcher_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch import train as ttrain

    state = ttrain.main(["--device", "cpu", "--smoke", "--steps", "4", "--seq", "32",
                         "--batch", "2"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("device cpu  arch qwen3_0p6b  strategy fused")
    assert out.splitlines()[-1] == "done" and int(state["step"]) == 4
