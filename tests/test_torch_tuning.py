"""The port's measured tuning against the JAX reference's: ``core.measure``,
``core.autotune.tune_runtime``, ``models.layers.set_tuning`` /
``tuning_table`` / ``tuned``, the engine's knob resolution and the
launchers' table files.

* ``config_hash`` equals the reference's for every config; the
  ``measure_*`` grids give the reference's entry kinds and params (times
  differ: the port times its plain versions here); profiles and tables
  cross-load in both directions.
* ``tune_runtime`` with ``measure_point`` replaced by one deterministic
  timer in both packages gives the reference's table entries, measured
  points, measured times and ``KindResult``s (no test gates on
  wall-clock order).  The port drops the flash blocks its kernel refuses
  for shared memory before measuring, and refuses ``decode`` /
  ``gemm_int8`` (their knobs change nothing in the port's kernels).
* ``flash_attend`` with blocks equals it without; tuned blocks reach the
  wrapper's grid (its execution map); the engine resolves ``page_size`` /
  ``prefill_chunk`` from the table as the reference's does, and its
  tokens under a tuned table equal the untuned ones and the reference
  engine's under the same table.

Model: ``qwen3_0p6b.scaled_down(num_layers=2, d_model=64, vocab=256)`` in
f32, params carried over by ``convert.params_from_numpy``.
"""

import dataclasses
import functools
import importlib
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import autotune as jat  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import measure as jmeasure  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import autotune as tat  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import measure as tmeasure  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402

tfl = importlib.import_module("repro_torch.kernels.flash_attention")
CPU = torch.device("cpu")
SMALL = dict(num_layers=2, d_model=64, vocab=256)


@pytest.fixture(autouse=True)
def _untuned():
    """Every test starts and ends with no table installed in either package."""
    prev = jlayers.set_tuning(None), tlayers.set_tuning(None)
    yield
    jlayers.set_tuning(prev[0])
    tlayers.set_tuning(prev[1])


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jget_config("qwen3_0p6b").scaled_down(**SMALL)
    cfg = get_config("qwen3_0p6b").scaled_down(**SMALL)
    jparams = jtf.init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


# ---------------------------------------------------------------------------
# measure: hashes, entries, profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_hash_equal(arch):
    assert tmeasure.config_hash(get_config(arch)) == jmeasure.config_hash(jget_config(arch))
    small_t = get_config(arch).scaled_down()
    small_j = jget_config(arch).scaled_down()
    assert tmeasure.config_hash(small_t) == jmeasure.config_hash(small_j)


def test_measure_entries_match_reference_params():
    """Every grid gives the reference's kinds and params, in its order,
    with finite positive times (the CPU's, not a device's)."""
    jcfg, jparams, cfg, params = _model()
    fast = dict(warmup=1, reps=1)
    pairs = [
        (tmeasure.measure_flash_prefill(seqs=(64,), blocks=((32, 32), (64, 16)), device=CPU,
                                        **fast),
         jmeasure.measure_flash_prefill(seqs=(64,), blocks=((32, 32), (64, 16)), **fast)),
        (tmeasure.measure_decode(buf=128, fills=(32, 128), block_ks=(64,), device=CPU, **fast),
         jmeasure.measure_decode(buf=128, fills=(32, 128), block_ks=(64,), **fast)),
        (tmeasure.measure_paged_decode(max_len=64, fills=(16, 40), page_sizes=(8, 16),
                                       device=CPU, **fast),
         jmeasure.measure_paged_decode(max_len=64, fills=(16, 40), page_sizes=(8, 16), **fast)),
        (tmeasure.measure_gemm(m=32, n=32, k=32, block_sets=[dict(block_m=32, block_n=32,
                                                                  block_k=32)],
                               device=CPU, **fast),
         jmeasure.measure_gemm(m=32, n=32, k=32, block_sets=[dict(block_m=32, block_n=32,
                                                                  block_k=32)], **fast)),
        (tmeasure.measure_prefill_chunk(params, cfg, prompt=32, chunks=(16, 64), **fast),
         jmeasure.measure_prefill_chunk(jparams, jcfg, prompt=32, chunks=(16, 64), **fast)),
    ]
    for got, want in pairs:
        assert [(e["kind"], e["params"]) for e in got] == [(e["kind"], e["params"]) for e in want]
        assert all(math.isfinite(e["t_s"]) and e["t_s"] > 0 for e in got)
    point = tmeasure.measure_point("paged_decode", dict(fill=40, page_size=8, max_len=64),
                                   device=CPU, **fast)
    assert point["params"] == pairs[2][1][1]["params"]
    with pytest.raises(ValueError, match="prefill_chunk needs"):
        tmeasure.measure_point("prefill_chunk", dict(tokens=32, chunk=16), device=CPU)
    with pytest.raises(ValueError, match="unknown measure kind"):
        tmeasure.measure_point("nope", {}, device=CPU)


def test_device_signature_is_the_ports(monkeypatch):
    """torch's device type and card name with the port's dispatch: the JAX
    package's backends are cpu / gpu / tpu, so no card's table is shared."""
    assert tmeasure.device_signature(CPU) == "cpu/cpu/attn=auto,gemm=auto"
    prev = tlayers.set_attention_impl("ref")
    try:
        assert tmeasure.device_signature("cpu") == "cpu/cpu/attn=ref,gemm=auto"
    finally:
        tlayers.set_attention_impl(prev)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert (tmeasure.device_signature() ==
            "cuda/NVIDIA H100 80GB HBM3/attn=auto,gemm=auto")


def test_time_fn_is_a_median_of_fenced_calls():
    calls = []
    t = tmeasure.time_fn(lambda x: calls.append(x), 7, warmup=2, reps=5, device=CPU)
    assert calls == [7] * 7 and t >= 0


def test_profiles_cross_load(tmp_path):
    jcfg, _, cfg, _ = _model()
    entries = [{"kind": "flash_prefill",
                "params": dict(seq=256, block_q=64, block_k=64, **tmeasure.DEFAULT_AUX),
                "t_s": 1e-4},
               {"kind": "paged_decode",
                "params": dict(fill=256, page_size=16, max_pp=32, max_len=512,
                               **tmeasure.DEFAULT_AUX), "t_s": 2e-5}]
    prof = tmeasure.collect_profile(entries, cfg=cfg, extra={"note": "x"}, device=CPU)
    assert prof["device"] == "cpu/cpu/attn=auto,gemm=auto" and prof["backend"] == "cpu"
    assert prof["config_hash"] == jmeasure.config_hash(jcfg) and prof["note"] == "x"
    tmeasure.save_profile(prof, str(tmp_path / "t.json"))
    back = jmeasure.load_profile(str(tmp_path / "t.json"))
    assert back["entries"] == entries
    jprof = jmeasure.collect_profile(entries, cfg=jcfg)
    jmeasure.save_profile(jprof, str(tmp_path / "j.json"))
    assert tmeasure.load_profile(str(tmp_path / "j.json"))["entries"] == entries
    fit = tcm.RuntimeCostModel.fit(back)
    assert fit.to_json() == jcm.RuntimeCostModel.fit(back).to_json()
    bad = dict(prof, schema=tmeasure.PROFILE_SCHEMA + 1)
    tmeasure.save_profile(bad, str(tmp_path / "bad.json"))
    with pytest.raises(ValueError, match="stale profile schema"):
        tmeasure.load_profile(str(tmp_path / "bad.json"))


# ---------------------------------------------------------------------------
# tune_runtime under one deterministic timer
# ---------------------------------------------------------------------------


def _fake_time(kind, p) -> float:
    """A deterministic time with an interior optimum per kind."""
    if kind == "flash_prefill":
        return 1e-3 * (1 + 0.3 * abs(math.log2(p["block_q"]) - 7)
                       + 0.2 * abs(math.log2(p["block_k"]) - 5))
    if kind == "paged_decode":
        return 1e-5 * (1 + 0.1 * abs(math.log2(p["page_size"]) - 5))
    return 1e-2 * (1 + 0.05 * abs(math.log2(p["chunk"]) - 5))


def _fake_point(config_hash, calls):
    """``measure_point`` with the reference's entry params and a fake time."""
    def point(kind, params, *, model_params=None, cfg=None, warmup=2, reps=3, device=None):
        p = dict(params)
        if kind == "flash_prefill":
            p = dict(seq=p["seq"], block_q=p["block_q"], block_k=p["block_k"],
                     **tmeasure.DEFAULT_AUX)
        elif kind == "paged_decode":
            pg = p["page_size"]
            p = dict(fill=p["fill"], page_size=pg, max_pp=-(-p["max_len"] // pg),
                     max_len=p["max_len"], **tmeasure.DEFAULT_AUX)
        else:
            p = dict(tokens=p["tokens"], chunk=p["chunk"], batch=p.get("batch", 2),
                     cfg=config_hash(cfg))
        calls.append((kind, p))
        return {"kind": kind, "params": p, "t_s": _fake_time(kind, p)}
    return point


GRIDS = {
    "flash_prefill": (dict(seq=256), dict(block_q=64, block_k=64),
                      [dict(block_q=bq, block_k=bk)
                       for bq in (32, 64, 128, 256) for bk in (16, 32, 64)]),
    "paged_decode": (dict(max_len=512, fill=256), dict(page_size=16),
                     [dict(page_size=pg) for pg in (8, 16, 32, 64, 128)]),
    "prefill_chunk": (dict(tokens=256, batch=2), dict(chunk=64),
                      [dict(chunk=c) for c in (16, 32, 64, 128, 256)]),
}


def test_tune_runtime_equals_reference_under_one_timer(monkeypatch, tmp_path):
    jcfg, jparams, cfg, params = _model()
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmeasure, "measure_point", _fake_point(jmeasure.config_hash, jcalls))
    monkeypatch.setattr(tmeasure, "measure_point", _fake_point(tmeasure.config_hash, tcalls))
    kinds = ("flash_prefill", "paged_decode", "prefill_chunk")
    want = jat.tune_runtime(jparams, jcfg, kinds=kinds, grids=GRIDS,
                            save_path=str(tmp_path / "j.json"))
    got = tat.tune_runtime(params, cfg, kinds=kinds, grids=GRIDS, device=CPU,
                           save_path=str(tmp_path / "t.json"))
    assert got.table.entries == want.table.entries
    assert got.table.meta == want.table.meta
    assert got.table.device == "cpu/cpu/attn=auto,gemm=auto"
    assert tcalls == jcalls and got.entries == want.entries
    assert [dataclasses.asdict(r) for r in got.results] == [
        dataclasses.asdict(r) for r in want.results]
    assert got.model.to_json() == want.model.to_json()
    assert got.table.get("serving") == {"page_size": 32, "prefill_chunk": 32}
    # the saved tables cross-load
    assert jat.TuningTable.load(str(tmp_path / "t.json")).entries == want.table.entries
    back = tat.TuningTable.load(str(tmp_path / "j.json"))
    assert back.entries == got.table.entries and back.device == want.table.device


def test_tune_runtime_drops_refused_flash_blocks_before_measuring(monkeypatch):
    """At the default aux shape (G 2, D 64, f32) a 128- or 256-key block
    needs more shared memory than a CTA has: never measured."""
    calls = []
    monkeypatch.setattr(tmeasure, "measure_point", _fake_point(tmeasure.config_hash, calls))
    rep = tat.tune_runtime(kinds=("flash_prefill",), device=CPU)
    base, default, cands = tat.default_grid("flash_prefill")
    fits = [c for c in cands if tfl.flash_blocks_fit(torch.float32, 2, min(c["block_q"], 256),
                                                     min(c["block_k"], 256), 64)]
    assert 0 < len(fits) < len(cands)
    timed = {(p["block_q"], p["block_k"]) for _, p in calls}
    assert all(bk <= 64 for _, bk in timed) and (64, 64) in timed
    assert rep.result("flash_prefill").candidates == len(fits) + 1
    assert rep.table.get("flash_prefill")["block_k"] <= 64


@pytest.mark.parametrize("kind", ["decode", "gemm_int8"])
def test_tune_runtime_refuses_knobs_the_kernels_ignore(kind):
    with pytest.raises(ValueError, match=f"{kind}.*not tuned in the port"):
        tat.tune_runtime(kinds=(kind,), device=CPU)


def test_flash_smem_formula_matches_layout():
    """The Python layout of csrc's Smem at the main path's shapes: f32 D 128
    G 2 takes 64-key blocks and refuses 128; bf16 takes 128."""
    assert tfl.flash_smem_bytes(torch.float32, 2, 64, 64, 128) == 202752
    assert tfl.flash_blocks_fit(torch.float32, 2, 256, 64, 128)
    assert not tfl.flash_blocks_fit(torch.float32, 2, 64, 128, 128)
    assert tfl.flash_blocks_fit(torch.bfloat16, 2, 64, 128, 128)
    # 32-key blocks take a 64-key stage; small query panels fewer rows
    assert (tfl.flash_smem_bytes(torch.float32, 2, 64, 32, 128)
            == tfl.flash_smem_bytes(torch.float32, 2, 64, 64, 128))
    assert (tfl.flash_smem_bytes(torch.float32, 1, 16, 64, 128)
            < tfl.flash_smem_bytes(torch.float32, 2, 64, 64, 128))


# ---------------------------------------------------------------------------
# set_tuning, flash blocks, the engine
# ---------------------------------------------------------------------------


def test_set_tuning_and_tuned():
    assert tlayers.tuning_table() is None and tlayers.tuned("flash_prefill") == {}
    t = tat.TuningTable()
    t.put("flash_prefill", block_q=128, block_k=32)
    assert tlayers.set_tuning(t) is None
    assert tlayers.tuning_table() is t
    assert tlayers.tuned("flash_prefill") == {"block_q": 128, "block_k": 32}
    assert tlayers.tuned("serving") == {}
    assert tlayers.set_tuning(None) is t and tlayers.tuned("flash_prefill") == {}


def _qkv(s=128, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((1, s, 4, 32), generator=gen),
            torch.randn((1, s, 2, 32), generator=gen),
            torch.randn((1, s, 2, 32), generator=gen))


def test_flash_block_override_matches_default():
    q, k, v = _qkv()
    base = tlayers.flash_attend(q, k, v)
    assert torch.equal(base, tlayers.flash_attend(q, k, v, block_q=32, block_k=16))
    t = tat.TuningTable()
    t.put("flash_prefill", block_q=128, block_k=32)
    tlayers.set_tuning(t)
    assert torch.equal(base, tlayers.flash_attend(q, k, v))
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    want = jlayers.flash_attend(jq, jk, jv, block_q=32, block_k=64)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_tuned_flash_blocks_reach_the_wrapper(monkeypatch):
    """A table entry gives the wrapper the blocks an explicit override
    does (its execution map is the tile map at those blocks); explicit
    arguments win."""
    seen = []
    real = tfl.flash_attention

    def spy(q, k, v, **kw):
        seen.append((kw["block_q"], kw["block_k"]))
        out, counts = real(q, k, v, return_counts=True, **kw)
        seen.append(counts[0, 0])
        return out

    monkeypatch.setattr(tlayers, "flash_attention", spy)
    q, k, v = _qkv(256)
    tlayers.flash_attend(q, k, v)
    t = tat.TuningTable()
    t.put("flash_prefill", block_q=128, block_k=32)
    tlayers.set_tuning(t)
    tlayers.flash_attend(q, k, v)
    tlayers.flash_attend(q, k, v, block_k=64)
    assert seen[0::2] == [(64, 64), (128, 32), (128, 64)]
    for (bq, bk), counts in zip(seen[0::2], seen[1::2]):
        assert torch.equal(counts, tfl.flash_tile_map(256, 256, block_q=bq, block_k=bk))


def test_engine_resolves_serving_knobs_like_reference():
    jcfg, jparams, cfg, params = _model()
    for put in ({"page_size": 8, "prefill_chunk": 16}, {"page_size": 32}, None):
        tables = []
        for mod in (jat, tat):
            t = mod.TuningTable()
            if put:
                t.put("serving", **put)
            tables.append(t)
        jlayers.set_tuning(tables[0])
        tlayers.set_tuning(tables[1])
        want = jeng.ServingEngine(jparams, jcfg, max_slots=2, max_len=64)
        got = teng.ServingEngine(params, cfg, max_slots=2, max_len=64)
        assert (got.page_size, got._prefill_chunk) == (want.page_size, want._prefill_chunk)
        # explicit arguments beat the table
        got = teng.ServingEngine(params, cfg, max_slots=2, max_len=64, page_size=16,
                                 prefill_chunk=32)
        assert (got.page_size, got._prefill_chunk) == (16, 32)
    assert (want.page_size, want._prefill_chunk) == (16, 64)


def test_tuned_tokens_equal_untuned_and_reference():
    """A pinned trace: tokens under a tuned table (page size, prefill chunk,
    flash blocks) equal the untuned engine's and the reference engine's
    under the same table."""
    jcfg, jparams, cfg, params = _model()
    reqs = [(np.array([5, 7, 11, 13, 17], np.int32), 4),
            (np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32), 6),
            (np.array([9] * 13, np.int32), 3)]

    def run(mod, p, c):
        eng = mod.ServingEngine(p, c, max_slots=2, max_len=64)
        for prompt, n in reqs:
            eng.submit(prompt if mod is teng else jnp.asarray(prompt), n)
        return {r.rid: [int(x) for x in r.tokens] for r in eng.run()}

    base = run(teng, params, cfg)
    tables = []
    for mod in (jat, tat):
        t = mod.TuningTable()
        t.put("serving", page_size=8, prefill_chunk=16)
        t.put("flash_prefill", block_q=32, block_k=32)
        tables.append(t)
    jlayers.set_tuning(tables[0])
    tlayers.set_tuning(tables[1])
    tuned = run(teng, params, cfg)
    assert tuned == base
    assert run(jeng, jparams, jcfg) == tuned


def test_tables_written_by_either_package_load_in_the_other(tmp_path):
    t = tat.TuningTable(device="cuda/NVIDIA H100 80GB HBM3/attn=auto,gemm=auto")
    t.put("flash_prefill", block_q=128, block_k=64)
    t.meta["measured"] = {"flash_prefill": {"default_s": 2e-4, "best_s": 1e-4}}
    t.save(str(tmp_path / "t.json"))
    j = jat.TuningTable.load(str(tmp_path / "t.json"))
    assert (j.device, j.entries, j.meta) == (t.device, t.entries, t.meta)
    j.save(str(tmp_path / "j.json"))
    back = tat.TuningTable.load(str(tmp_path / "j.json"))
    assert dataclasses.asdict(back) == dataclasses.asdict(t)
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
