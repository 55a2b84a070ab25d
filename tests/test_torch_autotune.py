"""The port's planner half of ``core.autotune`` against the reference's.

Both are pure Python doing the same arithmetic in the same order, so all
is compared exactly: ``tune`` on ResNet-18's graph for both boards (every
one of the 16 rows, the best config, the baseline), ``tune_microbatches``
over stages 1-8 x batch 1-64 x both schedules x two bubble targets,
``choose_pattern`` on the same synthetic fitted ``RuntimeCostModel``,
``default_grid``, ``KindResult`` / ``TuneReport``, and ``TuningTable``
files: a round trip, a stale version refused, and each package loading
the other's file.
"""

import dataclasses
import json

import pytest

pytest.importorskip("torch")

from repro.core import autotune as jat  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro_torch.core import autotune as tat  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402

BOARDS = ("ZYNQ7020", "ULTRASCALE")


def _d(obj):
    return dataclasses.asdict(obj)


@pytest.mark.parametrize("board", BOARDS)
def test_tune_equal(board):
    want = jat.tune(jgraph.resnet18_graph(), getattr(jcm, board))
    got = tat.tune(tgraph.resnet18_graph(), getattr(tcm, board))
    assert len(got.table) == len(want.table) == 16
    assert [(_d(c), ms) for c, ms in got.table] == [(_d(c), ms) for c, ms in want.table]
    assert _d(got.best) == _d(want.best)
    assert (got.best_ms, got.baseline_ms, got.speedup) == (
        want.best_ms, want.baseline_ms, want.speedup)
    assert [_d(c) for c in tat.candidate_configs(getattr(tcm, board).vta)] == [
        _d(c) for c in jat.candidate_configs(getattr(jcm, board).vta)]
    if board == "ULTRASCALE":  # the paper's §IV direction, rediscovered
        assert got.speedup > 1.2 and got.best.block >= 32


def test_achievable_clock_equal():
    for block in (8, 16, 32, 64):
        for scale in (0.5, 1.0, 2.0, 4.0):
            assert (tat.achievable_clock(300e6, block, scale)
                    == jat.achievable_clock(300e6, block, scale))
    assert tat.TIMING_PENALTY_BLOCK == jat.TIMING_PENALTY_BLOCK


@pytest.mark.parametrize("target", [0.15, 0.05])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_tune_microbatches_equal(schedule, target):
    for stages in range(1, 9):
        for batch in range(1, 65):
            want = jat.tune_microbatches(stages, batch, schedule, target)
            assert tat.tune_microbatches(stages, batch, schedule, target) == want
            assert batch % want == 0
        for cap in (1, 3, 8):
            assert (tat.tune_microbatches(stages, 48, schedule, target, cap)
                    == jat.tune_microbatches(stages, 48, schedule, target, cap))


def test_tune_microbatches_reference_uses():
    """The reference's own assertions (tests/test_core.py) and its
    launcher's choice for chip_smoke's pipeline: 4 stages, batch 4."""
    for sched in ("gpipe", "1f1b"):
        m = tat.tune_microbatches(4, 48, sched)
        assert 48 % m == 0 and 1 <= m < 48
    assert tat.tune_microbatches(1, 64) == 1
    assert tat.tune_microbatches(4, 8) == 4
    assert tat.tune_microbatches(4, 4, "1f1b") == jat.tune_microbatches(4, 4, "1f1b") == 4


def _synthetic_entries(mod):
    """The reference's synthetic profile (tests/test_autotune.py): known
    positive-linear structure over each kind's features."""
    entries = []
    for seq in (128, 256, 512):
        for bq in (64, 128, 256):
            p = dict(seq=seq, block_q=bq, block_k=bq, batch=1, heads=4, head_dim=64)
            f = mod.runtime_features("flash_prefill", p)
            entries.append({"kind": "flash_prefill", "params": p,
                            "t_s": 1e-9 * f[0] + 2e-5 * f[1] + 1e-4})
    for fill in (64, 256, 1024):
        for bk in (128, 512):
            p = dict(buf=1024, fill=fill, block_k=bk, batch=2, heads=4, head_dim=64)
            f = mod.runtime_features("decode", p)
            entries.append({"kind": "decode", "params": p,
                            "t_s": 2e-9 * f[0] + 1e-5 * f[1] + 5e-5})
    for fill in (32, 128, 512):
        for pg in (8, 16, 32):
            p = dict(fill=fill, page_size=pg, max_len=512, batch=2, heads=4, head_dim=64)
            f = mod.runtime_features("paged_decode", p)
            entries.append({"kind": "paged_decode", "params": p,
                            "t_s": 1e-9 * f[0] + 3e-5 * f[1] + 1e-4})
    return entries


CHOICES = [
    dict(batch=1, max_len=512, stages=4, microbatches=1),
    dict(batch=1, max_len=512, stages=4, microbatches=8),
    dict(batch=2, max_len=1024, fill=64, page_size=8, block_k=256),
    dict(batch=2, max_len=1024, fill=1024, page_size=32, kv_bytes_budget=1.0),
    dict(batch=4, max_len=2048, fill=700, kv_bytes_per_token=512.0, stages=2,
         microbatches=2, schedule="gpipe"),
    dict(batch=1, max_len=256, fill=256, page_size=8, block_k=256, heads=8, kv_heads=1,
         head_dim=128),
]


@pytest.mark.parametrize("kw", CHOICES, ids=[str(i) for i in range(len(CHOICES))])
def test_choose_pattern_equal(kw):
    jm = jcm.RuntimeCostModel.fit(_synthetic_entries(jcm), device="synthetic")
    tm = tcm.RuntimeCostModel.fit(_synthetic_entries(tcm), device="synthetic")
    assert tm.to_json() == jm.to_json()
    want = jat.choose_pattern(jm, **kw)
    got = tat.choose_pattern(tm, **kw)
    assert _d(got) == _d(want)


def test_choose_pattern_pipeline_decision():
    m = tcm.RuntimeCostModel.fit(_synthetic_entries(tcm), device="synthetic")
    assert tat.choose_pattern(m, batch=1, max_len=512, stages=4,
                              microbatches=1).execution == "sequential"
    pipe = tat.choose_pattern(m, batch=1, max_len=512, stages=4, microbatches=8)
    assert pipe.execution == "pipelined" and pipe.predicted["pipeline_rounds"] < 32
    forced = tat.choose_pattern(m, batch=1, max_len=256, fill=256, page_size=8,
                                block_k=256, kv_bytes_budget=1.0)
    assert forced.cache_layout == "paged"
    assert forced.reasons[0].startswith("dense KV residency")


def test_default_grid_and_reports_equal():
    for kind in ("decode", "gemm_int8", "paged_decode", "prefill_chunk"):
        assert tat.default_grid(kind) == jat.default_grid(kind)
    # flash: the same base and candidates around the port kernel's own
    # default blocks (64 / 64; the reference's are 128 / 128)
    (tb, td, tc), (jb, jd, jc) = tat.default_grid("flash_prefill"), jat.default_grid("flash_prefill")
    assert (tb, tc) == (jb, jc) and td == dict(block_q=64, block_k=64) != jd
    for mod in (tat, jat):
        with pytest.raises(ValueError, match="no default grid"):
            mod.default_grid("nope")
    assert tat.TUNING_VERSION == jat.TUNING_VERSION
    kr = tat.KindResult("decode", 2e-5, 1e-5, {"block_k": 256}, 3, 5)
    jkr = jat.KindResult("decode", 2e-5, 1e-5, {"block_k": 256}, 3, 5)
    assert _d(kr) == _d(jkr) and kr.speedup == jkr.speedup == 2.0
    rep = tat.TuneReport(table=tat.TuningTable(), model=tcm.RuntimeCostModel(),
                         entries=[], results=[kr])
    assert rep.result("decode") is kr


def _table(mod):
    t = mod.TuningTable(device="cpu/test/attn=jnp,gemm=jnp")
    t.put("flash_prefill", block_q=256, block_k=128)
    t.put("serving", page_size=32)
    t.put("serving", prefill_chunk=16)  # merges, doesn't replace
    t.meta["config_hash"] = "abc123"
    return t


def test_tuning_table_roundtrip(tmp_path):
    path = tmp_path / "table.json"
    _table(tat).save(str(path))
    back = tat.TuningTable.load(str(path))
    assert back.device == "cpu/test/attn=jnp,gemm=jnp"
    assert back.get("flash_prefill") == {"block_q": 256, "block_k": 128}
    assert back.get("serving") == {"page_size": 32, "prefill_chunk": 16}
    assert back.get("missing_kind") == {}
    assert back.meta["config_hash"] == "abc123"


def test_tuning_table_stale_version_rejected(tmp_path):
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"version": tat.TUNING_VERSION + 1,
                                "entries": {"serving": {"page_size": 8}}}))
    with pytest.raises(ValueError, match="stale tuning table"):
        tat.TuningTable.load(str(path))
    path.write_text(json.dumps({"entries": {}}))  # a missing version is stale too
    with pytest.raises(ValueError, match="stale tuning table"):
        tat.TuningTable.load(str(path))


@pytest.mark.parametrize("writer,reader", [(tat, jat), (jat, tat)],
                         ids=["port_to_reference", "reference_to_port"])
def test_tuning_table_files_cross_load(tmp_path, writer, reader):
    """Each package loads the other's file: the same JSON bytes, the same
    table back."""
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    _table(writer).save(str(a))
    _table(reader).save(str(b))
    assert a.read_text() == b.read_text()
    back = reader.TuningTable.load(str(a))
    assert _d(back) == _d(_table(reader))
