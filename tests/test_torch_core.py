"""The port's cluster planner (``repro_torch.core``) vs the reference's
``repro.core``.

Both are pure Python doing the same arithmetic in the same order, so
everything is compared exactly: graphs (op names, MACs, bytes, deps) of
ResNet-18 and of every config, plans of every strategy at N in (1, 2, 4,
8, 12), ``predict`` and the simulator's ``SimResult``s, ``auto_schedule``'s
choice and alternatives, the partitioner, the bubble oracle,
``rebalance`` and ``recut_boundaries``, the cost models' constants and
``RuntimeCostModel``'s fit.  Last, no module of ``repro_torch`` imports
``jax`` or ``repro``: a fresh interpreter with both blocked imports every
one and runs the quickstart's planning loop.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs.base import ARCH_IDS as J_ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.core import cost_model as jcm
from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.core import placement as jplace
from repro.core import scheduler as jsched
from repro.core import simulator as jsim
from repro.core import strategies as jstrat
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.core import cost_model as tcm
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from repro_torch.core import placement as tplace
from repro_torch.core import scheduler as tsched
from repro_torch.core import simulator as tsim
from repro_torch.core import strategies as tstrat

NODES = (1, 2, 4, 8, 12)
BOARDS = ("ZYNQ7020", "ULTRASCALE")


def _d(obj):
    return dataclasses.asdict(obj)


def test_resnet18_graph_equal():
    for kw in ({}, dict(image_hw=65, num_classes=10, dtype_bytes=4)):
        j, t = jgraph.resnet18_graph(**kw), tgraph.resnet18_graph(**kw)
        assert t.to_json() == j.to_json()
        assert (t.total_macs, t.total_param_bytes) == (j.total_macs, j.total_param_bytes)
    assert tgraph.resnet18_graph().total_macs == 1814234848.0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_graph_equal(arch):
    assert ARCH_IDS == J_ARCH_IDS
    for seq_len in (4096, 128):
        j = jgraph.config_graph(jget_config(arch), seq_len)
        t = tgraph.config_graph(get_config(arch), seq_len)
        assert t.to_json() == j.to_json()
        assert [o.name for o in t.bottlenecks(3)] == [o.name for o in j.bottlenecks(3)]
        assert tpart.layer_costs(t) == jpart.layer_costs(j)


@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("strategy", jstrat.STRATEGIES)
def test_plan_predict_and_simulate_equal(strategy, n):
    """The plan, the closed-form prediction and the simulated SimResult
    (nominal and with node 0 at half speed)."""
    assert tstrat.STRATEGIES == jstrat.STRATEGIES
    jg, tg = jgraph.resnet18_graph(), tgraph.resnet18_graph()
    jp, tp = jstrat.make_plan(jg, strategy, n), tstrat.make_plan(tg, strategy, n)
    assert _d(tp) == _d(jp)
    for board in BOARDS:
        jb, tb = getattr(jcm, board), getattr(tcm, board)
        assert tsched.predict(tg, strategy, n, tb) == jsched.predict(jg, strategy, n, jb)
        for slowdown in (None, {0: 0.5}):
            want = jsim.simulate(jg, jp, jb, slowdown=slowdown)
            got = tsim.simulate(tg, tp, tb, slowdown=slowdown)
            assert _d(got) == _d(want)


@pytest.mark.parametrize("board", BOARDS)
@pytest.mark.parametrize("n", NODES)
def test_auto_schedule_equal(n, board):
    want = jsched.auto_schedule(jgraph.resnet18_graph(), n, getattr(jcm, board))
    got = tsched.auto_schedule(tgraph.resnet18_graph(), n, getattr(tcm, board))
    assert _d(got) == _d(want)
    assert got.alternatives == want.alternatives


def test_partition_and_bubbles_equal():
    costs = [[1, 1, 1, 1], [5, 1, 1, 1, 5, 2], [3.5, 0.25, 7, 1, 1, 2, 9, 4.5],
             [float(i % 5 + 1) for i in range(24)]]
    for c in costs:
        for stages in range(1, min(len(c), 6) + 1):
            assert tpart.partition_layers(c, stages) == jpart.partition_layers(c, stages)
            w = [1.0 / (s + 1) for s in range(stages)]
            assert (tpart.partition_layers(c, stages, stage_weights=w)
                    == jpart.partition_layers(c, stages, stage_weights=w))
            b = tpart.partition_layers(c, stages)
            assert tpart.stage_costs(c, b) == jpart.stage_costs(c, b)
            assert tpart.stage_depths(b) == jpart.stage_depths(b)
            assert tpart.even_boundaries(len(c), stages) == jpart.even_boundaries(len(c), stages)
    for schedule in ("forward", "gpipe", "1f1b"):
        for stages in (1, 2, 4, 8):
            for micro in (1, 2, 3, 8, 16):
                assert (tpart.pipeline_bubble_counts(stages, micro, schedule)
                        == jpart.pipeline_bubble_counts(stages, micro, schedule))


@pytest.mark.parametrize("strategy", ["pipeline", "ai_core_assignment", "fused", "scatter_gather"])
def test_rebalance_equal(strategy):
    rates = {0: 0.25, 1: 1.0, 2: 0.5, 3: 1.0}
    for jg, tg in ((jgraph.resnet18_graph(), tgraph.resnet18_graph()),
                   (jgraph.config_graph(jget_config("qwen3_0p6b"), 512),
                    tgraph.config_graph(get_config("qwen3_0p6b"), 512))):
        jp = jsched.rebalance(jg, jstrat.make_plan(jg, strategy, 4), rates)
        tp = tsched.rebalance(tg, tstrat.make_plan(tg, strategy, 4), rates)
        assert _d(tp) == _d(jp)
        n = jpart.plan_num_layers(jp)
        assert tpart.plan_num_layers(tp) == n
        if n is not None:
            assert (tpart.layer_boundaries_from_plan(tp, n)
                    == jpart.layer_boundaries_from_plan(jp, n))


@pytest.mark.parametrize("arch,kw", [("qwen3_0p6b", {}), ("qwen3_0p6b", dict(num_layers=8)),
                                     ("zamba2_2p7b", dict(num_layers=8, attn_every=2)),
                                     ("mixtral_8x22b", {})])
def test_recut_and_pipeline_boundaries_equal(arch, kw):
    jc, tc = jget_config(arch), get_config(arch)
    if kw:
        jc, tc = jc.scaled_down(**kw), tc.scaled_down(**kw)
    for stages in (2, 4):
        assert (tplace.pipeline_boundaries(tc, 256, stages)
                == jplace.pipeline_boundaries(jc, 256, stages))
        for rates in ({}, {0: 0.5}, {s: 1.0 / (s + 1) for s in range(stages)}):
            assert (tsched.recut_boundaries(tc, 256, stages, rates)
                    == jsched.recut_boundaries(jc, 256, stages, rates))


def test_cost_models_equal():
    for name in ("VTA_ZYNQ7020", "VTA_ULTRASCALE", "VTA_ULTRASCALE_350", "VTA_ULTRASCALE_BIG",
                 "ZYNQ7020", "ULTRASCALE", "GBE", "TPU_V5E"):
        assert _d(getattr(tcm, name)) == _d(getattr(jcm, name)), name
    assert _d(tcm.board_with_vta(tcm.ZYNQ7020, tcm.VTA_ULTRASCALE_BIG)) == _d(
        jcm.board_with_vta(jcm.ZYNQ7020, jcm.VTA_ULTRASCALE_BIG))
    g = tgraph.resnet18_graph()
    for op in g.ops[:6]:
        for k in (1, 3):
            assert (tcm.ZYNQ7020.op_time_parts(op, k, False)
                    == jcm.ZYNQ7020.op_time_parts(jgraph.Op(**_d(op)), k, False))
    assert tsim.graph_service_time(tcm.ULTRASCALE, g) == jsim.graph_service_time(
        jcm.ULTRASCALE, jgraph.resnet18_graph())
    kw = dict(num_layers=28, d_model=1024, num_heads=16, kv_heads=8, d_ff=3072, vocab=151936)
    assert tcm.lm_param_count(**kw) == jcm.lm_param_count(**kw)


def test_runtime_cost_model_equal():
    """RuntimeCostModel: every kind's features, the nonnegative fit,
    predictions and the JSON round trip on a synthetic profile."""
    assert tcm.RUNTIME_FEATURES == jcm.RUNTIME_FEATURES
    points = {
        "flash_prefill": [dict(seq=s, block_q=128, block_k=bk, heads=16, head_dim=128)
                          for s in (256, 512, 2048) for bk in (128, 256)],
        "decode": [dict(buf=4096, fill=f, block_k=512, batch=4, heads=16) for f in (1, 900, 4096)],
        "paged_decode": [dict(fill=f, page_size=16, max_len=2048, batch=8) for f in (1, 700, 2000)],
        "gemm_int8": [dict(m=m, k=1024, n=3072) for m in (4, 100, 512, 2048)],
        "prefill_chunk": [dict(tokens=t, chunk=512, batch=2) for t in (100, 1100, 4096)],
    }
    entries = [{"kind": kind, "params": p, "t_s": 1e-6 * (i + 1) * (1 + len(kind))}
               for kind, ps in points.items() for i, p in enumerate(ps)]
    for e in entries:
        assert (tcm.runtime_features(e["kind"], e["params"])
                == jcm.runtime_features(e["kind"], e["params"]))
    want = jcm.RuntimeCostModel.fit(entries, device="d")
    got = tcm.RuntimeCostModel.fit(entries, device="d")
    assert got.to_json() == want.to_json()
    for e in entries:
        assert got.predict(e["kind"], **e["params"]) == want.predict(e["kind"], **e["params"])
    assert tcm.RuntimeCostModel.from_json(got.to_json()).to_json() == want.to_json()


_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["repro"] = None    # and so does any import of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.core.cost_model import ZYNQ7020
from repro_torch.core.graph import resnet18_graph
from repro_torch.core.scheduler import auto_schedule
g = resnet18_graph()
print([auto_schedule(g, n, ZYNQ7020).plan.strategy for n in (1, 2, 4, 8, 12)])
loaded = [k for k, v in sys.modules.items()
          if v is not None and (k.split(".")[0] in ("jax", "jaxlib", "repro"))]
assert not loaded, loaded
print(len(names), "modules")
"""


def test_port_imports_no_jax_and_no_reference():
    pytest.importorskip("torch")
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    out = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = [jsched.auto_schedule(jgraph.resnet18_graph(), n, jcm.ZYNQ7020).plan.strategy
            for n in NODES]
    assert out.stdout.splitlines()[0] == str(want)
    assert int(out.stdout.split()[-2]) >= 30  # every module of the port was imported
