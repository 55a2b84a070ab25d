"""``repro_torch.launch.dryrun``, the meta-device stand-in, against the
reference's XLA dry-run.

* One subprocess runs the reference's ``lower_cell`` on an Auto-axis
  ``jax.sharding.Mesh`` (2, 4) over 8 of its fake CPU devices with
  ``qwen3_0p6b.scaled_down()`` (``get_config`` patched in the subprocess):
  train_4k, prefill_32k and decode_32k under fused, ai_core_assignment and
  scatter_gather, and pipeline's train_4k (lowered in turn, compiled in
  threads).  The scaled-down stack has 2
  layers, which the 4-stage pipeline refuses (``ValueError: 4 stages > 2
  layers``): that cell is recorded with its error, and the pipeline is
  compared at ``scaled_down(num_layers=8)`` instead.  The stand-in's
  ``arg_bytes`` on a (2, 4) ``meta`` mesh equals each compiled module's
  ``memory_analysis().argument_size_in_bytes``.  The subprocess also
  returns each module's ``output_size_in_bytes``, ``temp_size_in_bytes``,
  cost-analysis ``flops`` and ``collective_bytes`` (its HLO parse), and
  the test prints the stand-in's rank-0 record (a fake world of 8 on
  ``meta``) beside them.  ``output_bytes`` is held equal on the train
  cells of fused, ai_core_assignment and scatter_gather, where both steps
  return the same tree, the new state and the metrics, on one position:
  XLA's figure also counts its output tuple's table, 8 bytes a leaf of
  the reference's (stacked) tree.  It differs, by design, on the serving
  cells (the port writes its caches in place, so they are no output; the
  reference's donated caches are).  The pipeline's record is one process
  a stage's (rank 0, stage 0 of row 0, as the reference's per-device
  figures are one stage's), with ``per_stage``, the same keys for each of
  row 0's 4 stages: each stage's ``arg_bytes`` and ``output_bytes``
  equal XLA's (the latter, as on the other train cells, less its table).
  ``temp_bytes``, ``flops`` and the collectives differ by design: the port
  runs its eager program (no fusion, no donation, the global batch and
  ``fused``'s whole-param gathers in each process, collectives written by
  hand), the reference XLA's partitioned module.
* A record holds only keys the stand-in computes (``lower_s`` and
  ``compile_s`` need a compiler); skipped cells carry the reference's
  reasons; the CLI appends a ``status: "ok"`` record for one full-size
  cell, whose peak is its arguments, outputs and temporaries.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

from repro_torch.configs.base import SHAPES, get_config  # noqa: E402
from repro_torch.dist.sharding import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.counters import KINDS  # noqa: E402

META = torch.device("meta")
CELLS = [(s, k) for s in ("fused", "ai_core_assignment", "scatter_gather")
         for k in ("train_4k", "prefill_32k", "decode_32k")] + [("pipeline", "train_4k")]
#: the reference's per-device keys, a pipeline's ``per_stage`` records
STAGE_KEYS = {"arg_bytes", "output_bytes", "temp_bytes", "per_device_mem_bytes", "flops",
              "bytes_accessed", "collective_bytes"}
RECORD_KEYS = {"arch", "shape", "mesh", "strategy", "status", "position", "route",
               "kernel_calls", "stand_in"} | STAGE_KEYS

_REF_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.dryrun as dr  # appends the 512-device flag; the mesh takes 8
from repro.configs import base

from concurrent.futures import ThreadPoolExecutor

mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out, lowered = {}, {}
for layers in (None, 8):
    cfg = base.get_config("qwen3_0p6b").scaled_down(
        **({} if layers is None else {"num_layers": layers}))
    dr.get_config = lambda arch, cfg=cfg: cfg
    for strategy, shape in CELLS:
        if layers is not None and strategy != "pipeline":
            continue
        key = f"{layers}/{strategy}/{shape}"
        try:
            lowered[key] = dr.lower_cell("qwen3_0p6b", shape, mesh, strategy)
        except Exception as e:
            out[key] = f"{type(e).__name__}: {e}"[:300]


def figures(low):
    try:
        compiled = low.compile()
    except Exception as e:
        return f"{type(e).__name__}: {e}"[:300]
    mem = compiled.memory_analysis()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return {"arg_bytes": int(mem.argument_size_in_bytes),
            "out_leaves": compiled.out_tree.num_leaves,
            "output_bytes": int(mem.output_size_in_bytes),
            "temp_bytes": int(mem.temp_size_in_bytes),
            "flops": float(cost.get("flops", 0.0)),
            "collective_bytes": dr.collective_bytes(compiled.as_text())}


# the cells compile in threads (XLA compiles outside the GIL)
with ThreadPoolExecutor(4) as pool:
    out.update(zip(lowered, pool.map(figures, lowered.values())))
print("REF_DRYRUN " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", f"CELLS = {CELLS!r}\n" + _REF_SCRIPT],
        capture_output=True, text=True,
        env={"PYTHONPATH": os.path.join(repo, "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"},
        cwd=repo, timeout=180)
    line = [x for x in r.stdout.splitlines() if x.startswith("REF_DRYRUN ")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][len("REF_DRYRUN "):])


def _mesh():
    return Mesh(np.array([META] * 8, dtype=object).reshape(2, 4), ("data", "model"))


@pytest.mark.parametrize("strategy,shape", CELLS)
def test_arg_bytes_equal_reference(reference, strategy, shape):
    want = reference[f"None/{strategy}/{shape}"]
    layers = {}
    if strategy == "pipeline":
        # the reference refuses 4 stages over the 2-layer stack: say so and
        # compare the pipeline at 8 layers
        assert want == "ValueError: 4 stages > 2 layers: stages would be empty", want
        print(f"reference lower_cell refused {strategy} x {shape} at 2 layers: {want}")
        layers = {"num_layers": 8}
        want = reference[f"8/{strategy}/{shape}"]
    assert isinstance(want, dict), want
    cfg = get_config("qwen3_0p6b").scaled_down(**layers)
    assert dryrun.arg_bytes(cfg, shape, _mesh(), strategy) == want["arg_bytes"]
    # the port's per-position figures beside the reference's per-device ones
    rec = dryrun.cell_record(cfg, shape, _mesh(), strategy, verbose=False)
    assert rec["status"] == "ok" and rec["arg_bytes"] == want["arg_bytes"]
    for key in ("output_bytes", "temp_bytes", "flops"):
        print(f"{strategy} x {shape} {key}: port {rec[key]}, reference {want[key]}")
    for kind in KINDS:
        print(f"{strategy} x {shape} {kind} bytes: port {rec['collective_bytes'][kind]}, "
              f"reference {want['collective_bytes'][kind]}")
    if SHAPES[shape].kind == "train":
        # the same tree (the new state and the metrics) on one position (a
        # pipeline's: one stage's layers); XLA also counts its output
        # tuple's table, 8 bytes a leaf
        assert rec["output_bytes"] + 8 * want["out_leaves"] == want["output_bytes"]
    assert rec["per_device_mem_bytes"] == (rec["arg_bytes"] + rec["output_bytes"]
                                           + rec["temp_bytes"])
    if strategy == "pipeline":
        # one process a stage: rank 0 is stage 0, and every stage of row 0
        # holds the reference's per-device arguments
        assert rec["position"] == "mesh" and set(rec) == RECORD_KEYS | {"per_stage"}
        assert [r["stage"] for r in rec["per_stage"]] == list(range(4))
        assert {k: v for k, v in rec["per_stage"][0].items() if k != "stage"} == {
            k: rec[k] for k in STAGE_KEYS}
        for r in rec["per_stage"]:
            assert set(r) == STAGE_KEYS | {"stage"}
            assert r["arg_bytes"] == want["arg_bytes"], r
            assert r["output_bytes"] + 8 * want["out_leaves"] == want["output_bytes"], r
            assert r["per_device_mem_bytes"] == (r["arg_bytes"] + r["output_bytes"]
                                                 + r["temp_bytes"])
            print(f"pipeline stage {r['stage']}: output {r['output_bytes']}, temp "
                  f"{r['temp_bytes']}, flops {r['flops']}, permute "
                  f"{r['collective_bytes']['collective-permute']}")
    else:
        assert set(rec) == RECORD_KEYS


def test_record_keys_and_skips():
    cfg = get_config("qwen3_0p6b").scaled_down()
    rec = dryrun.cell_record(cfg, "decode_32k", _mesh(), "fused", verbose=False)
    assert set(rec) == RECORD_KEYS
    assert rec["status"] == "ok" and rec["stand_in"] == "meta" and rec["flops"] > 0
    assert rec["mesh"] == "2x4" and rec["position"] == "mesh" and rec["route"] == "kernel"
    assert set(rec["collective_bytes"]) == set(KINDS) | {"total"}
    # the decode step's attention took the dense decode wrapper, once a layer
    assert rec["kernel_calls"] == {"decode_attention": cfg.num_layers}
    skip = dryrun.cell_record(cfg, "prefill_32k", _mesh(), "pipeline", verbose=False)
    assert skip["status"] == "skipped" and "train path only" in skip["reason"]
    long = dryrun.cell_record(get_config("qwen3_0p6b"), "long_500k", _mesh(), "fused",
                              verbose=False)
    assert long["status"] == "skipped" and "500k" in long["reason"]


def test_cli_full_size_cell(tmp_path):
    out = tmp_path / "dr.jsonl"
    assert dryrun.main(["--arch", "qwen3_0p6b", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    (rec,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and set(rec) == RECORD_KEYS
    assert rec["per_device_mem_bytes"] == (rec["arg_bytes"] + rec["output_bytes"]
                                           + rec["temp_bytes"]) >= rec["arg_bytes"]
    # full width: 28 layers of (128, 32768, 8, 128) bf16 K/V split over
    # 'data' (16) and the heads over 'model' (8 of 16 divide: replicated)
    assert rec["arg_bytes"] > 28 * 2 * 128 * 32768 * 8 * 128 * 2 // 16
