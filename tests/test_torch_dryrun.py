"""``repro_torch.launch.dryrun``, the meta-device stand-in, against the
reference's XLA dry-run.

* One subprocess runs the reference's ``lower_cell`` on an Auto-axis
  ``jax.sharding.Mesh`` (2, 4) over 8 of its fake CPU devices with
  ``qwen3_0p6b.scaled_down()`` (``get_config`` patched in the subprocess):
  train_4k, prefill_32k and decode_32k under fused, ai_core_assignment and
  scatter_gather, and pipeline's train_4k.  The scaled-down stack has 2
  layers, which the 4-stage pipeline refuses (``ValueError: 4 stages > 2
  layers``): that cell is recorded with its error, and the pipeline is
  compared at ``scaled_down(num_layers=8)`` instead.  The stand-in's
  ``arg_bytes`` on a (2, 4) ``meta`` mesh equals each compiled module's
  ``memory_analysis().argument_size_in_bytes``.
* A record holds only keys the stand-in computes; skipped cells carry the
  reference's reasons; the CLI appends a ``status: "ok"`` record for one
  full-size cell.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.dist.sharding import Mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

META = torch.device("meta")
CELLS = [(s, k) for s in ("fused", "ai_core_assignment", "scatter_gather")
         for k in ("train_4k", "prefill_32k", "decode_32k")] + [("pipeline", "train_4k")]
RECORD_KEYS = {"arch", "shape", "mesh", "strategy", "status", "arg_bytes", "flops_global",
               "stand_in"}

_REF_SCRIPT = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.dryrun as dr  # appends the 512-device flag; the mesh takes 8
from repro.configs import base

mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for layers in (None, 8):
    cfg = base.get_config("qwen3_0p6b").scaled_down(
        **({} if layers is None else {"num_layers": layers}))
    dr.get_config = lambda arch, cfg=cfg: cfg
    for strategy, shape in CELLS:
        if layers is not None and strategy != "pipeline":
            continue
        key = f"{layers}/{strategy}/{shape}"
        try:
            low = dr.lower_cell("qwen3_0p6b", shape, mesh, strategy)
            out[key] = int(low.compile().memory_analysis().argument_size_in_bytes)
        except Exception as e:
            out[key] = f"{type(e).__name__}: {e}"[:300]
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
        cwd=repo, timeout=300)
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
    assert isinstance(want, int), want
    cfg = get_config("qwen3_0p6b").scaled_down(**layers)
    assert dryrun.arg_bytes(cfg, shape, _mesh(), strategy) == want


def test_record_keys_and_skips():
    cfg = get_config("qwen3_0p6b").scaled_down()
    rec = dryrun.cell_record(cfg, "decode_32k", _mesh(), "fused", verbose=False)
    assert set(rec) == RECORD_KEYS
    assert rec["status"] == "ok" and rec["stand_in"] == "meta" and rec["flops_global"] > 0
    assert rec["mesh"] == "2x4"
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
    # full width: 28 layers of (128, 32768, 8, 128) bf16 K/V split over
    # 'data' (16) and the heads over 'model' (8 of 16 divide: replicated)
    assert rec["arg_bytes"] > 28 * 2 * 128 * 32768 * 8 * 128 * 2 // 16
