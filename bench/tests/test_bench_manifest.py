"""BENCHMARK.json keeps its own rules, and a cell, a mix, a configuration
or a metric is added by new files and entries alone."""

import json
import shutil

import torch

from bench.harness import cell, manifest
from conftest import ROOT, tiny_config, tiny_mix


def test_manifest_keeps_its_rules():
    assert manifest.check(manifest.load()) == []


def test_manifest_check_finds_breaches():
    m = manifest.load()
    m["end_to_end"][0]["unit"] = "tokens per second"
    m["per_layer"][0]["name"] = "prefix hit"
    m["workloads"].append(dict(m["workloads"][0], name="x", chips=4))
    m["workloads"].append(dict(m["workloads"][0], name="y", traffic="nothing-here", chips=4))
    bad = " ".join(manifest.check(m))
    for piece in ("unit", "prefix hit", "appears twice", "no mix", "4 chips"):
        assert piece in bad


def test_every_cell_resolves():
    m = manifest.load()
    for w in m["workloads"]:
        spec = manifest.cell(m, w["name"])
        assert spec["c"]["name"] == w["config"] and spec["mix"]["clients"] >= 1
        assert spec["limits"]["max_logit_gap"]["limit"] > 0


def test_a_new_mix_and_metric_need_no_edit(tmp_path):
    """A throwaway mix, cell, configuration and per-layer metric in a copy
    of bench/: only new files and new entries, and a CPU run reads them."""
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    c = tiny_config("qwen3_0p6b")
    (bench / "configs" / "tiny_qwen3.json").write_text(json.dumps(c))
    shutil.copy(bench / "reference" / "qwen3_0p6b.py", bench / "reference" / "tiny_qwen3.py")
    (bench / "mixes" / "throwaway.json").write_text(json.dumps(tiny_mix(True)))
    (bench / "cells" / "tiny_qwen3.throwaway.json").write_text(
        json.dumps({"max_logit_gap": {"limit": 1e-3}}))
    (bench / "metrics" / "submitted_requests.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    m = manifest.load()
    m["configs"].append({"name": "tiny_qwen3", "source": "https://huggingface.co/Qwen/Qwen3-0.6B",
                         "file": "bench/configs/tiny_qwen3.json", "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny_qwen3.throwaway", "config": "tiny_qwen3",
                           "traffic": "throwaway", "chips": 1, "why": "test"})
    m["per_layer"].append({"name": "submitted_requests", "unit": "requests", "better": "higher",
                           "source": "host_clock", "layer": "the clients",
                           "moves": "output_tokens_per_s", "workloads": ["tiny_qwen3.throwaway"]})
    assert manifest.check(m, bench) == []
    spec = manifest.cell(m, "tiny_qwen3.throwaway", bench)
    assert spec["c"]["reference_file"].startswith(str(bench))
    out = cell.run(spec, seed=77, seconds=0.6, traced=True, device=torch.device("cpu"),
                   t_start=0.0)
    assert out["correct"] and out["metrics"]["submitted_requests"]["value"] > 0
