"""On the card: the control (the reference at TF32 in the program's place)
fails a cell's limit where the program passes it, judged by the run's own
comparison, at a size a test run holds: the cell's widths, two layers,
shorter documents and questions.  Run on the chip with
``python3 -m pytest bench/tests -m gpu``."""

import pytest
import torch

from bench.harness import cell, manifest


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen3_0p6b.docqa-shared"])
def test_control_fails_the_limit(cuda, name):
    spec = manifest.cell(manifest.load(), name)
    c = dict(spec["c"], num_hidden_layers=2)
    c["port"] = dict(c["port"], set=dict(c["port"]["set"], num_layers=2))
    mix = spec["mix"]
    short = {"dist": "log_normal", "median": 512, "sigma": 0.6, "min": 64, "max": 2048}
    mix = dict(mix, clients=8, max_slots=8, warm_steps=8,
               shared=dict(mix["shared"], count=8, block=32, length=short),
               prompt=dict(short, median=256))
    spec = dict(spec, c=c, mix=mix)
    limit = spec["limits"]["max_logit_gap"]["limit"]
    readings = []
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        out = cell.run(spec, seed=seed, seconds=20.0, traced=False, device=cuda, t_start=0.0,
                       control=True)
        got = out["readings"]
        readings.append((max(got["program"]), max(got["control"]), got["tokens"]))
    assert all(program <= limit for program, _, _ in readings), readings
    assert all(control > limit for _, control, _ in readings), readings
