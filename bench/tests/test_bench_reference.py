"""Each configuration's plain reference against the program's serving path
on the CPU (its plain kernel versions), at a small size, on weights the
benchmark made; and the reference's weight layout against the program's
own parameter tree."""

import dataclasses

import pytest
import torch

from bench.harness import model
from bench.reference._plain import matmul, precision, round_tf32
from conftest import tiny_config

NAMES = ["qwen3_0p6b"]


@pytest.mark.parametrize("name", NAMES)
def test_layout_is_the_programs_tree(name):
    from repro_torch.models import transformer as tf

    c = tiny_config(name)
    ref = model.reference(c)
    cfg = model.port_config(c)
    port = tf.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                   device="cpu")
    mine, _ = model.make_weights(c, ref.layout(c), 1, torch.device("cpu"))
    assert {p: tuple(t.shape) for p, t in model.leaves(port)} == \
        {p: tuple(t.shape) for p, t in model.leaves(mine)}


@pytest.mark.parametrize("name", NAMES)
def test_reference_matches_the_program(name):
    from repro_torch.models import transformer as tf

    c = tiny_config(name)
    ref = model.reference(c)
    cfg = model.port_config(c)
    w, _ = model.make_weights(c, ref.layout(c), 12345, torch.device("cpu"))
    toks = torch.randint(0, c["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(3))
    rows = []
    with torch.no_grad():  # the serving path: a prefill, then decode steps
        caches = tf.init_caches(cfg, 1, 64, torch.float32, "cpu")
        logits, caches = tf.prefill(w, cfg, toks[:, :30], caches)
        rows.append(logits[0, -1])
        for i in range(30, 40):
            logits, caches = tf.decode_step(w, cfg, toks[:, i:i + 1], caches)
            rows.append(logits[0, -1])
    port = torch.stack(rows).float()
    mine = ref.score(w, c, toks[0], 29)
    assert torch.allclose(port, mine, atol=2e-5, rtol=1e-4)
    assert torch.equal(port.argmax(-1), mine.argmax(-1))


def test_port_config_refuses_a_file_that_disagrees():
    c = tiny_config("qwen3_0p6b")
    c["hidden_size"] = 96
    with pytest.raises(ValueError, match="d_model"):
        model.port_config(c)


def test_weights_follow_the_seed():
    c = tiny_config("qwen3_0p6b")
    lay = model.reference(c).layout(c)
    a, _ = model.make_weights(c, lay, 2 ** 31 + 5, torch.device("cpu"))
    b, _ = model.make_weights(c, lay, 2 ** 31 + 5, torch.device("cpu"))
    d, _ = model.make_weights(c, lay, 2 ** 31 + 6, torch.device("cpu"))
    ta, tb, td = (x["blocks"][1]["mixer"]["wq"]["w"] for x in (a, b, d))
    assert torch.equal(ta, tb) and not torch.equal(ta, td)
    assert abs(float(ta.std()) - c["hidden_size"] ** -0.5) < 0.02


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0000002])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0  # a tie rounds to even
    assert r[2] == 1.0 + 2 ** -10
    assert r[3] == -3.0
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with precision("tf32"):
        low = matmul(a, a)
    with precision("f32"):
        high = matmul(a, a)
    assert 0 < float((low - high).abs().max()) < 1e-2
