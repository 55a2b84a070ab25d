"""The port's ``ft.checkpoint`` against the JAX reference's, as
``tests/test_ft.py``'s ``TestCheckpoint`` and ``TestCheckpointRobustness``:
round trips (bf16 as its ``uint16`` bits), atomic rename, async saves
with rotation, resume-equals-straight-through training, integer-only
``step_N`` scans, the start-up sweep of torn ``.tmp`` dirs, a background
write failure surfacing on the next save, and a crash mid-save leaving
the previous checkpoint intact.  The manifests' leaf names and dtypes
equal the reference's for the same tree, and each package restores the
other's files.

State: ``train.step.make_state`` around the reference's params of
``qwen3_0p6b.scaled_down(num_layers=2, d_model=64, vocab=256)`` carried
over by ``convert.params_from_numpy``.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.ft import checkpoint as ckpt  # noqa: E402
from repro_torch.ft.faults import CheckpointWriteCrash, one_shot_write_fault  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train.step import make_state, make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SMALL = dict(num_layers=2, d_model=64, vocab=256)


@pytest.fixture(scope="module")
def small_state():
    cfg = get_config("qwen3_0p6b").scaled_down(**SMALL)
    tcfg = t_get_config("qwen3_0p6b").scaled_down(**SMALL)
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    state = make_state(convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return tcfg, state


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path, small_state):
        _, state = small_state
        d = str(tmp_path / "c1")
        ckpt.save(d, state, step=7)
        _equal(state, ckpt.restore(d, state))
        assert json.load(open(os.path.join(d, "manifest.json")))["step"] == 7

    def test_bf16_roundtrip(self, tmp_path):
        x = {"w": torch.arange(8, dtype=torch.bfloat16) / 3, "n": [torch.tensor(3)]}
        d = str(tmp_path / "c2")
        ckpt.save(d, x)
        back = ckpt.restore(d, x)
        assert back["w"].dtype == torch.bfloat16
        _equal(x, back)
        # stored as the uint16 bits, the logical dtype in the manifest
        arr = np.load(os.path.join(d, "w.npy"))
        assert arr.dtype == np.uint16
        leaves_ = json.load(open(os.path.join(d, "manifest.json")))["leaves"]
        assert {l["name"]: l["dtype"] for l in leaves_} == {"n__0": "int64", "w": "bfloat16"}

    def test_atomic_no_partial(self, tmp_path, small_state):
        _, state = small_state
        d = str(tmp_path / "c3")
        ckpt.save(d, state, step=1)
        assert not os.path.exists(d + ".tmp")
        assert os.path.isfile(os.path.join(d, "manifest.json"))

    def test_async_and_rotation(self, tmp_path, small_state):
        _, state = small_state
        ac = ckpt.AsyncCheckpointer(str(tmp_path / "root"), keep=2)
        for s in (1, 2, 3):
            ac.save(state, s)
        ac.wait()
        assert ckpt.latest_step(str(tmp_path / "root")) == 3
        assert sorted(os.listdir(tmp_path / "root")) == ["step_2", "step_3"]  # rotated
        back, step = ac.restore_latest(state)
        assert step == 3
        _equal(state, back)

    def test_restore_resumes_training(self, tmp_path, small_state):
        """checkpoint -> restore -> one more step == straight-through,
        bitwise on the CPU."""
        cfg, state = small_state
        step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3), remat=False)
        data = SyntheticLM(cfg.vocab, 32, 4)

        def batch(i):
            return {"tokens": torch.from_numpy(data.batch(i)["tokens"]).long()}

        s1, _ = step_fn(state, batch(0))
        d = str(tmp_path / "resume")
        ckpt.save(d, s1, step=1)
        s2a, m_a = step_fn(s1, batch(1))
        restored = ckpt.restore(d, s1)
        _equal(s1, restored)
        s2b, m_b = step_fn(restored, batch(1))
        assert float(m_a["loss"]) == float(m_b["loss"])
        _equal(s2a, s2b)

    def test_manifest_and_files_match_reference(self, tmp_path):
        """The same tree through both packages: the same leaf names, shapes
        and dtypes, and each restores the other's checkpoint bitwise."""
        rng = np.random.default_rng(0)
        tree = {"b": [rng.standard_normal((3, 4)).astype(np.float32),
                      rng.integers(0, 9, (5,)).astype(np.int32)],
                "a": {"z": rng.standard_normal((2,)).astype(np.float32)}}
        ttree = jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)
        jckpt.save(str(tmp_path / "j"), jax.tree.map(jnp.asarray, tree), step=4)
        ckpt.save(str(tmp_path / "t"), ttree, step=4)

        def manifest(d):
            m = json.load(open(tmp_path / d / "manifest.json"))
            return m["step"], m["format"], m["leaves"]

        assert manifest("t") == manifest("j")
        _equal(ttree, ckpt.restore(str(tmp_path / "j"), ttree))
        back = jckpt.restore(str(tmp_path / "t"), jax.tree.map(jnp.asarray, tree))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            assert np.array_equal(np.asarray(a), b)


class TestCheckpointRobustness:
    def test_latest_step_skips_noninteger_and_incomplete(self, tmp_path):
        root = tmp_path / "r"
        for name, manifest in [("step_5", True), ("step_12.tmp", True),
                               ("step_abc", True), ("step_9", False)]:
            d = root / name
            d.mkdir(parents=True)
            if manifest:
                (d / "manifest.json").write_text("{}")
        (root / "step_junkfile").write_text("")  # stray FILE, not a dir
        assert ckpt.latest_step(str(root)) == jckpt.latest_step(str(root)) == 5

    def test_startup_sweeps_orphaned_tmp(self, tmp_path):
        root = tmp_path / "r"
        (root / "step_3.tmp").mkdir(parents=True)
        (root / "step_2").mkdir()
        (root / "step_2" / "manifest.json").write_text("{}")
        ac = ckpt.AsyncCheckpointer(str(root))
        assert ac.swept == ["step_3.tmp"]
        assert not (root / "step_3.tmp").exists()
        assert ckpt.latest_step(str(root)) == 2

    def test_background_error_surfaces_on_next_save(self, tmp_path, small_state):
        _, state = small_state
        root = str(tmp_path / "r")
        ac = ckpt.AsyncCheckpointer(root)
        ac.save(state, 1)
        ac.wait()
        one_shot_write_fault(1)
        ac.save(state, 2)  # background thread dies mid-write
        with pytest.raises(CheckpointWriteCrash):
            ac.save(state, 3)
        ac.save(state, 3)  # error was consumed; still functional
        ac.wait()
        assert ckpt.latest_step(root) == 3

    def test_crash_mid_save_previous_intact(self, tmp_path, small_state):
        _, state = small_state
        root = str(tmp_path / "r")
        ac = ckpt.AsyncCheckpointer(root)
        ac.save(state, 1)
        ac.wait()
        one_shot_write_fault(3)  # die after the 3rd leaf file
        ac.save(state, 2)
        with pytest.raises(CheckpointWriteCrash):
            ac.wait()
        assert ckpt.latest_step(root) == 1
        assert os.path.isdir(os.path.join(root, "step_2.tmp"))
        back, step = ac.restore_latest(state)
        assert step == 1
        _equal(state, back)
        assert ckpt.AsyncCheckpointer(root).swept == ["step_2.tmp"]
