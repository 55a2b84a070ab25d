"""``repro_torch.launch.specs`` against ``repro.launch.specs``.

For every arch x shape (``skip_shapes`` honoured) the port's ``meta``
tree of the step's inputs has the reference's leaves: each leaf's shape
and dtype equal the reference's ``ShapeDtypeStruct``.  A per-layer list
compares per layer against the reference's stacked leaf (every layer's
shape equal to the stacked shape without its leading layer count).  The
port's trees differ from the reference's in three documented ways, which
the comparison maps: a host-int cache ``len`` stands for the
reference's int32 scalar; MLA's one latent buffer ``kv`` (B, T, r + dr)
stands for ``ckv`` and ``k_rope``; an enc-dec config's caches sit under
``blocks``.  Also ``pipeline_state_shapes`` on uneven cuts, and that
nothing is allocated on a real device.
"""

import functools

import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402

JDT = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}


def _ref_flat(tree) -> dict:
    return {jax.tree_util.keystr(k): (tuple(v.shape), JDT[str(v.dtype)])
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree, path="", out=None) -> dict:
    """{reference-style key path: (shape, dtype)}: a per-layer list stacked
    (its layers' shapes must agree), a host int as an int32 scalar."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _port_flat(v, f"{path}['{k}']", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            _port_flat(getattr(tree, f), f"{path}.{f}", out)
    elif isinstance(tree, list):
        layers = [_port_flat(v, path) for v in tree]
        for key in layers[0]:
            shapes = {layer[key] for layer in layers}
            assert len(shapes) == 1, (key, shapes)
            shape, dtype = shapes.pop()
            out[key] = ((len(tree),) + shape, dtype)
    elif isinstance(tree, int):
        out[path] = ((), torch.int32)
    else:
        assert tree.device.type == "meta", path
        out[path] = (tuple(tree.shape), tree.dtype)
    return out


def _port_as_reference(cfg, flat: dict) -> dict:
    """The documented tree differences mapped onto the reference's keys."""
    out = {}
    for key, (shape, dtype) in flat.items():
        if cfg.is_enc_dec and "['caches']['blocks']" in key:
            key = key.replace("['caches']['blocks']", "['caches']")
        if cfg.uses_mla and key.endswith("['kv']") and "caches" in key:
            r = cfg.kv_lora_rank
            out[key[:-len("['kv']")] + "['ckv']"] = (shape[:-1] + (r,), dtype)
            out[key[:-len("['kv']")] + "['k_rope']"] = (shape[:-1] + (shape[-1] - r,), dtype)
            continue
        out[key] = (shape, dtype)
    return out


@functools.lru_cache(maxsize=None)
def _cells():
    return [(a, s) for a in ARCH_IDS for s in SHAPES if s not in jget_config(a).skip_shapes]


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_equal(arch, shape):
    cfg = get_config(arch)
    want = _ref_flat(jspecs.input_specs(jget_config(arch), SHAPES[shape]))
    got = _port_as_reference(cfg, _port_flat(tspecs.input_specs(cfg, SHAPES[shape])))
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:6]
    for key, (shape_, dtype) in want.items():
        assert got[key] == (shape_, dtype), (key, got[key], (shape_, dtype))


def test_skipped_shapes_are_the_references():
    for arch in ARCH_IDS:
        assert get_config(arch).skip_shapes == jget_config(arch).skip_shapes


@pytest.mark.parametrize("arch", ["qwen3_0p6b", "deepseek_v2_236b"])
def test_pipeline_state_shapes_equal(arch):
    """Uneven cuts pad every stage to the deepest: the padded block list
    and both moments equal the reference's."""
    cfg = get_config(arch)
    n = cfg.num_layers
    bounds = (0, n // 4, n // 2 + 1, n)
    want = _ref_flat(jspecs.pipeline_state_shapes(jget_config(arch), bounds))
    got = _port_flat(tspecs.pipeline_state_shapes(cfg, bounds))
    assert got == want


def test_constants_equal():
    assert tspecs.TRAIN_GRAD_ACCUM == jspecs.TRAIN_GRAD_ACCUM
    assert tspecs.BF16_MOMENTS == jspecs.BF16_MOMENTS
    assert tspecs.ENC_FRAMES == jspecs.ENC_FRAMES
