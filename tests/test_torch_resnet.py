"""The port's ResNet-18 (``repro_torch.models.resnet``) vs the JAX
reference's ``repro.models.resnet``.

Reference params come from ``resnet.init(PRNGKey(0), 10)`` with every
batch norm's ``scale`` / ``bias`` / ``mean`` / ``var`` replaced by numpy
draws (so BN is not the identity), and go to the port through
``convert.resnet_params_from_numpy``; images are numpy draws.  On the CPU
the int8 head runs the VTA GEMM's plain version.

* f32 logits within 1e-4 x max|logit| at (2, 64, 64, 3) and at an odd
  (1, 65, 65, 3), where the stem pads (3, 3): the two frameworks sum the
  convolutions in different orders (~1e-6 apart here);
* bf16 logits within 1e-2 x max|logit|, the reference's bf16 tolerance
  (bf16 rounds at other places in the two frameworks);
* the int8 head: ``quantize_params`` packs the same leaves in both (``fc``
  only), codes and scales bitwise; logits within 1e-3 x max|logit| (one
  head layer; a pooled feature ~1e-6 apart can move one activation code
  at a tie, and XLA fuses the bias add into an FMA where the port rounds
  twice);
* SAME padding of every conv shape the model has and of the max-pool,
  against ``lax``; the port's ``init`` gives the reference's tree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import resnet as jres  # noqa: E402
from repro.optim.quant import quantize_params as jquantize  # noqa: E402
from repro_torch.convert import resnet_params_from_numpy  # noqa: E402
from repro_torch.models import resnet as tres  # noqa: E402
from repro_torch.optim.quant import quantize_params as tquantize  # noqa: E402

SHAPES = [(2, 64, 64, 3), (1, 65, 65, 3)]
BN_KEYS = {"scale", "bias", "mean", "var"}


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _with_bn_draws(tree, rng):
    """The reference's tree as numpy, every BN's four leaves drawn anew."""
    if isinstance(tree, list):
        return [_with_bn_draws(v, rng) for v in tree]
    if isinstance(tree, dict):
        if set(tree) == BN_KEYS:
            c = tree["scale"].shape[0]
            return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(c)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        return {k: _with_bn_draws(v, rng) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def ref_params():
    return _with_bn_draws(jres.init(jax.random.PRNGKey(0), 10), np.random.default_rng(0))


def _jax_tree(tree, dtype=jnp.float32):
    """The numpy tree as the reference's arrays in ``dtype`` (BN mean /
    var stay f32, as its ``_bn_init`` keeps them)."""
    if isinstance(tree, list):
        return [_jax_tree(v, dtype) for v in tree]
    return {k: (_jax_tree(v, dtype) if isinstance(v, (dict, list))
                else jnp.asarray(v, jnp.float32 if k in ("mean", "var") else dtype))
            for k, v in tree.items()}


def _images(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_forward_f32(ref_params, shape):
    img = _images(shape)
    want = np.asarray(jres.forward(_jax_tree(ref_params), jnp.asarray(img)))
    got = tres.forward(resnet_params_from_numpy(ref_params, "cpu"), torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 10)
    assert _rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_forward_bf16(ref_params, shape):
    img = _images(shape)
    want = jres.forward(_jax_tree(ref_params, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16))
    params = resnet_params_from_numpy(ref_params, "cpu", torch.bfloat16)
    got = tres.forward(params, torch.from_numpy(img).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], 10)
    assert _rel_err(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 1e-2


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_int8_head(ref_params, shape):
    jq = jquantize(_jax_tree(ref_params))
    tq = tquantize(resnet_params_from_numpy(ref_params, "cpu"))
    jl, tl = list(_leaves(jq)), list(_leaves(tq))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    packed = [p for p, _ in tl if p[-1] in ("qw", "qscale")]
    assert packed == [("fc", "qw"), ("fc", "qscale")]
    for (path, j), (_, t) in zip(jl, tl):
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
        if path[-1] in ("qw", "qscale"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    img = _images(shape)
    want = np.asarray(jres.forward(jq, jnp.asarray(img)))
    got = tres.forward(tq, torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (shape[0], 10)
    assert _rel_err(got.numpy(), want) <= 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_reference_tree(dtype):
    want = jres.init(jax.random.PRNGKey(0), 10, dtype=getattr(jnp, dtype))
    got = tres.init(torch.Generator().manual_seed(0), 10, dtype=getattr(torch, dtype),
                    device="cpu")
    jl, tl = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == str(j.dtype), path
    # the converter keeps the reference's dtypes too (jax.tree.map sorts
    # dict keys, so compare by path)
    conv = resnet_params_from_numpy(jax.tree.map(np.asarray, want), "cpu", getattr(torch, dtype))
    assert {p: t.dtype for p, t in _leaves(conv)} == {p: t.dtype for p, t in tl}


# every (H = W, kernel, stride) the model convolves at 224 and at the odd
# 65, with the (low, high) padding the reference's SAME rule gives
CONVS = [(224, 7, 2, (2, 3)), (56, 3, 1, (1, 1)), (56, 3, 2, (0, 1)), (56, 1, 2, (0, 0)),
         (7, 3, 1, (1, 1)), (65, 7, 2, (3, 3)), (33, 3, 2, (1, 1)), (33, 1, 2, (0, 0))]


@pytest.mark.parametrize("hw,k,stride,pads", CONVS)
def test_conv_same_padding(hw, k, stride, pads):
    assert tres.same_pads(hw, k, stride) == pads
    rng = np.random.default_rng(hw + k)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(jres._conv({"w": jnp.asarray(w)}, jnp.asarray(x), stride))
    got = tres._conv({"w": torch.from_numpy(w)}, torch.from_numpy(x), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("hw", [112, 33, 7])
def test_max_pool_same_padding(hw):
    """The -inf SAME pad: (0, 1) at 112; max-pool is exact."""
    x = np.random.default_rng(hw).standard_normal((2, hw, hw, 4)).astype(np.float32) - 3
    want = np.asarray(jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                            (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    np.testing.assert_array_equal(tres._max_pool(torch.from_numpy(x)).numpy(), want)
