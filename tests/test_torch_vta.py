"""The port's VTA GEMM (``kernels/vta_gemm``, ``kernels/ops``) vs the JAX
reference's Pallas kernel in interpret mode.

On the CPU ``vta_gemm`` runs its plain version, ``vta_gemm_ref``; the
same int8 operands (numpy, from seeds, -128 included) go through the
reference's ``ops`` wrappers with ``interpret=True``:

* ``none`` and ``requant`` bitwise, over ``tests/test_kernels.py``'s
  shapes and shift / ReLU cases, qwen3_0p6b's projection shapes at M 4
  and 512, and a shift past 31;
* ``dequant``: without a bias, act none / relu bitwise; with a bias
  within 1e-6 of the output's scale — XLA contracts ``acc * scale +
  bias`` into one FMA (one rounding) where the port rounds the product
  and the sum apart, as its CUDA kernel does, so the two differ by an
  ulp of the product, which near cancellation is more than an ulp of
  the sum; silu / gelu within 1e-5 (the libraries' exp / tanh differ in
  the last bits);
* ``vta_conv2d`` bitwise over ``test_conv_as_gemm``'s cases, through the
  padded im2col lowering; ``dense_requant_int8`` on conv patches; the
  presets, ``quantize`` and the unported ALU.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

# the module (the package exports its function under the same name)
tvta = importlib.import_module("repro_torch.kernels.vta_gemm")

I = dict(interpret=True)
# qwen3_0p6b's projections (K, N): q, k/v, o, gate/up, down
QWEN3 = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024)]
SHAPES = ([(16, 16, 16), (128, 128, 128), (100, 200, 300), (1, 2048, 512),
           (384, 64, 640)]
          + [(m, k, n) for m in (4, 512) for k, n in QWEN3])


def _int8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return _int8(rng, (m, k)), _int8(rng, (k, n)), rng


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_none_epilogue_bitwise(m, k, n):
    a, w, _ = _operands(m, k, n, m * n + k)
    want = np.asarray(jops.matmul_int8(jnp.asarray(a), jnp.asarray(w), **I))
    got = tops.matmul_int8(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


REQUANT = [(64, 96, 160, 0, False), (64, 96, 160, 6, True), (64, 96, 160, 10, True),
           (100, 200, 300, 8, True), (4, 1024, 2048, 12, False),
           (512, 3072, 1024, 14, True), (16, 16, 16, 40, False)]


@pytest.mark.parametrize("m,k,n,shift,relu", REQUANT)
def test_requant_epilogue_bitwise(m, k, n, shift, relu):
    a, w, rng = _operands(m, k, n, shift + 7 * relu)
    bias = rng.integers(-(2 ** 10), 2 ** 10, n).astype(np.int32)
    want = np.asarray(jops.dense_requant_int8(jnp.asarray(a), jnp.asarray(w),
                                              jnp.asarray(bias), shift=shift,
                                              relu=relu, **I))
    got = tops.dense_requant_int8(torch.from_numpy(a), torch.from_numpy(w),
                                  torch.from_numpy(bias), shift=shift, relu=relu)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.gemm_requant_ref(jnp.asarray(a), jnp.asarray(w),
                                                      jnp.asarray(bias), shift, relu)))


DEQUANT = [(130, 70, 129)] + [(m, k, n) for m in (4, 512) for k, n in QWEN3[::2]]


@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("m,k,n", DEQUANT, ids=_ids(DEQUANT))
def test_dequant_epilogue(m, k, n, with_bias, act):
    a, w, rng = _operands(m, k, n, m + k + n)
    scale = rng.uniform(1e-6, 1e-3, n).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if with_bias else None
    want = np.asarray(jops.dense_int8(
        jnp.asarray(a), jnp.asarray(w), jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), act=act, **I))
    got = tops.dense_int8(torch.from_numpy(a), torch.from_numpy(w),
                          torch.from_numpy(scale),
                          None if bias is None else torch.from_numpy(bias), act=act)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if act in (None, "relu") and not with_bias:
        np.testing.assert_array_equal(got.numpy(), want)
    elif act in (None, "relu"):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_vta_gemm_surface_and_presets():
    """The reference's surface: block arguments and presets change
    nothing, the plain version equals the wrapper on a CPU tensor, and the
    bad inputs the kernel cannot take raise."""
    a, w, rng = _operands(256, 512, 256, 0)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    want = np.asarray(jref.gemm_ref(jnp.asarray(a), jnp.asarray(w)))
    for preset in tops.BLOCK_PRESETS:
        np.testing.assert_array_equal(tops.matmul_int8(ta, tw, preset=preset).numpy(), want)
    np.testing.assert_array_equal(
        tvta.vta_gemm(ta, tw, block_m=32, block_n=32, block_k=32).numpy(), want)
    assert tops.BLOCK_PRESETS == jops.BLOCK_PRESETS
    scale = torch.from_numpy(rng.uniform(1e-3, 1e-1, 256).astype(np.float32))
    assert torch.equal(tvta.vta_gemm(ta, tw, scale=scale, epilogue="dequant", act="silu"),
                       tvta.vta_gemm_ref(ta, tw, scale=scale, epilogue="dequant", act="silu"))
    with pytest.raises(TypeError):
        tvta.vta_gemm(ta.int(), tw)
    with pytest.raises(ValueError):
        tvta.vta_gemm(ta, tw, epilogue="dequant")
    with pytest.raises(ValueError):
        tvta.vta_gemm(ta, tw, scale=scale, epilogue="dequant", act="tanh")
    with pytest.raises(ValueError):
        tvta.vta_gemm(ta, tw, bias=torch.zeros(256, dtype=torch.int32),
                      epilogue="requant", shift=-1)
    with pytest.raises(KeyError):
        tops.matmul_int8(ta, tw, preset="table9")


CONV = [(8, 3, 16, 3, 1), (16, 8, 8, 3, 2), (14, 16, 32, 1, 1), (7, 4, 8, 7, 2)]


@pytest.mark.parametrize("hw,cin,cout,kk,stride", CONV)
def test_vta_conv2d_bitwise(hw, cin, cout, kk, stride):
    rng = np.random.default_rng(hw * cin)
    x, w = _int8(rng, (2, hw, hw, cin)), _int8(rng, (kk, kk, cin, cout))
    want = np.asarray(jops.vta_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, **I))
    got = tops.vta_conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride)))
    # the im2col patches themselves, and the requant pipeline on them
    jp, ho, wo = jops._im2col(jnp.asarray(x), kk, kk, stride)
    tp, tho, two = tops._im2col(torch.from_numpy(x), kk, kk, stride)
    assert (tho, two) == (ho, wo)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    bias = rng.integers(-(2 ** 12), 2 ** 12, cout).astype(np.int32)
    wm = w.reshape(-1, cout)
    want = np.asarray(jops.dense_requant_int8(jp, jnp.asarray(wm), jnp.asarray(bias),
                                              shift=7, **I))
    got = tops.dense_requant_int8(tp, torch.from_numpy(wm), torch.from_numpy(bias), shift=7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_and_unported_alu():
    x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32) * 4
    for scale in (0.05, 0.013):
        want = np.asarray(jops.quantize(jnp.asarray(x), scale))
        got = tops.quantize(torch.from_numpy(x), scale)
        assert got.dtype == torch.int8 and got.numpy().min() == -128
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError, match="queue 2, items 5-6"):
        tops.alu(torch.zeros((4, 4), dtype=torch.int32), op="relu")
