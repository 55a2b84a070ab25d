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
  presets and ``quantize``;
* the ALU (``ops.alu``) bitwise for all seven ops over
  ``tests/test_kernels.py``'s cases, a ragged M, an int8 ``x``, the int32
  wrap and shifts 0, 7, 31 and 40; and the inputs it refuses.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.optim.quant import k_major  # noqa: E402

# the module (the package exports its function under the same name)
tvta = importlib.import_module("repro_torch.kernels.vta_gemm")
tvta_alu = importlib.import_module("repro_torch.kernels.vta_alu")
INT32_MIN, INT32_MAX = tvta_alu.INT32_MIN, tvta_alu.INT32_MAX

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


LAYOUT_CASES = [("none", {}), ("requant", dict(shift=9, relu=True)),
                ("dequant", dict(act=None)), ("dequant", dict(act="gelu"))]


@pytest.mark.parametrize("epi,kw", LAYOUT_CASES, ids=[f"{e}_{k.get('act')}" for e, k in
                                                        LAYOUT_CASES])
@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_plain_version_equal_on_both_weight_layouts(m, k, n, epi, kw):
    """A K-major ``w`` (as ``optim.quant`` packs it) and the same values
    N-contiguous give bitwise equal results, both equal to the Pallas
    kernel's int32 sums; ``w_layout`` reads each layout's stride."""
    a, w, rng = _operands(m, k, n, m + k + n)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    twk = k_major(tw)
    assert twk.stride() == (1, k) and torch.equal(twk, tw)
    assert tvta.w_layout(twk) == (True, k) and tvta.w_layout(tw) == (False, n)
    kw = dict(kw)
    if epi == "requant":
        kw["bias"] = torch.from_numpy(rng.integers(-4096, 4096, n).astype(np.int32))
    if epi == "dequant":
        kw["scale"] = torch.from_numpy(rng.uniform(1e-6, 1e-4, n).astype(np.float32))
    got_k = tvta.vta_gemm(ta, twk, epilogue=epi, **kw)
    got_n = tvta.vta_gemm(ta, tw, epilogue=epi, **kw)
    assert torch.equal(got_k, got_n)
    if epi == "none":
        want = jops.matmul_int8(jnp.asarray(a), jnp.asarray(w), **I)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want))


def test_w_layout_refuses_other_strides():
    """The kernel reads W K-major or N-contiguous; any other strides are
    refused before a launch (the plain version on the CPU takes them)."""
    w = torch.zeros((8, 6, 2), dtype=torch.int8)[:, :, 0]  # strides (12, 2)
    with pytest.raises(ValueError, match="K-major"):
        tvta.w_layout(w)
    assert tvta.w_layout(w[:1]) == (True, 2) and tvta.w_layout(w[:, :1]) == (False, 12)


# qwen3_0p6b's projections at the paths' rows on a 132-SM card: decode rows
# split K, the prefill chunks take no split (512: the 64 x 64 tile where
# 128 x 128 tiles would leave more than half the SMs idle; 2048: 128 x 128)
SPLIT_ROWS = [(4, True), (8, True), (512, False), (2048, False)]


@pytest.mark.parametrize("m,split", SPLIT_ROWS)
def test_split_k_choices_at_qwen3_rows(m, split):
    """Decode rows split K; the prefill chunks do not; nor does a GEMM
    whose K is too short to share (ResNet-18's 3x3x64 conv, K 576)."""
    assert tvta._splits(3136, 64, 576, 132)[0] == 1
    for k, n in QWEN3:
        splits, per = tvta._splits(m, n, k, 132)
        assert (splits > 1) == split, (m, k, n, splits)
        assert per % tvta._TILE_K == 0 and splits * per >= k and (splits - 1) * per < k
        tile = tvta._tile(m, n, 132)
        if m == 2048:
            assert tile == tvta._LARGE_TILE
        if m <= 8:
            assert tile == tvta._SMALL_TILE
            assert splits * -(-n // tile[1]) <= 2 * 132 + -(-n // tile[1])


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


@pytest.mark.parametrize("hw,cin,cout,kk,stride", CONV)
def test_packed_conv_weight_is_k_major_and_bitwise(hw, cin, cout, kk, stride):
    """``pack_conv_weight`` keeps the HWIO shape and values; the GEMM view
    ``vta_conv2d`` takes of it is K-major, with no copy, and the
    convolution and the requant pipeline stay bitwise the reference's."""
    rng = np.random.default_rng(hw * cin + 1)
    x, w = _int8(rng, (2, hw, hw, cin)), _int8(rng, (kk, kk, cin, cout))
    wp = tops.pack_conv_weight(torch.from_numpy(w))
    k = kk * kk * cin
    assert wp.shape == w.shape and wp.dtype == torch.int8
    np.testing.assert_array_equal(wp.numpy(), w)
    wm = wp.reshape(k, cout)
    assert wm.stride() == (1, k) and wm.data_ptr() == wp.data_ptr()
    want = np.asarray(jops.vta_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, **I))
    np.testing.assert_array_equal(tops.vta_conv2d(torch.from_numpy(x), wp, stride=stride).numpy(),
                                  want)
    jp, _, _ = jops._im2col(jnp.asarray(x), kk, kk, stride)
    bias = rng.integers(-(2 ** 12), 2 ** 12, cout).astype(np.int32)
    want = np.asarray(jops.dense_requant_int8(jp, jnp.asarray(w.reshape(k, cout)),
                                              jnp.asarray(bias), shift=7, **I))
    got = tops.dense_requant_int8(torch.from_numpy(np.asarray(jp)), wm, torch.from_numpy(bias),
                                  shift=7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_bitwise():
    x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32) * 4
    for scale in (0.05, 0.013):
        want = np.asarray(jops.quantize(jnp.asarray(x), scale))
        got = tops.quantize(torch.from_numpy(x), scale)
        assert got.dtype == torch.int8 and got.numpy().min() == -128
        np.testing.assert_array_equal(got.numpy(), want)


# the VTA ALU: tests/test_kernels.py's ops and immediates, the shifts 0, 7,
# 31 and 40 (past 31: all sign bits), and immediates at the int32 ends
ALU_OPS = [("add", {}), ("max", {}), ("min", {}), ("relu", {}),
           ("add_imm", {"imm": -3}), ("max_imm", {"imm": 11}),
           ("add_imm", {"imm": INT32_MAX}), ("add_imm", {"imm": INT32_MIN}),
           ("max_imm", {"imm": INT32_MIN})]
ALU_OPS += [("shr", {"shift": s}) for s in (0, 7, 31, 40)]
# test_kernels.py's (100, 64) int32 in [-2**20, 2**20); a ragged M (257
# rows, not a block multiple) and a narrow N; an int8 x (-128 included)
# against an int32 y, and int8 both; the full int32 range with both ends
# present (the adds wrap)
ALU_DATA = ["test_kernels", "ragged", "int8_x", "int8_xy", "wrap"]


def _alu_operands(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "test_kernels":
        return (rng.integers(-(2 ** 20), 2 ** 20, (100, 64)).astype(np.int32),
                rng.integers(-(2 ** 20), 2 ** 20, (100, 64)).astype(np.int32))
    if kind == "ragged":
        return (rng.integers(-(2 ** 20), 2 ** 20, (257, 24)).astype(np.int32),
                rng.integers(-(2 ** 20), 2 ** 20, (257, 24)).astype(np.int32))
    if kind in ("int8_x", "int8_xy"):
        x = rng.integers(-128, 128, (100, 64)).astype(np.int8)
        x[0, 0] = -128
        if kind == "int8_xy":
            y = rng.integers(-128, 128, (100, 64)).astype(np.int8)
            y[0, 1] = 127
            return x, y
        return x, rng.integers(-(2 ** 20), 2 ** 20, (100, 64)).astype(np.int32)
    x, y = (rng.integers(INT32_MIN, INT32_MAX, (64, 32), endpoint=True).astype(np.int32)
            for _ in range(2))
    x[0, :4] = y[0, 2:6] = [INT32_MAX, INT32_MIN, INT32_MAX, INT32_MIN]
    y[0, :2] = [INT32_MAX, INT32_MIN]
    return x, y


def _alu_id(case):
    op, kw = case
    return op + "".join(f"_{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("kind", ALU_DATA)
@pytest.mark.parametrize("op,kw", ALU_OPS, ids=[_alu_id(c) for c in ALU_OPS])
def test_alu_bitwise(op, kw, kind):
    """ops.alu equals the reference's Pallas vta_alu in interpret mode
    (through its padded ops.alu) bitwise, and the plain version
    equals it too."""
    x, y = _alu_operands(kind, len(op) + 17 * kw.get("shift", 0))
    binary = op in tvta_alu._BINARY
    want = np.asarray(jops.alu(jnp.asarray(x), jnp.asarray(y) if binary else None,
                               op=op, **kw, **I))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y) if binary else None
    n0 = dict(tvta_alu.vta_alu.launches)
    got = tops.alu(tx, ty, op=op, **kw)
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tvta_alu.vta_alu_ref(tx, ty, op, **kw).numpy(), want)
    assert tvta_alu.vta_alu.launches == n0  # the CPU runs the plain version


def test_alu_surface_and_raising():
    """block changes nothing; a negative shift, an imm outside int32,
    mismatched or missing y, an unknown op, and operands neither int8 nor
    int32 (the kernel's types) raise."""
    x, y = (torch.from_numpy(a) for a in _alu_operands("ragged", 3))
    assert torch.equal(tops.alu(x, y, op="add", block=8), tops.alu(x, y, op="add"))
    assert torch.equal(tops.alu(x, op="relu", block=1024), torch.clamp_min(x, 0))
    # a unary op ignores y, as the reference's unary kernel does
    assert torch.equal(tops.alu(x, y, op="shr", shift=3), x >> 3)
    with pytest.raises(ValueError, match="shift"):
        tops.alu(x, op="shr", shift=-1)
    for imm in (INT32_MAX + 1, INT32_MIN - 1):
        with pytest.raises(ValueError, match="imm"):
            tops.alu(x, op="add_imm", imm=imm)
    with pytest.raises(ValueError, match="shape"):
        tops.alu(x, y[:-1], op="max")
    with pytest.raises(ValueError, match="shape"):
        tops.alu(x, op="min")
    with pytest.raises(ValueError, match="unknown ALU op"):
        tops.alu(x, y, op="mul")
    for bad in (x.float(), x.long(), x.to(torch.int16)):
        with pytest.raises(TypeError, match="int8 or int32"):
            tops.alu(bad, op="relu")
    with pytest.raises(TypeError, match="int8 or int32"):
        tops.alu(x, y.long(), op="add")
