"""The port's CUDA kernels on the card, each held to its plain version.

Every test here is marked ``gpu`` and skips where torch sees no CUDA
device (the kernels have no CPU mode).  On a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports torch and numpy only, so it runs where JAX is absent.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

tdec = importlib.import_module("repro_torch.kernels.decode_attention")
tfl = importlib.import_module("repro_torch.kernels.flash_attention")

# f32: summation order only (32-key tiles / per-warp partials vs whole
# chunks); bf16: one output rounding apart plus P rounded to bf16
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, dtype, b, s, t, h, hkv, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
            for shape in ((b, s, h, d), (b, t, hkv, d), (b, t, hkv, dv))]


GPU_FLASH = [
    ("main_path_q0", dict(b=4, s=512, t=2080, h=16, hkv=8, d=128, dv=128),
     dict(q_offset=0, kv_len=512)),
    ("main_path_q1536", dict(b=4, s=512, t=2080, h=16, hkv=8, d=128, dv=128),
     dict(q_offset=1536, kv_len=2048)),
    ("swa", dict(b=1, s=256, t=256, h=4, hkv=2, d=64, dv=64), dict(window=96)),
    ("bidir", dict(b=1, s=128, t=192, h=4, hkv=2, d=32, dv=32),
     dict(bidirectional=True)),
    ("nonmult", dict(b=2, s=100, t=130, h=6, hkv=2, d=24, dv=8),
     dict(q_offset=3, kv_len=101)),
    ("tiny", dict(b=1, s=3, t=5, h=2, hkv=1, d=8, dv=4), dict(q_offset=2)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,opts", GPU_FLASH, ids=[c[0] for c in GPU_FLASH])
def test_flash_kernel_matches_plain_on_card(cuda, name, shape, opts, dtype):
    q, k, v = _qkv(cuda, getattr(torch, dtype), **shape, seed=len(name))
    n0 = tfl.flash_attention.launches
    got, counts = tfl.flash_attention(q, k, v, return_counts=True, **opts)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == n0 + 1
    want = tfl.flash_attention_ref(q, k, v, **opts)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    tile_map = tfl.flash_tile_map(shape["s"], shape["t"], **opts)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  tile_map.expand_as(counts.cpu()).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_len,window", [(1, 0), (511, 0), (512, 0), (513, 0),
                                           (2080, 0), (1700, 600)])
def test_decode_kernel_matches_plain_on_card(cuda, kv_len, window, dtype):
    q, k, v = _qkv(cuda, getattr(torch, dtype), 4, 1, 2080, 16, 8, 128, 128, seed=kv_len)
    n0 = tdec.decode_attention.launches
    got, counts = tdec.decode_attention(q, k, v, kv_len=kv_len, window=window,
                                        return_counts=True)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + 1
    want = tdec.decode_attention_ref(q, k, v, kv_len=kv_len, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    want_map = tdec.decode_partition_map(2080, kv_len, window=window)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  want_map.expand_as(counts.cpu()).numpy())


@pytest.mark.gpu
def test_generate_on_card_goes_through_kernels(cuda):
    """A reduced qwen3 generate on the card: the attention calls launch
    the kernels, and the greedy tokens equal a run on the plain versions."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import generate

    cfg = get_config("qwen3_0p6b").scaled_down()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tf.init(cfg, generator=gen, dtype=torch.float32, device=cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 600), generator=gen, device=cuda)
    n0 = (tfl.flash_attention.launches, tdec.decode_attention.launches)
    got = generate(params, cfg, prompt, 5, 1030, torch.float32, chunk=512)
    n1 = (tfl.flash_attention.launches, tdec.decode_attention.launches)
    # 600 = one 512 chunk + a right-padded second one (the cache holds
    # the pad: 1024 + 4 <= 1030): 2 flash calls per layer, 4 decode steps
    assert n1[0] - n0[0] == 2 * cfg.num_layers
    assert n1[1] - n0[1] == 4 * cfg.num_layers
    prev = layers.set_attention_impl("ref")
    try:
        want = generate(params, cfg, prompt, 5, 1030, torch.float32, chunk=512)
    finally:
        layers.set_attention_impl(prev)
    assert (tfl.flash_attention.launches, tdec.decode_attention.launches) == n1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
