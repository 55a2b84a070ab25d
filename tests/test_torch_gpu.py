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

# f32: summation order (64-key tiles on the tensor cores vs whole chunks)
# and the 3xTF32 split's ~2^-22; bf16: one output rounding apart plus P
# rounded to bf16
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


FLASH_BLOCKS = [(32, 32), (64, 64), (16, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", FLASH_BLOCKS, ids=["x".join(map(str, b)) for b in FLASH_BLOCKS])
@pytest.mark.parametrize("name", ["main_path_q1536", "swa", "nonmult"])
def test_flash_kernel_at_other_blocks_on_card(cuda, name, blocks, dtype):
    """Caller blocks that are not the defaults (a 48-key tile is not a
    multiple of the 64-key sub-step): the kernel computes that tiling,
    its map equals ``flash_tile_map`` at those blocks, and its output
    the plain version's."""
    _, shape, opts = next(c for c in GPU_FLASH if c[0] == name)
    bq, bk = blocks
    q, k, v = _qkv(cuda, getattr(torch, dtype), **shape, seed=bq + bk)
    got, counts = tfl.flash_attention(q, k, v, block_q=bq, block_k=bk, return_counts=True,
                                      **opts)
    torch.cuda.synchronize()
    want = tfl.flash_attention_ref(q, k, v, **opts)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    tile_map = tfl.flash_tile_map(shape["s"], shape["t"], block_q=bq, block_k=bk, **opts)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  tile_map.expand_as(counts.cpu()).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [dict(q_offset=0, kv_len=512), dict(q_offset=1536, kv_len=2048),
                                  dict(q_offset=1536, kv_len=2048, window=256)],
                         ids=["q0", "q1536", "window256"])
def test_flash_f32_within_1e5_of_f64_on_card(cuda, opts):
    """f32 on the tensor cores keeps f32 accuracy (3xTF32): within 1e-5 of
    exact f64 attention at the main path's shapes, where one TF32 pass
    would be ~1e-4 to 1e-3 off."""
    q, k, v = _qkv(cuda, torch.float32, 4, 512, 2080, 16, 8, 128, 128, seed=11)
    got = tfl.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    err = (got.double() - tfl.attention_f64(q, k, v, **opts)).abs().max().item()
    assert err <= 1e-5, err


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


def _paged(dev, dtype, b, s, h, hkv, d, w, pg, kv_lens, *, int8=False, seed=0):
    """Random q and page pools with every sequence's pages at shuffled,
    non-contiguous pool indices and -1 tails (one spare table entry at
    least); int8 pools come with per-page, per-head scales."""
    rng = np.random.default_rng(seed)
    pages = [-(-n // pg) for n in kv_lens]
    max_pp, num_pages = max(pages) + 1, sum(pages) + 3
    perm = rng.permutation(num_pages)
    bt = -np.ones((b, max_pp), np.int32)
    nxt = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[nxt:nxt + n]
        nxt += n
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    shape = (hkv, num_pages, pg, w)
    if int8:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
                  for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random(shape[:2]) * 0.02 + 1e-3).astype(np.float32))
                  for _ in range(2))
        extra = dict(k_scales=ks.to(dev), v_scales=vs.to(dev))
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                  for _ in range(2))
        extra = {}
    return (q.to(dev, dtype), kp.to(dev), vp.to(dev), torch.from_numpy(bt).to(dev),
            torch.tensor(kv_lens, dtype=torch.int32, device=dev)), extra


GPU_PAGED = [(s, window, pg) for s in (1, 5) for window in (0, 100) for pg in (16, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,pg", GPU_PAGED)
def test_paged_kernel_matches_plain_on_card(cuda, s, window, pg, dtype):
    kv_lens = [0, 1, pg - 1, pg, pg + 1, 2064]
    args, extra = _paged(cuda, getattr(torch, dtype), 6, s, 16, 8, 128, 128, pg,
                         kv_lens, seed=pg + s + window)
    n0 = tdec.paged_decode_attention.launches
    got, counts = tdec.paged_decode_attention(*args, window=window, return_counts=True)
    torch.cuda.synchronize()
    assert tdec.paged_decode_attention.launches == n0 + 1
    want, want_map = tdec.paged_decode_attention_ref(*args, window=window,
                                                     return_counts=True)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    assert not got[0].any(), "kv_len 0 gives exactly zero"
    np.testing.assert_array_equal(counts.cpu().numpy(), want_map.cpu().numpy())
    if s == 1:
        executed, total = tdec.paged_partition_counts(args[3].shape[1], kv_lens,
                                                      page_size=pg, window=window)
        assert counts.shape[2] == total
        assert counts[:, 0].sum(1).tolist() == executed


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dv", "int8", "int8_verify"])
def test_paged_kernel_dv_and_int8_on_card(cuda, case):
    int8 = case.startswith("int8")
    s = 5 if case == "int8_verify" else 1
    kv_lens = [0, 1, 15, 16, 17, 2064]
    args, extra = _paged(cuda, torch.float32, 6, s, 16, 8, 128, 160 if case == "dv" else 128,
                         16, kv_lens, int8=int8, seed=7)
    dv = 96 if case == "dv" else None
    got, counts = tdec.paged_decode_attention(*args, dv=dv, window=100,
                                              return_counts=True, **extra)
    torch.cuda.synchronize()
    want, want_map = tdec.paged_decode_attention_ref(*args, dv=dv, window=100,
                                                     return_counts=True, **extra)
    assert got.shape[-1] == (96 if case == "dv" else 128)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL["float32"])
    np.testing.assert_array_equal(counts.cpu().numpy(), want_map.cpu().numpy())


@pytest.mark.gpu
def test_decode_smem_bytes_match_the_kernel_on_card(cuda):
    """The wrapper's plan sizes shared memory with the kernel's layout."""
    lib = tdec._lib()
    for rows in (1, 2, 7, 12, 16):
        for d, dv in ((32, 32), (128, 128), (128, 8), (192, 128), (576, 512)):
            for chunk in (1, 8, 16):
                for esize in (2, 4):
                    for kw, rw in ((4, 1), (3, 1), (1, 1), (1, 8), (2, 2)):
                        for shared in (0, 1):
                            args = (rows, d, dv, chunk, esize, kw, rw, shared)
                            assert tdec.decode_smem_bytes(*args) == \
                                lib.decode_attention_smem_bytes(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_refuses_oversized_partition_on_card(cuda, dtype):
    """MLA's absorbed decode at full width (128 heads on one latent head,
    D 576, v a view of the leading 512 columns of k) no longer needs more
    shared memory than a CTA may opt in to: it runs in one launch and equals
    the plain version, its map ``decode_partition_map``.  A key that still
    does not fit (D 8192) raises a ValueError naming the limit, unlaunched."""
    q, k, _ = _qkv(cuda, getattr(torch, dtype), 2, 1, 2080, 128, 1, 576, 576, seed=9)
    v = k[..., :512]
    n0 = tdec.decode_attention.launches
    got, counts = tdec.decode_attention(q, k, v, kv_len=2064, return_counts=True)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + 1 and got.shape == (2, 1, 128, 512)
    want = tdec.decode_attention_ref(q, k, v, kv_len=2064)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    want_map = tdec.decode_partition_map(2080, 2064)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_map.expand_as(counts.cpu()).numpy())
    q, k, v = _qkv(cuda, torch.float32, 1, 1, 64, 16, 1, 8192, 128)
    with pytest.raises(ValueError, match="227 KiB"):
        tdec.decode_attention(q, k, v, kv_len=64)
    assert tdec.decode_attention.launches == n0 + 1


DECODE_G = [(8, 7, 0), (8, 8, 0), (4, 12, 0), (8, 7, 600), (4, 12, 600)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hkv,g,window", DECODE_G,
                         ids=[f"g{g}_hkv{h}_w{w}" for h, g, w in DECODE_G])
def test_decode_kernel_at_wide_groups_on_card(cuda, hkv, g, window, dtype):
    """One full-width layer of yi_34b (G 7), qwen2_72b (G 8) and
    starcoder2_15b (G 12, Hkv 4) at D 128, B 4, T 2080, kv_len 2064, with
    and without a window: the rows masked inside one tile equal the plain
    version, the map ``decode_partition_map``; a second call at kv_len 0
    gives an exactly zero output."""
    q, k, v = _qkv(cuda, getattr(torch, dtype), 4, 1, 2080, hkv * g, hkv, 128, 128, seed=g)
    got, counts = tdec.decode_attention(q, k, v, kv_len=2064, window=window,
                                        return_counts=True)
    torch.cuda.synchronize()
    want = tdec.decode_attention_ref(q, k, v, kv_len=2064, window=window)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    want_map = tdec.decode_partition_map(2080, 2064, window=window)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_map.expand_as(counts.cpu()).numpy())
    zero = tdec.decode_attention(q, k, v, kv_len=0, window=window)
    torch.cuda.synchronize()
    assert not zero.any()


@pytest.mark.gpu
def test_decode_kernel_graph_replay_equals_eager(cuda):
    """Dense decode calls captured in one CUDA graph (the span-merge
    counters of the capture zeroed by a memset the graph replays) and
    replayed after the cache and queries change in place equal eager calls
    on the same inputs, bitwise, at several lengths and both layouts."""
    q, k, v = _qkv(cuda, torch.float32, 4, 1, 2080, 16, 8, 128, 128, seed=21)
    mq, mk, _ = _qkv(cuda, torch.float32, 2, 1, 2080, 128, 1, 576, 576, seed=22)
    calls = [lambda n=n: tdec.decode_attention(q, k, v, kv_len=n) for n in (2064, 513, 1)]
    calls.append(lambda: tdec.decode_attention(q, k, v, kv_len=1700, window=600))
    calls.append(lambda: tdec.decode_attention(mq, mk, mk[..., :512], kv_len=2064))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c() for c in calls]
    for seed in (1, 2):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        for x in (q, k, v, mq, mk):
            x.copy_(torch.randn(x.shape, generator=gen, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        for got, c in zip(outs, calls):
            want = c()
            torch.cuda.synchronize()
            assert torch.equal(got, want), seed


@pytest.mark.gpu
def test_decode_kernel_on_two_streams_on_card(cuda):
    """Dense decode calls issued on two streams with no synchronisation
    between them, eager and as two captured graphs replayed at once, each
    equal to the plain version: launches that may overlap never share
    span-merge counters."""
    ins = [_qkv(cuda, torch.float32, 4, 1, 2080, 16, 8, 128, 128, seed=s) for s in (31, 32)]
    lens = (2064, 1100)
    want = [tdec.decode_attention_ref(*x, kv_len=n) for x, n in zip(ins, lens)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(tdec.decode_attention(*ins[i], kv_len=lens[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            np.testing.assert_allclose(got.cpu().numpy(), want[i].cpu().numpy(),
                                       atol=TOL["float32"])
    graphs, gouts = [], []
    for i in range(2):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gouts.append([tdec.decode_attention(*ins[i], kv_len=lens[i]) for _ in range(10)])
        graphs.append(graph)
    torch.cuda.synchronize()
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(5):
        for graph, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                graph.replay()
    torch.cuda.synchronize()
    for i in range(2):
        for got in gouts[i]:
            np.testing.assert_allclose(got.cpu().numpy(), want[i].cpu().numpy(),
                                       atol=TOL["float32"])


@pytest.mark.gpu
def test_paged_smem_bytes_match_the_kernel_on_card(cuda):
    """The wrapper's plan sizes shared memory with the kernel's layout."""
    lib = tdec._paged_lib()
    for rows in (1, 2, 10, 16):
        for d, dv in ((32, 32), (128, 128), (128, 96), (576, 512)):
            for pg in (1, 16, 64):
                for span in (1, 8):
                    for esize in (1, 2, 4):
                        for warps in (1, 3, 4):
                            args = (rows, d, dv, pg, span, esize, warps)
                            assert tdec.paged_smem_bytes(*args) == \
                                lib.paged_decode_attention_smem_bytes(*args)


ENGINE_LENS = [512, 740, 968, 1196, 1424, 1652, 1880, 2112]


def _paged_engine(dev, dtype, s, int8, seed):
    """The engine's 8 slots at lengths 512-2112 in 132-page tables of
    16-token pages at shuffled pool indices; slots 0 and 1 share their
    first 32 pages (a 512-token prefix)."""
    rng = np.random.default_rng(seed)
    pg, width, shared = 16, 132, 32
    pages = [-(-n // pg) for n in ENGINE_LENS]
    num_pages = sum(pages) - shared + 3
    perm = rng.permutation(num_pages)
    bt = -np.ones((8, width), np.int32)
    nxt = 0
    for i, n in enumerate(pages):
        own = 0 if i != 1 else shared
        bt[i, :own] = bt[0, :own]
        bt[i, own:n] = perm[nxt:nxt + n - own]
        nxt += n - own
    q = torch.from_numpy(rng.standard_normal((8, s, 16, 128)).astype(np.float32))
    shape = (8, num_pages, pg, 128)
    if int8:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
                  for _ in range(2))
        extra = {name: torch.from_numpy((rng.random(shape[:2]) * 0.02 + 1e-3)
                                        .astype(np.float32)).to(dev)
                 for name in ("k_scales", "v_scales")}
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                  for _ in range(2))
        extra = {}
    return (q.to(dev, dtype), kp.to(dev), vp.to(dev), torch.from_numpy(bt).to(dev),
            torch.tensor(ENGINE_LENS, dtype=torch.int32, device=dev)), extra


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("s", [1, 5])
def test_paged_kernel_at_engine_lengths_on_card(cuda, pages, s):
    """B 8 at the engine's lengths with a shared prefix, decode and S 5
    verify, f32 / bf16 / int8 pages: equal to the plain version, and the
    map to ``paged_partition_counts``."""
    dtype = torch.bfloat16 if pages == "bfloat16" else torch.float32
    args, extra = _paged_engine(cuda, dtype, s, pages == "int8", seed=s)
    got, counts = tdec.paged_decode_attention(*args, return_counts=True, **extra)
    torch.cuda.synchronize()
    want, want_map = tdec.paged_decode_attention_ref(*args, return_counts=True, **extra)
    tol = TOL["bfloat16" if pages == "bfloat16" else "float32"]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=tol)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_map.cpu().numpy())
    if s == 1:
        executed, total = tdec.paged_partition_counts(132, ENGINE_LENS, page_size=16)
        assert counts.shape[2] == total and counts[:, 0].sum(1).tolist() == executed


@pytest.mark.gpu
@pytest.mark.parametrize("h", [16, 128])
def test_paged_kernel_mla_shaped_on_card(cuda, h):
    """MLA's absorbed decode: H query heads on one latent head, D 576, the
    values the first 512 columns of the same pool; 128 heads take eight
    row tiles of 16."""
    args, _ = _paged(cuda, torch.float32, 2, 1, h, 1, 576, 576, 16, [0, 1100], seed=h)
    q, kp, _, bt, lens = args
    args = (q, kp, kp, bt, lens)
    got, counts = tdec.paged_decode_attention(*args, dv=512, return_counts=True)
    torch.cuda.synchronize()
    want, want_map = tdec.paged_decode_attention_ref(*args, dv=512, return_counts=True)
    assert got.shape == (2, 1, h, 512)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=TOL["float32"])
    np.testing.assert_array_equal(counts.cpu().numpy(), want_map.cpu().numpy())
    assert not got[0].any()


@pytest.mark.gpu
def test_paged_kernel_graph_replay_on_new_lengths(cuda):
    """One call captured in a CUDA graph and replayed after the lengths
    (on the device) change equals an eager call at those lengths: the
    plan depends on host shapes only, and nothing is read back."""
    args, _ = _paged(cuda, torch.float32, 4, 1, 16, 8, 128, 128, 16, [2064, 1500, 700, 40],
                     seed=3)
    q, kp, vp, bt, lens = args
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdec.paged_decode_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.paged_decode_attention(*args)
    for new in ([2064, 1500, 700, 40], [17, 0, 699, 33], [1, 1499, 16, 2]):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = tdec.paged_decode_attention(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, want), new
        np.testing.assert_allclose(
            out.cpu().numpy(),
            tdec.paged_decode_attention_ref(q, kp, vp, bt, lens).cpu().numpy(),
            atol=TOL["float32"])


@pytest.mark.gpu
def test_paged_kernel_on_two_streams_on_card(cuda):
    """Paged calls issued on two streams with no synchronisation between
    them, eager and as two captured graphs replayed at once, each equal to
    the plain version: the span-merge counters of launches that may
    overlap are never shared."""
    lens_a, lens_b = [2064, 1500, 700, 40], [33, 2064, 1, 1100]
    (qa, kpa, vpa, bta, la), _ = _paged(cuda, torch.float32, 4, 1, 16, 8, 128, 128, 16,
                                        lens_a, seed=11)
    (qb, kpb, vpb, btb, lb), _ = _paged(cuda, torch.float32, 4, 1, 16, 8, 128, 128, 16,
                                        lens_b, seed=12)
    calls = [(qa, kpa, vpa, bta, la), (qb, kpb, vpb, btb, lb)]
    want = [tdec.paged_decode_attention_ref(*c) for c in calls]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(20):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(tdec.paged_decode_attention(*calls[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            np.testing.assert_allclose(got.cpu().numpy(), want[i].cpu().numpy(),
                                       atol=TOL["float32"])
    graphs, gouts = [], []
    for c in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gouts.append([tdec.paged_decode_attention(*c) for _ in range(10)])
        graphs.append(graph)
    torch.cuda.synchronize()
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(5):
        for graph, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                graph.replay()
    torch.cuda.synchronize()
    for i in range(2):
        for got in gouts[i]:
            np.testing.assert_allclose(got.cpu().numpy(), want[i].cpu().numpy(),
                                       atol=TOL["float32"])


@pytest.mark.gpu
def test_paged_engine_on_card_goes_through_kernels(cuda):
    """A reduced qwen3 ServingEngine trace on the card: every decode step
    launches the paged kernel once per layer, and the tokens equal a run
    on the plain versions."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config("qwen3_0p6b").scaled_down()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tf.init(cfg, generator=gen, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(0)
    trace = [(rng.integers(0, cfg.vocab, n).astype(np.int32), m)
             for n, m in [(40, 6), (70, 3), (25, 9), (90, 5)]]

    def run():
        eng = ServingEngine(params, cfg, max_slots=2, max_len=128, page_size=16,
                            prefill_chunk=32, prefix_cache=True)
        for p, m in trace:
            eng.submit(p, m)
        done = eng.run()
        eng.audit()
        return {r.rid: r.tokens for r in done}, eng.steps

    n0 = tdec.paged_decode_attention.launches
    got, steps = run()
    assert tdec.paged_decode_attention.launches - n0 == steps * cfg.num_layers
    prev = layers.set_attention_impl("ref")
    try:
        want, _ = run()
    finally:
        layers.set_attention_impl(prev)
    assert got == want


# ---------------------------------------------------------------------------
# the VTA GEMM (int8 tensor cores) and the int8 serving path
# ---------------------------------------------------------------------------

tvta = importlib.import_module("repro_torch.kernels.vta_gemm")
tops = importlib.import_module("repro_torch.kernels.ops")

GPU_GEMM = [(16, 16, 16), (100, 200, 300), (1, 2048, 512), (384, 64, 640),
            (4, 1024, 2048), (8, 3072, 1024), (512, 1024, 3072), (2048, 2048, 1024),
            (49, 4608, 512), (12544, 147, 64)]
GEMM_CASES = ["none", "requant", "dequant", "dequant_relu_bias", "dequant_silu",
              "dequant_gelu"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES)
@pytest.mark.parametrize("m,k,n", GPU_GEMM, ids=["x".join(map(str, s)) for s in GPU_GEMM])
def test_vta_gemm_kernel_matches_plain_on_card(cuda, m, k, n, case):
    """none / requant / dequant none and relu bitwise; silu and gelu within
    1e-5 of max(1, |y|) (the kernel's expf / tanhf against PyTorch's)."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    epi = case.split("_")[0]
    kw = dict(epilogue=epi)
    if epi == "requant":
        kw.update(bias=torch.from_numpy(rng.integers(-4096, 4096, n).astype(np.int32)).to(cuda),
                  shift=9, relu=True)
    if epi == "dequant":
        kw["scale"] = torch.from_numpy(rng.uniform(1e-6, 1e-4, n).astype(np.float32)).to(cuda)
        kw["act"] = None if case == "dequant" else case.split("_")[1]
        if case.endswith("bias"):
            kw["bias"] = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    n0 = dict(tvta.vta_gemm.launches)
    got = tvta.vta_gemm(a, w, **kw)
    torch.cuda.synchronize()
    assert tvta.vta_gemm.launches[epi] == n0[epi] + 1
    want = tvta.vta_gemm_ref(a, w, **kw)
    assert got.dtype == want.dtype and got.shape == (m, n)
    if case in ("dequant_silu", "dequant_gelu"):
        err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        assert err <= 1e-5
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES)
@pytest.mark.parametrize("m,k,n", GPU_GEMM, ids=["x".join(map(str, s)) for s in GPU_GEMM])
def test_vta_gemm_kernel_k_major_on_card(cuda, m, k, n, case):
    """W packed K-major (the model's layout) and the same values
    N-contiguous: both bitwise equal to the plain version (silu / gelu
    within 1e-5 of max(1, |y|)), and to each other."""
    from repro_torch.optim.quant import k_major

    rng = np.random.default_rng(m * 7 + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    wk = k_major(w)
    assert wk.stride() == (1, k)
    epi = case.split("_")[0]
    kw = dict(epilogue=epi)
    if epi == "requant":
        kw.update(bias=torch.from_numpy(rng.integers(-4096, 4096, n).astype(np.int32)).to(cuda),
                  shift=9, relu=True)
    if epi == "dequant":
        kw["scale"] = torch.from_numpy(rng.uniform(1e-6, 1e-4, n).astype(np.float32)).to(cuda)
        kw["act"] = None if case == "dequant" else case.split("_")[1]
        if case.endswith("bias"):
            kw["bias"] = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    n0 = tvta.vta_gemm.launches[epi]
    got = tvta.vta_gemm(a, wk, **kw)
    got_n = tvta.vta_gemm(a, w, **kw)
    torch.cuda.synchronize()
    assert tvta.vta_gemm.launches[epi] == n0 + 2
    want = tvta.vta_gemm_ref(a, w, **kw)
    assert torch.equal(got, got_n)
    if case in ("dequant_silu", "dequant_gelu"):
        err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
        assert err <= 1e-5
    else:
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("k,n", [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                                 (3072, 1024)])
def test_vta_gemm_decode_rows_split_k_on_card(cuda, m, k, n):
    """Decode rows on qwen3's projections take the split-K path on this
    card, K-major and N-contiguous, bitwise equal to the plain version."""
    from repro_torch.kernels import _build
    from repro_torch.optim.quant import k_major

    splits, _ = tvta._splits(m, n, k, _build.sm_count(cuda))
    assert splits > 1
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(rng.uniform(1e-6, 1e-4, n).astype(np.float32)).to(cuda)
    want = tvta.vta_gemm_ref(a, w, scale=scale, epilogue="dequant")
    for ww in (k_major(w), w):
        got = tvta.vta_gemm(a, ww, scale=scale, epilogue="dequant")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(tvta.vta_gemm(a, ww), tvta.vta_gemm_ref(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("hw,cin,cout,kk,stride", [(224, 3, 64, 7, 2), (56, 64, 64, 3, 1),
                                                   (14, 256, 512, 3, 2), (16, 8, 8, 3, 2)])
def test_vta_conv2d_on_card(cuda, hw, cin, cout, kk, stride):
    """ResNet-18-shaped convolutions through im2col and the kernel, bitwise
    against an f64 convolution with the reference's SAME padding, with the
    weight contiguous HWIO (N-contiguous GEMM path) and packed K-major."""
    rng = np.random.default_rng(hw + cin)
    x = torch.from_numpy(rng.integers(-128, 128, (1, hw, hw, cin)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (kk, kk, cin, cout)).astype(np.int8)).to(cuda)
    got = tops.vta_conv2d(x, w, stride=stride)
    ho = -(-hw // stride)
    pad = max((ho - 1) * stride + kk - hw, 0)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2).double(),
                                 (pad // 2, pad - pad // 2, pad // 2, pad - pad // 2))
    want = torch.nn.functional.conv2d(xp, w.permute(3, 2, 0, 1).double(), stride=stride)
    assert torch.equal(got, want.permute(0, 2, 3, 1).to(torch.int32))
    assert torch.equal(tops.vta_conv2d(x, tops.pack_conv_weight(w), stride=stride), got)


def _quantized_model(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params

    cfg = get_config("qwen3_0p6b").scaled_down()
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, quantize_params(tf.init(cfg, generator=gen, dtype=torch.float32, device=dev))


@pytest.mark.gpu
def test_quantized_generate_on_card_goes_through_kernels(cuda):
    """Reduced qwen3 on int8 weights: every projection of every forward
    call launches the dequant kernel, and the tokens equal a run whose
    GEMMs take the plain version (bitwise equal for act none)."""
    from repro_torch.models import layers
    from repro_torch.serve.step import generate

    cfg, params = _quantized_model(cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 600), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    n0 = tvta.vta_gemm.launches["dequant"]
    got = generate(params, cfg, prompt, 5, 1030, torch.float32, chunk=512)
    # two prefill chunks and four decode steps, 7 projections per layer
    assert tvta.vta_gemm.launches["dequant"] - n0 == 7 * cfg.num_layers * 6
    prev = layers.set_gemm_impl("ref")
    try:
        want = generate(params, cfg, prompt, 5, 1030, torch.float32, chunk=512)
    finally:
        layers.set_gemm_impl(prev)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
def test_quantized_model_k_major_weights_on_card(cuda):
    """``quantize_params`` on the card packs every projection K-major, and
    a projection launches the dequant kernel on that layout, bitwise equal
    to its plain version."""
    from repro_torch.models import layers

    cfg, params = _quantized_model(cuda)
    blk = params["blocks"][0]
    for mod, name in [("mixer", "wq"), ("mixer", "wo"), ("ffn", "w_gate"), ("ffn", "w_down")]:
        qw = blk[mod][name]["qw"]
        assert qw.is_cuda and qw.stride() == (1, qw.shape[0])
    x = torch.randn((2, 37, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    n0 = tvta.vta_gemm.launches["dequant"]
    got = layers.quant_dense_apply(blk["ffn"]["w_gate"], x, act="silu")
    torch.cuda.synchronize()
    assert tvta.vta_gemm.launches["dequant"] == n0 + 1
    prev = layers.set_gemm_impl("ref")
    try:
        want = layers.quant_dense_apply(blk["ffn"]["w_gate"], x, act="silu")
    finally:
        layers.set_gemm_impl(prev)
    err = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
    assert err <= 1e-5


@pytest.mark.gpu
def test_int8_engine_on_card_goes_through_kernels(cuda):
    """A reduced ServingEngine trace on int8 weights and int8 pools with
    the prefix cache: launches per step exact, prefix hits on whole pages,
    no page leaked, tokens equal to a run whose GEMMs take the plain
    version."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServingEngine

    cfg, params = _quantized_model(cuda)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 40)
    trace = []
    for n, m in [(40, 6), (70, 3), (25, 9), (90, 5)]:
        p = rng.integers(0, cfg.vocab, n).astype(np.int32)
        if n > 40:
            p[:40] = shared
        trace.append((p, m))

    def run():
        eng = ServingEngine(params, cfg, max_slots=2, max_len=128, page_size=16,
                            prefill_chunk=32, prefix_cache=True, kv_dtype="int8")
        for p, m in trace:
            eng.submit(p, m)
        for _ in range(200):
            if not eng.pending and eng.active == 0:
                break
            eng.step(debug_audit=True)
        done = eng.run()
        eng.audit()
        assert eng.allocator.num_free + len(eng.prefix.pages()) == eng.num_pages
        return {r.rid: r.tokens for r in done}, eng.stats()

    n0 = (tdec.paged_decode_attention.launches, tvta.vta_gemm.launches["dequant"])
    got, st = run()
    assert tdec.paged_decode_attention.launches - n0[0] == st["steps"] * cfg.num_layers
    assert (tvta.vta_gemm.launches["dequant"] - n0[1]
            == 7 * cfg.num_layers * (st["steps"] + st["prefill_chunk_calls"]))
    assert st["prefix_hits"] >= 1 and st["prefix_hit_tokens"] % 16 == 0
    prev = layers.set_gemm_impl("ref")
    try:
        want, _ = run()
    finally:
        layers.set_gemm_impl(prev)
    assert got == want


# ---------------------------------------------------------------------------
# the VTA ALU and ResNet-18
# ---------------------------------------------------------------------------

talu = importlib.import_module("repro_torch.kernels.vta_alu")
ALU_OPS = [("add", {}), ("max", {}), ("min", {}), ("add_imm", {"imm": -(2 ** 31)}),
           ("max_imm", {"imm": 11}), ("relu", {})]
ALU_OPS += [("shr", {"shift": s}) for s in (0, 7, 31, 40)]
# ResNet-18's stem accumulator, a ragged (100, 64), an odd flat length at a
# pointer 4 bytes off 16-byte alignment (the scalar path), an int8 x, an
# int8 x and y, an int8 x 1 byte off 4-byte alignment (its scalar path)
ALU_SHAPES = ["12544x64", "100x64", "misaligned", "int8", "int8xy", "int8misaligned"]
# flat lengths: one element, a tail alone, and 2^20 + 5 (many CTAs and a tail)
ALU_SHAPES += ["n1", "n3", "n1048581"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ALU_SHAPES)
@pytest.mark.parametrize("op,kw", ALU_OPS, ids=[o + "".join(f"_{v}" for v in k.values())
                                                for o, k in ALU_OPS])
def test_vta_alu_kernel_matches_plain_on_card(cuda, op, kw, shape):
    """Every op bitwise against the plain version, int32 wrap included (the
    operands span the whole int32 range), one launch counted per call."""
    rng = np.random.default_rng(len(op) + len(shape))

    def draw(n, dtype=np.int32):
        lo, hi = (-128, 127) if dtype == np.int8 else (-(2 ** 31), 2 ** 31 - 1)
        return torch.from_numpy(rng.integers(lo, hi, n, endpoint=True).astype(dtype)).to(cuda)

    if shape == "misaligned":
        x, y = draw(10001)[1:], draw(10001)[1:]
    elif shape == "int8":
        x, y = draw(100 * 64, np.int8).view(100, 64), draw(100 * 64).view(100, 64)
    elif shape == "int8xy":
        x, y = draw(12544 * 64, np.int8).view(12544, 64), draw(12544 * 64, np.int8).view(12544, 64)
    elif shape == "int8misaligned":
        x, y = draw(10001, np.int8)[1:], draw(10000)
    elif shape.startswith("n"):
        x, y = draw(int(shape[1:])), draw(int(shape[1:]))
    else:
        m, n = map(int, shape.split("x"))
        x, y = draw(m * n).view(m, n), draw(m * n).view(m, n)
    binary = op in talu._BINARY
    n0 = talu.vta_alu.launches[op]
    got = tops.alu(x, y if binary else None, op=op, **kw)
    torch.cuda.synchronize()
    assert talu.vta_alu.launches[op] == n0 + 1
    want = talu.vta_alu_ref(x, y if binary else None, op, **kw)
    assert got.dtype == torch.int32 and got.shape == x.shape
    assert torch.equal(got, want)


def _resnet_params(dev, dtype=torch.float32, num_classes=10):
    """Seeded ResNet-18 params with batch norms that are not the identity."""
    from repro_torch.models import resnet

    params = resnet.init(torch.Generator(device=dev).manual_seed(0), num_classes,
                         dtype=dtype, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for blk in [params["stem"]] + [b for stage in params["stages"] for b in stage]:
        for name, bn in blk.items():
            if name.endswith("bn") or name.startswith("bn"):
                c = bn["mean"].shape[0]
                u = torch.rand((4, c), generator=gen, device=dev)
                bn.update(scale=(0.5 + u[0]).to(dtype), bias=(0.2 * u[1] - 0.1).to(dtype),
                          mean=0.2 * u[2] - 0.1, var=0.5 + u[3])
    return params


def _to_f64(tree):
    if isinstance(tree, list):
        return [_to_f64(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _to_f64(v) for k, v in tree.items()}
    return tree.double()


@pytest.mark.gpu
def test_resnet18_f32_on_card_matches_f64(cuda):
    """The f32 forward (cuDNN's TF32 flag left at its default, on) within
    1e-4 x max|logit| of the same forward in f64: TF32 would miss it."""
    from repro_torch.models import resnet

    params = _resnet_params(cuda)
    img = torch.randn((2, 64, 64, 3), generator=torch.Generator(device=cuda).manual_seed(2),
                      device=cuda)
    got = resnet.forward(params, img)
    want = resnet.forward(_to_f64(params), img.double())
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.gpu
def test_resnet18_int8_head_on_card(cuda):
    """The int8 head: one dequant launch per forward, logits bitwise equal
    to the same run with the GEMM on its plain version."""
    from repro_torch.models import layers, resnet
    from repro_torch.optim.quant import quantize_params

    params = quantize_params(_resnet_params(cuda))
    img = torch.randn((3, 64, 64, 3), generator=torch.Generator(device=cuda).manual_seed(3),
                      device=cuda)
    n0 = tvta.vta_gemm.launches["dequant"]
    got = resnet.forward(params, img)
    torch.cuda.synchronize()
    assert tvta.vta_gemm.launches["dequant"] == n0 + 1
    prev = layers.set_gemm_impl("ref")
    try:
        want = resnet.forward(params, img)
    finally:
        layers.set_gemm_impl(prev)
    assert tvta.vta_gemm.launches["dequant"] == n0 + 1
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the MoE family and the rest of the dense family (slice 8)
# ---------------------------------------------------------------------------

# one full-width layer's flash call: the dense family's G 7 / 8 / 12 (a
# 512-row chunk at q_offset 512), mixtral's G 6 with its window biting,
# MLA's prefill (G 1, D = dn + dr = 192, Dv 128, scale 192^-0.5)
GPU_FLASH_FAMILY = [
    ("yi_34b_g7", dict(b=1, s=512, t=1024, h=56, hkv=8, d=128, dv=128),
     dict(q_offset=512, kv_len=1024)),
    ("qwen2_72b_g8", dict(b=1, s=512, t=1024, h=64, hkv=8, d=128, dv=128),
     dict(q_offset=512, kv_len=1024)),
    ("starcoder2_15b_g12", dict(b=1, s=512, t=1024, h=48, hkv=4, d=128, dv=128),
     dict(q_offset=512, kv_len=1024)),
    ("mixtral_g6_window", dict(b=1, s=512, t=4608, h=48, hkv=8, d=128, dv=128),
     dict(q_offset=4096, kv_len=4608, window=4096)),
    ("mla_g1_d192_dv128", dict(b=2, s=512, t=1040, h=128, hkv=128, d=192, dv=128),
     dict(q_offset=512, kv_len=1024, scale=192 ** -0.5)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,opts", GPU_FLASH_FAMILY, ids=[c[0] for c in GPU_FLASH_FAMILY])
def test_flash_kernel_at_family_shapes_on_card(cuda, name, shape, opts, dtype):
    q, k, v = _qkv(cuda, getattr(torch, dtype), **shape, seed=len(name))
    n0 = tfl.flash_attention.launches
    got = tfl.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == n0 + 1
    want = tfl.flash_attention_ref(q, k, v, **opts)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])


def _moe_model(dev, arch, **kw):
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf

    cfg = get_config(arch).scaled_down(**kw)
    gen = torch.Generator(device=dev).manual_seed(0)
    return cfg, tf.init(cfg, generator=gen, dtype=torch.float32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek_v2_236b", "mixtral_8x22b"])
def test_moe_generate_on_card_goes_through_kernels(cuda, arch):
    """Reduced MoE generate on the card (prompt 600 at chunk 512): deepseek
    launches flash per prefill chunk and the dense decode kernel per step;
    mixtral's 128-token window makes its cache a rolling buffer, whose
    branch launches neither.  Tokens equal a run on the plain versions."""
    from repro_torch.models import layers
    from repro_torch.serve.step import generate

    cfg, params = _moe_model(cuda, arch)
    prompt = torch.randint(0, cfg.vocab, (2, 600), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    n0 = (tfl.flash_attention.launches, tdec.decode_attention.launches)
    got = generate(params, cfg, prompt, 5, 1030, torch.float32, chunk=512)
    n1 = (tfl.flash_attention.launches, tdec.decode_attention.launches)
    want_n = (0, 0) if cfg.sliding_window else (2 * cfg.num_layers, 4 * cfg.num_layers)
    assert (n1[0] - n0[0], n1[1] - n0[1]) == want_n
    prev = layers.set_attention_impl("ref")
    try:
        want = generate(params, cfg, prompt, 5, 1030, torch.float32, chunk=512)
    finally:
        layers.set_attention_impl(prev)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.gpu
def test_moe_int8_experts_on_card_go_through_the_gemm(cuda):
    """deepseek reduced on int8 weights: every routed and shared expert's
    three projections are one VTA GEMM launch each per forward call, and
    the logits equal a run with the GEMMs on their plain version bitwise;
    two runs on the card are bitwise equal (the fixed-order combine)."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params

    cfg, params = _moe_model(cuda, "deepseek_v2_236b")
    qp = quantize_params(params)
    ex = qp["blocks"][0]["ffn"]["experts"]["w_gate"]["qw"]
    assert ex.shape == (cfg.moe_experts, cfg.d_model, cfg.d_ff)
    assert ex.stride()[1:] == (1, cfg.d_model), "K-major per expert"
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(3))
    n0 = tvta.vta_gemm.launches["none"]
    got, aux = tf.forward(qp, cfg, toks)
    torch.cuda.synchronize()
    per_call = 3 * (cfg.moe_experts + cfg.moe_shared_experts) * cfg.num_layers
    assert tvta.vta_gemm.launches["none"] - n0 == per_call
    again, _ = tf.forward(qp, cfg, toks)
    assert torch.equal(got, again)
    prev = layers.set_gemm_impl("ref")
    try:
        want, want_aux = tf.forward(qp, cfg, toks)
    finally:
        layers.set_gemm_impl(prev)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_mla_engine_on_card_goes_through_kernels(cuda, kv_dtype):
    """A reduced deepseek ServingEngine trace on MLA's one-pool pages with
    the prefix cache: the paged kernel per layer and decode step, flash per
    layer and 512-token prefill chunk, the audit green, and tokens equal to
    a run on the plain versions."""
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServingEngine

    cfg, params = _moe_model(cuda, "deepseek_v2_236b")
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 512)
    trace = []
    for n, m in [(530, 6), (700, 3), (520, 9), (600, 5)]:
        p = rng.integers(0, cfg.vocab, n).astype(np.int32)
        if n >= 600:
            p[:512] = shared
        trace.append((p, m))

    def run():
        eng = ServingEngine(params, cfg, max_slots=2, max_len=1024, page_size=16,
                            prefill_chunk=512, prefix_cache=True, kv_dtype=kv_dtype)
        for p, m in trace:
            eng.submit(p, m)
        for _ in range(200):
            if not eng.pending and eng.active == 0:
                break
            eng.step(debug_audit=True)
        done = eng.run()
        eng.audit()
        assert eng.allocator.num_free + len(eng.prefix.pages()) == eng.num_pages
        return {r.rid: r.tokens for r in done}, eng.stats(), set(eng.blocks[0])

    n0 = (tdec.paged_decode_attention.launches, tfl.flash_attention.launches)
    got, st, pools = run()
    assert pools == ({"kv_pages", "kv_scales"} if kv_dtype == "int8" else {"kv_pages"})
    assert tdec.paged_decode_attention.launches - n0[0] == st["steps"] * cfg.num_layers
    assert tfl.flash_attention.launches - n0[1] == st["prefill_chunk_calls"] * cfg.num_layers
    prev = layers.set_attention_impl("ref")
    try:
        want, want_st, _ = run()
    finally:
        layers.set_attention_impl(prev)
    assert got == want and st["prefill_chunk_calls"] == want_st["prefill_chunk_calls"]


# ---------------------------------------------------------------------------
# the remaining families: mamba2, zamba2, seamless, internvl2
# ---------------------------------------------------------------------------

# flash at the slice's shapes (one full-width layer, batch 2): zamba2's
# shared block (G 1, D 80) at its last prompt chunk; seamless's encoder
# (bidirectional S = T = 1024), its cross-attention at prefill (S 512) and
# at a decode step (S 1) against 1024 frames; internvl2's first chunk (256
# patch embeddings + 512 tokens: 768 rows, G 8)
GPU_FLASH_SLICE9 = [
    ("zamba2_g1_d80", dict(b=2, s=512, t=2064, h=32, hkv=32, d=80, dv=80),
     dict(q_offset=1536, kv_len=2048)),
    ("seamless_encoder_bidir", dict(b=2, s=1024, t=1024, h=16, hkv=16, d=64, dv=64),
     dict(bidirectional=True)),
    ("seamless_cross_s512", dict(b=2, s=512, t=1024, h=16, hkv=16, d=64, dv=64),
     dict(bidirectional=True)),
    ("seamless_cross_s1", dict(b=2, s=1, t=1024, h=16, hkv=16, d=64, dv=64),
     dict(bidirectional=True)),
    ("internvl2_g8_s768", dict(b=2, s=768, t=1808, h=64, hkv=8, d=128, dv=128),
     dict(q_offset=0, kv_len=768)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,opts", GPU_FLASH_SLICE9, ids=[c[0] for c in GPU_FLASH_SLICE9])
def test_flash_kernel_at_slice9_shapes_on_card(cuda, name, shape, opts, dtype):
    q, k, v = _qkv(cuda, getattr(torch, dtype), **shape, seed=len(name))
    n0 = tfl.flash_attention.launches
    got, counts = tfl.flash_attention(q, k, v, return_counts=True, **opts)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == n0 + 1
    want = tfl.flash_attention_ref(q, k, v, **opts)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    tile_map = tfl.flash_tile_map(shape["s"], shape["t"], **opts)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  tile_map.expand_as(counts.cpu()).numpy())


# dense decode at the slice's shapes: zamba2 (G 1, D 80), seamless (G 1,
# D 64), internvl2 (G 8, D 128), each at its static path's last step
GPU_DECODE_SLICE9 = [
    ("zamba2_g1_d80", dict(h=32, hkv=32, d=80, t=2064), 2063),
    ("seamless_g1_d64", dict(h=16, hkv=16, d=64, t=1040), 1039),
    ("internvl2_g8_d128", dict(h=64, hkv=8, d=128, t=1808), 1807),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,kv_len", GPU_DECODE_SLICE9,
                         ids=[c[0] for c in GPU_DECODE_SLICE9])
def test_decode_kernel_at_slice9_shapes_on_card(cuda, name, shape, kv_len, dtype):
    h, hkv, d, t = shape["h"], shape["hkv"], shape["d"], shape["t"]
    q, k, v = _qkv(cuda, getattr(torch, dtype), 2, 1, t, h, hkv, d, d, seed=len(name))
    n0 = tdec.decode_attention.launches
    got, counts = tdec.decode_attention(q, k, v, kv_len=kv_len, return_counts=True)
    torch.cuda.synchronize()
    assert tdec.decode_attention.launches == n0 + 1
    want = tdec.decode_attention_ref(q, k, v, kv_len=kv_len)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])
    want_map = tdec.decode_partition_map(t, kv_len)
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  want_map.expand_as(counts.cpu()).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("L,chunk", [(512, 128), (37, 1)], ids=["chunk128", "ragged_chunk1"])
def test_ssd_chunked_f32_matches_f64_recurrence_on_card(cuda, L, chunk):
    """mamba2's full-width head layout (H 80, P 64, N 128) from a drawn
    state: the f32 chunked form within 1e-4 of max|y| of the per-token
    recurrence in f64, with TF32 off."""
    from repro_torch.models import ssm

    gen = torch.Generator(device=cuda).manual_seed(3)
    b, h, p, n = 2, 80, 64, 128
    x = torch.randn((b, L, h, p), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(torch.randn((b, L, h), generator=gen, device=cuda))
    a_log = torch.randn((h,), generator=gen, device=cuda) * 0.5
    bm = torch.randn((b, L, n), generator=gen, device=cuda)
    cm = torch.randn((b, L, n), generator=gen, device=cuda)
    s0 = torch.randn((b, h, n, p), generator=gen, device=cuda) * 0.1
    y, st = ssm.ssd_chunked(x, dt, a_log, bm, cm, chunk=chunk, initial_state=s0)
    y64, st64 = ssm.ssd_reference(x.double(), dt.double(), a_log.double(), bm.double(),
                                  cm.double(), initial_state=s0.double())
    assert y.dtype == torch.float32 and y64.dtype == torch.float64
    assert (y.double() - y64).abs().max().item() <= 1e-4 * y64.abs().max().item()
    assert (st.double() - st64).abs().max().item() <= 1e-4 * st64.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2_2p7b", "zamba2_2p7b"])
def test_ssm_families_int8_logits_bitwise_against_plain_gemm_on_card(cuda, arch):
    """Reduced mamba2 / zamba2 (2 groups) on int8 weights: prefill (an
    exact-size remainder) and decode logits with every projection on the
    dequant GEMM kernel equal the run on its plain version, bitwise; zamba2's
    shared block runs flash and dense decode on the card."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.vta_gemm import vta_gemm
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    cfg = get_config(arch).scaled_down()
    gen = torch.Generator(device=cuda).manual_seed(0)
    qparams = quantize_params(tf.init(cfg, generator=gen, dtype=torch.float32, device=cuda))
    prompt = torch.randint(0, cfg.vocab, (2, 600), generator=gen, device=cuda)

    def run():
        caches = tf.init_caches(cfg, 2, 610, torch.float32, cuda)
        tok, lg, caches = make_prefill_step(cfg, 512, return_logits=True)(qparams, prompt, caches)
        out, step = [lg], make_serve_step(cfg, return_logits=True)
        tok = tok[:, None]
        for _ in range(3):
            tok, lg, caches = step(qparams, tok, caches)
            out.append(lg)
        return torch.cat(out, dim=1)

    n0 = (vta_gemm.launches["dequant"], tfl.flash_attention.launches,
          tdec.decode_attention.launches)
    got = run()
    n1 = (vta_gemm.launches["dequant"], tfl.flash_attention.launches,
          tdec.decode_attention.launches)
    groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    per_call = 2 * cfg.num_layers + 7 * groups + 1
    # 600 = one 512 chunk + an exact-size 88-token pass, then 3 decode steps
    assert n1[0] - n0[0] == per_call * 5
    assert (n1[1] - n0[1], n1[2] - n0[2]) == (groups, 3 * groups)
    prev = layers.set_gemm_impl("ref")
    try:
        want = run()
    finally:
        layers.set_gemm_impl(prev)
    assert vta_gemm.launches["dequant"] == n1[0]
    assert bool(torch.isfinite(got).all()) and torch.equal(got, want)


@pytest.mark.gpu
def test_encdec_and_vlm_generate_on_card_go_through_kernels(cuda):
    """Reduced seamless (1024 frames: the encoder and every cross-attention
    on flash, decode steps' S 1 included) and internvl2 (a first chunk of
    256 embeddings + 512 tokens) through ``generate`` on the card: tokens
    equal to the runs on the plain versions."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import encdec
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import generate

    for arch in ("seamless_m4t_large_v2", "internvl2_76b"):
        cfg = get_config(arch).scaled_down()
        gen = torch.Generator(device=cuda).manual_seed(0)
        mod = encdec if cfg.is_enc_dec else tf
        params = mod.init(cfg, generator=gen, dtype=torch.float32, device=cuda)
        prompt = torch.randint(0, cfg.vocab, (2, 1024), generator=gen, device=cuda)
        side = torch.randn((2, 1024 if cfg.is_enc_dec else 256, cfg.d_model), generator=gen,
                           device=cuda)
        kw = dict(frames=side) if cfg.is_enc_dec else dict(embeds=side)
        max_len = 1024 + 5 + (0 if cfg.is_enc_dec else 256)
        n0 = (tfl.flash_attention.launches, tdec.decode_attention.launches)
        got = generate(params, cfg, prompt, 5, max_len, torch.float32, chunk=512, **kw)
        n1 = (tfl.flash_attention.launches, tdec.decode_attention.launches)
        nl = cfg.num_layers
        if cfg.is_enc_dec:
            want_flash = cfg.encoder_layers + 2 * nl + 2 * nl + 4 * nl
        else:
            want_flash = 2 * nl
        assert (n1[0] - n0[0], n1[1] - n0[1]) == (want_flash, 4 * nl)
        prev = layers.set_attention_impl("ref")
        try:
            want = generate(params, cfg, prompt, 5, max_len, torch.float32, chunk=512, **kw)
        finally:
            layers.set_attention_impl(prev)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


# ---------------------------------------------------------------------------
# training: flash through autograd; the other wrappers refuse grad
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,opts", GPU_FLASH[:4], ids=[c[0] for c in GPU_FLASH[:4]])
def test_flash_function_grads_on_card_match_plain_route(cuda, name, shape, opts):
    """``layers.flash_attend`` with grad on the card: one kernel launch
    forward, none backward, the output within the kernel's tolerance of the
    plain route's and dq / dk / dv equal to the plain route's (both
    backwards differentiate the plain version on the same inputs)."""
    from repro_torch.models import layers

    q, k, v = _qkv(cuda, torch.float32, **shape, seed=len(name))
    w = torch.randn(q.shape[:3] + (shape["dv"],), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    grads = {}
    for impl in ("auto", "ref"):
        prev = layers.set_attention_impl(impl)
        try:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            n0 = tfl.flash_attention.launches
            out = layers.flash_attend(*leaves, **opts)
            n1 = tfl.flash_attention.launches
            (out * w).sum().backward()
            torch.cuda.synchronize()
            assert tfl.flash_attention.launches == n1
            assert n1 - n0 == (1 if impl == "auto" else 0)
            grads[impl] = (out.detach(), [x.grad for x in leaves],
                           type(out.grad_fn).__name__)
        finally:
            layers.set_attention_impl(prev)
    (got, g_k, fn_k), (want, g_r, fn_r) = grads["auto"], grads["ref"]
    assert fn_k == "FlashAttentionFunctionBackward" != fn_r
    assert float((got - want).abs().max()) <= TOL["float32"]
    for a, b in zip(g_k, g_r):
        assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.gpu
def test_kernel_wrappers_refuse_inputs_that_require_grad(cuda):
    """A kernel writing through a raw pointer leaves autograd no path back:
    every wrapper but flash's Function refuses, so no gradient is silently
    zero.  Under ``torch.no_grad`` the same call launches."""
    from repro_torch.kernels.vta_alu import vta_alu
    from repro_torch.kernels.vta_gemm import vta_gemm

    q, k, v = _qkv(cuda, torch.float32, 1, 64, 64, 4, 2, 32, 32)
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        tfl.flash_attention(qg, k, v)
    with pytest.raises(ValueError, match="no backward"):
        tdec.decode_attention(qg[:, :1], k, v, kv_len=64)
    args, _ = _paged(cuda, torch.float32, 2, 1, 4, 2, 32, 32, 16, [5, 40])
    with pytest.raises(ValueError, match="no backward"):
        tdec.paged_decode_attention(args[0].requires_grad_(), *args[1:])
    a = torch.randint(-127, 128, (8, 32), device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (32, 16), device=cuda, dtype=torch.int8)
    scale = torch.rand(16, device=cuda).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        vta_gemm(a, wq, scale=scale, epilogue="dequant")
    # the ALU takes integer tensors only, and those cannot require grad
    with pytest.raises(TypeError, match="int8 or int32"):
        vta_alu(torch.ones(4, device=cuda, requires_grad=True))
    with torch.no_grad():
        tfl.flash_attention(qg, k, v)
        tdec.decode_attention(qg[:, :1], k, v, kv_len=64)
        vta_gemm(a, wq, scale=scale, epilogue="dequant")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_supervised_decode_nan_on_card(cuda):
    """``ServeSupervisor`` over the engine on the card: a decode_nan is
    found by the probe and quarantined in place, the slots it never
    touched decode exactly as in a clean run, the victim finishes, and the
    drained pool is leak-free."""
    from repro_torch.configs.base import get_config
    from repro_torch.ft.faults import FaultPlan
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.supervisor import ServeSupervisor

    cfg = get_config("qwen3_0p6b").scaled_down()
    params = tf.init(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                     dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, cfg.vocab, (n,)).astype(np.int32), m)
            for n, m in [(9, 12), (13, 10), (8, 8)]]
    kw = dict(max_slots=2, max_len=128, page_size=8, prefill_chunk=8, prefix_cache=True)
    eng = ServingEngine(params, cfg, **kw)
    for p, m in reqs:
        eng.submit(p, m)
    clean = {r.rid: list(r.tokens) for r in eng.run()}
    sup = ServeSupervisor(params, cfg, engine_kw=kw, devices=[0, 1, 2, 3],
                          fault_plan=FaultPlan.parse("decode_nan:step=3"))
    for p, m in reqs:
        sup.submit(p, m)
    done = {r.rid: r for r in sup.run()}
    assert sup.stats()["events"] == {"quarantine": 1} and not sup.degraded
    victims = set(sup.events[0].detail["rids"])
    assert victims and all(len(done[rid].tokens) == m for rid, (_, m) in enumerate(reqs))
    for rid in clean:
        if rid not in victims:
            assert list(done[rid].tokens) == clean[rid], rid
    eng = sup.engine
    eng.audit()
    eng.prefix.clear()
    assert eng.allocator.num_free == eng.num_pages - eng.allocator.num_quarantined


# ---------------------------------------------------------------------------
# the distributed runtime: the pipeline on one card, the launchers' flags
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_pipeline_on_card_schedules_bitwise_through_flash(cuda):
    """Four stages on the one card at seq 512 (attention on flash): GPipe
    and 1F1B bitwise equal, flash launched 3 x layers x m times per
    ``loss_and_grad`` (forward unit, the backward unit's re-run, its remat
    recompute), loss and grads within tolerance of the single-device
    ``value_and_grad``."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist import pipeline as pl
    from repro_torch.ft.elastic import make_mesh_for
    from repro_torch.models import transformer as tf
    from repro_torch.train import step as st
    from repro_torch.tree import flatten_with_path, leaves

    cfg = get_config("qwen3_0p6b").scaled_down(num_layers=6, vocab=512)
    params = tf.init(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                     dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (4, 513))).to(cuda)}
    mesh = make_mesh_for([cuda] * 4, model_axis=4)
    bounds = (0, 1, 3, 5, 6)
    padded = pl.pad_pipeline_params(params, cfg, bounds)
    outs = {}
    for sched in ("gpipe", "1f1b"):
        lg = pl.make_pipeline_loss_and_grad(cfg, mesh, 4, bounds, sched)
        n0 = tfl.flash_attention.launches
        outs[sched] = lg(padded, batch)
        torch.cuda.synchronize()
        assert tfl.flash_attention.launches - n0 == 3 * cfg.num_layers * 4
        assert lg.counts == pl.pipeline_bubble_counts(4, 4, sched)
    (l1, _), g1 = outs["gpipe"]
    (l2, _), g2 = outs["1f1b"]
    assert torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
    (rl, _), rg = st.value_and_grad(st.make_loss_fn(cfg, remat=True), params, batch)
    assert abs(float(l2) - float(rl)) <= 1e-5 * abs(float(rl))
    for (path, a), (_, w) in zip(flatten_with_path(pl.unpad_pipeline_params(g2, cfg, bounds)),
                                 flatten_with_path(rg)):
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max()), path


@pytest.mark.gpu
def test_pipeline_stages_on_distinct_cards(cuda):
    """With two or more cards, stage k on card k: the forward and the
    train pipe equal the same pipe with every stage on card 0."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.configs.base import get_config
    from repro_torch.dist import pipeline as pl
    from repro_torch.dist.sharding import param_specs, place
    from repro_torch.ft.elastic import make_mesh_for
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves

    stages = min(n, 4)
    cfg = get_config("qwen3_0p6b").scaled_down(num_layers=2 * stages, vocab=512)
    params = tf.init(cfg, generator=torch.Generator(device=cuda).manual_seed(0),
                     dtype=torch.float32, device=torch.device("cuda", 0))
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 513))).to("cuda:0")
    one = make_mesh_for([torch.device("cuda", 0)] * stages, model_axis=stages)
    many = make_mesh_for([torch.device("cuda", i) for i in range(stages)], model_axis=stages)
    spread = place(params, param_specs(params, many, "pipeline"), many)
    devs = [{x.device.index for x in leaves(layer)} for layer in spread["blocks"]]
    assert devs == [{k} for k in range(stages) for _ in range(2)]
    want = pl.make_pipeline_forward(cfg, one, 2)(params, tokens[:, :-1])
    got = pl.make_pipeline_forward(cfg, many, 2)(spread, tokens[:, :-1])
    assert float((got.to(want.device) - want).abs().max()) <= 1e-5 * float(want.abs().max())
    (wl, _), wg = pl.make_pipeline_loss_and_grad(cfg, one, 2)(params, {"tokens": tokens})
    (gl, _), gg = pl.make_pipeline_loss_and_grad(cfg, many, 2)(spread, {"tokens": tokens})
    assert abs(float(gl) - float(wl)) <= 1e-6 * abs(float(wl))
    for a, b in zip(leaves(gg), leaves(wg)):
        assert float((a.to(b.device) - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
def test_train_launcher_pipeline_on_card(cuda, capsys):
    """``launch.train --strategy pipeline --steps 2 --seq 512 --batch 4``
    on the card: a one-stage pipe over the card's (1, 1) mesh, flash in
    every unit."""
    from repro_torch.launch import train as ttrain

    argv = ["--strategy", "pipeline", "--steps", "2", "--seq", "512", "--batch", "4"]
    if torch.cuda.device_count() > 1:
        # the cards' (data, model) mesh puts a data axis over distinct cards
        with pytest.raises(NotImplementedError, match="item 16"):
            ttrain.main(argv)
        return
    n0 = tfl.flash_attention.launches
    state = ttrain.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("strategy pipeline  mesh {'data': 1, 'model': 1}")
    assert out[1] == "pipeline stages 1  boundaries (0, 28)  microbatches 1  schedule 1f1b"
    assert tfl.flash_attention.launches - n0 == 2 * 3 * 28
    assert out[-1] == "done" and int(state["step"]) == 2
    assert all(bool(torch.isfinite(x).all()) for x in state["params"]["blocks"][0]["mixer"]
               ["wq"].values())


@pytest.mark.gpu
def test_serve_launcher_strategy_on_card(cuda, capsys):
    """``launch.serve --strategy ai_core_assignment`` on the card: params
    placed on the card's mesh, the static path through the decode kernel."""
    from repro_torch.launch import serve as tserve

    argv = ["--strategy", "ai_core_assignment", "--new-tokens", "8"]
    if torch.cuda.device_count() > 1:
        # TP shards over distinct cards are multi-card execution
        with pytest.raises(NotImplementedError, match="item 16"):
            tserve.main(argv)
        return
    n0 = tdec.decode_attention.launches
    res = tserve.main(argv)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh {'data': 1, 'model': 1}  arch qwen3_0p6b  strategy ai_core_assignment"
    assert tdec.decode_attention.launches - n0 == 28 * 7
    assert res["tokens"].shape == (4, 8)


@pytest.mark.gpu
def test_flash_smem_formula_equals_the_kernels_export(cuda):
    """``flash_smem_bytes`` (the wrapper's and the tuner's check) equals
    the kernel's own ``flash_attention_smem_bytes`` over dtypes, group
    sizes, blocks and head dims."""
    lib = tfl._lib()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for g in (1, 2, 7, 16):
            for qc in (1, 16, 32, 64, 100, 128, 256):
                for kc in (8, 32, 48, 64, 128, 256):
                    for d, dv in ((24, 8), (64, 64), (128, 128), (192, 128)):
                        want = lib.flash_attention_smem_bytes(code, g, qc, kc, d, dv)
                        assert tfl.flash_smem_bytes(dtype, g, qc, kc, d) == want


@pytest.mark.gpu
def test_tuned_flash_blocks_reach_the_kernel_on_card(cuda):
    """A tuning table's flash blocks reach the kernel's grid: the output
    and execution map equal an explicit call at those blocks, bitwise; a
    block the kernel would refuse for shared memory raises."""
    from repro_torch.core.autotune import TuningTable
    from repro_torch.models import layers

    q, k, v = _qkv(cuda, torch.float32, 2, 512, 512, 16, 8, 128, 128, seed=3)
    want, wmap = tfl.flash_attention(q, k, v, block_q=128, block_k=32, return_counts=True)
    t = TuningTable()
    t.put("flash_prefill", block_q=128, block_k=32)
    prev = layers.set_tuning(t)
    try:
        n0 = tfl.flash_attention.launches
        got = layers.flash_attend(q, k, v)
        assert tfl.flash_attention.launches == n0 + 1
        assert torch.equal(got, want)
        np.testing.assert_array_equal(wmap[0, 0].cpu().numpy(),
                                      tfl.flash_tile_map(512, 512, block_q=128, block_k=32).numpy())
        base = tfl.flash_attention(q, k, v)
        assert float((got - base).abs().max()) <= TOL["float32"]
        t.put("flash_prefill", block_k=128)  # 128-key f32 stages at D 128 do not fit
        with pytest.raises(ValueError, match="shared memory"):
            layers.flash_attend(q, k, v)
    finally:
        layers.set_tuning(prev)


@pytest.mark.gpu
def test_fused_supervisor_on_card(cuda, tmp_path):
    """``TrainSupervisor`` on the card at seq 512 (flash in every layer):
    a NaN rollback and a checkpoint-crash retry, finite losses, a latest
    checkpoint at the last step, and flash launched 2 x layers for every
    step the run executed (the warm step, the poisoned one and the
    replayed ones included)."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.ft.faults import CheckpointWriteCrash, FaultPlan
    from repro_torch.ft.supervisor import TrainSupervisor

    cfg = get_config("qwen3_0p6b").scaled_down(num_layers=2, d_model=128, vocab=512)
    n0 = tfl.flash_attention.launches
    sup = TrainSupervisor(cfg, steps=8, seq=512, batch=2, strategy="fused",
                          fault_plan=FaultPlan.parse("nan:step=3;ckpt_crash:step=4"),
                          ckpt_dir=str(tmp_path / "ck"), ckpt_every=2)
    assert sup.devices == [torch.device("cuda", 0)] and sup.device.type == "cuda"
    res = sup.run()
    rb, = res.events_of("rollback")
    retry, = res.events_of("ckpt_retry")
    assert rb.detail == {"skipped_data_index": 3, "restored_step": 2} and rb.steps_lost == 1
    assert retry.detail["error"].startswith(CheckpointWriteCrash.__name__)
    assert all(math.isfinite(x) for x in res.losses) and len(res.losses) == 8
    assert ckpt.sweep_tmp(str(tmp_path / "ck")) == [] and ckpt.latest_step(str(tmp_path / "ck")) == 8
    executed = 8 + rb.steps_lost + 1 + 1  # + the poisoned step + the warm step
    assert tfl.flash_attention.launches - n0 == 2 * cfg.num_layers * executed
    assert all(x.device.type == "cuda" for x in sup.state["params"]["blocks"][0]["mixer"]["wq"].values())
