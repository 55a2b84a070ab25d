"""The port's attention kernels vs the JAX reference.

On the CPU the wrappers run their plain versions; those are held to the
Pallas kernels (interpret mode) and to ``flash_attend_ref`` /
``softmax_attend`` at 1e-5 in f32 over the sweep of
``tests/test_attn_kernels.py``, and the port's execution-map oracles to
the reference's.  ``tests/test_torch_gpu.py`` holds each CUDA kernel to
its plain version on the card.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models.layers import flash_attend_ref, softmax_attend  # noqa: E402

# the kernels packages re-export the wrapper functions under the modules'
# own names, so the modules are fetched by path
jdec = importlib.import_module("repro.kernels.decode_attention")
jfl = importlib.import_module("repro.kernels.flash_attention")
tdec = importlib.import_module("repro_torch.kernels.decode_attention")
tfl = importlib.import_module("repro_torch.kernels.flash_attention")

ATOL = 1e-5

FLASH_CASES = [
    ("gqa", dict(b=2, s=256, t=256, h=8, hkv=4, d=16, dv=16)),
    ("mha", dict(b=1, s=128, t=128, h=4, hkv=4, d=16, dv=16)),
    ("swa", dict(b=1, s=256, t=256, h=4, hkv=2, d=16, dv=16, window=96)),
    ("bidir", dict(b=1, s=128, t=192, h=4, hkv=2, d=16, dv=16, bidirectional=True)),
    ("mla", dict(b=1, s=128, t=128, h=4, hkv=4, d=24, dv=16)),
    ("ragged", dict(b=1, s=64, t=256, h=4, hkv=4, d=16, dv=16, q_offset=100, kv_len=170)),
    ("nonmult", dict(b=1, s=100, t=130, h=4, hkv=2, d=16, dv=8)),
]


def _qkv(b, s, t, h, hkv, d, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, dv)).astype(np.float32))


def _split(kw):
    kw = dict(kw)
    opts = {k: kw.pop(k) for k in ("window", "bidirectional", "q_offset", "kv_len")
            if k in kw}
    return kw, opts


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("name,kw", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_pallas_and_jnp_ref(name, kw):
    shape, opts = _split(kw)
    q, k, v = _qkv(**shape, seed=len(name))
    want_pallas = jfl.flash_attention(*_j(q, k, v), block_q=32, block_k=32,
                                      interpret=True, **opts)
    want_ref = flash_attend_ref(*_j(q, k, v), q_chunk=64, kv_chunk=64, **opts)
    got = tfl.flash_attention(*_t(q, k, v), **opts)   # CPU tensor -> plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), atol=ATOL)
    chunked = tfl.flash_attention_ref(*_t(q, k, v), q_chunk=32, kv_chunk=48, **opts)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want_ref), atol=ATOL)


@pytest.mark.parametrize("name,kw", [c for c in FLASH_CASES if "bidirectional" not in c[1]],
                         ids=[c[0] for c in FLASH_CASES if "bidirectional" not in c[1]])
def test_attention_f64_matches_jnp_ref(name, kw):
    """The exact f64 yardstick of the card's accuracy gate agrees with the
    reference's f32 attention."""
    shape, opts = _split(kw)
    q, k, v = _qkv(**shape, seed=len(name))
    want = flash_attend_ref(*_j(q, k, v), q_chunk=64, kv_chunk=64, **opts)
    got = tfl.attention_f64(*_t(q, k, v), **opts)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), atol=ATOL)


def test_flash_plain_bf16_matches_pallas():
    q, k, v = _qkv(1, 256, 256, 4, 2, 16, 16, seed=3)
    qj, kj, vj = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jfl.flash_attention(qj, kj, vj, block_q=64, block_k=64, interpret=True)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tfl.flash_attention(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    # one bf16 output rounding apart (values |x| < 4: ulp <= 2**-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2)


def test_flash_chunked_resume_matches_one_shot():
    b, s, h, hkv, d, chunk = 1, 128, 4, 2, 16, 64
    q, k, v = _qkv(b, s, s, h, hkv, d, d, seed=7)
    want = tfl.flash_attention(*_t(q, k, v))
    kbuf, vbuf = torch.zeros(b, s, hkv, d), torch.zeros(b, s, hkv, d)
    outs = []
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        kbuf[:, sl] = torch.from_numpy(k[:, sl])
        vbuf[:, sl] = torch.from_numpy(v[:, sl])
        outs.append(tfl.flash_attention(torch.from_numpy(q[:, sl]), kbuf, vbuf,
                                        q_offset=i * chunk, kv_len=(i + 1) * chunk))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(), atol=ATOL)


TILE_CASES = [
    dict(s=256, t=256),
    dict(s=512, t=2080, q_offset=1536, kv_len=2048),
    dict(s=512, t=2080, q_offset=0, kv_len=512),
    dict(s=256, t=256, window=96),
    dict(s=256, t=256, kv_len=128),
    dict(s=128, t=192, bidirectional=True),
    dict(s=100, t=130, q_offset=7, kv_len=101, window=40),
    dict(s=3, t=5),
]


@pytest.mark.parametrize("case", TILE_CASES)
@pytest.mark.parametrize("blocks", [(32, 32), (64, 32), (128, 128)])
def test_flash_tile_counts_match_reference_oracle(case, blocks):
    bq, bk = blocks
    want = jfl.flash_tile_counts(block_q=bq, block_k=bk, **case)
    got = tfl.flash_tile_counts(block_q=bq, block_k=bk, **case)
    assert got == tuple(int(x) for x in want)


@pytest.mark.parametrize("case", TILE_CASES)
def test_flash_tile_counts_at_default_blocks_match_reference_oracle(case):
    """The kernel's default tiles (64-row q-tiles, 64-key K/V tiles): the
    port's map and counts, called without blocks, equal the reference's
    oracle at the same blocks."""
    assert (tfl.DEFAULT_BLOCK_Q, tfl.DEFAULT_BLOCK_K) == (64, 64)
    want = jfl.flash_tile_counts(block_q=tfl.DEFAULT_BLOCK_Q,
                                 block_k=tfl.DEFAULT_BLOCK_K, **case)
    assert tfl.flash_tile_counts(**case) == tuple(int(x) for x in want)
    tile_map = tfl.flash_tile_map(**case)
    assert (int(tile_map.sum()), tile_map.numel()) == tuple(int(x) for x in want)


@pytest.mark.parametrize("opts", [dict(), dict(window=96), dict(kv_len=128),
                                  dict(q_offset=100, kv_len=170)])
def test_flash_map_matches_pallas_map(opts):
    q, k, v = _qkv(1, 64 if "q_offset" in opts else 256, 256, 4, 2, 16, 16, seed=1)
    _, want = jfl.flash_attention(*_j(q, k, v), block_q=32, block_k=32,
                                  return_counts=True, interpret=True, **opts)
    _, got = tfl.flash_attention(*_t(q, k, v), block_q=32, block_k=32,
                                 return_counts=True, **opts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_len", [1, 7, 250, 511, 512])
def test_decode_plain_matches_pallas_across_fill(kv_len):
    b, t, h, hkv, d = 2, 512, 8, 4, 16
    q, k, v = _qkv(b, 1, t, h, hkv, d, d, seed=kv_len)
    want, want_map = jdec.decode_attention(*_j(q, k, v), kv_len=kv_len, block_k=64,
                                           interpret=True, return_counts=True)
    got, got_map = tdec.decode_attention(*_t(q, k, v), kv_len=kv_len, block_k=64,
                                         return_counts=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    kv_pos = np.arange(t)
    mask = (kv_pos <= kv_len - 1)[None, :]
    ref = softmax_attend(*_j(q, k, v), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name,shape,kv_len,window", [
    ("windowed_nonmult", (1, 300, 4, 2, 16, 16), 123, 50),
    ("mla_shaped", (1, 256, 4, 4, 24, 16), 100, 0),
    ("full_default_block", (2, 2080, 4, 2, 16, 16), 2080, 0),
])
def test_decode_plain_shapes(name, shape, kv_len, window):
    b, t, h, hkv, d, dv = shape
    q, k, v = _qkv(b, 1, t, h, hkv, d, dv, seed=5)
    block_k = 512 if name.startswith("full") else 64
    want = jdec.decode_attention(*_j(q, k, v), kv_len=kv_len, window=window,
                                 block_k=block_k, interpret=True)
    got = tdec.decode_attention(*_t(q, k, v), kv_len=kv_len, window=window,
                                block_k=block_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("t,kv_len,block_k,window", [
    (512, 5, 64, 0), (512, 250, 64, 0), (2080, 1, 512, 0), (2080, 511, 512, 0),
    (2080, 512, 512, 0), (2080, 513, 512, 0), (2080, 2080, 512, 0),
    (300, 123, 64, 50), (2080, 2000, 512, 700), (100, 100, 512, 0),
])
def test_decode_partition_counts_match_reference_oracle(t, kv_len, block_k, window):
    want = jdec.decode_partition_counts(t, kv_len, block_k=block_k, window=window)
    got = tdec.decode_partition_counts(t, kv_len, block_k=block_k, window=window)
    assert got == want


def test_wrappers_reject_what_the_kernels_do_not_take():
    q = torch.zeros(1, 1, 4, 16, dtype=torch.float16)
    with pytest.raises(TypeError):
        tfl.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        tdec.decode_attention(q, q, q, kv_len=1)
    with pytest.raises(ValueError, match="S=1"):
        tdec.decode_attention(torch.zeros(1, 2, 4, 16), torch.zeros(1, 8, 2, 16),
                              torch.zeros(1, 8, 2, 16), kv_len=2)


DECODE_SMEM_CASES = [
    (2, 128, 128, 16, 4, 4, 1, False),   # qwen3_0p6b f32: G 2, four key warps
    (2, 128, 128, 16, 2, 4, 1, False),   # bf16
    (2, 128, 128, 8, 4, 4, 1, False),    # 8-key chunks: K rows skewed 64 bytes
    (7, 128, 128, 16, 4, 4, 1, False),   # yi_34b's G 7 in one masked tile
    (12, 128, 128, 16, 4, 4, 1, False),  # starcoder2_15b's G 12
    (4, 576, 512, 8, 4, 1, 8, True),     # MLA at full width: 8 row warps, V in K's rows
    (16, 24, 8, 1, 2, 3, 2, False),      # a 48-byte K row, 16-byte V row
    (1, 4, 4, 2, 4, 1, 1, False),
]


@pytest.mark.parametrize("rows,d,dv,chunk,esize,kw,rw,shared", DECODE_SMEM_CASES)
def test_decode_smem_bytes_is_the_kernels_formula(rows, d, dv, chunk, esize, kw, rw, shared):
    """``decode_smem_bytes`` is ``layout`` of ``csrc/decode_attention.cu``:
    128 bytes of mbarriers; a key group's slots (a chunk's K rows then V
    rows, or two chunks of K rows where V is K's leading columns; K rows
    skewed 16 bytes a QK lane below 8), at least the key groups' (o, m, l)
    merge and the spans' per-row (max, 1 / den); the CTA's f32 query rows;
    a warp's chunk of logits; a warp's (m, l, alpha) a row; a 16-byte flag,
    each rounded up to 16 bytes.  The card test holds it to the exported C
    function."""
    r16 = lambda x: -(-x // 16) * 16  # noqa: E731
    lanes = 32 // chunk  # QK lanes a key: K rows skewed 16 bytes a lane under 8
    krow, vrow = r16(d * esize) + (16 * lanes if lanes < 8 else 0), r16(dv * esize)
    stage = 2 * chunk * krow if shared else chunk * (krow + vrow)
    rows_cta, warps = rw * rows, kw * rw
    merge = kw * rows_cta * (dv + 2) * 4 if kw > 1 else 0
    want = (128 + r16(max(kw * stage, merge, rows_cta * 2 * 4)) + r16(rows_cta * d * 4)
            + r16(warps * rows * chunk * 4) + r16(warps * rows * 3 * 4) + 16)
    assert tdec.decode_smem_bytes(rows, d, dv, chunk, esize, kw, rw, shared) == want


def test_decode_smem_check_refuses_full_width_mla():
    """MLA's absorbed decode at full width (128 heads on one latent head,
    D 576, Dv 512, V the leading columns of K's rows) is no longer refused:
    the plan fits it in 227 KiB (four groups of eight row warps, 4 rows a
    warp).  What the kernel still cannot take raises ``ValueError`` before
    any launch: K/V rows that are not 16-byte multiples, and a key whose
    rows and query panel pass 227 KiB, naming the limit, shape and bytes."""
    for esize in (4, 2):
        for shared in (True, False):
            plan = tdec.decode_plan(2, 128, 1, 2080, 576, 512, esize, shared, 132)
            assert plan["smem"] <= 227 * 1024
            assert plan["rows_tile"] * plan["row_warps"] * plan["groups"] >= 128
    x = torch.zeros(1, 8, 1, 4, dtype=torch.bfloat16)  # 8-byte rows
    with pytest.raises(ValueError, match="16-byte multiples"):
        tdec._check_rows16("decode_attention", (("k", x, 4),))
    tdec._check_rows16("decode_attention", (("k", torch.zeros(1, 8, 1, 8,
                                                              dtype=torch.bfloat16), 8),))
    with pytest.raises(ValueError, match=r"227 KiB") as err:
        tdec.decode_plan(1, 16, 1, 512, 8192, 128, 4, False, 132)
    assert "G=16" in str(err.value) and "D=8192" in str(err.value)


@pytest.mark.parametrize("dtype,esize", [("float32", 4), ("bfloat16", 2)])
def test_decode_plan_fills_the_card(dtype, esize):
    """The main path's decode shape (B 4, T 2080, Hkv 8, G 2, D 128) gets
    one even wave of CTAs, at least two an SM of 132: T split into 12 spans
    of 176 keys (11 whole 16-key chunks), four key warps; one sequence the
    same wave in 44 spans of 48 keys."""
    plan = tdec.decode_plan(4, 16, 8, 2080, 128, 128, esize, False, 132)
    assert 2 * 132 <= plan["ctas"] <= plan["wave"] == 3 * 132
    assert (plan["span"], plan["nspan"], plan["chunk"]) == (176, 12, 16)
    assert plan["span"] % plan["chunk"] == 0 and plan["nspan"] * plan["span"] >= 2080
    one = tdec.decode_plan(1, 16, 8, 2080, 128, 128, esize, False, 132)
    assert (one["span"], one["nspan"]) == (48, 44) and 2 * 132 <= one["ctas"] <= one["wave"]
    assert (plan["key_warps"], plan["row_warps"], plan["groups"]) == (4, 1, 1)
    assert plan["ctas"] == 4 * 8 * plan["nspan"] and plan["nspan"] * plan["span"] >= 2080


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("d", [32, 64, 128, 192, 256, 576])
def test_decode_plan_fits_shared_memory_at_any_g(d, esize):
    """Every G up to 128 and D up to 576 (Dv = D, or 512 under MLA's 576,
    V in K's rows or not) fits in 227 KiB: shared memory does not grow
    with G, whose rows go to warp tiles of at most 16 (4 at Dv 512), and
    the plan's bytes are ``decode_smem_bytes`` of its fields."""
    for dv in sorted({d, min(d, 512)}):
        for g in range(1, 129):
            for shared in (False, True):
                plan = tdec.decode_plan(4, g, 1, 2080, d, dv, esize, shared, 132)
                assert plan["smem"] <= 227 * 1024
                assert plan["smem"] == tdec.decode_smem_bytes(
                    plan["rows_tile"], d, dv, plan["chunk"], esize, plan["key_warps"],
                    plan["row_warps"], shared)
                assert plan["rows_tile"] <= min(tdec.ROW_TILE, tdec._row_cap(dv))
                assert plan["rows_tile"] * plan["row_warps"] * plan["groups"] >= g
                assert plan["key_warps"] * plan["row_warps"] <= 8


@pytest.mark.parametrize("hkv,g", [(8, 7), (8, 8), (4, 12)])
def test_decode_plan_takes_g_in_one_masked_tile(hkv, g):
    """yi_34b's G 7, qwen2_72b's G 8 and starcoder2_15b's G 12 (not all
    powers of two) are one tile of G rows, masked inside the kernel's
    accumulator shapes: one row group, four key warps."""
    plan = tdec.decode_plan(4, hkv * g, hkv, 2080, 128, 128, 4, False, 132)
    assert (plan["rows_tile"], plan["row_warps"], plan["groups"]) == (g, 1, 1)
    assert plan["key_warps"] == 4 and 132 <= plan["ctas"] <= plan["wave"]


def test_cpu_tensors_never_count_a_launch():
    before = (tfl.flash_attention.launches, tdec.decode_attention.launches)
    q, k, v = _qkv(1, 32, 32, 2, 1, 8, 8)
    tfl.flash_attention(*_t(q, k, v))
    tdec.decode_attention(*_t(q[:, :1], k, v), kv_len=9)
    assert (tfl.flash_attention.launches, tdec.decode_attention.launches) == before


def test_kernel_row_layout_check():
    """What the CUDA kernels cannot read (rows not in groups of 4) is
    refused before any launch; unit dimensions' strides do not matter."""
    from repro_torch.kernels import _build

    _build.check_rows4("t", torch.zeros(2, 1, 4, 8), torch.zeros(3, 5, 8)[:, 1:])
    for bad in (torch.zeros(3, 6)[:, 1:5], torch.zeros(2, 4, 6), torch.zeros(4, 8)[:, ::2]):
        with pytest.raises(ValueError, match="multiple of 4"):
            _build.check_rows4("t", bad)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel that does not compile raises; nothing falls back."""
    from repro_torch.kernels import _build

    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{__import__('os').environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed for flash_attention"):
        _build.build_all(("flash_attention",))
    assert not list((tmp_path / "build").glob("*.so"))
