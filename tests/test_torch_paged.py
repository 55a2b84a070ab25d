"""The port's paged KV cache and paged kernel vs the JAX reference.

* ``paged_decode_attention_ref`` (what the CUDA kernel's wrapper runs on a
  CPU tensor) against the reference's Pallas ``paged_decode_attention`` in
  interpret mode over the chip sweep (S 1/5, window 0/100, page 16/64,
  kv_lens 0, 1, page-1, page, page+1, 2064 at shuffled pages with -1
  tails; bf16; ``dv`` < W; int8 pages with scales): f32 within 1e-5, bf16
  within 1e-2 (the reference's tolerances), maps equal, and equal to
  ``paged_partition_counts`` at S = 1;
* ``PageAllocator`` / ``RadixPrefixCache`` on one seeded op sequence;
* the pool writers (``write_prompt_pages``, ``seed_prefix_dense``,
  ``fork_page``, ``find_nonfinite_pages``), whose port updates the pools
  in place and keeps a sink page past the served ones, and an int8 pool
  written by a prefill and six decode steps;
* paged ``decode_step`` / ``verify_step`` logits at mixed fill levels with
  an inactive slot, and the dynamic ``n_tokens`` prefill resumed across
  chunks.

Model: ``qwen3_0p6b.scaled_down()`` in f32, params carried over by
``convert.params_from_numpy``; inputs made with numpy from seeds.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

jdec = importlib.import_module("repro.kernels.decode_attention")
tdec = importlib.import_module("repro_torch.kernels.decode_attention")

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# f32 logits after a few layers, summed in another order
LOGIT_ATOL = 1e-4


def _paged_np(rng, b, s, h, hkv, d, w, pg, kv_lens, *, int8=False):
    """q, page pools and a block table with every sequence's pages at
    shuffled, non-contiguous pool indices and -1 tails (one spare table
    entry at least), as numpy; int8 pools with per-page, per-head scales."""
    pages = [-(-n // pg) for n in kv_lens]
    max_pp, num_pages = max(pages) + 1, sum(pages) + 3
    perm = rng.permutation(num_pages)
    bt = -np.ones((b, max_pp), np.int32)
    nxt = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[nxt:nxt + n]
        nxt += n
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    shape = (hkv, num_pages, pg, w)
    if int8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        scales = [(rng.random(shape[:2]) * 0.02 + 1e-3).astype(np.float32)
                  for _ in range(2)]
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
        scales = None
    return q, kp, vp, bt, np.asarray(kv_lens, np.int32), scales


PAGED_CASES = (
    [(f"s{s}_w{w}_pg{pg}", dict(s=s, window=w, pg=pg, dtype="float32"))
     for s in (1, 5) for w in (0, 100) for pg in (16, 64)]
    + [(f"bf16_s{s}_pg{pg}", dict(s=s, window=100, pg=pg, dtype="bfloat16"))
       for s in (1, 5) for pg in (16, 64)]
    + [("dv", dict(s=1, window=0, pg=16, dtype="float32", w=24, dv=8)),
       ("int8", dict(s=1, window=100, pg=16, dtype="float32", int8=True)),
       ("int8_verify", dict(s=5, window=0, pg=16, dtype="float32", int8=True))]
)


@pytest.mark.parametrize("name,case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_plain_version_matches_reference_kernel(name, case):
    s, window, pg, dtype = case["s"], case["window"], case["pg"], case["dtype"]
    kv_lens = [0, 1, pg - 1, pg, pg + 1, 2064]
    rng = np.random.default_rng(len(name))
    q, kp, vp, bt, lens, scales = _paged_np(rng, 6, s, 4, 2, 16, case.get("w", 16),
                                            pg, kv_lens, int8=case.get("int8", False))
    dv = case.get("dv")
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jkw = dict(window=window, dv=dv)
    tkw = dict(window=window, dv=dv)
    if scales is not None:
        jkw.update(k_scales=jnp.asarray(scales[0]), v_scales=jnp.asarray(scales[1]))
        tkw.update(k_scales=torch.from_numpy(scales[0]),
                   v_scales=torch.from_numpy(scales[1]))
        jpages = [jnp.asarray(kp), jnp.asarray(vp)]
        tpages = [torch.from_numpy(kp), torch.from_numpy(vp)]
    else:
        jpages = [jnp.asarray(kp, jd), jnp.asarray(vp, jd)]
        tpages = [torch.from_numpy(kp).to(td), torch.from_numpy(vp).to(td)]
    want, want_map = jdec.paged_decode_attention(
        jnp.asarray(q, jd), *jpages, jnp.asarray(bt), jnp.asarray(lens),
        interpret=True, return_counts=True, **jkw)
    got, got_map = tdec.paged_decode_attention(
        torch.from_numpy(q).to(td), *tpages, torch.from_numpy(bt),
        torch.from_numpy(lens), return_counts=True, **tkw)
    assert got.dtype == td and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=TOL[dtype])
    assert not got[0].any(), "kv_len 0 gives exactly zero"
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    if s == 1:
        executed, total = tdec.paged_partition_counts(bt.shape[1], kv_lens,
                                                      page_size=pg, window=window)
        assert got_map.shape[2] == total
        assert got_map[:, 0].sum(1).tolist() == executed
        assert executed == jdec.paged_partition_counts(bt.shape[1], kv_lens, page_size=pg,
                                                       window=window)[0]


@pytest.mark.parametrize("s,window", [(1, 0), (3, 20)])
def test_paged_dispatcher_matches_reference_ref(s, window):
    """The ``ref`` route of ``paged_decode_attend`` against the reference's
    ``paged_decode_attend_ref`` (gather dense, mask per sequence) on
    lengths a decode or verify step gives (>= S, or 0 for an idle slot)."""
    rng = np.random.default_rng(s)
    kv_lens = [0, s, 9, 40]
    q, kp, vp, bt, lens, _ = _paged_np(rng, 4, s, 4, 2, 16, 16, 8, kv_lens)
    want = jlayers.paged_decode_attend_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                           jnp.asarray(bt), jnp.asarray(lens), window=window)
    prev = tlayers.set_attention_impl("ref")
    try:
        got = tlayers.paged_decode_attend(*map(torch.from_numpy, (q, kp, vp, bt, lens)),
                                          window=window)
    finally:
        tlayers.set_attention_impl(prev)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"])


# the kernel's timed shape (B 4, 2064 keys in 129 pages of 16 and one -1
# entry) and the engine's (8 slots, 2112-token tables of 132 pages)
PLAN_GRIDS = [(4, 130), (8, 132)]


@pytest.mark.parametrize("b,max_pp", PLAN_GRIDS)
@pytest.mark.parametrize("s", [1, 5])
def test_paged_plan_fills_the_card(b, max_pp, s):
    """qwen3_0p6b's decode (S 1) and verify (S 5) rows on 16-token pages:
    the span chooser gives at least two CTAs per SM of a 132-SM card (it
    aims at one wave of CTAs the SMs hold at once), spans of at most 256
    keys, and four pages in work at once, a warp each."""
    plan = tdec.paged_plan(b, s, 16, 8, 128, 128, 16, max_pp, 4, 132)
    assert plan["ctas"] >= 2 * 132
    assert plan["ctas"] == b * 8 * plan["tiles"] * plan["nspan"]
    assert plan["span_pages"] * 16 <= tdec.SPAN_KEYS[1]
    assert plan["warps"] == tdec.PAGED_WARPS
    assert plan["nspan"] == -(-max_pp // plan["span_pages"])
    assert plan["tiles"] == 1 and plan["rows_tile"] == 2 * s


@pytest.mark.parametrize("esize", [1, 2, 4])
@pytest.mark.parametrize("d,dv", [(32, 32), (128, 128), (128, 96), (256, 256), (576, 512),
                                  (576, 576)])
def test_paged_plan_fits_shared_memory_at_any_rows(d, dv, esize):
    """Rows come in tiles of at most 16 (fewer at wide Dv), so shared
    memory does not grow with S x G: for every R up to 128 and D up to 576
    on 16-token pages (and D 128 on 64-token pages) the plan fits the
    227 KiB a CTA may opt in to and its tiles cover the rows."""
    pages = [16] + ([64] if d <= 128 else [])
    for pg in pages:
        for rows in range(1, 129):
            for b in (1, 8):
                plan = tdec.paged_plan(b, 1, rows, 1, d, dv, pg, 130, esize, 132)
                assert plan["smem"] <= 227 * 1024
                assert plan["smem"] == tdec.paged_smem_bytes(
                    plan["rows_tile"], d, dv, pg, plan["span_pages"], esize, plan["warps"])
                assert plan["rows_tile"] <= min(tdec.ROW_TILE, tdec._row_cap(dv))
                assert plan["tiles"] * plan["rows_tile"] >= rows
                assert (plan["tiles"] - 1) * plan["rows_tile"] < rows
                assert 1 <= plan["warps"] <= tdec.PAGED_WARPS


def test_paged_smem_bytes_layout():
    """A CTA's shared memory, term by term, at the timed shape (2 rows,
    D = Dv = 128 f32, pages of 16, four warps with a page slot each, spans
    of 8 pages): 128 B of mbarriers; four slots of 16 K rows and 16 V rows of
    512 B; the f32 query tile; each warp's page of logits and its rows'
    (m, l, factor); the span's page ids and two scales; the flag."""
    ring = 4 * 16 * (512 + 512)
    want = 128 + ring + 2 * 128 * 4 + 4 * 2 * 16 * 4 + 4 * 2 * 3 * 4 + 3 * 32 + 16
    assert tdec.paged_smem_bytes(2, 128, 128, 16, 8, 4, 4) == want
    # at small pages the warps' merge buffer (o, m, l a row) sets the ring
    assert tdec.paged_smem_bytes(2, 4, 128, 1, 8, 1, 4) == \
        128 + 4 * 2 * 130 * 4 + 32 + 32 + 96 + 3 * 32 + 16


def test_paged_plan_refuses_what_does_not_fit():
    """One page of 64 f32 keys at D 576 does not fit: the plan raises a
    ValueError naming the limit before any launch; so does a dv past the
    1024 value columns a CTA accumulates."""
    with pytest.raises(ValueError, match="227 KiB"):
        tdec.paged_plan(1, 1, 16, 1, 576, 576, 64, 40, 4, 132)
    with pytest.raises(ValueError, match="1024 value columns"):
        tdec.paged_plan(1, 1, 16, 1, 64, 1028, 16, 40, 4, 132)


# ---------------------------------------------------------------------------
# allocator and radix prefix cache
# ---------------------------------------------------------------------------


def _state(alloc):
    return list(alloc._free), dict(alloc._refs), sorted(alloc._quarantined)


def _tree(cache):
    return sorted((c.chunk, c.page, c.last_used) for _, c in cache._walk())


def test_allocator_and_radix_match_reference():
    """One seeded sequence of alloc / ref / release / free / quarantine and
    radix insert / lookup / evict through both packages: equal results,
    errors, free lists, refcounts, trees and audits after every op."""
    rng = np.random.default_rng(0)
    pkgs = [(jkv.PageAllocator(48), jkv), (tkv.PageAllocator(48), tkv)]
    trees = [mod.RadixPrefixCache(a, 4) for a, mod in pkgs]
    held = [[], []]
    base = rng.integers(0, 6, 40)
    for step in range(300):
        op = rng.integers(0, 7)
        n = int(rng.integers(1, 5))
        seq = base[:int(rng.integers(1, 40))].copy()
        if rng.random() < 0.3:
            seq[int(rng.integers(0, len(seq)))] = 9
        results = []
        for i, ((alloc, mod), tree) in enumerate(zip(pkgs, trees)):
            try:
                if op == 0:
                    pages = alloc.alloc(n)
                    held[i].append(pages)
                    r = pages
                elif op == 1 and held[i]:
                    r = alloc.release(held[i].pop(0))
                elif op == 2 and held[i]:
                    r = alloc.free(held[i][-1])
                    held[i].pop()
                elif op == 3:
                    r = tree.lookup(seq)
                    held[i].append(r[1])
                elif op == 4 and held[i]:
                    r = tree.insert(seq[:4 * len(held[i][-1])], held[i][-1])
                elif op == 5:
                    r = tree.evict(n)
                elif op == 6 and step % 50 == 0:
                    r = alloc.quarantine([int(rng.integers(0, 48))])
                    held[i] = [[p for p in h if p in alloc._refs] for h in held[i]]
                else:
                    r = None
            except (ValueError, MemoryError) as e:
                r = type(e).__name__
            claims = {f"h{j}": h for j, h in enumerate(held[i])}
            claims["radix"] = tree.pages()
            try:
                audit = alloc.audit()
            except mod.PoolAuditError as e:
                audit = str(e)
            results.append((r, _state(alloc), _tree(tree), audit, tree.hits,
                            tree.hit_tokens, tree.evicted_pages))
        assert results[0] == results[1], (step, op)
    assert trees[1].lookups == trees[0].lookups > 0


# ---------------------------------------------------------------------------
# pool writers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3_0p6b").scaled_down()
    jparams = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tcfg = t_get_config("qwen3_0p6b").scaled_down()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return cfg, jparams, tcfg, tparams


def _pools_equal(tblocks, jblocks, atol=0.0):
    for tp, jp in zip(tblocks, jblocks):
        assert set(tp) == set(jp)
        for key in jp:
            n = jp[key].shape[1]
            assert tp[key].shape[1] == n + 1, "one sink page past the served ones"
            np.testing.assert_allclose(tp[key][:, :n].numpy(), np.asarray(jp[key]),
                                       atol=atol)


def test_pool_writers_match_reference(model):
    cfg, _, tcfg, _ = model
    rng = np.random.default_rng(1)
    pg, max_len, n_tok, row_lo = 8, 64, 37, 13
    jc = jkv.init_paged_caches(cfg, 2, max_len, jnp.float32, page_size=pg, num_pages=20)
    tc = tkv.init_paged_caches(tcfg, 2, max_len, torch.float32, page_size=pg,
                               num_pages=20, device="cpu")
    assert tkv.pool_num_pages(tc["blocks"][0]["k_pages"]) == 20
    assert tc["block_tables"].shape == tuple(jc["block_tables"].shape)
    assert tkv.page_bytes(tcfg, pg) == jkv.page_bytes(cfg, pg)
    assert tkv.pool_pages_for_bytes(tcfg, 10 ** 6, pg) == jkv.pool_pages_for_bytes(
        cfg, 10 ** 6, pg)
    row = np.full((max_len // pg,), -1, np.int32)
    row[:5] = [7, 2, 11, 0, 19]
    t = 48  # dense capacity: pad rows past n_tok must go nowhere live
    dense = [rng.standard_normal((2, 1, t, cfg.kv_heads, cfg.head_dim)).astype(np.float32)
             for _ in range(cfg.num_layers)]
    jdense = {"k": jnp.asarray(np.stack([d[0] for d in dense])),
              "v": jnp.asarray(np.stack([d[1] for d in dense]))}
    tdense = [{"k": torch.from_numpy(d[0]), "v": torch.from_numpy(d[1])} for d in dense]
    # a full write, then a suffix-only write (row_lo) over other data
    jb = jkv.write_prompt_pages(jc["blocks"], jdense, jnp.asarray(row), n_tok)
    tkv.write_prompt_pages(tc["blocks"], tdense, torch.from_numpy(row), n_tok)
    _pools_equal(tc["blocks"], jb)
    jdense2 = {k: v * 2 for k, v in jdense.items()}
    tdense2 = [{k: v * 2 for k, v in d.items()} for d in tdense]
    jb = jkv.write_prompt_pages(jb, jdense2, jnp.asarray(row), n_tok, 0, row_lo)
    tkv.write_prompt_pages(tc["blocks"], tdense2, torch.from_numpy(row), n_tok,
                           row_lo=row_lo)
    _pools_equal(tc["blocks"], jb)
    # copy-on-write fork of page 11 into page 5
    jb = jkv.fork_page(jb, jnp.int32(11), jnp.int32(5))
    tkv.fork_page(tc["blocks"], 11, 5)
    _pools_equal(tc["blocks"], jb)
    # seed a fresh dense cache from the first 21 prefix rows
    jd = jtf.init_caches(cfg, 1, t, jnp.float32)
    td = ttf.init_caches(tcfg, 1, t, torch.float32, "cpu")
    jd = jkv.seed_prefix_dense(jd, jb, jnp.asarray(row), jnp.int32(21))
    tkv.seed_prefix_dense(td, tc["blocks"], torch.from_numpy(row), 21)
    for li in range(cfg.num_layers):
        assert td["blocks"][li]["len"] == int(jd["blocks"]["len"][li]) == 21
        for key in ("k", "v"):
            np.testing.assert_array_equal(td["blocks"][li][key].numpy(),
                                          np.asarray(jd["blocks"][key][li]))
    # poisoned pages, found in both; the sink's garbage is not a served page
    jb = [dict(p) for p in jb]
    jb[1]["v_pages"] = jb[1]["v_pages"].at[0, 3, 2, 1].set(jnp.nan)
    jb[0]["k_pages"] = jb[0]["k_pages"].at[1, 17, 0, 0].set(jnp.inf)
    tc["blocks"][1]["v_pages"][0, 3, 2, 1] = float("nan")
    tc["blocks"][0]["k_pages"][1, 17, 0, 0] = float("inf")
    tc["blocks"][0]["v_pages"][0, 20] = float("nan")  # the sink
    assert tkv.find_nonfinite_pages(tc["blocks"]) == jkv.find_nonfinite_pages(jb) == [3, 17]


def test_int8_pools_match_reference(model):
    """The reference's int8-pool path (``TestInt8PagedModel``): a dense
    prefill of 21 tokens scattered into int8 pages (per-page, per-head
    scales; the pages past the prompt get the eps scale), then six paged
    decode steps that requantize their page per token, teacher-forced
    with the reference's tokens.  The pools' layout and dtypes match,
    with one sink page and scale column more; codes within one step (an
    ulp apart in f32 K/V rows can round to neighbouring codes); logits
    within 1e-3 and greedy tokens equal."""
    cfg, jparams, tcfg, tparams = model
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (1, 21)).astype(np.int32)
    pg, max_len, n = 8, 64, 21
    jc = jkv.init_paged_caches(cfg, 1, max_len, jnp.float32, page_size=pg, kv_dtype="int8")
    tc = tkv.init_paged_caches(tcfg, 1, max_len, torch.float32, page_size=pg,
                               kv_dtype="int8", device="cpu")
    for jp, tp in zip(jc["blocks"], tc["blocks"]):
        assert set(tp) == set(jp) == {"k_pages", "v_pages", "k_scales", "v_scales"}
        for key in jp:
            assert tp[key].shape[0] == jp[key].shape[0]
            assert tp[key].shape[1] == jp[key].shape[1] + 1
            assert tp[key].dtype == getattr(torch, str(jp[key].dtype))
    bt = -np.ones((1, max_len // pg), np.int32)
    bt[0, :5] = [3, 0, 6, 1, 2]
    jd = jtf.init_caches(cfg, 1, 32, jnp.float32)
    td = ttf.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    jt, jd = jstep.make_prefill_step(cfg, chunk=32)(jparams, jnp.asarray(prompt), jd)
    tt, td = tstep.make_prefill_step(tcfg, chunk=32)(tparams, torch.from_numpy(prompt).long(), td)
    assert tt.tolist() == np.asarray(jt).tolist()
    jb = jkv.write_prompt_pages(jc["blocks"], jd["blocks"], jnp.asarray(bt[0]), n)
    tkv.write_prompt_pages(tc["blocks"], td["blocks"], torch.from_numpy(bt[0]), n)
    jcache = {"blocks": jb, "block_tables": jnp.asarray(bt), "lens": jnp.asarray([n], jnp.int32)}
    tcache = {"blocks": tc["blocks"], "block_tables": torch.from_numpy(bt),
              "lens": torch.tensor([n], dtype=torch.int32)}
    tok = np.asarray(jt).astype(np.int32)[:, None]
    for _ in range(6):
        jl, jcache = jtf.decode_step(jparams, cfg, jnp.asarray(tok), jcache)
        tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-3)
        assert tl[0, -1].argmax().item() == int(np.asarray(jl)[0, -1].argmax())
        tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    assert tcache["lens"].tolist() == np.asarray(jcache["lens"]).tolist() == [n + 6]
    for tp, jp in zip(tcache["blocks"], jcache["blocks"]):
        for key in ("k_pages", "v_pages"):
            diff = tp[key][:, :-1].int().numpy() - np.asarray(jp[key]).astype(np.int32)
            assert np.abs(diff).max() <= 1
        for key in ("k_scales", "v_scales"):
            np.testing.assert_allclose(tp[key][:, :-1].numpy(), np.asarray(jp[key]), rtol=1e-5)
        assert (tp["k_scales"][:, 2] == 1e-12 / 127).all(), "pool page 2 is never written"


# ---------------------------------------------------------------------------
# paged model steps
# ---------------------------------------------------------------------------


def test_paged_decode_and_verify_steps_match_reference(model):
    """Pools filled with the same random rows; slots at fills 5, 0
    (inactive: block-table row -1), 19 and 30; one decode step, then a
    3-token verify step.  Logits within 1e-4, written rows, lens equal."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(2)
    pg, max_len, num_pages = 8, 48, 24
    jc = jkv.init_paged_caches(cfg, 4, max_len, jnp.float32, page_size=pg,
                               num_pages=num_pages)
    tc = tkv.init_paged_caches(tcfg, 4, max_len, torch.float32, page_size=pg,
                               num_pages=num_pages, device="cpu")
    fills = [5, 0, 19, 30]
    perm = rng.permutation(num_pages)
    bt = -np.ones((4, max_len // pg), np.int32)
    nxt = 0
    for i, n in enumerate(fills):
        if n:
            k = -(-(n + 4) // pg)  # room for the step and the verify rows
            bt[i, :k] = perm[nxt:nxt + k]
            nxt += k
    jblocks = []
    for li in range(cfg.num_layers):
        pool = {}
        for key in ("k_pages", "v_pages"):
            arr = rng.standard_normal(jc["blocks"][li][key].shape).astype(np.float32)
            pool[key] = jnp.asarray(arr)
            tc["blocks"][li][key][:, :num_pages] = torch.from_numpy(arr)
        jblocks.append(pool)
    jcache = {"blocks": jblocks, "block_tables": jnp.asarray(bt),
              "lens": jnp.asarray(fills, jnp.int32)}
    tcache = {"blocks": tc["blocks"], "block_tables": torch.from_numpy(bt),
              "lens": torch.tensor(fills, dtype=torch.int32)}
    tok = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
    jl, jcache = jtf.decode_step(jparams, cfg, jnp.asarray(tok), jcache)
    tl, tcache = ttf.decode_step(tparams, tcfg, torch.from_numpy(tok).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tcache["lens"].numpy(), np.asarray(jcache["lens"]))
    assert tcache["lens"].tolist() == [6, 0, 20, 31]
    _pools_equal(tcache["blocks"], jcache["blocks"], atol=1e-5)
    toks = rng.integers(0, cfg.vocab, (4, 3)).astype(np.int32)
    jg, jcache = jstep.make_verify_step(cfg)(jparams, jnp.asarray(toks), jcache)
    tg, tcache = tstep.make_verify_step(tcfg)(tparams, torch.from_numpy(toks).long(), tcache)
    jl, _ = jtf.verify_step(jparams, cfg, jnp.asarray(toks), jcache)
    tl, _ = ttf.verify_step(tparams, tcfg, torch.from_numpy(toks).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tcache["lens"].numpy(), np.asarray(jcache["lens"]))
    _pools_equal(tcache["blocks"], jcache["blocks"], atol=1e-5)


def test_dynamic_prefill_resumes_across_chunks(model):
    """The engine's prefill contract: right-padded pieces with the real
    count as ``n_tokens``, resumed call after call (17 = 8 + 8 + 1 real
    tokens at chunk 8), then a padded 24-token prompt of 19 real in one
    call over three chunks: equal tokens, cache rows and ``len``."""
    cfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(3)
    seq = rng.integers(0, cfg.vocab, 17).astype(np.int32)
    jpre = jstep.make_prefill_step(cfg, chunk=8)
    tpre = tstep.make_prefill_step(tcfg, chunk=8)
    jc = jtf.init_caches(cfg, 1, 32, jnp.float32)
    tc = ttf.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    for lo in range(0, 17, 8):
        k = min(8, 17 - lo)
        piece = np.zeros((1, 8), np.int32)
        piece[0, :k] = seq[lo:lo + k]
        jt, jc = jpre(jparams, jnp.asarray(piece), jc, n_tokens=jnp.int32(k))
        tt, tc = tpre(tparams, torch.from_numpy(piece).long(), tc, n_tokens=k)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert tc["blocks"][0]["len"] == int(jc["blocks"]["len"][0]) == lo + k
    for li in range(cfg.num_layers):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][li][key][:, :17].numpy(),
                                       np.asarray(jc["blocks"][key][li][:, :17]), atol=1e-5)
    prompt = np.zeros((1, 24), np.int32)
    prompt[0, :19] = rng.integers(0, cfg.vocab, 19)
    jc = jtf.init_caches(cfg, 1, 32, jnp.float32)
    tc = ttf.init_caches(tcfg, 1, 32, torch.float32, "cpu")
    jt, jc = jpre(jparams, jnp.asarray(prompt), jc, n_tokens=jnp.int32(19))
    tt, tc = tpre(tparams, torch.from_numpy(prompt).long(), tc, n_tokens=19)
    assert tt.tolist() == np.asarray(jt).tolist()
    assert tc["blocks"][1]["len"] == int(jc["blocks"]["len"][1]) == 19
    np.testing.assert_allclose(tc["blocks"][1]["k"][:, :19].numpy(),
                               np.asarray(jc["blocks"]["k"][1][:, :19]), atol=1e-5)
