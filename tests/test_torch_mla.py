"""The port's MLA (``models.attention.mla_*``) and its caches vs the JAX
reference, at ``deepseek_v2_236b.scaled_down()`` (4 heads, latent r 32,
rope 16, nope 32, v 32):

* ``mla_apply`` with no cache (S 20, and S 520 through flash's plain
  version), on a dense cache (a 20-token prefill, a 520-token prefill
  through flash at q_offset 20, two absorbed decode steps) and on a paged
  pool (S 1 decode and S 5 verify at mixed fills with an inactive slot),
  f32 and int8 (weights, and pools): outputs within 1e-5 (int8 pools
  1e-4), cache rows and lens equal;
* the ``q_lora_rank`` branch, which neither config uses, by an override;
* ``kv_cache``'s writers over MLA's ``kv_pages`` pool (prompt scatter with
  and without ``row_lo``, fork, prefix seeding, the non-finite probe, int8
  scales) and the SWA rolling buffer's ``row0_pos`` scatter on GQA pools,
  f32 and int8.

Params from the reference's init carried over by
``convert.params_from_numpy``; inputs made with numpy from seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import quant as jq  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402

ATOL = 1e-5


def _model(arch="deepseek_v2_236b", **kw):
    cfg = get_config(arch).scaled_down(num_layers=2, **kw)
    tcfg = t_get_config(arch).scaled_down(num_layers=2, **kw)
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def mla():
    cfg, jp, tcfg, tp = _model()
    layers = {"f32": (jax.tree.map(lambda a: a[0], jp["blocks"]["mixer"]),
                      tp["blocks"][0]["mixer"]),
              "int8": (jax.tree.map(lambda a: a[0], jq.quantize_params(jp)["blocks"]["mixer"]),
                       tq.quantize_params(tp)["blocks"][0]["mixer"])}
    return cfg, tcfg, layers


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _pos(b, s, start=0):
    return np.broadcast_to(start + np.arange(s), (b, s)).astype(np.int32)


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("s", [20, 520])
def test_mla_no_cache_matches_reference(mla, weights, s):
    cfg, tcfg, layers = mla
    jp, tp = layers[weights]
    x = _x(1, 2, s, cfg.d_model)
    want, _ = jattn.mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(_pos(2, s)))
    got, _ = tattn.mla_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(_pos(2, s)).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_mla_dense_cache_matches_reference(mla, weights):
    """One (B, T, r+dr) buffer against the reference's ckv / k_rope pair:
    prefill 20 (the masked einsum path), prefill 520 at q_offset 20 (flash
    at D 48, Dv 32 over the up-projected cache), then two S=1 absorbed
    decode steps (V a view of the buffer's leading r columns)."""
    cfg, tcfg, layers = mla
    jp, tp = layers[weights]
    r = cfg.kv_lora_rank
    jc = jattn.mla_cache_init(cfg, 2, 600, jnp.float32)
    tc = tattn.mla_cache_init(tcfg, 2, 600, torch.float32, "cpu")
    assert set(tc) == {"kv", "len"} and tc["kv"].shape == (2, 600, r + cfg.rope_head_dim)
    cur = 0
    for i, s in enumerate([20, 520, 1, 1]):
        x = _x(10 + i, 2, s, cfg.d_model)
        pos = _pos(2, s, cur)
        want, jc = jattn.mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jc)
        got, tc = tattn.mla_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos).long(), tc)
        cur += s
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=f"call {i}")
        assert tc["len"] == int(jc["len"]) == cur
        np.testing.assert_allclose(tc["kv"][..., :r].numpy(), np.asarray(jc["ckv"]), atol=ATOL)
        np.testing.assert_allclose(tc["kv"][..., r:].numpy(), np.asarray(jc["k_rope"]),
                                   atol=ATOL)


def _pools(rng, cfg, tcfg, fills, pg, max_pp, num_pages, int8):
    """Reference and port pools filled with the same random rows (int8:
    random codes and scales) and a block table at shuffled pages."""
    jc = jkv.init_paged_caches(cfg, len(fills), max_pp * pg, jnp.float32, page_size=pg,
                               num_pages=num_pages, kv_dtype="int8" if int8 else None)
    tc = tkv.init_paged_caches(tcfg, len(fills), max_pp * pg, torch.float32, page_size=pg,
                               num_pages=num_pages, kv_dtype="int8" if int8 else "f32",
                               device="cpu")
    perm = rng.permutation(num_pages)
    bt = -np.ones((len(fills), max_pp), np.int32)
    nxt = 0
    for i, n in enumerate(fills):
        if n:
            k = -(-(n + 5) // pg)  # room for the step and the verify rows
            bt[i, :k] = perm[nxt:nxt + k]
            nxt += k
    jblocks = []
    for li in range(cfg.num_layers):
        pool = {}
        for key, leaf in jc["blocks"][li].items():
            if key == "kv_scales":
                arr = rng.uniform(0.005, 0.02, leaf.shape).astype(np.float32)
            elif int8:
                arr = rng.integers(-127, 128, leaf.shape).astype(np.int8)
            else:
                arr = rng.standard_normal(leaf.shape).astype(np.float32)
            pool[key] = jnp.asarray(arr)
            tc["blocks"][li][key][:, :num_pages] = torch.from_numpy(arr)
        jblocks.append(pool)
    return jblocks, tc["blocks"], bt


@pytest.mark.parametrize("pools", ["f32", "int8"])
@pytest.mark.parametrize("weights", ["f32", "int8"])
def test_mla_paged_decode_and_verify_match_reference(mla, weights, pools):
    """Fills 5, 0 (inactive), 19 and 30 on 8-row pages: one S=1 decode,
    then an S=5 verify; outputs and the written pool rows (int8: codes
    within one step, scales within 1e-5 relative)."""
    cfg, tcfg, layers = mla
    jp, tp = layers[weights]
    rng = np.random.default_rng(3)
    fills = [5, 0, 19, 30]
    jpool, tpool, bt = _pools(rng, cfg, tcfg, fills, 8, 6, 24, pools == "int8")
    jlens, tlens = jnp.asarray(fills, jnp.int32), torch.tensor(fills, dtype=torch.int32)
    for s in (1, 5):
        x = _x(20 + s, 4, s, cfg.d_model)
        pos = np.asarray(fills)[:, None] + np.arange(s)[None, :]
        jcache = dict(jpool[0], block_tables=jnp.asarray(bt), len=jlens)
        tcache = dict(tpool[0], block_tables=torch.from_numpy(bt), len=tlens)
        want, jnew = jattn.mla_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos), jcache)
        got, tnew = tattn.mla_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos).long(),
                                    tcache)
        tol = 1e-4 if pools == "int8" else ATOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, err_msg=f"s={s}")
        assert set(tnew) == set(jnew)
        diff = tnew["kv_pages"][:, :-1].float().numpy() - np.asarray(jnew["kv_pages"], np.float32)
        assert np.abs(diff).max() <= (1 if pools == "int8" else ATOL)
        if pools == "int8":
            np.testing.assert_allclose(tnew["kv_scales"][:, :-1].numpy(),
                                       np.asarray(jnew["kv_scales"]), rtol=1e-5)
        jpool[0] = jnew


def test_mla_q_lora_branch_matches_reference():
    """``q_lora_rank`` 24 (an override: neither config sets it): queries
    from the normed q-lora latent, no cache and a dense-cache decode."""
    cfg, jp, tcfg, tp = _model(q_lora_rank=24)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["mixer"])
    tl = tp["blocks"][0]["mixer"]
    assert tl["wq"]["w"].shape == (24, cfg.num_heads * (cfg.mla_head_dim + cfg.rope_head_dim))
    assert set(tl) == set(jl)
    x = _x(4, 2, 9, cfg.d_model)
    want, _ = jattn.mla_apply(jl, cfg, jnp.asarray(x), jnp.asarray(_pos(2, 9)))
    got, _ = tattn.mla_apply(tl, tcfg, torch.from_numpy(x), torch.from_numpy(_pos(2, 9)).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jc = jtf.init_caches(cfg, 2, 16, jnp.float32)
    tc = ttf.init_caches(tcfg, 2, 16, torch.float32, "cpu")
    _, jc = jtf.prefill(jp, cfg, jnp.asarray(toks[:, :8]), jc)
    _, tc = ttf.prefill(tp, tcfg, torch.from_numpy(toks[:, :8]).long(), tc)
    want, _ = jtf.decode_step(jp, cfg, jnp.asarray(toks[:, 8:]), jc)
    got, _ = ttf.decode_step(tp, tcfg, torch.from_numpy(toks[:, 8:]).long(), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# pool writers
# ---------------------------------------------------------------------------


def _pools_equal(tblocks, jblocks, atol=0.0):
    for tp, jp in zip(tblocks, jblocks):
        assert set(tp) == set(jp)
        for key in jp:
            n = jp[key].shape[1]
            assert tp[key].shape[1] == n + 1, "one sink page past the served ones"
            np.testing.assert_allclose(tp[key][:, :n].float().numpy(),
                                       np.asarray(jp[key], np.float32), atol=atol)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_mla_pool_writers_match_reference(kv_dtype):
    cfg, _, tcfg, _ = _model()
    rng = np.random.default_rng(1)
    pg, max_len, n_tok, row_lo, t = 8, 64, 37, 16, 48
    r = cfg.kv_lora_rank
    jc = jkv.init_paged_caches(cfg, 2, max_len, jnp.float32, page_size=pg, num_pages=20,
                               kv_dtype=kv_dtype)
    tc = tkv.init_paged_caches(tcfg, 2, max_len, torch.float32, page_size=pg, num_pages=20,
                               kv_dtype=kv_dtype, device="cpu")
    assert set(tc["blocks"][0]) == set(jc["blocks"][0])
    assert tkv.page_bytes(tcfg, pg, kv_dtype) == jkv.page_bytes(cfg, pg, kv_dtype)
    row = np.full((max_len // pg,), -1, np.int32)
    row[:5] = [7, 2, 11, 0, 19]
    rows = [rng.standard_normal((1, t, r + cfg.rope_head_dim)).astype(np.float32)
            for _ in range(cfg.num_layers)]

    def dense(scale):
        jd = {"ckv": jnp.asarray(np.stack(rows)[..., :r] * scale),
              "k_rope": jnp.asarray(np.stack(rows)[..., r:] * scale)}
        return jd, [{"kv": torch.from_numpy(x * scale)} for x in rows]

    jd, td = dense(1.0)
    jb = jkv.write_prompt_pages(jc["blocks"], jd, jnp.asarray(row), n_tok)
    tkv.write_prompt_pages(tc["blocks"], td, torch.from_numpy(row), n_tok)
    _pools_equal(tc["blocks"], jb)
    jd, td = dense(2.0)
    jb = jkv.write_prompt_pages(jb, jd, jnp.asarray(row), n_tok, 0, row_lo)
    tkv.write_prompt_pages(tc["blocks"], td, torch.from_numpy(row), n_tok, row_lo=row_lo)
    _pools_equal(tc["blocks"], jb)
    jb = jkv.fork_page(jb, jnp.int32(11), jnp.int32(5))
    tkv.fork_page(tc["blocks"], 11, 5)
    _pools_equal(tc["blocks"], jb)
    jd = jtf.init_caches(cfg, 1, t, jnp.float32)
    td = ttf.init_caches(tcfg, 1, t, torch.float32, "cpu")
    jd = jkv.seed_prefix_dense(jd, jb, jnp.asarray(row), jnp.int32(21))
    tkv.seed_prefix_dense(td, tc["blocks"], torch.from_numpy(row), 21)
    for li in range(cfg.num_layers):
        assert td["blocks"][li]["len"] == int(jd["blocks"]["len"][li]) == 21
        np.testing.assert_array_equal(td["blocks"][li]["kv"][..., :r].numpy(),
                                      np.asarray(jd["blocks"]["ckv"][li]))
        np.testing.assert_array_equal(td["blocks"][li]["kv"][..., r:].numpy(),
                                      np.asarray(jd["blocks"]["k_rope"][li]))
    key = "kv_scales" if kv_dtype == "int8" else "kv_pages"
    jb = [dict(p) for p in jb]
    jb[1][key] = jb[1][key].at[0, 3].set(jnp.nan)
    tc["blocks"][1][key][0, 3] = float("nan")
    tc["blocks"][0][key][0, 20] = float("nan")  # the sink
    assert tkv.find_nonfinite_pages(tc["blocks"]) == jkv.find_nonfinite_pages(jb) == [3]


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_swa_rolling_buffer_scatter_matches_reference(kv_dtype):
    """A 16-row rolling buffer after a 37-token prompt holds positions
    21..36 (``row0_pos`` 21): only they reach the pages; then a 10-token
    prompt in a 16-row buffer (``row0_pos`` -6: six unwritten rows)."""
    cfg, _, tcfg, _ = _model("mixtral_8x22b")
    rng = np.random.default_rng(2)
    pg, max_len, t = 8, 64, 16
    for n_tok, pages in ((37, [7, 2, 11, 0, 19]), (10, [4, 9])):
        jc = jkv.init_paged_caches(cfg, 1, max_len, jnp.float32, page_size=pg, num_pages=20,
                                   kv_dtype=kv_dtype)
        tc = tkv.init_paged_caches(tcfg, 1, max_len, torch.float32, page_size=pg,
                                   num_pages=20, kv_dtype=kv_dtype, device="cpu")
        row = np.full((max_len // pg,), -1, np.int32)
        row[:len(pages)] = pages
        dense = [rng.standard_normal((2, 1, t, cfg.kv_heads, cfg.head_dim)).astype(np.float32)
                 for _ in range(cfg.num_layers)]
        jd = {"k": jnp.asarray(np.stack([d[0] for d in dense])),
              "v": jnp.asarray(np.stack([d[1] for d in dense]))}
        td = [{"k": torch.from_numpy(d[0]), "v": torch.from_numpy(d[1])} for d in dense]
        row0 = n_tok - t
        jb = jkv.write_prompt_pages(jc["blocks"], jd, jnp.asarray(row), n_tok, row0)
        tkv.write_prompt_pages(tc["blocks"], td, torch.from_numpy(row), n_tok, row0_pos=row0)
        _pools_equal(tc["blocks"], jb)
