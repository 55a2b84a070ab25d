"""The port's int8 serving path vs the JAX reference.

* ``optim.quant``: ``quantize_params`` codes and scales bitwise on a
  converted ``scaled_down`` qwen3 tree, ``quant_int8`` bitwise over its
  granularities; ``convert`` carries a quantized tree in bf16 with int8
  codes and f32 scales;
* ``quant_dense_apply``: the same ``x`` gives bitwise equal int8 codes,
  activation scales and int32 accumulators, and outputs within 1e-6 of
  the reference's (jnp route, and its Pallas route in interpret mode);
* the whole model on quantized params: ``forward`` logits, chunked
  prefill with a ragged final chunk, and ``generate`` — tokens equal to
  the reference's int8 tokens (its int8-vs-f32 parity test is red);
* int8 KV pools: ``write_prompt_pages`` (with ``row_lo``),
  ``quant_page_update`` (recycled garbage masked, inactive slot on the
  sink), ``seed_prefix_dense``, ``fork_page``, ``find_nonfinite_pages``,
  and paged decode / verify logits.

Logit tolerance: a one-ulp f32 difference before a quantize step (norms,
RoPE, softmax and matmuls summed in another order) can move one int8
activation code by one step, which moves a layer's outputs by about one
code step of one input; logits (~1 in scale) are held at 1e-3.
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
from repro.optim import quant as jq  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import quant as tq  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve import step as tstep  # noqa: E402

# the module (the package exports its function under the same name)
tvta = importlib.import_module("repro_torch.kernels.vta_gemm")

LOGIT_ATOL = 1e-3
PROJ = [("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
        ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3_0p6b").scaled_down()
    jparams = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    jqp = jq.quantize_params(jparams)
    tcfg = t_get_config("qwen3_0p6b").scaled_down()
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tqp = tq.quantize_params(tparams)
    return cfg, jqp, tcfg, tparams, tqp


def _bits(x):
    return np.asarray(x).view(np.uint32 if np.asarray(x).dtype == np.float32 else np.uint8)


# ---------------------------------------------------------------------------
# optim.quant and convert
# ---------------------------------------------------------------------------


def test_quantize_params_bitwise(model):
    cfg, jqp, _, tparams, tqp = model
    for li in range(cfg.num_layers):
        for mod, name in PROJ:
            j, t = jqp["blocks"][mod][name], tqp["blocks"][li][mod][name]
            assert set(t) == set(j) == {"qw", "qscale"}
            assert t["qw"].dtype == torch.int8 and t["qscale"].dtype == torch.float32
            np.testing.assert_array_equal(t["qw"].numpy(), np.asarray(j["qw"][li]))
            np.testing.assert_array_equal(_bits(t["qscale"].numpy()), _bits(j["qscale"][li]))
        for norm in ("norm1", "norm2"):
            assert tqp["blocks"][li][norm]["scale"] is tparams["blocks"][li][norm]["scale"]
    assert tqp["embed"]["table"] is tparams["embed"]["table"]
    assert "w" in tparams["blocks"][0]["mixer"]["wq"], "the f32 params are not modified"
    assert tq.is_quantized(tqp["blocks"][0]["ffn"]["w_up"])
    assert not tq.is_quantized(tqp["embed"])
    # a stacked (E, K, N) weight with a bias, and a router array
    rng = np.random.default_rng(1)
    w3 = rng.standard_normal((3, 16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    tree = {"moe": {"router": w3[0], "experts": {"w": w3, "b": b}}, "conv": {"w": w3[None]}}
    jt = jq.quantize_params(jax.tree.map(jnp.asarray, tree))
    tt = tq.quantize_params(jax.tree.map(torch.from_numpy, tree))
    for key in ("router", "experts"):
        for leaf in ("qw", "qscale"):
            np.testing.assert_array_equal(tt["moe"][key][leaf].numpy(),
                                          np.asarray(jt["moe"][key][leaf]))
    np.testing.assert_array_equal(tt["moe"]["experts"]["b"].numpy(), b)
    assert set(tt["conv"]) == {"w"}, "4D conv weights stay as they are"


@pytest.mark.parametrize("axes", [None, (0,), (1,), 0, (0, 1)])
def test_quant_int8_bitwise(axes):
    x = np.random.default_rng(2).standard_normal((37, 64)).astype(np.float32) * 3
    x[5, 7] = 0.5 * 3 / 127  # ties round half to even in both
    jqx, js = jq.quant_int8(jnp.asarray(x), axes=axes)
    tqx, ts = tq.quant_int8(torch.from_numpy(x), axes=axes)
    assert tuple(ts.shape) == js.shape and tqx.dtype == torch.int8
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(
        tq.dequant_int8(tqx, tq.scale_for(torch.from_numpy(x), axes, keepdims=True)).numpy(),
        np.asarray(jq.dequant_int8(jqx, jq.scale_for(jnp.asarray(x), axes, keepdims=True))))
    np.testing.assert_array_equal(tq.scale_from_amax(torch.zeros(())).numpy(),
                                  np.asarray(jq.scale_from_amax(jnp.zeros(()))))


def test_convert_carries_a_quantized_bf16_tree(model):
    """int8 codes stay int8 and every scale leaf stays f32 whatever the
    dtype; the float leaves take it."""
    cfg, jqp, tcfg, _, _ = model
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jqp), tcfg, "cpu",
                                   dtype=torch.bfloat16)
    for li in range(cfg.num_layers):
        for mod, name in PROJ:
            t, j = tp["blocks"][li][mod][name], jqp["blocks"][mod][name]
            assert t["qw"].dtype == torch.int8 and t["qscale"].dtype == torch.float32
            np.testing.assert_array_equal(t["qw"].numpy(), np.asarray(j["qw"][li]))
            np.testing.assert_array_equal(_bits(t["qscale"].numpy()), _bits(j["qscale"][li]))
        assert tp["blocks"][li]["norm1"]["scale"].dtype == torch.bfloat16
    assert tp["embed"]["table"].dtype == torch.bfloat16
    pool = {"k_scales": np.ones((2, 3), np.float32), "k_pages": np.ones((2, 3), np.int8),
            "v": np.ones(3, np.float32)}
    out = convert._to_torch(pool, "cpu", torch.bfloat16)
    assert (out["k_scales"].dtype, out["k_pages"].dtype, out["v"].dtype) == (
        torch.float32, torch.int8, torch.bfloat16)


def _k_major_strides(x):
    """(1, K) for a (K, N) leaf, (K * N, 1, K) for a stacked (E, K, N) one."""
    k = x.shape[-2]
    return (1, k) if x.dim() == 2 else (k * x.shape[-1], 1, k)


@pytest.mark.parametrize("source", ["quantize_params", "convert"])
def test_packed_weights_are_k_major_and_bitwise(model, source):
    """``quantize_params`` and ``convert`` of a quantized tree give every
    ``qw`` K-major (strides (1, K)), with the reference's shape and
    values bit for bit."""
    cfg, jqp, tcfg, _, tqp = model
    tp = (tqp if source == "quantize_params" else
          convert.params_from_numpy(jax.tree.map(np.asarray, jqp), tcfg, "cpu"))
    for li in range(cfg.num_layers):
        for mod, name in PROJ:
            qw = tp["blocks"][li][mod][name]["qw"]
            want = np.asarray(jqp["blocks"][mod][name]["qw"][li])
            assert qw.stride() == _k_major_strides(qw) and qw.shape == want.shape
            np.testing.assert_array_equal(qw.numpy(), want)
            assert torch.equal(qw.contiguous(), torch.from_numpy(want))


def test_quantize_dense_stacked_is_k_major_per_expert():
    """A stacked (E, K, N) weight packs K-major per expert, strides
    (K * N, 1, K), with the reference's codes and scales."""
    w = np.random.default_rng(4).standard_normal((3, 40, 24)).astype(np.float32)
    got = tq.quantize_dense({"w": torch.from_numpy(w)})
    want = jq.quantize_dense({"w": jnp.asarray(w)})
    assert got["qw"].stride() == (40 * 24, 1, 40)
    np.testing.assert_array_equal(got["qw"].numpy(), np.asarray(want["qw"]))
    np.testing.assert_array_equal(_bits(got["qscale"].numpy()), _bits(want["qscale"]))
    assert torch.equal(tq.k_major(got["qw"]), got["qw"])


# ---------------------------------------------------------------------------
# quant_dense_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "silu_3d", "bias_gelu", "pallas"])
def test_quant_dense_apply_matches_reference(model, case):
    """On equal x: equal codes, activation scale and int32 accumulators;
    outputs within 1e-6 of the reference's jnp route (or, for
    ``pallas``, its Pallas route in interpret mode, restored after)."""
    _, jqp, _, _, tqp = model
    rng = np.random.default_rng(3)
    p_j, p_t = jqp["blocks"]["ffn"]["w_gate"], tqp["blocks"][1]["ffn"]["w_gate"]
    p_j = {k: v[1] for k, v in p_j.items()}
    act = {"silu_3d": "silu", "bias_gelu": "gelu"}.get(case)
    if case == "bias_gelu":
        b = rng.standard_normal(p_t["qw"].shape[1]).astype(np.float32)
        p_j, p_t = dict(p_j, b=jnp.asarray(b)), dict(p_t, b=torch.from_numpy(b))
    shape = (2, 9, 128) if case == "silu_3d" else (8, 128)
    x = rng.standard_normal(shape).astype(np.float32)
    jqx, jsx = jq.quant_int8(jnp.asarray(x).reshape(-1, 128))
    tqx, tsx = tq.quant_int8(torch.from_numpy(x).reshape(-1, 128))
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(_bits(tsx.numpy()), _bits(jsx))
    jacc = jnp.dot(jqx.astype(jnp.int32), p_j["qw"].astype(jnp.int32))
    np.testing.assert_array_equal(tvta.gemm_int32(tqx, p_t["qw"]).numpy(), np.asarray(jacc))
    prev = jlayers.set_gemm_impl("pallas" if case == "pallas" else "jnp")
    try:
        want = np.asarray(jlayers.quant_dense_apply(p_j, jnp.asarray(x), act=act))
    finally:
        jlayers.set_gemm_impl(prev)
    got = tlayers.quant_dense_apply(p_t, torch.from_numpy(x), act=act)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_gemm_impl_dispatch(model):
    _, _, _, _, tqp = model
    p = tqp["blocks"][0]["mixer"]["wq"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 128)).astype(np.float32))
    auto = tlayers.dense_apply(p, x)
    prev = tlayers.set_gemm_impl("ref")
    try:
        assert tlayers.gemm_impl() == "ref"
        assert torch.equal(tlayers.dense_apply(p, x), auto)
        tlayers.set_gemm_impl("kernel")
        with pytest.raises(RuntimeError, match="needs a CUDA tensor"):
            tlayers.dense_apply(p, x)
        with pytest.raises(ValueError):
            tlayers.set_gemm_impl("pallas")
    finally:
        tlayers.set_gemm_impl(prev)
    assert tlayers.gemm_impl() == "auto"
    assert tlayers.dense_apply(p, x.to(torch.bfloat16)).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the whole model on quantized params
# ---------------------------------------------------------------------------


def test_quantized_forward_and_chunked_prefill_match_reference(model):
    cfg, jqp, tcfg, _, tqp = model
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jl, _ = jtf.forward(jqp, cfg, jnp.asarray(toks))
    tl, _ = ttf.forward(tqp, tcfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    # 41 tokens at chunk 16: a ragged final chunk right-padded with 7 rows
    # that take part in every activation scale of that chunk, as in the
    # reference
    prompt = rng.integers(0, cfg.vocab, (2, 41)).astype(np.int32)
    jpre = jstep.make_prefill_step(cfg, chunk=16)
    tpre = tstep.make_prefill_step(tcfg, chunk=16, return_logits=True)
    jc = jtf.init_caches(cfg, 2, 64, jnp.float32)
    tc = ttf.init_caches(tcfg, 2, 64, torch.float32, "cpu")
    jt, jc = jpre(jqp, jnp.asarray(prompt), jc)
    tt, tlog, tc = tpre(tqp, torch.from_numpy(prompt).long(), tc)
    assert tt.tolist() == np.asarray(jt).tolist()
    for li in range(cfg.num_layers):
        assert tc["blocks"][li]["len"] == int(jc["blocks"]["len"][li]) == 41
        for key in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][li][key][:, :41].numpy(),
                                       np.asarray(jc["blocks"][key][li][:, :41]),
                                       atol=LOGIT_ATOL)
    jlast, _ = jtf.prefill(jqp, cfg, jnp.asarray(prompt[:, :16]),
                           jtf.init_caches(cfg, 2, 64, jnp.float32))
    tlast, _ = ttf.prefill(tqp, tcfg, torch.from_numpy(prompt[:, :16]).long(),
                           ttf.init_caches(tcfg, 2, 64, torch.float32, "cpu"))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=LOGIT_ATOL)
    assert tlog.shape == (2, 1, cfg.vocab)


@pytest.mark.parametrize("prompt_len,max_new", [(9, 8), (37, 12), (520, 6)])
def test_quantized_generate_matches_reference_int8_tokens(model, prompt_len, max_new):
    """Greedy tokens equal to what the reference emits on the same int8
    params, run op by op (``jax.disable_jit``; 520 tokens take the flash
    branch of both prefills).  The reference's jitted ``generate`` is not
    the oracle: XLA's fusions (an FMA where the eager ops round twice)
    move an activation code at a near-tie, and at 37 tokens its own
    jitted and eager runs part at a token whose top-2 margin is 0.0034."""
    cfg, jqp, tcfg, _, tqp = model
    prompt = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (2, prompt_len)).astype(np.int32)
    max_len = prompt_len + max_new
    with jax.disable_jit():
        want = np.asarray(jstep.generate(jqp, cfg, jnp.asarray(prompt), max_new=max_new,
                                         max_len=max_len, dtype=jnp.float32))
    got = tstep.generate(tqp, tcfg, torch.from_numpy(prompt).long(), max_new=max_new,
                         max_len=max_len, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# int8 KV pools
# ---------------------------------------------------------------------------


def _pools_equal(tblocks, jblocks):
    for tp, jp in zip(tblocks, jblocks):
        assert set(tp) == set(jp)
        for key in jp:
            n = jp[key].shape[1]
            assert tp[key].shape[1] == n + 1, "one sink page (and scale column) more"
            np.testing.assert_array_equal(tp[key][:, :n].numpy(), np.asarray(jp[key]))


def test_int8_pool_writers_match_reference(model):
    """``write_prompt_pages`` (a full write, then a page-aligned
    suffix-only write over other data), ``fork_page``,
    ``seed_prefix_dense`` and ``find_nonfinite_pages`` on int8 pools:
    codes and scales bitwise."""
    cfg, _, tcfg, _, _ = model
    rng = np.random.default_rng(6)
    pg, max_len, n_tok, row_lo = 8, 64, 37, 16
    jc = jkv.init_paged_caches(cfg, 2, max_len, jnp.float32, page_size=pg,
                               num_pages=20, kv_dtype="int8")
    tc = tkv.init_paged_caches(tcfg, 2, max_len, torch.float32, page_size=pg,
                               num_pages=20, kv_dtype="int8", device="cpu")
    pool = tc["blocks"][0]
    assert pool["k_scales"].shape == (cfg.kv_heads, 21) and pool["k_scales"].dtype == torch.float32
    assert pool["k_pages"].dtype == torch.int8
    assert tkv.page_bytes(tcfg, pg, "int8") == jkv.page_bytes(cfg, pg, "int8")
    assert tkv.pool_pages_for_bytes(tcfg, 10 ** 6, pg, "int8") == jkv.pool_pages_for_bytes(
        cfg, 10 ** 6, pg, "int8")
    # recycled garbage in the pools, identical in both
    jblocks = []
    for li in range(cfg.num_layers):
        jp = {}
        for key in ("k_pages", "v_pages"):
            arr = rng.integers(-127, 128, jc["blocks"][li][key].shape).astype(np.int8)
            tc["blocks"][li][key][:, :20] = torch.from_numpy(arr)
            jp[key] = jnp.asarray(arr)
        for key in ("k_scales", "v_scales"):
            arr = rng.uniform(1e-3, 1e-1, jc["blocks"][li][key].shape).astype(np.float32)
            tc["blocks"][li][key][:, :20] = torch.from_numpy(arr)
            jp[key] = jnp.asarray(arr)
        jblocks.append(jp)
    row = np.full((max_len // pg,), -1, np.int32)
    row[:6] = [7, 2, 11, 0, 19, 4]  # page 4 lies past the prompt: eps scale
    t = 48
    dense = [rng.standard_normal((2, 1, t, cfg.kv_heads, cfg.head_dim)).astype(np.float32)
             for _ in range(cfg.num_layers)]
    jdense = {"k": jnp.asarray(np.stack([d[0] for d in dense])),
              "v": jnp.asarray(np.stack([d[1] for d in dense]))}
    tdense = [{"k": torch.from_numpy(d[0]), "v": torch.from_numpy(d[1])} for d in dense]
    jb = jkv.write_prompt_pages(jblocks, jdense, jnp.asarray(row), n_tok)
    tkv.write_prompt_pages(tc["blocks"], tdense, torch.from_numpy(row), n_tok)
    _pools_equal(tc["blocks"], jb)
    np.testing.assert_array_equal(tc["blocks"][0]["k_scales"][:, 4].numpy(),
                                  np.full(cfg.kv_heads, 1e-12 / 127, np.float32))
    jdense2 = {k: v * 3 for k, v in jdense.items()}
    tdense2 = [{k: v * 3 for k, v in d.items()} for d in tdense]
    jb = jkv.write_prompt_pages(jb, jdense2, jnp.asarray(row), n_tok, 0, row_lo)
    scales_below = tc["blocks"][1]["v_scales"][:, [7, 2]].clone()
    tkv.write_prompt_pages(tc["blocks"], tdense2, torch.from_numpy(row), n_tok, row_lo=row_lo)
    _pools_equal(tc["blocks"], jb)
    assert torch.equal(tc["blocks"][1]["v_scales"][:, [7, 2]], scales_below)
    jb = jkv.fork_page(jb, jnp.int32(11), jnp.int32(5))
    tkv.fork_page(tc["blocks"], 11, 5)
    _pools_equal(tc["blocks"], jb)
    jd = jtf.init_caches(cfg, 1, t, jnp.float32)
    td = ttf.init_caches(tcfg, 1, t, torch.float32, "cpu")
    jd = jkv.seed_prefix_dense(jd, jb, jnp.asarray(row), jnp.int32(29))
    tkv.seed_prefix_dense(td, tc["blocks"], torch.from_numpy(row), 29)
    for li in range(cfg.num_layers):
        assert td["blocks"][li]["len"] == int(jd["blocks"]["len"][li]) == 29
        for key in ("k", "v"):
            np.testing.assert_array_equal(td["blocks"][li][key].numpy(),
                                          np.asarray(jd["blocks"][key][li]))
    # a NaN scale poisons its page; int8 codes are skipped; the sink is not served
    jb = [dict(p) for p in jb]
    jb[1]["v_scales"] = jb[1]["v_scales"].at[0, 3].set(jnp.nan)
    jb[0]["k_scales"] = jb[0]["k_scales"].at[1, 17].set(jnp.inf)
    tc["blocks"][1]["v_scales"][0, 3] = float("nan")
    tc["blocks"][0]["k_scales"][1, 17] = float("inf")
    tc["blocks"][0]["v_scales"][0, 20] = float("nan")  # the sink
    assert tkv.find_nonfinite_pages(tc["blocks"]) == jkv.find_nonfinite_pages(jb) == [3, 17]


def test_quant_page_update_matches_reference():
    """Decode writes into int8 pages, bitwise: a recycled page whose loud
    garbage must not reach the new scale, a range-growing row that
    re-rounds the page, a row inside the range, and an inactive slot
    whose write lands on the sink (the reference drops it)."""
    rng = np.random.default_rng(7)
    hkv, num_pages, pg, w = 2, 5, 8, 16
    pages = rng.integers(-127, 128, (hkv, num_pages, pg, w)).astype(np.int8)
    pages[:, 2] = 127  # loud garbage
    pages[:, 3, 0, 0] = 127  # page 3 spans its scale's whole range
    scales = rng.uniform(1e-2, 1e-1, (hkv, num_pages)).astype(np.float32)
    scales[:, 2] = 10.0
    page = np.array([2, 0, 3, num_pages], np.int32)
    slot = np.array([0, 5, 7, 3], np.int32)
    row = rng.standard_normal((hkv, 4, w)).astype(np.float32)
    row[:, 1] *= 10.0  # grows page 0's range
    row[:, 2] *= 1e-3  # inside page 3's range
    jp, js = jkv.quant_page_update(jnp.asarray(pages), jnp.asarray(scales), jnp.asarray(page),
                                   jnp.asarray(slot), jnp.asarray(row))
    tpages = torch.zeros((hkv, num_pages + 1, pg, w), dtype=torch.int8)
    tscales = torch.zeros((hkv, num_pages + 1), dtype=torch.float32)
    tpages[:, :num_pages] = torch.from_numpy(pages)
    tscales[:, :num_pages] = torch.from_numpy(scales)
    out = tkv.quant_page_update(tpages, tscales, torch.from_numpy(page).long(),
                                torch.from_numpy(slot).long(), torch.from_numpy(row))
    assert out[0] is tpages and out[1] is tscales, "updated in place"
    np.testing.assert_array_equal(tpages[:, :num_pages].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(tscales[:, :num_pages].numpy()), _bits(js))
    np.testing.assert_allclose(tscales[:, 2].numpy(), np.abs(row[:, 0]).max(-1) / 127, rtol=1e-6)
    assert not tpages[:, 2, 1:].any(), "rows past the write slot are zeroed"
    np.testing.assert_array_equal(tpages[:, 3, :7].numpy(), pages[:, 3, :7])
    np.testing.assert_array_equal(tpages[:, 1].numpy(), pages[:, 1])
    assert tpages[:, num_pages].any(), "the inactive slot's write went to the sink"


def test_int8_paged_decode_and_verify_steps_match_reference(model):
    """Quantized params on int8 pools filled with the same codes and
    scales; slots at fills 5, 0 (inactive), 19 and 30; one decode step,
    then a 3-token verify step (tokens inserted one by one).  Logits
    within the tolerance above, lens equal, pools within one code step."""
    cfg, jqp, tcfg, _, tqp = model
    rng = np.random.default_rng(8)
    pg, max_len, num_pages = 8, 48, 24
    jc = jkv.init_paged_caches(cfg, 4, max_len, jnp.float32, page_size=pg,
                               num_pages=num_pages, kv_dtype="int8")
    tc = tkv.init_paged_caches(tcfg, 4, max_len, torch.float32, page_size=pg,
                               num_pages=num_pages, kv_dtype="int8", device="cpu")
    fills = [5, 0, 19, 30]
    perm = rng.permutation(num_pages)
    bt = -np.ones((4, max_len // pg), np.int32)
    nxt = 0
    for i, n in enumerate(fills):
        if n:
            k = -(-(n + 4) // pg)
            bt[i, :k] = perm[nxt:nxt + k]
            nxt += k
    jblocks = []
    for li in range(cfg.num_layers):
        jp = {}
        for key in ("k_pages", "v_pages"):
            arr = rng.integers(-127, 128, jc["blocks"][li][key].shape).astype(np.int8)
            tc["blocks"][li][key][:, :num_pages] = torch.from_numpy(arr)
            jp[key] = jnp.asarray(arr)
        for key in ("k_scales", "v_scales"):
            arr = rng.uniform(5e-3, 2e-2, jc["blocks"][li][key].shape).astype(np.float32)
            tc["blocks"][li][key][:, :num_pages] = torch.from_numpy(arr)
            jp[key] = jnp.asarray(arr)
        jblocks.append(jp)
    jcache = {"blocks": jblocks, "block_tables": jnp.asarray(bt),
              "lens": jnp.asarray(fills, jnp.int32)}
    tcache = {"blocks": tc["blocks"], "block_tables": torch.from_numpy(bt),
              "lens": torch.tensor(fills, dtype=torch.int32)}
    tok = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
    jl, jcache = jtf.decode_step(jqp, cfg, jnp.asarray(tok), jcache)
    tl, tcache = ttf.decode_step(tqp, tcfg, torch.from_numpy(tok).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    assert tcache["lens"].tolist() == np.asarray(jcache["lens"]).tolist() == [6, 0, 20, 31]
    toks = rng.integers(0, cfg.vocab, (4, 3)).astype(np.int32)
    jl, jcache2 = jtf.verify_step(jqp, cfg, jnp.asarray(toks), jcache)
    tl, tcache2 = ttf.verify_step(tqp, tcfg, torch.from_numpy(toks).long(), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(np.argmax(tl.numpy(), -1), np.argmax(np.asarray(jl), -1))
    for tp, jp in zip(tcache2["blocks"], jcache2["blocks"]):
        assert set(tp) == set(jp)
        for key in ("k_pages", "v_pages"):
            diff = tp[key][:, :num_pages].int().numpy() - np.asarray(jp[key]).astype(np.int32)
            assert np.abs(diff).max() <= 1
        for key in ("k_scales", "v_scales"):
            np.testing.assert_allclose(tp[key][:, :num_pages].numpy(), np.asarray(jp[key]),
                                       rtol=1e-5)
