"""The port's pipeline runtime (``repro_torch.dist.pipeline`` and the
pipelined ``train.step``) on the CPU.

* Against the port's own single-device functions: the pipelined forward
  within 1e-5 of max|logit| of ``transformer.forward`` (qwen3 on uneven
  cuts and a data axis, fewer microbatches than stages, deepseek below
  capacity with the MoE warning, zamba2 on uneven group cuts); the
  pipelined loss within 1e-5 (relative) and every gradient leaf within
  1e-4 of its max of ``value_and_grad(make_loss_fn(cfg, remat))``, after
  unpadding; padding rows' gradients exactly zero.
* GPipe and 1F1B bitwise equal (loss and every gradient leaf); each
  executor's ``counts`` equal to ``pipeline_bubble_counts``.
* ``pad`` / ``unpad`` / ``repad`` bitwise to the reference's
  ``pad_pipeline_params`` after ``convert.params_from_numpy``; padding
  rows independent tensors.
* Against the reference's own pipeline: one subprocess runs
  ``repro.dist.pipeline`` on 4 fake CPU devices
  (``--xla_force_host_platform_device_count=4``) on Auto-axis
  ``jax.sharding.Mesh`` meshes (1, 4) and (2, 2) with uneven cuts, in
  both schedules, and saves its logits, losses and grads; the port's
  multi-stage pipeline on a mesh that lists the CPU four times is held to
  them: logits within 1e-4 of max|logit|, loss within 1e-5, grads within
  1e-4 of each leaf's max.  (``jax.make_mesh`` gives Explicit axes under
  the installed JAX, which the reference's shard_map pipeline rejects:
  that is why ``tests/test_dist.py::TestPipeline`` is red.)

Params come from the reference's init through ``convert`` where the
reference is compared, else from the port's seeded init.
"""

import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.dist import pipeline as jpl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.partition import partition_layers  # noqa: E402
from repro_torch.dist import pipeline as pl  # noqa: E402
from repro_torch.dist.sharding import Mesh  # noqa: E402
from repro_torch.ft.elastic import make_mesh_for  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

CPU = torch.device("cpu")
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5, 1e-4
REF_LOGIT_TOL = 1e-4
SMALL = dict(num_layers=6, d_model=64, vocab=256)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The pipe runs many small ops: one intra-op thread, so that parallel
    test workers do not oversubscribe the cores (their barriers then cost
    more than the ops)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh(data, model):
    return make_mesh_for([CPU] * (data * model), model_axis=model)


def _params(cfg, seed=0):
    return ttf.init(cfg, generator=torch.Generator().manual_seed(seed), dtype=torch.float32,
                    device="cpu")


def _tokens(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).long()


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _cfg(arch="qwen3_0p6b", **kw):
    return get_config(arch).scaled_down(**dict(SMALL, **kw))


# ---------------------------------------------------------------------------
# forward pipe against transformer.forward
# ---------------------------------------------------------------------------

FORWARD = [
    ("qwen3_uneven_1x4", "qwen3_0p6b", {}, (1, 4), (0, 1, 3, 5, 6), 4),
    ("qwen3_uneven_2x2", "qwen3_0p6b", {}, (2, 2), (0, 2, 6), 4),
    ("qwen3_m_lt_stages", "qwen3_0p6b", {}, (1, 4), (0, 1, 3, 5, 6), 2),
    ("qwen3_even_default", "qwen3_0p6b", {}, (1, 2), None, 8),
    ("deepseek_below_capacity", "deepseek_v2_236b", dict(num_layers=4), (1, 4), None, 4),
    ("zamba2_group_cuts", "zamba2_2p7b", dict(num_layers=8, attn_every=2), (2, 2), (0, 1, 4), 2),
]


@pytest.mark.parametrize("name,arch,kw,shape,bounds,m", FORWARD, ids=[c[0] for c in FORWARD])
def test_forward_matches_transformer(name, arch, kw, shape, bounds, m):
    cfg = _cfg(arch, **kw)
    if cfg.moe_experts:
        # capacity factor E / k makes the global capacity provably dropless
        cfg = _cfg(arch, **kw, moe_capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    params = _params(cfg)
    tok = _tokens(cfg, 8, 16)
    want, _ = ttf.forward(params, cfg, tok)
    padded = pl.pad_pipeline_params(params, cfg, bounds) if bounds else params
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fwd = pl.make_pipeline_forward(cfg, _mesh(*shape), m, bounds)
    assert any("capacity" in str(x.message) for x in w) == bool(cfg.moe_experts)
    got = fwd(padded, tok)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got, want) <= LOGIT_TOL
    assert fwd.counts == pl.pipeline_bubble_counts(shape[1], m, "forward")


# ---------------------------------------------------------------------------
# train pipe: schedules bitwise, against value_and_grad, counts
# ---------------------------------------------------------------------------

TRAIN = [
    ("qwen3_uneven_1x4", "qwen3_0p6b", {}, (1, 4), (0, 1, 3, 5, 6), 4, True),
    ("qwen3_uneven_2x2", "qwen3_0p6b", {}, (2, 2), (0, 2, 6), 4, True),
    ("qwen3_no_remat", "qwen3_0p6b", {}, (1, 2), (0, 4, 6), 2, False),
    ("qwen3_m_lt_stages", "qwen3_0p6b", {}, (1, 4), (0, 2, 3, 4, 6), 2, True),
    ("qwen3_nondivisible_dp", "qwen3_0p6b", {}, (4, 1), None, 4, True),
    ("starcoder2_untied_bias", "starcoder2_15b", {}, (1, 2), (0, 2, 6), 4, True),
    ("deepseek_one_microbatch", "deepseek_v2_236b", dict(num_layers=4), (1, 2), (0, 1, 4), 1,
     True),
]


@pytest.mark.parametrize("name,arch,kw,shape,bounds,m,remat", TRAIN,
                         ids=[c[0] for c in TRAIN])
def test_loss_and_grad_schedules(name, arch, kw, shape, bounds, m, remat):
    """GPipe == 1F1B bitwise; both within tolerance of the single-device
    value_and_grad (an MoE aux loss is a mean over microbatches, so the
    MoE case runs one microbatch); padding rows' grads exactly zero."""
    cfg = _cfg(arch, **kw)
    params = _params(cfg)
    b = 4 if name == "qwen3_nondivisible_dp" else 8
    batch = {"tokens": _tokens(cfg, b, 17)}
    padded = pl.pad_pipeline_params(params, cfg, bounds) if bounds else params
    mesh = _mesh(*shape)
    outs = {}
    for sched in ("gpipe", "1f1b"):
        lg = pl.make_pipeline_loss_and_grad(cfg, mesh, m, bounds, sched, remat=remat)
        outs[sched] = lg(padded, batch)
        assert lg.counts == pl.pipeline_bubble_counts(shape[1], m, sched)
    (l1, m1), g1 = outs["gpipe"]
    (l2, m2), g2 = outs["1f1b"]
    assert torch.equal(l1, l2) and all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))

    (rl, rm), rg = tstep.value_and_grad(tstep.make_loss_fn(cfg, remat=remat), params, batch)
    assert abs(float(l2) - float(rl)) <= LOSS_RTOL * abs(float(rl))
    assert abs(float(m2["ce"]) - float(rm["ce"])) <= LOSS_RTOL * abs(float(rm["ce"]))
    unpadded = pl.unpad_pipeline_params(g2, cfg, bounds) if bounds else g2
    for (path, a), (_, w) in zip(flatten_with_path(unpadded), flatten_with_path(rg)):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert _rel(a, w) <= GRAD_TOL, path
    real = {id(x) for x in leaves(unpadded)}
    pads = [x for x in leaves(g2["blocks"]) if id(x) not in real]
    assert all(not x.any() for x in pads)
    if bounds and len(set(np.diff(bounds))) > 1:
        assert pads


def test_attention_grads_nonzero_through_pipe():
    cfg = _cfg()
    params = _params(cfg)
    bounds = (0, 1, 3, 5, 6)
    lg = pl.make_pipeline_loss_and_grad(cfg, _mesh(1, 4), 4, bounds)
    _, g = lg(pl.pad_pipeline_params(params, cfg, bounds), {"tokens": _tokens(cfg, 8, 17)})
    for path, x in flatten_with_path(pl.unpad_pipeline_params(g, cfg, bounds)["blocks"]):
        if path[-2] in ("wq", "wk", "wv", "q_norm", "k_norm"):
            assert x.abs().max() > 0, path


@pytest.mark.parametrize("stages,m", [(1, 1), (2, 1), (2, 3), (3, 2), (4, 4), (4, 6)])
def test_schedule_counts_match_oracle(stages, m):
    cfg = get_config("qwen3_0p6b").scaled_down(num_layers=stages + 1, d_model=32, vocab=64)
    params = _params(cfg)
    mesh = _mesh(1, stages)
    bounds = partition_layers([1.0] * (stages + 1), stages)
    padded = pl.pad_pipeline_params(params, cfg, bounds)
    tok = _tokens(cfg, m, 9)
    fwd = pl.make_pipeline_forward(cfg, mesh, m, bounds)
    fwd(padded, tok[:, :-1])
    assert fwd.counts == pl.pipeline_bubble_counts(stages, m, "forward")
    for sched in ("gpipe", "1f1b"):
        lg = pl.make_pipeline_loss_and_grad(cfg, mesh, m, bounds, sched)
        lg(padded, {"tokens": tok})
        assert lg.counts == pl.pipeline_bubble_counts(stages, m, sched)


def test_refusals():
    mesh = _mesh(1, 2)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        pl.make_pipeline_forward(get_config("seamless_m4t_large_v2").scaled_down(), mesh, 2)
    for arch in ("zamba2_2p7b", "seamless_m4t_large_v2"):
        with pytest.raises(NotImplementedError, match="homogeneous decoder stacks"):
            pl.make_pipeline_loss_and_grad(get_config(arch).scaled_down(), mesh, 2)
    with pytest.raises(NotImplementedError, match="token-only"):
        pl.make_pipeline_loss_and_grad(get_config("internvl2_76b").scaled_down(), mesh, 2)
    cfg = _cfg()
    with pytest.raises(ValueError, match="unknown schedule"):
        pl.make_pipeline_loss_and_grad(cfg, mesh, 2, schedule="zb")
    with pytest.raises(ValueError, match="boundaries for 2 stages"):
        pl.make_pipeline_forward(cfg, mesh, 2, (0, 6))
    with pytest.raises(ValueError, match="boundaries end at 5"):
        pl.make_pipeline_forward(cfg, mesh, 2, (0, 2, 5))
    with pytest.raises(ValueError, match="at least one microbatch"):
        pl.make_pipeline_forward(cfg, mesh, 0)
    params = _params(cfg)
    fwd = pl.make_pipeline_forward(cfg, mesh, 3, (0, 1, 6))
    with pytest.raises(ValueError, match="not divisible by 3 microbatches"):
        fwd(pl.pad_pipeline_params(params, cfg, (0, 1, 6)), _tokens(cfg, 4, 8))
    with pytest.raises(ValueError, match="pad uneven cuts"):
        pl.make_pipeline_forward(cfg, mesh, 2, (0, 1, 6))(params, _tokens(cfg, 4, 8))


# ---------------------------------------------------------------------------
# pad / unpad / repad against the reference's pad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw,bounds", [
    ("qwen3_0p6b", {}, (0, 1, 3, 5, 6)),
    ("qwen3_0p6b", {}, (0, 3, 6)),
    ("zamba2_2p7b", dict(num_layers=8, attn_every=2), (0, 1, 4)),
    ("deepseek_v2_236b", dict(num_layers=3), (0, 2, 3)),
])
def test_pad_unpad_bitwise_to_reference(arch, kw, bounds):
    jcfg = jget_config(arch).scaled_down(**dict(SMALL, **kw))
    cfg = get_config(arch).scaled_down(**dict(SMALL, **kw))
    jp = jax.jit(lambda key: jtf.init(key, jcfg, jnp.float32))(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jpad = jpl.pad_pipeline_params(jp, jcfg, bounds)
    n_pad = jax.tree.leaves(jpad["blocks"])[0].shape[0]
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jpad),
                                     cfg.scaled_down(num_layers=n_pad), "cpu")
    got = pl.pad_pipeline_params(params, cfg, bounds)
    assert len(got["blocks"]) == n_pad
    for (pa, a), (pb, b) in zip(flatten_with_path(got), flatten_with_path(want)):
        assert pa == pb and torch.equal(a, b), pa
    # padding rows are new tensors: no storage appears twice in the tree
    ptrs = [x.data_ptr() for x in leaves(got)]
    assert len(set(ptrs)) == len(ptrs)
    back = pl.unpad_pipeline_params(got, cfg, bounds)
    assert all(a is b for a, b in zip(leaves(back), leaves(params)))
    jback = jpl.unpad_pipeline_params(jpad, jcfg, bounds)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jp)))


def test_pipeline_state_pad_unpad_repad():
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    old, new = (0, 1, 3, 5, 6), (0, 2, 6)
    state = tstep.init_pipeline_state(cfg, old, generator=gen, dtype=torch.float32,
                                      device="cpu")
    assert len(state["params"]["blocks"]) == 4 * 2
    assert len(state["opt"].mu["blocks"]) == len(state["opt"].nu["blocks"]) == 8
    flat = tstep.unpad_pipeline_state(state, cfg, old)
    assert len(flat["params"]["blocks"]) == cfg.num_layers
    moved = tstep.repad_pipeline_state(state, cfg, old, new)
    assert len(moved["params"]["blocks"]) == 2 * 4
    again = tstep.unpad_pipeline_state(moved, cfg, new)
    for a, b in zip(leaves(again), leaves(flat)):
        assert torch.equal(a, b)
    assert tstep.pad_pipeline_state(flat, cfg, (0, 3, 6))["params"] is flat["params"]


def test_pipeline_train_step_against_single_device():
    """Two pipelined AdamW steps: finite, the first step's loss and the
    updated real layers within tolerance of make_train_step's."""
    cfg = _cfg()
    params = _params(cfg)
    bounds = (0, 1, 3, 5, 6)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = tstep.make_pipeline_train_step(cfg, opt, _mesh(1, 4), num_microbatches=4,
                                          boundaries=bounds)
    state = tstep.make_state(pl.pad_pipeline_params(params, cfg, bounds))
    ref_step = tstep.make_train_step(cfg, opt)
    ref = tstep.make_state(params)
    for i in range(2):
        batch = {"tokens": _tokens(cfg, 8, 17, seed=10 + i)}
        state, met = step(state, batch)
        ref, rmet = ref_step(ref, batch)
        assert np.isfinite(float(met["loss"])) and np.isfinite(float(met["grad_norm"]))
        assert abs(float(met["loss"]) - float(rmet["loss"])) <= 1e-5 * abs(float(rmet["loss"]))
    assert int(state["step"]) == 2
    got = pl.unpad_pipeline_params(state["params"], cfg, bounds)
    for (path, a), (_, b) in zip(flatten_with_path(got), flatten_with_path(ref["params"])):
        assert float((a - b).abs().max()) <= 1e-5, path
    assert step.loss_and_grad.counts == pl.pipeline_bubble_counts(4, 4, "1f1b")


def test_train_step_refuses_distinct_stage_devices():
    """Stages on distinct devices in one process now build a train step
    (the grad norm sums on the first stage's device); one process on a
    data axis over distinct devices is still refused (one process per data
    position runs it)."""
    meta = torch.device("meta")
    stages = Mesh(np.array([CPU, meta], dtype=object).reshape(1, 2), ("data", "model"))
    step = tstep.make_pipeline_train_step(_cfg(), AdamWConfig(), stages, num_microbatches=2)
    assert callable(step) and callable(step.loss_and_grad)
    data = Mesh(np.array([CPU, CPU, meta, meta], dtype=object).reshape(2, 2),
                ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 16"):
        tstep.make_pipeline_train_step(_cfg(), AdamWConfig(), data, num_microbatches=2)


# ---------------------------------------------------------------------------
# against the reference's own pipeline on 4 fake CPU devices
# ---------------------------------------------------------------------------

REF_CASES = {"1x4": ((1, 4), (0, 1, 3, 5, 6)), "2x2": ((2, 2), (0, 2, 6))}

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.dist.pipeline import (make_pipeline_forward, make_pipeline_loss_and_grad,
                                 pad_pipeline_params)
from repro.models import transformer as tf

cfg = get_config("qwen3_0p6b").scaled_down(num_layers=6, d_model=64, vocab=256)
params = tf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
tokens = np.random.default_rng(0).integers(0, cfg.vocab, (8, 17)).astype(np.int32)
res = {"tokens": tokens}
for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["params" + jax.tree_util.keystr(k)] = np.asarray(v)
for tag, ((d, m), bounds) in CASES.items():
    # Auto axes: jax.make_mesh's Explicit axes are refused by the pipeline
    mesh = Mesh(np.array(jax.devices()).reshape(d, m), ("data", "model"))
    padded = pad_pipeline_params(params, cfg, bounds)
    with mesh:
        fwd = make_pipeline_forward(cfg, mesh, 4, boundaries=bounds)
        res[tag + "/logits"] = np.asarray(jax.jit(fwd)(padded, jnp.asarray(tokens[:, :-1])))
        for sched in ("gpipe", "1f1b"):
            lg = make_pipeline_loss_and_grad(cfg, mesh, 4, boundaries=bounds, schedule=sched)
            (loss, _), grads = jax.jit(lg)(padded, {"tokens": jnp.asarray(tokens)})
            res[tag + "/" + sched + "/loss"] = np.asarray(loss)
            for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
                res[tag + "/" + sched + "/grads" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(sys.argv[1], **res)
print("REF_PIPELINE_OK")
"""


@pytest.fixture(scope="module")
def reference_pipeline(tmp_path_factory):
    """The reference's pipeline outputs, from one 4-fake-device subprocess
    (the device override must not leak into this process)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("ref_pipeline") / "ref.npz"
    code = f"CASES = {REF_CASES!r}\n" + _REF_SCRIPT
    r = subprocess.run(
        [sys.executable, "-c", code, str(out)], capture_output=True, text=True,
        env={"PYTHONPATH": os.path.join(repo, "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": "cpu"},
        cwd=repo, timeout=300)
    assert "REF_PIPELINE_OK" in r.stdout, r.stdout + r.stderr
    return dict(np.load(out))


def _nest(z, prefix):
    """The reference's flattened tree under ``prefix`` as nested dicts."""
    out = {}
    for key, val in z.items():
        if not key.startswith(prefix):
            continue
        names = re.findall(r"\['([^']+)'\]", key[len(prefix):])
        node = out
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = val
    return out


@pytest.mark.parametrize("what", ["logits", "gpipe", "1f1b"])
@pytest.mark.parametrize("tag", list(REF_CASES))
def test_matches_reference_pipeline(reference_pipeline, tag, what):
    z = reference_pipeline
    cfg = _cfg()
    (d, m), bounds = REF_CASES[tag]
    params = convert.params_from_numpy(_nest(z, "params"), cfg, "cpu")
    padded = pl.pad_pipeline_params(params, cfg, bounds)
    tok = torch.from_numpy(z["tokens"]).long()
    mesh = _mesh(d, m)
    if what == "logits":
        got = pl.make_pipeline_forward(cfg, mesh, 4, bounds)(padded, tok[:, :-1])
        want = torch.from_numpy(z[f"{tag}/logits"])
        assert _rel(got, want) <= REF_LOGIT_TOL
        return
    lg = pl.make_pipeline_loss_and_grad(cfg, mesh, 4, bounds, what)
    (loss, _), grads = lg(padded, {"tokens": tok})
    want_loss = float(z[f"{tag}/{what}/loss"])
    assert abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss)
    want = convert.params_from_numpy(_nest(z, f"{tag}/{what}/grads"),
                                     cfg.scaled_down(num_layers=len(padded["blocks"])), "cpu")
    for (path, a), (_, b) in zip(flatten_with_path(grads), flatten_with_path(want)):
        assert _rel(a, b) <= GRAD_TOL if b.abs().max() > 0 else not a.any(), path
