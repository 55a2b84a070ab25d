"""Tensor and expert parallelism over the 'model' axis: one process per mesh
position (``dist.collective.mesh_groups``, ``dist.tensor``), gloo on the
CPU, and MoE routing across the data positions.

* Training (float32, S 32, global batch 8, grad_accum 2, two AdamW steps,
  the reference's params and batches): qwen3_0p6b ``scaled_down()`` under
  ai_core_assignment on (1, 2) and (1, 4) (K / V split inside a head) and
  fused on (2, 2) (FSDP x TP); mixtral_8x22b under fused on (2, 2) (EP,
  routing across 2 data positions); deepseek_v2_236b under
  ai_core_assignment on (1, 4) (MLA's latent split, one expert a rank) and
  scatter_gather on (2, 1) at capacity factor 0.75, where the reference
  drops choices (MoE across data processes, no TP).  Each is held to the
  reference's jitted step on an Auto-axis mesh of the same shape over 4
  fake CPU devices (one JAX subprocess) and to the port's one-process
  step: loss and ``grad_norm`` within 1e-5 (relative) at both steps.
  Params after step 2: within 1e-5 of the one-process port's wherever
  both steps' one-process gradients clear ``GRAD_FLOOR`` (100 x AdamW's
  eps); below it AdamW's ``g / (|g| + eps)`` turns the all-reduces'
  summation order into differences up to ~6e-5 (printed, with their
  count), as it puts the one-process port ~2e-5 from the reference;
  and no more than 1e-5 farther from the reference's than the
  one-process port's own params are there.  Every process holds exactly
  the slices the reference's sharded state holds (its ``shard_shape``),
  with values equal to the gathered tree's slice.  Routing (``gate_idx``,
  ``keep``) is identical across each model group; at factor 0.75 the kept
  set equals the reference's, some choices drop, and routing each
  process's rows alone would drop another set.  The router's gradient
  across data processes (aux weight 1, the load-balancing loss's path)
  equals one process's.
* Serving: ``launch.serve.run_static`` (f32) on (1, 2) and (2, 2): tokens
  equal to the one-process run's except at a top-2 margin below 1e-5
  (printed), logits within 1e-5 of max|logit|.
* ``dist.tensor``'s four Functions and ``sum_across`` on 2 gloo
  processes, forward and backward against the whole computation,
  including both adjoints of ``gather``; the launchers under ``torchrun
  --nproc-per-node 4`` on the CPU, a world of another size refused
  naming both commands.

The children are spawned fresh (``collective.spawn``: one spawn per mesh
shape running every case on it, a file store under the test's temporary
directory, every child joined within a timeout).
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.dist import collective  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.dist import tensor as tp  # noqa: E402
from repro_torch.ft.elastic import make_mesh_for, state_shardings  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

CPU = torch.device("cpu")
RTOL, PARAM_TOL, MARGIN_TOL = 1e-5, 1e-5, 1e-5
#: one-process gradients below this (100 x AdamW's eps) make AdamW's
#: first updates amplify summation order
GRAD_FLOOR = 1e-6
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
B, S, GA, STEPS = 8, 32, 2, 2
#: the capacity factor at which the reference drops choices
DROP_FACTOR = 0.75
#: case -> (arch, strategy, mesh shape, capacity factor or None)
CASES = {
    "qwen3_ai_1x2": ("qwen3_0p6b", "ai_core_assignment", (1, 2), None),
    "qwen3_ai_1x4": ("qwen3_0p6b", "ai_core_assignment", (1, 4), None),
    "qwen3_fused_2x2": ("qwen3_0p6b", "fused", (2, 2), None),
    "mixtral_fused_2x2": ("mixtral_8x22b", "fused", (2, 2), None),
    "deepseek_ai_1x4": ("deepseek_v2_236b", "ai_core_assignment", (1, 4), None),
    "deepseek_sg_2x1": ("deepseek_v2_236b", "scatter_gather", (2, 1), DROP_FACTOR),
}
SHAPES = sorted({c[2] for c in CASES.values()})
SPAWN_TIMEOUT = 240
SERVE_NEW, SERVE_CHUNK = 8, 16

_REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.dist.sharding import data_specs, param_specs
from repro.optim.adamw import AdamWConfig, OptState
from repro.train.step import init_state, make_loss_fn, make_train_step

opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
res = {}


def ns(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def config(arch, cf):
    cfg = get_config(arch).scaled_down()
    return dataclasses.replace(cfg, moe_capacity_factor=cf) if cf else cfg


states = {}
for arch in sorted({c[0] for c in CASES.values()}):
    cfg = config(arch, None)
    states[arch] = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
    for i, t in enumerate(batches):
        res[f"{arch}/tokens{i}"] = t
    for k, v in jax.tree_util.tree_flatten_with_path(states[arch]["params"])[0]:
        res[f"{arch}/params" + jax.tree_util.keystr(k)] = np.asarray(v)

for name, (arch, strategy, (d, m), cf) in CASES.items():
    cfg = config(arch, cf)
    state0 = states[arch]
    batches = [res[f"{arch}/tokens{i}"] for i in range(STEPS)]
    # Auto axes (jax.make_mesh gives Explicit ones)
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
    with mesh:
        ps = param_specs(state0["params"], mesh, strategy)
        ss = {"params": ps, "opt": OptState(mu=ps, nu=ps, step=P()), "step": P()}
        bs = data_specs({"tokens": jnp.asarray(batches[0])}, mesh)
        step = jax.jit(make_train_step(cfg, opt, grad_accum=GA),
                       in_shardings=(ns(mesh, ss), ns(mesh, bs)),
                       out_shardings=(ns(mesh, ss), None))
        state = state0
        for i, t in enumerate(batches):
            state, met = step(state, {"tokens": jnp.asarray(t)})
            res[f"{name}/loss{i}"] = np.asarray(met["loss"])
            res[f"{name}/grad_norm{i}"] = np.asarray(met["grad_norm"])
        for k, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
            key = jax.tree_util.keystr(k)
            res[f"{name}/params" + key] = np.asarray(v)
            res[f"{name}/shard" + key] = np.asarray(v.sharding.shard_shape(v.shape))
    if cf:
        # the routing of step 1's first microbatch, op by op on one device
        calls = []
        top_k = jax.lax.top_k

        def recording(x, k):
            vals, idx = top_k(x, k)
            calls.append(np.asarray(idx))
            return vals, idx

        jax.lax.top_k = recording
        try:
            with jax.disable_jit():
                make_loss_fn(cfg, remat=False)(state0["params"],
                                               {"tokens": jnp.asarray(batches[0][:B // GA])})
        finally:
            jax.lax.top_k = top_k
        for j, idx in enumerate(calls):
            res[f"{name}/route{j}"] = idx
np.savez(sys.argv[1], **res)
print("REF_TP_OK")
"""


def _cfg(arch, cf=None):
    cfg = get_config(arch).scaled_down()
    return dataclasses.replace(cfg, moe_capacity_factor=cf) if cf else cfg


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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's jitted steps on 4 fake CPU devices, one subprocess."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("ref_tp") / "ref.npz"
    code = (f"B, S, GA, STEPS = {B}, {S}, {GA}, {STEPS}\nCASES = {CASES!r}\n"
            + _REF_SCRIPT)
    r = subprocess.run(
        [sys.executable, "-c", code, str(out)], capture_output=True, text=True,
        env={"PYTHONPATH": os.path.join(repo, "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": "cpu"},
        cwd=repo, timeout=400)
    assert "REF_TP_OK" in r.stdout, r.stdout + r.stderr
    return str(out)


def _inputs(ref_path, case):
    arch, _, _, cf = CASES[case]
    z = np.load(ref_path)
    cfg = _cfg(arch, cf)
    params = convert.params_from_numpy(_nest(z, f"{arch}/params"), cfg, "cpu")
    batches = [{"tokens": torch.from_numpy(z[f"{arch}/tokens{i}"]).long()}
               for i in range(STEPS)]
    return cfg, params, batches


def _join(rank, nprocs, init_method, shape):
    d, m = shape
    mesh = make_mesh_for([CPU] * (d * m), model_axis=m)
    if m == 1:
        return mesh, collective.data_group(mesh, init_method=init_method, rank=rank,
                                           world_size=nprocs), None
    return (mesh, *collective.mesh_groups(mesh, init_method=init_method, rank=rank,
                                          world_size=nprocs))


class _Routes:
    """Records every ``moe.dispatch_slots`` call's (gate_idx, keep)."""

    def __init__(self):
        self.calls = []
        self.orig = tmoe.dispatch_slots

    def __enter__(self):
        def recording(exp_flat, *a):
            out = self.orig(exp_flat, *a)
            self.calls.append((exp_flat.clone(), out[1].clone()))
            return out

        tmoe.dispatch_slots = recording
        return self.calls

    def __exit__(self, *exc):
        tmoe.dispatch_slots = self.orig


def _train(case, ref_path, mesh, data, model):
    """Two steps of ``case`` in this process's position: metrics, its
    local leaves, the gathered params and step 1's routing."""
    _, strategy, _, _ = CASES[case]
    cfg, params, batches = _inputs(ref_path, case)
    state = tstep.make_state(params)
    specs = state_shardings(state, mesh, strategy)
    state = tsh.place(state, specs, mesh, data, model)
    shards = tsh.data_shards(specs["params"], mesh) if data is not None else None
    mshards = tsh.model_shards(specs["params"], mesh) if model is not None else None
    step = tstep.make_train_step(cfg, OPT, grad_accum=GA, group=data, shards=shards,
                                 model=model, model_shards=mshards)
    rec = {}
    for i, batch in enumerate(batches):
        with _Routes() as calls:
            state, met = step(state, batch)
        if i == 0:
            # the first microbatch's forward: one call a layer
            rec["routes"] = calls[:cfg.num_layers] if cfg.moe_experts else []
        rec[f"loss{i}"] = met["loss"].item()
        rec[f"grad_norm{i}"] = met["grad_norm"].item()
    rec["local"] = state["params"]
    whole = collective.gather_tree(state["params"], shards, data)
    rec["params"] = collective.gather_tree(whole, mshards, model)
    return rec


def _router_grads(ref_path, data):
    """The mean over the data processes of the grads of one microbatch's
    loss (aux weight 1) at the reference's params, each process on its
    rows with the tokens routed across the group."""
    case = "deepseek_sg_2x1"
    cfg, params, batches = _inputs(ref_path, case)
    mb = {"tokens": batches[0]["tokens"][:B // GA]}
    mine = collective.shard_rows(mb, 1, data.size, data.rank)
    with tp.parallel(routing=data):
        _, grads = tstep.value_and_grad(tstep.make_loss_fn(cfg, aux_weight=1.0), params, mine)
    grads = collective.pmean(grads, data)
    return [blk["ffn"]["router"] for blk in grads["blocks"]]


def _serve(strategy, mesh, data, model, prompts):
    from repro_torch.launch.serve import run_static
    from repro_torch.models import transformer as tf

    cfg = _cfg("qwen3_0p6b")
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                     device="cpu")
    specs = tsh.param_specs(params, mesh, strategy)
    params = tsh.place(params, specs, mesh, data, model)
    params = collective.gather_tree(params, tsh.data_shards(specs, mesh), data)
    res = run_static(params, cfg, prompts, new_tokens=SERVE_NEW, chunk=SERVE_CHUNK,
                     return_logits=True, mesh=mesh, group=data, model=model)
    return {"tokens": res["tokens"], "logits": [x for x in res["logits"]],
            "kv_heads": params["blocks"][0]["mixer"]["wk"]["w"].shape[1] // cfg.head_dim}


def _fn_inputs(rank):
    """Rank ``rank``'s inputs x, w, a (3, 4), and every rank's loss
    weights c (3, 8)."""
    g = torch.Generator().manual_seed(rank)
    x, w, a = (torch.randn(3, 4, generator=g) for _ in range(3))
    c = [torch.randn(3, 8, generator=torch.Generator().manual_seed(100 + r)) for r in range(2)]
    return x, w, c, a


def _functions(model):
    """``dist.tensor``'s Functions on this rank's inputs: forward values
    and the grads of each rank's loss."""
    x, w, c, a = _fn_inputs(model.rank)
    c4 = c[0][:, :4]
    out = {}
    with tp.parallel(model=model):
        xs = x.clone().requires_grad_()
        y = tp.copy(xs) * w
        y.sum().backward()
        out["copy"] = (y.detach(), xs.grad)
        xs = x.clone().requires_grad_()
        y = tp.reduce(xs * w)
        (y * c4).sum().backward()
        out["reduce"] = (y.detach(), xs.grad)
        xs = x.clone().requires_grad_()
        y = tp.gather(xs, 1)
        (y * c[0]).sum().backward()
        out["gather"] = (y.detach(), xs.grad)
        xs = x.clone().requires_grad_()
        y = tp.gather(xs, 1, reduce_grad=True)
        (y * c[model.rank]).sum().backward()
        out["gather_reduce_grad"] = (y.detach(), xs.grad)
    theta = torch.ones(x.shape, requires_grad=True)
    s = tp.sum_across(theta * a, model)
    (s * c4).sum().backward()
    (g,) = collective.pmean([theta.grad], model)
    out["sum_across"] = (s.detach(), g)
    return out


def _child(rank, nprocs, init_method, shape, ref_path, prompts, out_dir):
    torch.set_num_threads(1)
    mesh, data, model = _join(rank, nprocs, init_method, shape)
    rec = {"train": {c: _train(c, ref_path, mesh, data, model)
                     for c, spec in CASES.items() if spec[2] == shape}}
    if shape == (1, 2):
        rec["serve"] = _serve("ai_core_assignment", mesh, data, model, prompts)
        rec["functions"] = _functions(model)
    if shape == (2, 2):
        rec["serve"] = _serve("fused", mesh, data, model, prompts)
    if shape == (2, 1):
        rec["router_grads"] = _router_grads(ref_path, data)
    torch.save(rec, os.path.join(out_dir, f"tp_{rank}.pt"))
    collective.close(data, model)


def _prompts():
    return torch.from_numpy(np.random.default_rng(7).integers(0, 512, (4, 24))).long()


@pytest.fixture(scope="module")
def runs(reference, tmp_path_factory):
    """Every process's records, per mesh shape."""
    out = {}
    for shape in SHAPES:
        d, m = shape
        n = d * m
        path = tmp_path_factory.mktemp(f"tp_{d}x{m}")
        collective.spawn(_child, n, (shape, reference, _prompts(), str(path)),
                         timeout=SPAWN_TIMEOUT, workdir=str(path))
        out[shape] = [torch.load(path / f"tp_{r}.pt") for r in range(n)]
    return out


def _one_process(ref_path, case):
    """The port's one-process step: per-step metrics, the params after
    step 2 and the grads each step's AdamW update took."""
    from repro_torch.optim import adamw

    cfg, params, batches = _inputs(ref_path, case)
    state = tstep.make_state(params)
    step = tstep.make_train_step(cfg, OPT, grad_accum=GA)
    grads = []
    apply = adamw.apply

    def spy(c, p, g, st, norm_fn=adamw.global_norm):
        grads.append(dict(flatten_with_path(g)))
        return apply(c, p, g, st, norm_fn)

    mets = []
    tstep.adamw.apply = spy
    try:
        for batch in batches:
            state, met = step(state, batch)
            mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
    finally:
        tstep.adamw.apply = apply
    return mets, state["params"], grads


@pytest.fixture(scope="module")
def one_process(reference):
    return {case: _one_process(reference, case) for case in CASES}


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def _recs(runs, case):
    return [r["train"][case] for r in runs[CASES[case][2]]]


@pytest.mark.parametrize("case", list(CASES))
def test_train_metrics(runs, reference, one_process, case):
    """Every process reads the same loss and grad norm, within 1e-5 of the
    reference's jitted step on the same mesh and of the one-process port."""
    z = np.load(reference)
    recs = _recs(runs, case)
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            got = [r[f"{key}{i}"] for r in recs]
            assert len(set(got)) == 1, (case, key, i, got)
            ref = float(z[f"{case}/{key}{i}"])
            one = one_process[case][0][i][key]
            assert _close(got[0], ref, RTOL), (case, key, i, got[0], ref)
            assert _close(got[0], one, RTOL), (case, key, i, got[0], one)


@pytest.mark.parametrize("case", list(CASES))
def test_train_params(runs, reference, one_process, case):
    """After step 2 the gathered params are within 1e-5 of the one-process
    port's, and no more than 1e-5 farther from the reference's than its
    own, wherever both steps' gradients clear ``GRAD_FLOOR``; the elements
    below it are printed (module docstring)."""
    arch, _, _, cf = CASES[case]
    cfg = _cfg(arch, cf)
    z = np.load(reference)
    want = dict(flatten_with_path(
        convert.params_from_numpy(_nest(z, f"{case}/params"), cfg, "cpu")))
    _, one, grads = one_process[case]
    one = dict(flatten_with_path(one))
    got = _recs(runs, case)[0]["params"]
    amplified = []
    for path, a in flatten_with_path(got):
        b, r = one[path], want[path]
        assert a.shape == b.shape, path
        clear = (grads[0][path].abs() >= GRAD_FLOOR) & (grads[1][path].abs() >= GRAD_FLOOR)
        err = float(((a - b).abs() * clear).max())
        assert err <= PARAM_TOL, (case, path, err)
        err_ref = float(((a - r).abs() * clear).max())
        own = float(((b - r).abs() * clear).max())
        assert err_ref <= own + PARAM_TOL, (case, path, err_ref, own)
        below = ~clear
        if below.any():
            amplified.append((float(((a - b).abs() * below).max()), int(below.sum()),
                              "/".join(map(str, path))))
    worst = max(amplified, default=(0.0, 0, "-"))
    print(f"{case}: {sum(n for _, n, _ in amplified)} elements below the gradient floor, "
          f"worst {worst[0]:.3e} from one process ({worst[2]})")


def _ref_key(path) -> str:
    """The reference's key of a port leaf (its stacked leaves have no
    layer index)."""
    return "".join(f"['{p}']" for p in path if not isinstance(p, int))


@pytest.mark.parametrize("case", list(CASES))
def test_processes_hold_the_reference_slices(runs, reference, case):
    """Every process holds exactly the reference's shard of each leaf: its
    shape (``shard_shape`` of the reference's sharded state, without the
    stacked layer axis) and the gathered tree's values at its slice."""
    _, strategy, (d, m), _ = CASES[case]
    z = np.load(reference)
    mesh = make_mesh_for([CPU] * (d * m), model_axis=m)
    recs = _recs(runs, case)
    specs = tsh.param_specs(recs[0]["params"], mesh, strategy)
    # a shard is a (dim, n) pair, which a tree walk would take for a node
    paths = [path for path, _ in flatten_with_path(recs[0]["params"])]
    dsh = dict(zip(paths, collective._shard_leaves(tsh.data_shards(specs, mesh))))
    msh = dict(zip(paths, collective._shard_leaves(tsh.model_shards(specs, mesh))))
    for rank, rec in enumerate(recs):
        p, k = divmod(rank, m)
        whole = dict(flatten_with_path(rec["params"]))
        for path, leaf in flatten_with_path(rec["local"]):
            shard = z[f"{case}/shard" + _ref_key(path)]
            want = tuple(int(x) for x in shard[len(shard) - leaf.dim():])
            assert tuple(leaf.shape) == want, (case, rank, path, tuple(leaf.shape), want)
            expect = whole[path]
            for sh, index, count in ((dsh[path], p, d), (msh[path], k, m)):
                if sh is not None:
                    dim, n = sh
                    size = expect.shape[dim] // n
                    expect = expect.narrow(dim, (index // (count // n)) * size, size)
            assert torch.equal(leaf, expect), (case, rank, path)


def _keep(routes, cap):
    """The reference's kept set: token-major positions over the
    microbatch's choices, against ``cap``."""
    flat = routes.reshape(-1)
    onehot = np.eye(int(flat.max()) + 1, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return pos < cap


def test_routing_across_a_model_group(runs):
    """Every rank of a model group routes the same tokens the same way."""
    for case, (arch, _, (d, m), _) in CASES.items():
        if m == 1 or not get_config(arch).moe_experts:
            continue
        recs = _recs(runs, case)
        for p in range(d):
            group = recs[p * m:(p + 1) * m]
            for calls in zip(*[r["routes"] for r in group]):
                assert all(torch.equal(c[0], calls[0][0]) and torch.equal(c[1], calls[0][1])
                           for c in calls), (case, p)


def test_routing_across_data_processes_drops_the_reference_set(runs, reference):
    """At factor 0.75 the kept set over the global microbatch equals the
    reference's, some choices drop, and routing each process's rows alone
    (capacity from its own tokens) would drop another set."""
    case = "deepseek_sg_2x1"
    cfg = _cfg("deepseek_v2_236b", DROP_FACTOR)
    z = np.load(reference)
    recs = _recs(runs, case)
    n = (B // GA) * S
    for layer in range(cfg.num_layers):
        ref_idx = z[f"{case}/route{layer}"]
        got_idx = np.concatenate([r["routes"][layer][0].numpy() for r in recs])
        np.testing.assert_array_equal(got_idx, ref_idx.reshape(-1))
        want = _keep(ref_idx, tmoe.capacity_for(cfg, n))
        got = np.concatenate([r["routes"][layer][1].numpy() for r in recs])
        np.testing.assert_array_equal(got, want)
        assert not want.all(), layer
        local_cap = tmoe.capacity_for(cfg, n // len(recs))
        alone = np.concatenate([_keep(r["routes"][layer][0].numpy(), local_cap)
                                for r in recs])
        assert (alone != want).any(), layer


def test_router_gradient_across_data_processes(runs, reference):
    """The load-balancing loss's gradient reaches the router as in one
    process: the mean of the processes' router grads (aux weight 1, the
    statistic summed across them) equals one process's."""
    case = "deepseek_sg_2x1"
    cfg, params, batches = _inputs(reference, case)
    mb = {"tokens": batches[0]["tokens"][:B // GA]}
    _, grads = tstep.value_and_grad(tstep.make_loss_fn(cfg, aux_weight=1.0), params, mb)
    want = [blk["ffn"]["router"] for blk in grads["blocks"]]
    for rec in runs[(2, 1)]:
        for a, b in zip(rec["router_grads"], want):
            assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_static_serving_per_mesh_position(runs, shape):
    """``run_static`` on every mesh position: each process reads the same
    gathered tokens and logits, equal to one process's (a token may differ
    only at a near-tie), logits within 1e-5 of max|logit|."""
    from repro_torch.launch.serve import run_static
    from repro_torch.models import transformer as tf

    cfg = _cfg("qwen3_0p6b")
    recs = [r["serve"] for r in runs[shape]]
    assert recs[0]["kv_heads"] == cfg.kv_heads // shape[1]
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                     device="cpu")
    one = run_static(params, cfg, _prompts(), new_tokens=SERVE_NEW, chunk=SERVE_CHUNK,
                     return_logits=True)
    logits = torch.stack(one["logits"], dim=1)
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    for rec in recs:
        assert torch.equal(rec["tokens"], recs[0]["tokens"])
        assert rec["tokens"].shape == (4, SERVE_NEW)
    got = recs[0]["tokens"]
    for row in range(got.shape[0]):
        diff = (got[row] != one["tokens"][row]).nonzero()
        if len(diff):
            at = int(diff[0])
            print(f"{shape} row {row}: first differing token at {at}, one-process margin "
                  f"{float(margin[row, at]):.3e}")
            assert float(margin[row, at]) < MARGIN_TOL
            continue
        got_logits = torch.stack([x[row] for x in recs[0]["logits"]])
        err = float((got_logits - logits[row]).abs().max())
        assert err <= 1e-5 * float(logits[row].abs().max()), (shape, row, err)


def test_tensor_functions_against_the_whole_computation(runs):
    """``copy``, ``reduce``, both adjoints of ``gather`` and ``sum_across``
    on 2 processes: forward values and gradients equal the whole
    computation's (the two ranks' inputs side by side); the slice adjoint
    would miss the other rank's terms where the ranks read the gathered
    tensor differently."""
    ins = [_fn_inputs(r) for r in range(2)]
    xs = [i[0] for i in ins]
    ws = [i[1] for i in ins]
    c = ins[0][2]
    a = [i[3] for i in ins]
    for rank, rec in enumerate(runs[(1, 2)]):
        f = rec["functions"]
        y, g = f["copy"]
        torch.testing.assert_close(y, xs[rank] * ws[rank])
        torch.testing.assert_close(g, ws[0] + ws[1])
        y, g = f["reduce"]
        torch.testing.assert_close(y, xs[0] * ws[0] + xs[1] * ws[1])
        torch.testing.assert_close(g, ws[rank] * c[0][:, :4])
        y, g = f["gather"]
        torch.testing.assert_close(y, torch.cat(xs, dim=1))
        torch.testing.assert_close(g, c[0][:, 4 * rank:4 * rank + 4])
        y, g = f["gather_reduce_grad"]
        torch.testing.assert_close(y, torch.cat(xs, dim=1))
        want = (c[0] + c[1])[:, 4 * rank:4 * rank + 4]
        torch.testing.assert_close(g, want)
        assert not torch.allclose(g, c[rank][:, 4 * rank:4 * rank + 4])
        s, g = f["sum_across"]
        torch.testing.assert_close(s, a[0] + a[1])
        # d/dtheta of the loss on the summed statistic: c * (a_0 + a_1)
        torch.testing.assert_close(g, c[0][:, :4] * (a[0] + a[1]))


def test_model_shards_and_position_device():
    cuda = [torch.device("cuda", i) for i in range(4)]
    mesh = tsh.Mesh(np.array(cuda, dtype=object).reshape(2, 2), ("data", "model"))
    assert tsh.position_device(mesh, collective.DataGroup(1, 2, "nccl"),
                               collective.ModelGroup(0, 2, "nccl")) == cuda[2]
    assert collective.backend_for(mesh, per_position=True) == "nccl"
    shared = tsh.Mesh(np.array([cuda[0]] * 4, dtype=object).reshape(2, 2), ("data", "model"))
    assert collective.backend_for(shared, per_position=True) == "gloo"
    specs = {"w": ("data", "model"), "b": ("model",), "s": ()}
    assert tsh.model_shards(specs, mesh) == {"w": (1, 2), "b": (0, 2), "s": None}
    assert tsh.data_shards(specs, mesh) == {"w": (0, 2), "b": None, "s": None}


def test_a_split_leaf_needs_a_model_group():
    from repro_torch.models import layers

    table = {"table": torch.randn(8, 4)}
    with pytest.raises(ValueError, match="model group"):
        layers.embedding_apply(table, torch.tensor([[1, 2]]), vocab=16)
    with pytest.raises(ValueError, match="processes for a mesh"):
        collective.mesh_groups(make_mesh_for([CPU] * 4, model_axis=2),
                               init_method="file:///nonexistent", rank=0, world_size=2)


def test_tensor_parallel_refuses_the_other_families():
    from repro_torch.models import transformer as tf

    model = collective.ModelGroup(0, 2, "gloo")
    with tp.parallel(model=model):
        for arch in ("mamba2_2p7b", "zamba2_2p7b", "seamless_m4t_large_v2", "internvl2_76b"):
            with pytest.raises(NotImplementedError, match="item 16"):
                tf.check_supported(get_config(arch).scaled_down())
        tf.check_supported(_cfg("deepseek_v2_236b"))


def _torchrun(nproc, module, args, cwd, timeout=240):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(nproc), "-m", module, *args],
                       capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return [x for x in r.stdout.splitlines() if x and not x.startswith("*")]


def test_launchers_per_mesh_position(tmp_path):
    """Both launchers under ``torchrun --nproc-per-node 4`` on the CPU, one
    process per position of the (2, 2) mesh: process 0 alone prints; the
    fused checkpoint (gathered over both groups by process 0) resumes in
    one process."""
    from repro_torch.launch import train as ttrain

    ck = tmp_path / "ck"
    smoke = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4"]
    out = _torchrun(4, "repro_torch.launch.train",
                    smoke + ["--steps", "2", "--ckpt", str(ck), "--ckpt-every", "2"], tmp_path)
    assert out == ["device cpu  arch qwen3_0p6b  strategy fused  mesh {'data': 2, 'model': 2}",
                   "done"]
    state = ttrain.main(smoke + ["--steps", "3", "--ckpt", str(ck)])
    assert int(state["step"]) == 3
    out = _torchrun(4, "repro_torch.launch.serve",
                    ["--device", "cpu", "--smoke", "--batch", "4", "--prompt", "32",
                     "--new-tokens", "4", "--strategy", "ai_core_assignment", "--arch",
                     "mixtral_8x22b"], tmp_path)
    assert out[0] == "mesh {'data': 2, 'model': 2}  arch mixtral_8x22b  strategy " \
                     "ai_core_assignment"
    assert len(out) == 3 and out[2].startswith("decode 3 steps: ")


def test_a_world_of_another_size_names_both_commands(monkeypatch):
    from repro_torch.launch.mesh import join_groups

    mesh = make_mesh_for([CPU] * 4)
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match=r"nproc-per-node 2 .*nproc-per-node 4"):
        join_groups(mesh, "fused", "repro_torch.launch.train")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="nproc-per-node 4"):
        join_groups(mesh, "scatter_gather", "repro_torch.launch.train")


def test_the_pipeline_keeps_moe_in_one_process():
    """The pipe routes each process's rows alone, so an MoE config's
    pipeline across processes stays refused (item 16)."""
    mesh = make_mesh_for([CPU] * 4, model_axis=2)
    with pytest.raises(NotImplementedError, match="item 16"):
        tstep.make_pipeline_train_step(_cfg("mixtral_8x22b"), OPT, mesh, num_microbatches=2,
                                       group=collective.DataGroup(0, 2, "gloo"))
