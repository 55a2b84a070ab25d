"""Training and static serving across processes: one process per data
position (``repro_torch.dist.collective``), gloo on the CPU.

* Training: qwen3_0p6b ``scaled_down()`` in float32, S 32, global batch 8,
  grad_accum 2, two AdamW steps, the reference's params and batches.
  ``scatter_gather`` and ``fused`` on a (4, 1) mesh (4 processes) and
  ``pipeline`` on a (2, 2) mesh (2 processes x 2 stages on the CPU, 1F1B,
  2 microbatches) are each held to two references: the reference's
  jitted step on an Auto-axis mesh of the same shape over 4 fake CPU
  devices (one JAX subprocess, which writes its inputs first and then
  runs beside the port's processes), and the port's one-process step on the
  same global batch.  Loss and ``grad_norm`` within 1e-5 (relative) at
  both steps; params within 1e-5 of the one-process port's after step 2,
  and no more than 1e-5 farther from the reference's than the
  one-process port's own params are (AdamW's first update amplifies
  summation-order differences at near-zero grads: 1.3e-5-2.4e-5 for one
  process at lr 1e-3); every process reads the same metrics; under
  ``fused`` each process holds only its FSDP slices and the gathered
  params equal the one-process params.
* The MoE pipeline across processes: mixtral_8x22b and deepseek_v2_236b
  ``scaled_down(num_layers=2)`` at capacity factor 0.75, one microbatch
  (its data shards' calls route half the global batch's tokens against
  the global capacity) and ids drawn from the vocabulary's first
  ``MOE_IDS`` (a skewed load), so choices drop; GPipe and 1F1B on the (2, 2)
  mesh (2 processes x 2 stages), two steps: loss, aux and grad norm
  within 1e-5 of the reference's jitted pipe on the same Auto-axis mesh
  and of the one-process pipe (its data shards in turn); params within
  1e-5 of the one-process pipe's wherever both steps' gradients clear
  ``GRAD_FLOOR`` (and no farther from the reference's than its own plus
  1e-5); GPipe == 1F1B bitwise; each layer's kept set of step 1 equal
  to the reference pipe's (its data shard's rows routed op by op under
  ``jax.disable_jit`` against the global capacity), with drops, where a
  capacity sized from the process's own rows would keep another set.
* Serving: 2 processes run ``launch.serve.run_static`` (f32) on their
  rows of the prompts; the gathered tokens equal the one-process run's.
  A token may differ only where the one-process top-2 margin is below
  1e-5 (printed when it happens).
* The pieces: ``pmean_scatter`` / ``gather_tree`` / ``global_norm`` over
  slices shared by several positions, ``data_group`` without a world, a
  world of the wrong size, ``shard_rows``' layout, ``local_mesh`` and
  ``backend_for``.

The children are spawned fresh (``collective.spawn``: a file store under
``tmp_path``, every child joined within a timeout, a child's traceback
re-raised here); this module imports no JAX, so they start quickly.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.dist import collective  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.ft.elastic import make_mesh_for, state_shardings  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

CPU = torch.device("cpu")
RTOL, PARAM_TOL, MARGIN_TOL = 1e-5, 1e-5, 1e-5
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
B, S, GA, STEPS = 8, 32, 2, 2
#: strategy -> (mesh shape, processes)
CASES = {"scatter_gather": ((4, 1), 4), "fused": ((4, 1), 4), "pipeline": ((2, 2), 2)}
#: limits on each spawn and on the reference's subprocess, near their
#: measured times
SPAWN_TIMEOUT, REF_TIMEOUT = 60, 300
#: the MoE pipeline's configs: 2 layers (one a stage), capacity factor
#: 0.75 and one microbatch, so that the data shards' calls drop choices
MOE_ARCHS, MOE_LAYERS, MOE_CF, MOE_M = ("mixtral_8x22b", "deepseek_v2_236b"), 2, 0.75, 1
#: the MoE batches draw their ids from the first MOE_IDS of the vocabulary:
#: few distinct tokens skew the routers' load past the capacity
MOE_IDS = 4
#: one-process gradients below this (100 x AdamW's eps) make AdamW's
#: first updates amplify summation order
GRAD_FLOOR = 1e-6

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.dist.sharding import data_specs, param_specs
from repro.optim.adamw import AdamWConfig, OptState
from repro.train.step import init_state, make_pipeline_train_step, make_train_step

cfg = get_config("qwen3_0p6b").scaled_down()
opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
state0 = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)
rng = np.random.default_rng(5)
batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
res = {f"tokens{i}": t for i, t in enumerate(batches)}
for k, v in jax.tree_util.tree_flatten_with_path(state0["params"])[0]:
    res["params" + jax.tree_util.keystr(k)] = np.asarray(v)

# the MoE pipeline's params and batches; every input is written (whole,
# then renamed) before the first step compiles, for the port's processes
import dataclasses
moe = {}
for arch in MOE_ARCHS:
    mcfg = dataclasses.replace(get_config(arch).scaled_down(num_layers=MOE_LAYERS),
                               moe_capacity_factor=MOE_CF)
    mstate = init_state(jax.random.PRNGKey(0), mcfg, jnp.float32, jnp.float32)
    mrng = np.random.default_rng(6)
    toks = [mrng.integers(0, MOE_IDS, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
    moe[arch] = mcfg, mstate, toks
    for i, t in enumerate(toks):
        res[f"{arch}/tokens{i}"] = t
    for k, v in jax.tree_util.tree_flatten_with_path(mstate["params"])[0]:
        res[f"{arch}/params" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(sys.argv[2] + ".tmp.npz", **res)
os.replace(sys.argv[2] + ".tmp.npz", sys.argv[2])


def ns(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


for strategy, ((d, m), _) in CASES.items():
    # Auto axes, as the reference's pipeline needs (jax.make_mesh gives Explicit)
    mesh = Mesh(np.array(jax.devices()).reshape(d, m), ("data", "model"))
    with mesh:
        if strategy == "pipeline":
            step = jax.jit(make_pipeline_train_step(cfg, opt, mesh, num_microbatches=GA,
                                                    schedule="1f1b"))
        else:
            ps = param_specs(state0["params"], mesh, strategy)
            ss = {"params": ps, "opt": OptState(mu=ps, nu=ps, step=P()), "step": P()}
            bs = data_specs({"tokens": jnp.asarray(batches[0])}, mesh)
            step = jax.jit(make_train_step(cfg, opt, grad_accum=GA),
                           in_shardings=(ns(mesh, ss), ns(mesh, bs)),
                           out_shardings=(ns(mesh, ss), None))
        state = state0
        for i, t in enumerate(batches):
            state, met = step(state, {"tokens": jnp.asarray(t)})
            res[f"{strategy}/loss{i}"] = np.asarray(met["loss"])
            res[f"{strategy}/grad_norm{i}"] = np.asarray(met["grad_norm"])
        for k, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
            res[f"{strategy}/params" + jax.tree_util.keystr(k)] = np.asarray(v)

# the MoE pipeline: the jitted pipe on the (2, 2) mesh, then step 1's
# routing of each data shard's rows op by op (the pipe's stage arithmetic
# on those rows) against the global capacity
from repro.dist.pipeline import _moe_global_capacity
from repro.models import transformer as jtf

mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for arch in MOE_ARCHS:
    mcfg, mstate, toks = moe[arch]
    with mesh:
        step = jax.jit(make_pipeline_train_step(mcfg, opt, mesh, num_microbatches=MOE_M,
                                                schedule="1f1b"))
        state = mstate
        for i, t in enumerate(toks):
            state, met = step(state, {"tokens": jnp.asarray(t)})
            for key in ("loss", "aux", "grad_norm"):
                res[f"{arch}/{key}{i}"] = np.asarray(met[key])
    for k, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        res[f"{arch}/final" + jax.tree_util.keystr(k)] = np.asarray(v)
    cap = _moe_global_capacity(mcfg, B * S)
    calls = []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        calls.append(np.asarray(idx))
        return vals, idx

    jax.lax.top_k = recording
    try:
        with jax.disable_jit():
            mb, r = B // MOE_M, B // MOE_M // 2
            for i in range(MOE_M):
                for j in range(2):
                    rows = jnp.asarray(toks[0][i * mb + j * r:i * mb + (j + 1) * r, :-1])
                    x = jtf._embed(mstate["params"], mcfg, rows, None)
                    pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
                    for layer in range(mcfg.num_layers):
                        p = jax.tree.map(lambda a: a[layer], mstate["params"]["blocks"])
                        x, _, _ = jtf.block_apply(p, mcfg, x, pos, None, moe_cap=cap)
                        res[f"{arch}/route{i}_{j}_{layer}"] = calls.pop()
    finally:
        jax.lax.top_k = top_k
np.savez(sys.argv[1], **res)
print("REF_MULTIPROC_OK")
"""


def _cfg():
    return get_config("qwen3_0p6b").scaled_down()


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
def reference_run(tmp_path_factory):
    """The reference's jitted steps on 4 fake CPU devices, one subprocess
    (the device override must not leak into this process), started here:
    it writes its inputs (params, batches) before its steps compile, so
    the port's processes overlap it.  Yields (process, inputs path,
    results path, log path)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tmp_path_factory.mktemp("ref_multiproc")
    out, ins, log = tmp / "ref.npz", tmp / "inputs.npz", tmp / "ref.log"
    code = (f"B, S, GA, STEPS = {B}, {S}, {GA}, {STEPS}\nCASES = {CASES!r}\n"
            f"MOE_ARCHS, MOE_LAYERS, MOE_CF, MOE_M, MOE_IDS = {MOE_ARCHS!r}, {MOE_LAYERS}, "
            f"{MOE_CF}, {MOE_M}, {MOE_IDS}\n" + _REF_SCRIPT)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(out), str(ins)], stdout=f,
            stderr=subprocess.STDOUT, text=True, cwd=repo,
            env={"PYTHONPATH": os.path.join(repo, "src"),
                 "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                 "HOME": os.environ.get("HOME", "/tmp"),
                 "JAX_PLATFORMS": "cpu"})
    try:
        yield proc, str(ins), str(out), log
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


@pytest.fixture(scope="module")
def ref_inputs(reference_run):
    """The reference's params and batches, once its subprocess wrote them."""
    proc, ins, _, log = reference_run
    deadline = time.monotonic() + REF_TIMEOUT
    while not os.path.exists(ins):
        assert proc.poll() is None, log.read_text()
        assert time.monotonic() < deadline, "no reference inputs within the timeout"
        time.sleep(0.5)
    return ins


@pytest.fixture(scope="module")
def reference(reference_run, multiproc):
    """The reference's results (its inputs too), once its subprocess ends
    (after the port's processes, which overlap it)."""
    proc, _, out, log = reference_run
    proc.wait(REF_TIMEOUT)
    assert "REF_MULTIPROC_OK" in log.read_text(), log.read_text()
    return out


def _inputs(ref_path):
    z = dict(np.load(ref_path))
    cfg = _cfg()
    params = convert.params_from_numpy(_nest(z, "params"), cfg, "cpu")
    batches = [{"tokens": torch.from_numpy(z[f"tokens{i}"]).long()} for i in range(STEPS)]
    return z, cfg, params, batches


def _step_for(cfg, strategy, mesh, group=None, shards=None):
    if strategy == "pipeline":
        return tstep.make_pipeline_train_step(cfg, OPT, mesh, num_microbatches=GA,
                                              schedule="1f1b", group=group, shards=shards)
    return tstep.make_train_step(cfg, OPT, grad_accum=GA, group=group, shards=shards)


def _storage_bytes(tree) -> int:
    return sum(t.untyped_storage().nbytes() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _moe_cfg(arch):
    import dataclasses

    return dataclasses.replace(get_config(arch).scaled_down(num_layers=MOE_LAYERS),
                               moe_capacity_factor=MOE_CF)


def _moe_inputs(ref_path, arch):
    z = dict(np.load(ref_path))
    cfg = _moe_cfg(arch)
    params = convert.params_from_numpy(_nest(z, f"{arch}/params"), cfg, "cpu")
    batches = [{"tokens": torch.from_numpy(z[f"{arch}/tokens{i}"]).long()}
               for i in range(STEPS)]
    return z, cfg, params, batches


class _Routes:
    """Records the (gate_idx, keep) of every ``moe.dispatch_slots`` call
    outside autograd: the pipe's forward units, in schedule order."""

    def __enter__(self):
        from repro_torch.models import moe as tmoe

        self.orig, self.calls = tmoe.dispatch_slots, []

        def recording(exp_flat, *a):
            out = self.orig(exp_flat, *a)
            if not torch.is_grad_enabled():
                self.calls.append((exp_flat.clone(), out[1].clone()))
            return out

        tmoe.dispatch_slots = recording
        return self.calls

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe

        tmoe.dispatch_slots = self.orig


def _moe_pipeline(ref_path, arch, schedule, mesh, group=None):
    """Two pipelined steps of ``arch``'s MoE config on ``mesh`` (its data
    shards across ``group``'s processes, or in turn in one process): the
    metrics, step 1's routing, the params (gathered) and the grads each
    step's AdamW update took (this process's)."""
    from repro_torch.optim import adamw

    _, cfg, params, batches = _moe_inputs(ref_path, arch)
    state = tstep.make_state(params)
    specs = state_shardings(state, mesh, "pipeline")
    shards = tsh.data_shards(specs["params"], mesh) if group is not None else None
    state = tsh.place(state, specs, mesh, group=group)
    step = tstep.make_pipeline_train_step(cfg, OPT, mesh, num_microbatches=MOE_M,
                                          schedule=schedule, group=group, shards=shards)
    rec = {"grads": []}
    apply = adamw.apply

    def spy(c, p, g, st, norm_fn=adamw.global_norm):
        rec["grads"].append(dict(flatten_with_path(g)))
        return apply(c, p, g, st, norm_fn)

    tstep.adamw.apply = spy
    try:
        for i, batch in enumerate(batches):
            with _Routes() as calls:
                state, met = step(state, batch)
            if i == 0:
                rec["routes"] = calls
            for key in ("loss", "aux", "grad_norm"):
                rec[f"{key}{i}"] = met[key].item()
    finally:
        tstep.adamw.apply = apply
    rec["params"] = collective.gather_tree(state["params"], shards, group)
    return rec


def _train_child(rank, nprocs, init_method, ref_path, strategies, out_dir):
    """One data position: each strategy's two steps from the reference's
    params on the global batches; saves metrics and the gathered params
    (and for the pipeline the MoE pipe's records)."""
    torch.set_num_threads(1)
    z, cfg, params, batches = _inputs(ref_path)
    group = None
    for strategy in strategies:
        (d, m), _ = CASES[strategy]
        mesh = make_mesh_for([CPU] * (d * m), model_axis=m)
        if group is None:
            group = collective.data_group(mesh, init_method=init_method, rank=rank,
                                          world_size=nprocs)
        state = tstep.make_state(params)
        specs = state_shardings(state, mesh, strategy)
        state = tsh.place(state, specs, mesh, group=group)
        shards = tsh.data_shards(specs["params"], mesh)
        placed_bytes = _storage_bytes(state)
        step = _step_for(cfg, strategy, mesh, group, shards)
        rec = {"placed_bytes": placed_bytes,
               "local_shapes": [tuple(t.shape) for t in leaves(state["params"])]}
        for i, batch in enumerate(batches):
            state, met = step(state, batch)
            rec[f"loss{i}"] = met["loss"].item()
            rec[f"grad_norm{i}"] = met["grad_norm"].item()
        rec["params"] = collective.gather_tree(state["params"], shards, group)
        if strategy == "pipeline":
            rec["moe"] = {(arch, sched): _moe_pipeline(ref_path, arch, sched, mesh, group)
                          for arch in MOE_ARCHS for sched in ("gpipe", "1f1b")}
            for r in rec["moe"].values():
                del r["grads"]
        torch.save(rec, os.path.join(out_dir, f"{strategy}_{rank}.pt"))
    group.close()


def _serve_child(rank, nprocs, init_method, out_dir, prompts, new_tokens, chunk):
    torch.set_num_threads(1)
    from repro_torch.launch.serve import run_static
    from repro_torch.models import transformer as tf

    cfg = _cfg()
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                     device="cpu")
    mesh = make_mesh_for([CPU] * nprocs, model_axis=1)
    group = collective.data_group(mesh, init_method=init_method, rank=rank, world_size=nprocs)
    res = run_static(params, cfg, prompts, new_tokens=new_tokens, chunk=chunk, mesh=mesh,
                     group=group)
    torch.save(res["tokens"], os.path.join(out_dir, f"serve_{rank}.pt"))
    group.close()


@pytest.fixture(scope="module")
def multiproc(ref_inputs, tmp_path_factory):
    """Each strategy's per-process records: 4 processes for the (4, 1)
    strategies, 2 for the pipeline."""
    out = tmp_path_factory.mktemp("multiproc")
    collective.spawn(_train_child, 4, (ref_inputs, ("scatter_gather", "fused"), str(out)),
                     timeout=SPAWN_TIMEOUT, workdir=str(out))
    collective.spawn(_train_child, 2, (ref_inputs, ("pipeline",), str(out)),
                     timeout=SPAWN_TIMEOUT, workdir=str(out))
    return {s: [torch.load(out / f"{s}_{r}.pt") for r in range(n)]
            for s, (_, n) in CASES.items()}


def _one_process(ref_path, strategy):
    z, cfg, params, batches = _inputs(ref_path)
    (d, m), _ = CASES[strategy]
    mesh = make_mesh_for([CPU] * (d * m), model_axis=m)
    state = tstep.make_state(params)
    step = _step_for(cfg, strategy, mesh)
    mets = []
    for batch in batches:
        state, met = step(state, batch)
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm")})
    return mets, state["params"]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def _show_own_distance(ref_path, base, want_params):
    """Print where the one-process port's params lie farthest from the
    reference's after two steps, beside the first step's gradient there
    and the leaf's median |gradient|: the distance sits where the gradient
    is near zero, which AdamW's g / (|g| + eps) amplifies."""
    z, cfg, params, batches = _inputs(ref_path)
    _, grads = tstep.value_and_grad(tstep.make_loss_fn(cfg), params, batches[0])
    grads = dict(flatten_with_path(grads))
    own, path = max((float((base[p] - b).abs().max()), p)
                    for p, b in flatten_with_path(want_params))
    diff = (base[path] - dict(flatten_with_path(want_params))[path]).abs()
    at = np.unravel_index(int(diff.argmax()), diff.shape)
    g = grads[path]
    print(f"one process vs reference: worst leaf {'/'.join(map(str, path))} {own:.3e} at "
          f"{tuple(int(i) for i in at)}, step-1 |grad| there {float(g[at].abs()):.3e}, "
          f"leaf median |grad| {float(g.abs().median()):.3e}")


@pytest.mark.parametrize("against", ["reference", "one_process"])
@pytest.mark.parametrize("strategy", list(CASES))
def test_train_across_processes(multiproc, reference, strategy, against):
    recs = multiproc[strategy]
    cfg = _cfg()
    if against == "reference":
        z = dict(np.load(reference))
        want = [{"loss": float(z[f"{strategy}/loss{i}"]),
                 "grad_norm": float(z[f"{strategy}/grad_norm{i}"])} for i in range(STEPS)]
        want_params = convert.params_from_numpy(_nest(z, f"{strategy}/params"), cfg, "cpu")
    else:
        want, want_params = _one_process(reference, strategy)
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            got = [r[f"{key}{i}"] for r in recs]
            # every process reads the same metrics
            assert len(set(got)) == 1, (key, i, got)
            assert _close(got[0], want[i][key], RTOL), (strategy, against, key, i, got[0],
                                                        want[i][key])
    # against the reference the one-process port's own params are up to
    # ~2.4e-5 off after two steps (AdamW's first update g / (|g| + eps)
    # amplifies summation-order differences at near-zero grads), so there
    # the processes must add no more than PARAM_TOL to that distance
    base = (dict(flatten_with_path(_one_process(reference, strategy)[1]))
            if against == "reference" else None)
    if base is not None:
        _show_own_distance(reference, base, want_params)
    for (path, a), (_, b) in zip(flatten_with_path(recs[0]["params"]),
                                 flatten_with_path(want_params)):
        assert a.shape == b.shape, path
        err = float((a - b).abs().max())
        own = 0.0 if base is None else float((base[path] - b).abs().max())
        assert err <= own + PARAM_TOL, (path, err, own)


@pytest.fixture(scope="module")
def moe_one_process(reference):
    """The one-process MoE pipe on the (2, 2) mesh (its data shards in
    turn), per arch."""
    mesh = make_mesh_for([CPU] * 4, model_axis=2)
    return {arch: _moe_pipeline(reference, arch, "1f1b", mesh) for arch in MOE_ARCHS}


def _keep(routes, cap):
    """The reference's kept set: token-major positions over the call's
    choices, against ``cap``."""
    flat = routes.reshape(-1)
    onehot = np.eye(int(flat.max()) + 1, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return pos < cap


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_pipeline_across_processes(multiproc, reference, moe_one_process, arch, schedule):
    """Loss, aux and grad norm of both steps within 1e-5 of the
    reference's pipe and of one process, every process reading the same;
    the gathered params within 1e-5 of one process's where both steps'
    gradients clear ``GRAD_FLOOR``; GPipe == 1F1B bitwise."""
    z, cfg, _, _ = _moe_inputs(reference, arch)
    recs = [r["moe"][(arch, schedule)] for r in multiproc["pipeline"]]
    one = moe_one_process[arch]
    for i in range(STEPS):
        for key in ("loss", "aux", "grad_norm"):
            got = [r[f"{key}{i}"] for r in recs]
            assert len(set(got)) == 1, (arch, key, i, got)
            ref = float(z[f"{arch}/{key}{i}"])
            assert _close(got[0], ref, RTOL), (arch, schedule, key, i, got[0], ref)
            assert _close(got[0], one[f"{key}{i}"], RTOL), (arch, schedule, key, i, got[0],
                                                            one[f"{key}{i}"])
    want = dict(flatten_with_path(convert.params_from_numpy(_nest(z, f"{arch}/final"), cfg,
                                                            "cpu")))
    base = dict(flatten_with_path(one["params"]))
    for path, a in flatten_with_path(recs[0]["params"]):
        b, r = base[path], want[path]
        clear = ((one["grads"][0][path].abs() >= GRAD_FLOOR)
                 & (one["grads"][1][path].abs() >= GRAD_FLOOR))
        err = float(((a - b).abs() * clear).max())
        assert err <= PARAM_TOL, (arch, schedule, path, err)
        own = float(((b - r).abs() * clear).max())
        assert float(((a - r).abs() * clear).max()) <= own + PARAM_TOL, (arch, path)
    other = [r["moe"][(arch, "gpipe" if schedule == "1f1b" else "1f1b")]
             for r in multiproc["pipeline"]]
    for a, b in zip(recs, other):
        assert all(a[f"{k}{i}"] == b[f"{k}{i}"] for k in ("loss", "aux", "grad_norm")
                   for i in range(STEPS))
        assert all(torch.equal(x, y) for x, y in zip(leaves(a["params"]), leaves(b["params"])))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_pipeline_keeps_the_reference_set(multiproc, reference, moe_one_process, arch):
    """Step 1's routing: each process's calls (its data shard's rows, one
    a layer) choose the experts the reference pipe's do and keep its set
    against the capacity sized from the global batch; some choices drop,
    and a capacity sized from the process's own rows would keep another
    set.  The one-process pipe's shards keep the same."""
    from repro_torch.models.moe import capacity_for

    z, cfg, _, _ = _moe_inputs(reference, arch)
    n = (B // MOE_M // 2) * S
    cap, local = (min(capacity_for(cfg, tokens), n) for tokens in (B * S, B * S // 2))
    one = moe_one_process[arch]["routes"]
    dropped, differs = 0, 0
    for j, rec in enumerate(multiproc["pipeline"]):
        for schedule in ("gpipe", "1f1b"):
            calls = rec["moe"][(arch, schedule)]["routes"]
            assert len(calls) == MOE_M * cfg.num_layers
            for c, (idx, keep) in enumerate(calls):
                i, layer = divmod(c, cfg.num_layers)
                ref = z[f"{arch}/route{i}_{j}_{layer}"]
                np.testing.assert_array_equal(idx.numpy(), ref.reshape(-1))
                want = _keep(ref, cap)
                np.testing.assert_array_equal(keep.numpy(), want)
                # the one-process pipe: microbatch i's shards in turn
                o_idx, o_keep = one[(i * 2 + j) * cfg.num_layers + layer]
                assert torch.equal(o_idx, idx) and torch.equal(o_keep, keep)
                dropped += int((~want).sum())
                differs += int((_keep(ref, local) != want).any())
    assert dropped and differs, (arch, dropped, differs)


def test_fused_holds_only_its_slices(multiproc):
    """Under ``fused`` each process holds a quarter of every FSDP leaf: the
    placed state is smaller than scatter_gather's, and every process's
    gathered params are the same."""
    fused, sg = multiproc["fused"], multiproc["scatter_gather"]
    assert all(r["placed_bytes"] < sg[0]["placed_bytes"] for r in fused)
    shapes = [r["local_shapes"] for r in fused]
    assert all(s == shapes[0] for s in shapes)
    assert shapes[0] != sg[0]["local_shapes"]
    for r in fused[1:]:
        assert all(torch.equal(a, b) for a, b in zip(leaves(r["params"]),
                                                     leaves(fused[0]["params"])))


def test_static_serving_across_processes(tmp_path):
    """2 processes on their rows of the prompts: the gathered tokens equal
    the one-process run's (a token may differ only at a near-tie)."""
    from repro_torch.launch.serve import run_static
    from repro_torch.models import transformer as tf

    cfg = _cfg()
    prompts = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (4, 24))).long()
    new, chunk = 8, 16
    collective.spawn(_serve_child, 2, (str(tmp_path), prompts, new, chunk),
                     timeout=SPAWN_TIMEOUT, workdir=str(tmp_path))
    got = [torch.load(tmp_path / f"serve_{r}.pt") for r in range(2)]
    assert torch.equal(got[0], got[1]) and got[0].shape == (4, new)
    params = tf.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                     device="cpu")
    one = run_static(params, cfg, prompts, new_tokens=new, chunk=chunk, return_logits=True)
    logits = torch.stack(one["logits"], dim=1)
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    for row in range(prompts.shape[0]):
        diff = (got[0][row] != one["tokens"][row]).nonzero()
        if len(diff):
            at = int(diff[0])
            print(f"row {row}: first differing token at {at}, one-process margin "
                  f"{float(margin[row, at]):.3e}")
            assert float(margin[row, at]) < MARGIN_TOL


def _tensors(rank):
    """Process ``rank``'s leaves for the collectives test."""
    g = torch.Generator().manual_seed(rank)
    return {"a": torch.randn(4, 6, generator=g), "b": torch.randn(3, 8, generator=g),
            "c": torch.randn(5, generator=g)}


#: a: dim 0 split 2 ways (positions 0-1 and 2-3 share a slice); b: dim 1
#: split 4 ways; c: replicated
SHARDS = {"a": (0, 2), "b": (1, 4), "c": None}


def _collectives_child(rank, nprocs, init_method, out_dir):
    torch.set_num_threads(1)
    mesh = make_mesh_for([CPU] * nprocs, model_axis=1)
    group = collective.data_group(mesh, init_method=init_method, rank=rank, world_size=nprocs)
    mine = collective.pmean_scatter(_tensors(rank), SHARDS, group)
    rec = {"mine": mine, "whole": collective.gather_tree(mine, SHARDS, group),
           "first": collective.gather_tree_first(mine, SHARDS, group),
           "norm": collective.global_norm(mine, SHARDS, group)}
    torch.save(rec, os.path.join(out_dir, f"coll_{rank}.pt"))
    group.close()


def test_collectives_over_shared_slices(tmp_path):
    """4 processes: ``pmean_scatter`` leaves each its slice of the mean
    (one ``reduce_scatter`` a sharded leaf, also where several positions
    share a slice), ``gather_tree`` rebuilds the whole mean on every
    process and ``gather_tree_first`` on the first alone (a checkpoint's
    writer), and ``global_norm`` counts each slice once."""
    collective.spawn(_collectives_child, 4, (str(tmp_path),), timeout=SPAWN_TIMEOUT,
                     workdir=str(tmp_path))
    mean = {k: sum(_tensors(r)[k] for r in range(4)) / 4 for k in SHARDS}
    norm = torch.sqrt(sum(v.square().sum() for v in mean.values()))
    for r in range(4):
        rec = torch.load(tmp_path / f"coll_{r}.pt")
        want = {"a": mean["a"][(r // 2) * 2:(r // 2) * 2 + 2], "b": mean["b"][:, 2 * r:2 * r + 2],
                "c": mean["c"]}
        for k in SHARDS:
            torch.testing.assert_close(rec["mine"][k], want[k], rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(rec["whole"][k], mean[k], rtol=1e-6, atol=1e-6)
            assert rec["whole"][k].is_contiguous()
            if r == 0 or SHARDS[k] is None:
                assert torch.equal(rec["first"][k], rec["whole"][k]), (r, k)
            else:
                assert rec["first"][k] is None, (r, k)
        torch.testing.assert_close(rec["norm"], norm, rtol=1e-6, atol=1e-6)


def test_data_group_needs_a_world(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    mesh = make_mesh_for([CPU] * 4, model_axis=1)
    assert collective.data_group(mesh) is None
    assert collective.process_count(None) == 1 and collective.process_index(None) == 0
    with pytest.raises(ValueError, match="2 processes for a mesh with 4 data positions"):
        collective.data_group(mesh, init_method="file:///nonexistent", rank=0, world_size=2)
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="3 processes for a mesh with 4 data positions"):
        collective.data_group(mesh)
    one = make_mesh_for([CPU], model_axis=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert collective.data_group(one) is None


def test_shard_rows_layout():
    """Shard j of microbatch i holds rows [i*mb + j*r, i*mb + (j+1)*r)."""
    tok = torch.arange(16)[:, None].expand(16, 3)
    got = collective.shard_rows({"tokens": tok}, 2, 4, 1)["tokens"][:, 0].tolist()
    assert got == [2, 3, 10, 11]
    with pytest.raises(ValueError, match="does not split"):
        collective.shard_rows({"tokens": tok}, 3, 2, 0)


def test_local_mesh_and_backend():
    cuda = [torch.device("cuda", i) for i in range(4)]
    mesh = tsh.Mesh(np.array(cuda, dtype=object).reshape(2, 2), ("data", "model"))
    row = tsh.local_mesh(mesh, collective.DataGroup(1, 2, "nccl"))
    assert row.shape == {"data": 1, "model": 2} and row.distinct_devices() == cuda[2:]
    assert collective.backend_for(mesh) == "nccl"
    shared = tsh.Mesh(np.array([cuda[0]] * 2, dtype=object).reshape(2, 1), ("data", "model"))
    assert collective.backend_for(shared) == "gloo"
    assert collective.backend_for(make_mesh_for([CPU] * 4, model_axis=1)) == "gloo"
    pod = tsh.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 2, 2), ("pod", "data", "model"))
    assert tsh.data_positions(pod) == 4 and len(tsh.row_devices(pod)) == 4
    with pytest.raises(ValueError, match="3 processes for a mesh with 4 data positions"):
        tsh.local_mesh(pod, collective.DataGroup(0, 3, "gloo"))


def _torchrun(module, args, cwd, timeout=60):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", module, *args],
                       capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return [x for x in r.stdout.splitlines() if x and not x.startswith("*")]


def test_launchers_under_torchrun(tmp_path):
    """Both launchers under ``torchrun --nproc-per-node 2`` on the CPU:
    process 0 alone prints the reference's lines with the global mesh; the
    train launcher's fused checkpoint (written gathered by process 0) is
    resumed by the one-process launcher; ``--fault-plan`` runs the
    supervisor in both processes to ``done``."""
    from repro_torch.launch import train as ttrain

    ck = tmp_path / "ck"
    smoke = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4"]
    out = _torchrun("repro_torch.launch.train",
                    smoke + ["--steps", "2", "--ckpt", str(ck), "--ckpt-every", "2"], tmp_path)
    assert out == ["device cpu  arch qwen3_0p6b  strategy fused  mesh {'data': 2, 'model': 1}",
                   "done"]
    state = ttrain.main(smoke + ["--steps", "3", "--ckpt", str(ck)])
    assert int(state["step"]) == 3
    # the supervised loop across the two processes: a rollback, then done
    out = _torchrun("repro_torch.launch.train",
                    smoke + ["--steps", "4", "--fault-plan", "nan:step=2", "--ckpt",
                             str(tmp_path / "sup"), "--ckpt-every", "2"], tmp_path)
    assert out[-1] == "done" and out[-2].startswith("  [rollback] at step 2: lost 0 steps")
    out = _torchrun("repro_torch.launch.serve", ["--device", "cpu", "--smoke", "--batch", "4",
                                                 "--prompt", "32", "--new-tokens", "4"], tmp_path)
    assert out[0] == "mesh {'data': 2, 'model': 1}  arch qwen3_0p6b  strategy fused"
    assert len(out) == 3 and out[2].startswith("decode 3 steps: ")


def test_launchers_refuse_one_process_paths_across_processes(monkeypatch):
    """In a world of two processes the paged engine, the serving
    supervisor and the pipeline's training supervisor exit before any
    group is made."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    smoke = ["--device", "cpu", "--smoke"]
    with pytest.raises(SystemExit, match="serves from one device"):
        tserve.main(smoke + ["--engine", "paged"])
    with pytest.raises(SystemExit, match="serves from one device as the reference's does"):
        tserve.main(smoke + ["--engine", "paged", "--supervise"])
    with pytest.raises(SystemExit, match=r"pipeline supervisor .* in one process"):
        ttrain.main(smoke + ["--strategy", "pipeline", "--fault-plan", "nan:step=3"])


def test_lone_process_on_many_positions_exits():
    from repro_torch.launch.mesh import refuse_lone_process

    two = tsh.Mesh(np.array([CPU, torch.device("meta")], dtype=object).reshape(2, 1),
                   ("data", "model"))
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2 -m repro_torch.launch"):
        refuse_lone_process(two, "repro_torch.launch.train")
    refuse_lone_process(make_mesh_for([CPU] * 2, model_axis=1), "repro_torch.launch.train")
