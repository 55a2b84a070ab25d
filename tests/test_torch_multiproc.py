"""Training and static serving across processes: one process per data
position (``repro_torch.dist.collective``), gloo on the CPU.

* Training: qwen3_0p6b ``scaled_down()`` in float32, S 32, global batch 8,
  grad_accum 2, two AdamW steps, the reference's params and batches.
  ``scatter_gather`` and ``fused`` on a (4, 1) mesh (4 processes) and
  ``pipeline`` on a (2, 2) mesh (2 processes x 2 stages on the CPU, 1F1B,
  2 microbatches) are each held to two references: the reference's
  jitted step on an Auto-axis mesh of the same shape over 4 fake CPU
  devices (one JAX subprocess), and the port's one-process step on the
  same global batch.  Loss and ``grad_norm`` within 1e-5 (relative) at
  both steps; params within 1e-5 of the one-process port's after step 2,
  and no more than 1e-5 farther from the reference's than the
  one-process port's own params are (AdamW's first update amplifies
  summation-order differences at near-zero grads: 1.3e-5-2.4e-5 for one
  process at lr 1e-3); every process reads the same metrics; under
  ``fused`` each process holds only its FSDP slices and the gathered
  params equal the one-process params.
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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
SPAWN_TIMEOUT = 240

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
def reference(tmp_path_factory):
    """The reference's jitted steps on 4 fake CPU devices, one subprocess
    (the device override must not leak into this process)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("ref_multiproc") / "ref.npz"
    code = f"B, S, GA, STEPS = {B}, {S}, {GA}, {STEPS}\nCASES = {CASES!r}\n" + _REF_SCRIPT
    r = subprocess.run(
        [sys.executable, "-c", code, str(out)], capture_output=True, text=True,
        env={"PYTHONPATH": os.path.join(repo, "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": "cpu"},
        cwd=repo, timeout=300)
    assert "REF_MULTIPROC_OK" in r.stdout, r.stdout + r.stderr
    return str(out)


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


def _train_child(rank, nprocs, init_method, ref_path, strategies, out_dir):
    """One data position: each strategy's two steps from the reference's
    params on the global batches; saves metrics and the gathered params."""
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
def multiproc(reference, tmp_path_factory):
    """Each strategy's per-process records: 4 processes for the (4, 1)
    strategies, 2 for the pipeline."""
    out = tmp_path_factory.mktemp("multiproc")
    collective.spawn(_train_child, 4, (reference, ("scatter_gather", "fused"), str(out)),
                     timeout=SPAWN_TIMEOUT, workdir=str(out))
    collective.spawn(_train_child, 2, (reference, ("pipeline",), str(out)),
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
           "norm": collective.global_norm(mine, SHARDS, group)}
    torch.save(rec, os.path.join(out_dir, f"coll_{rank}.pt"))
    group.close()


def test_collectives_over_shared_slices(tmp_path):
    """4 processes: ``pmean_scatter`` leaves each its slice of the mean
    (one ``reduce_scatter`` a sharded leaf, also where several positions
    share a slice), ``gather_tree`` rebuilds the whole mean and
    ``global_norm`` counts each slice once."""
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


def _torchrun(module, args, cwd, timeout=240):
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
    resumed by the one-process launcher."""
    from repro_torch.launch import train as ttrain

    ck = tmp_path / "ck"
    smoke = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4"]
    out = _torchrun("repro_torch.launch.train",
                    smoke + ["--steps", "2", "--ckpt", str(ck), "--ckpt-every", "2"], tmp_path)
    assert out == ["device cpu  arch qwen3_0p6b  strategy fused  mesh {'data': 2, 'model': 1}",
                   "done"]
    state = ttrain.main(smoke + ["--steps", "3", "--ckpt", str(ck)])
    assert int(state["step"]) == 3
    out = _torchrun("repro_torch.launch.serve", ["--device", "cpu", "--smoke", "--batch", "4",
                                                 "--prompt", "32", "--new-tokens", "4"], tmp_path)
    assert out[0] == "mesh {'data': 2, 'model': 1}  arch qwen3_0p6b  strategy fused"
    assert len(out) == 3 and out[2].startswith("decode 3 steps: ")


def test_launchers_refuse_one_process_paths_across_processes(monkeypatch):
    """In a world of two processes the paged engine and the supervisors
    exit before any group is made."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    smoke = ["--device", "cpu", "--smoke"]
    with pytest.raises(SystemExit, match="serves from one device"):
        tserve.main(smoke + ["--engine", "paged"])
    with pytest.raises(SystemExit, match="item 16"):
        tserve.main(smoke + ["--engine", "paged", "--supervise"])
    with pytest.raises(SystemExit, match="item 16"):
        ttrain.main(smoke + ["--fault-plan", "nan:step=3"])


def test_lone_process_on_many_positions_exits():
    from repro_torch.launch.mesh import refuse_lone_process

    two = tsh.Mesh(np.array([CPU, torch.device("meta")], dtype=object).reshape(2, 1),
                   ("data", "model"))
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2 -m repro_torch.launch"):
        refuse_lone_process(two, "repro_torch.launch.train")
    refuse_lone_process(make_mesh_for([CPU] * 2, model_axis=1), "repro_torch.launch.train")
