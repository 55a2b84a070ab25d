"""Pipeline stages as processes: one gloo process per mesh position under
``pipeline`` (``dist.collective.mesh_groups``), each running its row's
stage k alone, activations forward and gradients back by point-to-point
sends (``dist.collective.send_to`` / ``recv_from``).

* qwen3_0p6b ``scaled_down(num_layers=4)`` in float32, global batch 8 x 32
  tokens, 2 microbatches, on (1, 2), (2, 2) and (1, 4), GPipe and 1F1B:
  - each stage's ``loss_and_grad`` against the one-process row pipe on
    the same rows (its data position's, ``group`` a data group of the
    row layout): its layer grads and the CE bitwise (the same units on the
    same values), the grads of the leaves off 'model' (summed over the
    stages) within 1e-5; the stages' busy and idle rounds summed equal
    ``pipeline_bubble_counts``;
  - two AdamW steps: every process reads the same metrics, loss and grad
    norm within 1e-5 of the reference's jitted pipe (1F1B on an Auto-axis
    mesh of the same shape, one JAX subprocess) and of the one-process
    row pipe's step; each process's params within 1e-5 of the row pipe's
    where both steps' gradients clear ``GRAD_FLOOR``, and no more than
    1e-5 farther from the reference's than the row pipe's own;
  - GPipe == 1F1B bitwise in the stage layout (grads, metrics, params);
  - the forward pipe: the last stage's logits bitwise the one-process
    forward pipe's rows;
  - process 0's checkpoint (the stages' layers gathered over the model
    group, the data slices over the data group) restores, in the port
    (into the row layout's tree) and in the reference's checkpoint module,
    bitwise to the stages' states.
* mixtral_8x22b ``scaled_down(num_layers=2)`` at capacity factor 0.75 on
  (1, 2), one microbatch, ids from the vocabulary's first 4 (a skewed
  load): loss, aux and grad norm of two steps within 1e-5 of the
  reference's pipe; each stage's layer routes, against the capacity sized
  from the global batch, keep the reference pipe's set, with drops.
* The train launcher under ``torchrun --nproc-per-node 4 --strategy
  pipeline`` on the CPU's (2, 2) mesh: one process a stage; its
  checkpoint resumes in one process.

The JAX subprocess writes its inputs first, then compiles its steps in
threads beside the port's processes (``collective.spawn``, a file store
under ``tmp_path``).
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
from repro_torch.dist import pipeline as pl  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.ft import checkpoint as tckpt  # noqa: E402
from repro_torch.ft.elastic import make_mesh_for, state_shardings  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402

CPU = torch.device("cpu")
RTOL, PARAM_TOL, GRAD_FLOOR = 1e-5, 1e-5, 1e-6
OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
B, S, M, STEPS, LAYERS = 8, 32, 2, 2, 4
SHAPES = [(1, 2), (2, 2), (1, 4)]
SCHEDULES = ("gpipe", "1f1b")
MOE_ARCH, MOE_LAYERS, MOE_CF, MOE_M, MOE_IDS = "mixtral_8x22b", 2, 0.75, 1, 4
SPAWN_TIMEOUT, REF_TIMEOUT = 120, 300

_REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from concurrent.futures import ThreadPoolExecutor
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import get_config
from repro.optim.adamw import AdamWConfig
from repro.train.step import init_state, make_pipeline_train_step

cfg = get_config("qwen3_0p6b").scaled_down(num_layers=LAYERS)
opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
state0 = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)
rng = np.random.default_rng(5)
batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
res = {f"tokens{i}": t for i, t in enumerate(batches)}
for k, v in jax.tree_util.tree_flatten_with_path(state0["params"])[0]:
    res["params" + jax.tree_util.keystr(k)] = np.asarray(v)
mcfg = dataclasses.replace(get_config(MOE_ARCH).scaled_down(num_layers=MOE_LAYERS),
                           moe_capacity_factor=MOE_CF)
mstate = init_state(jax.random.PRNGKey(0), mcfg, jnp.float32, jnp.float32)
mrng = np.random.default_rng(6)
mtoks = [mrng.integers(0, MOE_IDS, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
for i, t in enumerate(mtoks):
    res[f"moe/tokens{i}"] = t
for k, v in jax.tree_util.tree_flatten_with_path(mstate["params"])[0]:
    res["moe/params" + jax.tree_util.keystr(k)] = np.asarray(v)
np.savez(sys.argv[2] + ".tmp.npz", **res)
os.replace(sys.argv[2] + ".tmp.npz", sys.argv[2])

# every step lowers on its Auto-axis mesh, then all compile in threads
jobs = {}
for d, m in SHAPES:
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
    with mesh:
        step = jax.jit(make_pipeline_train_step(cfg, opt, mesh, num_microbatches=M,
                                                schedule="1f1b"))
        jobs[f"{d}x{m}"] = (step.lower(state0, {"tokens": jnp.asarray(batches[0])}), state0,
                            batches)
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
with mesh:
    step = jax.jit(make_pipeline_train_step(mcfg, opt, mesh, num_microbatches=MOE_M,
                                            schedule="1f1b"))
    jobs["moe"] = (step.lower(mstate, {"tokens": jnp.asarray(mtoks[0])}), mstate, mtoks)
with ThreadPoolExecutor(4) as pool:
    compiled = dict(zip(jobs, pool.map(lambda j: j[0].compile(), jobs.values())))
for key, (_, state, toks) in jobs.items():
    for i, t in enumerate(toks):
        state, met = compiled[key](state, {"tokens": jnp.asarray(t)})
        for name in ("loss", "aux", "grad_norm"):
            res[f"{key}/{name}{i}"] = np.asarray(met[name])
    for k, v in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
        res[f"{key}/final" + jax.tree_util.keystr(k)] = np.asarray(v)

# step 1's routing of the MoE pipe, op by op against the global capacity
from repro.dist.pipeline import _moe_global_capacity
from repro.models import transformer as jtf

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
        x = jtf._embed(mstate["params"], mcfg, jnp.asarray(mtoks[0][:, :-1]), None)
        pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
        for layer in range(mcfg.num_layers):
            p = jax.tree.map(lambda a: a[layer], mstate["params"]["blocks"])
            x, _, _ = jtf.block_apply(p, mcfg, x, pos, None, moe_cap=cap)
            res[f"moe/route{layer}"] = calls.pop()
finally:
    jax.lax.top_k = top_k
np.savez(sys.argv[1], **res)
print("REF_PIPE_STAGES_OK")
"""


def _cfg():
    return get_config("qwen3_0p6b").scaled_down(num_layers=LAYERS)


def _moe_cfg():
    import dataclasses

    return dataclasses.replace(get_config(MOE_ARCH).scaled_down(num_layers=MOE_LAYERS),
                               moe_capacity_factor=MOE_CF)


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


def _inputs(path, moe=False):
    """(cfg, params, batches) from the reference's inputs."""
    z = dict(np.load(path))
    cfg, pre = (_moe_cfg(), "moe/") if moe else (_cfg(), "")
    params = convert.params_from_numpy(_nest(z, pre + "params"), cfg, "cpu")
    batches = [{"tokens": torch.from_numpy(z[f"{pre}tokens{i}"]).long()} for i in range(STEPS)]
    return cfg, params, batches


def _mesh(shape):
    return make_mesh_for([CPU] * (shape[0] * shape[1]), model_axis=shape[1])


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's jitted pipes on 4 fake CPU devices, one subprocess,
    started first: it writes its inputs before its steps compile, so the
    port's processes overlap it.  Yields (process, inputs, results, log)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tmp_path_factory.mktemp("ref_pipe_stages")
    out, ins, log = tmp / "ref.npz", tmp / "inputs.npz", tmp / "ref.log"
    code = (f"B, S, M, STEPS, LAYERS, SHAPES = {B}, {S}, {M}, {STEPS}, {LAYERS}, {SHAPES!r}\n"
            f"MOE_ARCH, MOE_LAYERS, MOE_CF, MOE_M, MOE_IDS = {MOE_ARCH!r}, {MOE_LAYERS}, "
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
    proc, ins, _, log = reference_run
    deadline = time.monotonic() + REF_TIMEOUT
    while not os.path.exists(ins):
        assert proc.poll() is None, log.read_text()
        assert time.monotonic() < deadline, "no reference inputs within the timeout"
        time.sleep(0.5)
    return ins


@pytest.fixture(scope="module")
def reference(reference_run, stages):
    """The reference's results, once its subprocess ends (after the port's
    processes, which overlap it)."""
    proc, _, out, log = reference_run
    proc.wait(REF_TIMEOUT)
    assert "REF_PIPE_STAGES_OK" in log.read_text(), log.read_text()
    return dict(np.load(out))


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


def _stage_run(cfg, params, batches, mesh, data, model, schedule, m, ckpt_dir=None,
               routes=False):
    """One stage process's records for ``schedule``: its ``loss_and_grad``
    on the first batch (grads and counts), STEPS train steps' metrics, its
    params after them (its layers, the data slices gathered) and, with
    ``ckpt_dir``, process 0's checkpoint of the final state."""
    state = tstep.make_state(params)
    specs = state_shardings(state, mesh, "pipeline")
    local = tsh.stage_slice(specs, specs, model)
    shards = tsh.data_shards(local, mesh)["params"] if data is not None else None
    state = tsh.place(state, specs, mesh, data, model)
    lg = pl.make_pipeline_loss_and_grad(cfg, mesh, m, schedule=schedule, group=data,
                                        model=model)
    rec = {}
    (loss, met), grads = lg(collective.gather_tree(state["params"], shards, data), batches[0])
    rec.update(loss=loss, ce=met["ce"], aux=met["aux"], grads=grads, counts=lg.counts)
    step = tstep.make_pipeline_train_step(cfg, OPT, mesh, num_microbatches=m,
                                          schedule=schedule, group=data, shards=shards,
                                          model=model)
    for i, batch in enumerate(batches):
        with _Routes() as calls:
            state, met = step(state, batch)
        if routes and i == 0:
            rec["routes"] = calls
        for key in ("loss", "aux", "grad_norm"):
            rec[f"{key}{i}"] = met[key].item()
    rec["params"] = collective.gather_tree(state["params"], shards, data)
    if ckpt_dir is not None:
        whole = collective.gather_tree_first(state, tsh.data_shards(local, mesh), data)
        if collective.process_index(data) == 0:
            whole = collective.gather_stages_first(whole, specs, model)
            if model.rank == 0:
                tckpt.save(ckpt_dir, whole, step=STEPS)
        rec["state"] = collective.gather_tree(state, tsh.data_shards(local, mesh), data)
    return rec


def _child(rank, nprocs, init_method, ref_path, jobs, out_dir):
    """One mesh position: each job's stage records (qwen3 under both
    schedules, or the MoE pipe), saved as ``<job>_<rank>.pt``."""
    torch.set_num_threads(1)
    for n, (name, shape, moe) in enumerate(jobs):
        mesh = _mesh(shape)
        data, model = collective.mesh_groups(mesh, init_method=f"{init_method}_{n}", rank=rank,
                                             world_size=nprocs)
        cfg, params, batches = _inputs(ref_path, moe)
        recs = {}
        if not moe:
            # the fill-and-drain forward: the last stage's logits of its
            # data position's rows
            specs = tsh.param_specs(params, mesh, "pipeline")
            mine = tsh.place(params, specs, mesh, data, model)
            mine = collective.gather_tree(mine, tsh.data_shards(
                tsh.stage_slice(specs, specs, model), mesh), data)
            fwd = pl.make_pipeline_forward(cfg, mesh, M, group=data, model=model)
            with torch.no_grad():
                recs["forward"] = (fwd(mine, batches[0]["tokens"][:, :-1]), fwd.counts)
            del mine
        for schedule in SCHEDULES:
            ck = (os.path.join(out_dir, f"ckpt_{name}")
                  if schedule == "1f1b" and not moe else None)
            recs[schedule] = _stage_run(cfg, params, batches, mesh, data, model, schedule,
                                        MOE_M if moe else M, ck, routes=moe)
        torch.save(recs, os.path.join(out_dir, f"{name}_{rank}.pt"))
        collective.close(data, model)


def _name(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def stages(ref_inputs, tmp_path_factory):
    """Every job's per-process records: one spawn of 2 processes ((1, 2)
    qwen3 and the MoE pipe), one of 4 ((2, 2) and (1, 4))."""
    out = tmp_path_factory.mktemp("pipe_stages")
    jobs = {2: [(_name((1, 2)), (1, 2), False), ("moe", (1, 2), True)],
            4: [(_name((2, 2)), (2, 2), False), (_name((1, 4)), (1, 4), False)]}
    for n, js in jobs.items():
        collective.spawn(_child, n, (ref_inputs, js, str(out)), timeout=SPAWN_TIMEOUT,
                         workdir=str(out))
    # the states hold optim.adamw.OptState: not a weights-only load
    recs = {name: [torch.load(out / f"{name}_{r}.pt", weights_only=False) for r in range(n)]
            for n, js in jobs.items() for name, _, _ in js}
    recs["dir"] = out
    return recs


def _row(ref_path, shape, schedule, moe=False):
    """The one-process row pipe on ``shape``: each data position's
    ``loss_and_grad`` on its rows (the row layout's process, its ``group``
    standing for the data group), STEPS train steps' metrics on the global
    batch, the grads each step's AdamW took and the final params."""
    cfg, params, batches = _inputs(ref_path, moe)
    mesh = _mesh(shape)
    m = MOE_M if moe else M
    out = {"shards": []}
    for p in range(shape[0]):
        group = collective.DataGroup(p, shape[0], "gloo") if shape[0] > 1 else None
        lg = pl.make_pipeline_loss_and_grad(cfg, mesh, m, schedule=schedule, group=group)
        (loss, met), grads = lg(params, batches[0])
        out["shards"].append({"ce": met["ce"], "grads": grads})
    step = tstep.make_pipeline_train_step(cfg, OPT, mesh, num_microbatches=m,
                                          schedule=schedule)
    state = tstep.make_state(params)
    out["grads"] = []
    apply = adamw.apply

    def spy(c, p_, g, st, norm_fn=adamw.global_norm):
        out["grads"].append(dict(flatten_with_path(g)))
        return apply(c, p_, g, st, norm_fn)

    tstep.adamw.apply = spy
    try:
        for i, batch in enumerate(batches):
            state, met = step(state, batch)
            for key in ("loss", "aux", "grad_norm"):
                out[f"{key}{i}"] = met[key].item()
    finally:
        tstep.adamw.apply = apply
    out["params"] = state["params"]
    out["state"] = state
    return out


@pytest.fixture(scope="module")
def rows(ref_inputs):
    return {(_name(shape), sched): _row(ref_inputs, shape, sched)
            for shape in SHAPES for sched in SCHEDULES}


def _stage_slice(tree, shape, k):
    """Stage k's blocks of a whole (padded) tree."""
    per = len(tree["blocks"]) // shape[1]
    return tree["blocks"][k * per:(k + 1) * per]


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


CASES = [(shape, sched) for shape in SHAPES for sched in SCHEDULES]


def _ids(case):
    return f"{_name(case[0])}-{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stage_grads_equal_the_row_pipe(stages, rows, case):
    """Each stage's layer grads and the CE bitwise the row pipe's on the
    same rows; the grads of the leaves off 'model' within 1e-5; the
    stages' busy and idle rounds sum to the oracle's."""
    shape, sched = case
    recs = [r[sched] for r in stages[_name(shape)]]
    row = rows[(_name(shape), sched)]
    rounds, busy, idle = pl.pipeline_bubble_counts(shape[1], M, sched)
    for p in range(shape[0]):
        mine = recs[p * shape[1]:(p + 1) * shape[1]]
        want = row["shards"][p]
        assert sum(r["counts"][1] for r in mine) == busy
        assert sum(r["counts"][2] for r in mine) == idle
        assert all(r["counts"][0] == rounds for r in mine)
        for k, rec in enumerate(mine):
            assert torch.equal(rec["ce"], want["ce"]), (p, k)
            got = rec["grads"]
            for a, b in zip(leaves(got["blocks"]), leaves(_stage_slice(want["grads"], shape, k))):
                assert torch.equal(a, b), (p, k)
            for (path, a), (_, b) in zip(
                    flatten_with_path({x: v for x, v in got.items() if x != "blocks"}),
                    flatten_with_path({x: v for x, v in want["grads"].items()
                                       if x != "blocks"})):
                err = float((a - b).abs().max())
                assert err <= RTOL * max(float(b.abs().max()), 1e-30), (p, k, path, err)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_stage_train_steps(stages, rows, reference, case):
    """Two AdamW steps: the processes read the same metrics, within 1e-5
    of the reference's pipe and of the row pipe's; each process's params
    within 1e-5 of the row pipe's where both steps' grads clear
    GRAD_FLOOR, and within the row pipe's own distance to the reference's
    plus 1e-5."""
    shape, sched = case
    recs = [r[sched] for r in stages[_name(shape)]]
    row = rows[(_name(shape), sched)]
    z = reference
    cfg = _cfg()
    for i in range(STEPS):
        for key in ("loss", "grad_norm"):
            got = {r[f"{key}{i}"] for r in recs}
            assert len(got) == 1, (key, i, got)
            got = got.pop()
            ref = float(z[f"{_name(shape)}/{key}{i}"])
            assert _close(got, ref, RTOL), (shape, sched, key, i, got, ref)
            assert _close(got, row[f"{key}{i}"], RTOL), (shape, sched, key, i, got,
                                                         row[f"{key}{i}"])
    want = dict(flatten_with_path(convert.params_from_numpy(
        _nest(z, f"{_name(shape)}/final"), cfg, "cpu")))
    base = dict(flatten_with_path(row["params"]))
    g = row["grads"]
    worst = 0.0
    for r, rec in enumerate(recs):
        k = r % shape[1]
        per = len(rec["params"]["blocks"])
        for path, a in flatten_with_path(rec["params"]):
            # the stage's layer j is the row's k * per + j
            full = path if path[0] != "blocks" else ("blocks", path[1] + k * per) + path[2:]
            b = base[full]
            clear = (g[0][full].abs() >= GRAD_FLOOR) & (g[1][full].abs() >= GRAD_FLOOR)
            err = float(((a - b).abs() * clear).max())
            worst = max(worst, float((a - b).abs().max()))
            assert err <= PARAM_TOL, (shape, sched, r, path, err)
            ref = torch.from_numpy(np.asarray(want[full]))
            own = float(((b - ref).abs() * clear).max())
            assert float(((a - ref).abs() * clear).max()) <= own + PARAM_TOL, (r, path)
    print(f"{case}: params vs the row pipe at most {worst:.3e} over every element")


@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_stage_forward_equals_the_row_pipe(stages, ref_inputs, shape):
    """The forward pipe one process a stage: the last stage's logits of its
    data position's rows bitwise the one-process forward pipe's, the
    other stages' None; the stages' busy and idle rounds sum to the
    oracle's."""
    cfg, params, batches = _inputs(ref_inputs)
    tokens = batches[0]["tokens"][:, :-1]
    with torch.no_grad():
        want = pl.make_pipeline_forward(cfg, _mesh(shape), M)(params, tokens)
    rounds, busy, idle = pl.pipeline_bubble_counts(shape[1], M, "forward")
    recs = stages[_name(shape)]
    for p in range(shape[0]):
        row = [r["forward"] for r in recs[p * shape[1]:(p + 1) * shape[1]]]
        assert all(out is None for out, _ in row[:-1])
        rows = collective.shard_rows({"x": want}, M, shape[0], p)["x"]
        assert torch.equal(row[-1][0], rows), p
        assert all(c[0] == rounds for _, c in row)
        assert sum(c[1] for _, c in row) == busy and sum(c[2] for _, c in row) == idle


@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_gpipe_equals_1f1b_in_the_stage_layout(stages, shape):
    for rec in stages[_name(shape)]:
        a, b = rec["gpipe"], rec["1f1b"]
        assert torch.equal(a["loss"], b["loss"])
        assert all(torch.equal(x, y) for x, y in zip(leaves(a["grads"]), leaves(b["grads"])))
        assert all(a[f"{k}{i}"] == b[f"{k}{i}"] for k in ("loss", "aux", "grad_norm")
                   for i in range(STEPS))
        assert all(torch.equal(x, y) for x, y in zip(leaves(a["params"]), leaves(b["params"])))


@pytest.mark.parametrize("shape", SHAPES, ids=_name)
def test_stage_checkpoint_cross_loads(stages, rows, shape):
    """Process 0's checkpoint holds every stage's layers: the port restores
    it into the row layout's tree and the reference's checkpoint module
    into the same tree, both bitwise the stages' states."""
    import jax
    import jax.numpy as jnp
    from repro.ft import checkpoint as jckpt

    recs = stages[_name(shape)]
    d = str(stages["dir"] / f"ckpt_{_name(shape)}")
    like = rows[(_name(shape), "1f1b")]["state"]
    got = tckpt.restore(d, like)
    # the stages' states (row 0's processes): stage k's layers are rows
    # k * per .. of each layer list
    want = [dict(flatten_with_path(recs[k]["1f1b"]["state"])) for k in range(shape[1])]
    per = len(recs[0]["1f1b"]["state"]["params"]["blocks"])
    for path, a in flatten_with_path(got):
        k = 0
        if "blocks" in path:
            i = path.index("blocks")
            k, j = divmod(path[i + 1], per)
            path = path[:i + 1] + (j,) + path[i + 2:]
        assert torch.equal(a, want[k][path]), path
    # the reference's module reads the same files into the same tree of
    # JAX arrays
    back = jckpt.restore(d, unflatten(like, [jnp.asarray(x.numpy()) for x in leaves(like)]))
    for (path, a), b in zip(flatten_with_path(got), jax.tree.leaves(back)):
        assert np.array_equal(a.numpy(), np.asarray(b)), path


def _keep(routes, cap):
    """The reference's kept set: token-major positions over the call's
    choices, against ``cap``."""
    flat = routes.reshape(-1)
    onehot = np.eye(int(flat.max()) + 1, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return pos < cap


def test_moe_stages(stages, reference):
    """mixtral on (1, 2): loss, aux and grad norm of both steps within 1e-5
    of the reference's pipe under both schedules; each stage's forward
    units route its own layer and keep the reference's set against the
    capacity from the global batch, with drops."""
    from repro_torch.models.moe import capacity_for

    z = reference
    cfg = _moe_cfg()
    recs = stages["moe"]
    for sched in SCHEDULES:
        for i in range(STEPS):
            for key in ("loss", "aux", "grad_norm"):
                got = {r[sched][f"{key}{i}"] for r in recs}
                assert len(got) == 1, (sched, key, i, got)
                got = got.pop()
                ref = float(z[f"moe/{key}{i}"])
                assert _close(got, ref, RTOL), (sched, key, i, got, ref)
    cap = min(capacity_for(cfg, B * S), B * S)
    dropped = 0
    for k, rec in enumerate(recs):
        for sched in SCHEDULES:
            calls = rec[sched]["routes"]
            assert len(calls) == MOE_M  # one layer a stage, one microbatch
            idx, keep = calls[0]
            ref = z[f"moe/route{k}"]
            np.testing.assert_array_equal(idx.numpy(), ref.reshape(-1))
            want = _keep(ref, cap)
            np.testing.assert_array_equal(keep.numpy(), want)
            dropped += int((~want).sum())
    assert dropped, dropped


def test_train_launcher_one_process_a_stage(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --strategy
    pipeline`` on the CPU's (2, 2) mesh: one process a stage, process 0
    alone prints; its checkpoint (every stage's layers) resumes in one
    process."""
    from repro_torch.launch import train as ttrain

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    ck = tmp_path / "ck"
    smoke = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4", "--strategy",
             "pipeline"]
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *smoke,
                        "--steps", "2", "--ckpt", str(ck), "--ckpt-every", "2"],
                       capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = [x for x in r.stdout.splitlines() if x and not x.startswith("*")]
    assert out == ["device cpu  arch qwen3_0p6b  strategy pipeline  mesh {'data': 2, "
                   "'model': 2}",
                   "pipeline stages 2  boundaries (0, 1, 2)  microbatches 2  schedule 1f1b",
                   "done"]
    state = ttrain.main(smoke + ["--steps", "3", "--ckpt", str(ck)])
    assert int(state["step"]) == 3 and len(state["params"]["blocks"]) == 2
