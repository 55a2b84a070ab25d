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
  eps); below it AdamW's ``g / (|g| + eps)`` turns any rounding, the
  all-reduces' summation order as much as one ulp on the reference's own
  params (its envelope, ``GRAD_FLOOR``), into differences up to ~6e-5
  (printed, with their count), as it puts the one-process port ~2e-5 from
  the reference;
  and no more than 1e-5 farther from the reference's than the
  one-process port's own params are there.  Every process holds exactly
  the slices the reference's sharded state holds (its ``shard_shape``),
  with values equal to the gathered tree's slice.  Routing (``gate_idx``,
  ``keep``) is identical across each model group; at factor 0.75 the kept
  set equals the reference's, some choices drop, and routing each
  process's rows alone would drop another set.  The router's gradient
  across data processes (aux weight 1, the load-balancing loss's path)
  equals one process's.  The SSM and hybrid families (mamba2_2p7b,
  zamba2_2p7b: Mamba2 blocks on each rank's heads) under
  ai_core_assignment on (1, 2) and (1, 4) and fused on (2, 2), the
  enc-dec (seamless_m4t_large_v2, with 24 encoder frames a sample) and
  VLM (internvl2_76b, 8 patch embeddings prepended) families under
  ai_core_assignment on (1, 2), held the same way; their (1, 4) and
  (2, 2) cases to the reference's (1, 2) run of the same arch
  (``REF_RUN``) and to their own mesh's shards.  The reference's cases
  compile in threads of its one subprocess.
* Gradient compressors (``optim.compress``: int8 and top-k, ``COMPRESS``)
  on qwen3 under fused (2, 1) (2 data processes), ai_core_assignment
  (1, 2) and fused (2, 2), each state starting with a zero ``ef`` placed
  as the params: loss and grad norm within 1e-5 of the reference's (1, 2)
  run (``REF_RUN``) and of one process; every process's ``ef`` slices the
  reference's ``shard_shape``, the gathered ``ef`` within 1e-5 of both
  (an int8 code at a rounding tie may flip, counted).  The one-process
  runs are shared by the cases that differ only in their mesh.
* Serving: ``launch.serve.run_static`` (f32) on (1, 2) and (2, 2): tokens
  equal to the one-process run's except at a top-2 margin below 1e-5
  (printed), logits within 1e-5 of max|logit|.  On (1, 2) also mamba2 and
  zamba2 through ``run_static``, seamless and internvl2 through
  ``serve.step.generate``, and int8 trees (``quantize_params``) of
  qwen2_72b (random q/k/v biases, split beside whole int8 weights) and
  zamba2, each held to its one-process run the same way; every process's
  caches and cross K/V are the reference's ``cache_specs`` shards.
* ``dist.tensor``'s four Functions and ``sum_across`` on 2 gloo
  processes, forward and backward against the whole computation,
  including both adjoints of ``gather``; Mamba2's gathered ``in_proj`` and
  its ``out_norm`` across the group the same way; the launchers under
  ``torchrun --nproc-per-node 4`` on the CPU (the dense and MoE families,
  then mamba2 training under fused and zamba2 serving), a world of
  another size refused naming both commands.

The children are spawned fresh (``collective.spawn``: one spawn per mesh
shape running every case on it, a file store under the test's temporary
directory, every child joined within a timeout), while the reference's
subprocess compiles: it writes its params and batches first.
"""

import dataclasses
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
from repro_torch.dist import tensor as tp  # noqa: E402
from repro_torch.ft.elastic import make_mesh_for, state_shardings  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

CPU = torch.device("cpu")
RTOL, PARAM_TOL, MARGIN_TOL = 1e-5, 1e-5, 1e-5
#: one-process gradients below this (100 x AdamW's eps) make AdamW's
#: first updates g / (|g| + eps) amplify any rounding, the reference's own
#: as much as the port's: one ulp on the reference's initial params moves
#: mamba2's 20-step loss by up to 3.2e-5 and zamba2's by up to 4.4e-6
#: (tools/tp_drift_study.py's envelope, a CPU run), as far as the port's
#: processes and its one process sit from it.  Elements below the floor are
#: held through that envelope (tests/test_torch_drift.py), not elementwise
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
    "mamba2_ai_1x2": ("mamba2_2p7b", "ai_core_assignment", (1, 2), None),
    "mamba2_ai_1x4": ("mamba2_2p7b", "ai_core_assignment", (1, 4), None),
    "mamba2_fused_2x2": ("mamba2_2p7b", "fused", (2, 2), None),
    "zamba2_ai_1x2": ("zamba2_2p7b", "ai_core_assignment", (1, 2), None),
    "zamba2_ai_1x4": ("zamba2_2p7b", "ai_core_assignment", (1, 4), None),
    "zamba2_fused_2x2": ("zamba2_2p7b", "fused", (2, 2), None),
    "seamless_ai_1x2": ("seamless_m4t_large_v2", "ai_core_assignment", (1, 2), None),
    "internvl2_ai_1x2": ("internvl2_76b", "ai_core_assignment", (1, 2), None),
    "qwen3_int8_fused_2x1": ("qwen3_0p6b", "fused", (2, 1), None),
    "qwen3_topk_fused_2x1": ("qwen3_0p6b", "fused", (2, 1), None),
    "qwen3_int8_ai_1x2": ("qwen3_0p6b", "ai_core_assignment", (1, 2), None),
    "qwen3_topk_ai_1x2": ("qwen3_0p6b", "ai_core_assignment", (1, 2), None),
    "qwen3_int8_fused_2x2": ("qwen3_0p6b", "fused", (2, 2), None),
    "qwen3_topk_fused_2x2": ("qwen3_0p6b", "fused", (2, 2), None),
}
#: the gradient compressor cases (``optim.compress``): case -> compressor;
#: their state starts with a zero ``ef``, placed as the params are
COMPRESS = {case: case.split("_")[1] for case in CASES if case.split("_")[1] in ("int8", "topk")}
#: cases whose loss, grad norm and params are held to the reference's
#: jitted step on another mesh of the same arch (its (1, 2) run: the
#: reference's sharded steps agree across meshes to rounding), their shards
#: read from their own mesh's specs; one compile fewer each
REF_RUN = {"mamba2_ai_1x4": "mamba2_ai_1x2", "mamba2_fused_2x2": "mamba2_ai_1x2",
           "zamba2_ai_1x4": "zamba2_ai_1x2", "zamba2_fused_2x2": "zamba2_ai_1x2",
           "qwen3_int8_fused_2x1": "qwen3_int8_ai_1x2", "qwen3_int8_fused_2x2": "qwen3_int8_ai_1x2",
           "qwen3_topk_fused_2x1": "qwen3_topk_ai_1x2", "qwen3_topk_fused_2x2": "qwen3_topk_ai_1x2"}
#: the stubbed frontends' inputs: batch key and rows a sample (encoder
#: frames, prepended patch embeddings)
FRONT = {"seamless_m4t_large_v2": ("frames", 24), "internvl2_76b": ("embeds", 8)}
#: serving on (1, 2) under ai_core_assignment: case -> (arch, entry point,
#: int8 weights)
SERVE_CASES = {
    "mamba2_static": ("mamba2_2p7b", "run_static", False),
    "zamba2_static": ("zamba2_2p7b", "run_static", False),
    "zamba2_int8": ("zamba2_2p7b", "run_static", True),
    "qwen2_int8": ("qwen2_72b", "run_static", True),
    "seamless_generate": ("seamless_m4t_large_v2", "generate", False),
    "internvl2_generate": ("internvl2_76b", "generate", False),
}
#: the caches' rows: run_static's (two 16-token chunks, 8 new) and generate's
STATIC_LEN, GENERATE_LEN = 40, 48
#: the families with Mamba2 blocks
MAMBA_ARCHS = ("mamba2_2p7b", "zamba2_2p7b")
#: the mesh shapes this module spawns; ``test_torch_tp_wide.py`` imports its
#: fixtures and case tests for (1, 4) and (2, 2), so that the two halves'
#: spawns and reference compiles run on two workers
SHAPES = [(1, 2), (2, 1)]
#: limits on each mesh shape's spawn and on the reference's subprocess, near
#: their measured times (25-56 s and 133-143 s under the suite's six workers)
SPAWN_TIMEOUT = 150
REF_TIMEOUT = 300
SERVE_NEW, SERVE_CHUNK = 8, 16

_REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.dist.sharding import data_specs, param_specs
from repro.optim.adamw import AdamWConfig, OptState
from repro.optim.compress import Int8Compressor, TopKCompressor
from repro.train.step import init_state, make_loss_fn, make_train_step

opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
COMPRESSORS = {"int8": Int8Compressor(), "topk": TopKCompressor()}
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
    if arch in FRONT:
        key, rows = FRONT[arch]
        frng = np.random.default_rng(6)
        for i in range(STEPS):
            res[f"{arch}/{key}{i}"] = frng.standard_normal((B, rows, cfg.d_model)).astype(
                np.float32)
    for k, v in jax.tree_util.tree_flatten_with_path(states[arch]["params"])[0]:
        res[f"{arch}/params" + jax.tree_util.keystr(k)] = np.asarray(v)
# the inputs first, so that the port's runs start while the steps compile
np.savez(sys.argv[2] + ".tmp.npz", **res)
os.replace(sys.argv[2] + ".tmp.npz", sys.argv[2])


def batches_of(arch):
    out = []
    for i in range(STEPS):
        b = {"tokens": jnp.asarray(res[f"{arch}/tokens{i}"])}
        if arch in FRONT:
            b[FRONT[arch][0]] = jnp.asarray(res[f"{arch}/{FRONT[arch][0]}{i}"])
        out.append(b)
    return out


def compiled(name):
    # the case's jitted step, compiled, and its state / batch shardings
    arch, strategy, (d, m), cf = CASES[name]
    state0, batch0 = start(name), batches_of(arch)[0]
    # Auto axes (jax.make_mesh gives Explicit ones)
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
    with mesh:
        ps = param_specs(state0["params"], mesh, strategy)
        specs = {"params": ps, "opt": OptState(mu=ps, nu=ps, step=P()), "step": P()}
        if name in COMPRESS:
            specs["ef"] = ps
        ss = ns(mesh, specs)
        bs = ns(mesh, data_specs(batch0, mesh))
        step = jax.jit(make_train_step(config(arch, cf), opt, grad_accum=GA,
                                       compress=COMPRESSORS.get(COMPRESS.get(name))),
                       in_shardings=(ss, bs), out_shardings=(ss, None))
        return step.lower(state0, batch0).compile(), ss, bs


def start(name):
    # the case's first state: a compressor's starts with a zero ef
    state0 = states[CASES[name][0]]
    if name in COMPRESS:
        state0 = dict(state0, ef=COMPRESSORS[COMPRESS[name]].init(state0["params"]))
    return state0


# the cases' compiles run in threads (XLA compiles outside the GIL); their
# steps then run in turn
from concurrent.futures import ThreadPoolExecutor

run = [name for name in CASES if name not in REF_RUN]
with ThreadPoolExecutor(4) as pool:
    steps = dict(zip(run, pool.map(compiled, run)))

# the cases held to another case's run after the runs they copy
for name, (arch, strategy, (d, m), cf) in sorted(CASES.items(), key=lambda kv: kv[0] in REF_RUN):
    cfg = config(arch, cf)
    state0 = states[arch]
    if name in REF_RUN:
        # the metrics and params of the run named, the shards of this mesh
        for key in [k for k in res if k.startswith(REF_RUN[name] + "/")]:
            if "shard" not in key:
                res[name + key[len(REF_RUN[name]):]] = res[key]
        mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m), ("data", "model"))
        ps = param_specs(state0["params"], mesh, strategy)
        flat = jax.tree_util.tree_flatten_with_path(state0["params"])[0]
        for tree in ("params", "ef") if name in COMPRESS else ("params",):
            for (k, v), sp in zip(flat, jax.tree_util.tree_leaves(
                    ps, is_leaf=lambda x: isinstance(x, P))):
                res[f"{name}/shard_{tree}" + jax.tree_util.keystr(k)] = np.asarray(
                    NamedSharding(mesh, sp).shard_shape(v.shape))
        continue
    batches = batches_of(arch)
    step, ss, bs = steps[name]
    state = jax.device_put(start(name), ss)
    for i, t in enumerate(batches):
        state, met = step(state, jax.device_put(t, bs))
        res[f"{name}/loss{i}"] = np.asarray(met["loss"])
        res[f"{name}/grad_norm{i}"] = np.asarray(met["grad_norm"])
    for tree in ("params", "ef") if name in COMPRESS else ("params",):
        for k, v in jax.tree_util.tree_flatten_with_path(state[tree])[0]:
            key = jax.tree_util.keystr(k)
            res[f"{name}/{tree}" + key] = np.asarray(v)
            res[f"{name}/shard_{tree}" + key] = np.asarray(v.sharding.shard_shape(v.shape))
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
                                               {"tokens": batches[0]["tokens"][:B // GA]})
        finally:
            jax.lax.top_k = top_k
        for j, idx in enumerate(calls):
            res[f"{name}/route{j}"] = idx

# the serving caches' shards on (1, 2): cache_specs, and for the cross K/V
# the reference dry-run's (None, data, None, model, None)
from repro.dist.sharding import cache_specs, fix_spec
from repro.models import encdec, transformer

mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
for name, (arch, entry, int8) in SERVE_CASES.items():
    if int8:
        continue
    cfg = config(arch, None)
    max_len = GENERATE_LEN if entry == "generate" else STATIC_LEN
    mod = encdec if cfg.is_enc_dec else transformer
    caches = {"caches": jax.eval_shape(lambda: mod.init_caches(cfg, 4, max_len, jnp.float32))}
    specs = {"caches": cache_specs(caches["caches"], mesh)}
    if cfg.is_enc_dec:
        caches["kv"] = jax.eval_shape(
            lambda p: encdec.cross_kv(p, cfg, jnp.zeros((4, FRONT[arch][1], cfg.d_model))),
            jax.eval_shape(lambda: encdec.init(jax.random.PRNGKey(0), cfg, jnp.float32)))
        specs["kv"] = jax.tree.map(
            lambda l: P(*fix_spec((None, "data", None, "model", None), l.shape, mesh)),
            caches["kv"])
    flat_specs = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    for (k, v), sp in zip(jax.tree_util.tree_flatten_with_path(caches)[0], flat_specs):
        res[f"{name}/cache" + jax.tree_util.keystr(k)] = np.asarray(
            NamedSharding(mesh, sp).shard_shape(v.shape))
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


def _mine(module) -> dict:
    """The cases of ``module``'s mesh shapes (its ``SHAPES``)."""
    return {c: v for c, v in CASES.items() if v[2] in module.SHAPES}


#: how each case test takes its parameters from its module's shapes
_PARAMETERS = {
    "test_train_metrics": ("case", lambda mine, shapes: list(mine)),
    "test_train_params": ("case", lambda mine, shapes: [c for c in mine if c not in COMPRESS]),
    "test_processes_hold_the_reference_slices": ("case", lambda mine, shapes: list(mine)),
    "test_placed_state_bytes_equal_the_stand_in": ("case", lambda mine, shapes: list(mine)),
    "test_compressor_error_feedback": ("case", lambda mine, shapes: [c for c in mine
                                                                      if c in COMPRESS]),
    "test_static_serving_per_mesh_position": (
        "shape", lambda mine, shapes: [s for s in ((1, 2), (2, 2)) if s in shapes]),
}


def pytest_generate_tests(metafunc):
    spec = _PARAMETERS.get(metafunc.function.__name__)
    if spec is not None:
        name, pick = spec
        metafunc.parametrize(name, pick(_mine(metafunc.module), metafunc.module.SHAPES))


@pytest.fixture(scope="module")
def reference_run(request, tmp_path_factory):
    """The reference's jitted steps on 4 fake CPU devices, one subprocess:
    started here, its inputs (params, batches) written before its steps
    compile.  It runs the module's cases and the runs they are held to
    (``REF_RUN``).  Yields (process, inputs path, results path, log path)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmp = tmp_path_factory.mktemp("ref_tp")
    out, ins, log = tmp / "ref.npz", tmp / "inputs.npz", tmp / "ref.log"
    mine = _mine(request.module)
    cases = {c: v for c, v in CASES.items() if c in mine or c in
             {REF_RUN[k] for k in mine if k in REF_RUN}}
    serve = SERVE_CASES if (1, 2) in request.module.SHAPES else {}
    code = (f"B, S, GA, STEPS = {B}, {S}, {GA}, {STEPS}\nCASES = {cases!r}\n"
            f"COMPRESS = {COMPRESS!r}\nREF_RUN = {REF_RUN!r}\nFRONT = {FRONT!r}\n"
            f"SERVE_CASES = {serve!r}\n"
            f"STATIC_LEN, GENERATE_LEN = {STATIC_LEN}, {GENERATE_LEN}\n" + _REF_SCRIPT)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(out), str(ins)], stdout=f, stderr=subprocess.STDOUT,
            text=True, cwd=repo,
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
def reference(reference_run, runs, one_process):
    """The reference's results, once its subprocess ends (after the port's
    runs and one-process steps, which overlap it)."""
    proc, _, out, log = reference_run
    proc.wait(REF_TIMEOUT)
    assert "REF_TP_OK" in log.read_text(), log.read_text()
    return out


def _inputs(ref_path, case):
    arch, _, _, cf = CASES[case]
    z = np.load(ref_path)
    cfg = _cfg(arch, cf)
    params = convert.params_from_numpy(_nest(z, f"{arch}/params"), cfg, "cpu")
    batches = [{"tokens": torch.from_numpy(z[f"{arch}/tokens{i}"]).long()}
               for i in range(STEPS)]
    if arch in FRONT:
        key = FRONT[arch][0]
        for i, b in enumerate(batches):
            b[key] = torch.from_numpy(z[f"{arch}/{key}{i}"])
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


def _compressor(case):
    from repro_torch.optim.compress import Int8Compressor, TopKCompressor

    return {"int8": Int8Compressor(), "topk": TopKCompressor(), None: None}[COMPRESS.get(case)]


def _state(case, params):
    """The case's first train state: a compressor's with a zero ``ef``."""
    state = tstep.make_state(params)
    if case in COMPRESS:
        state["ef"] = _compressor(case).init(params)
    return state


def _train(case, ref_path, mesh, data, model):
    """Two steps of ``case`` in this process's position: metrics, its
    local leaves, the gathered params and step 1's routing (and a
    compressor's ``ef``: its slices and the gathered tree)."""
    _, strategy, _, _ = CASES[case]
    cfg, params, batches = _inputs(ref_path, case)
    state = _state(case, params)
    specs = state_shardings(state, mesh, strategy)
    state = tsh.place(state, specs, mesh, data, model)
    shards = tsh.data_shards(specs["params"], mesh) if data is not None else None
    mshards = tsh.model_shards(specs["params"], mesh) if model is not None else None
    step = tstep.make_train_step(cfg, OPT, grad_accum=GA, group=data, shards=shards,
                                 model=model, model_shards=mshards,
                                 compress=_compressor(case))
    rec = {"placed_bytes": sum(t.untyped_storage().nbytes() for _, t in flatten_with_path(state)
                               if isinstance(t, torch.Tensor))}
    for i, batch in enumerate(batches):
        with _Routes() as calls:
            state, met = step(state, batch)
        if i == 0:
            # the first microbatch's forward: one call a layer
            rec["routes"] = calls[:cfg.num_layers] if cfg.moe_experts else []
        rec[f"loss{i}"] = met["loss"].item()
        rec[f"grad_norm{i}"] = met["grad_norm"].item()
    for key, tree in (("", "params"), ("ef_", "ef")) if case in COMPRESS else (("", "params"),):
        rec[key + "local"] = state[tree]
        whole = collective.gather_tree(state[tree], shards, data)
        rec[key + "params"] = collective.gather_tree(whole, mshards, model)
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


def _front(arch):
    """The serving cases' frontend stub input (B 4), or none."""
    if arch not in FRONT:
        return {}
    key, rows = FRONT[arch]
    x = np.random.default_rng(8).standard_normal((4, rows, _cfg(arch).d_model))
    return {key: torch.from_numpy(x.astype(np.float32))}


def _serve_params(arch, int8, mesh=None, data=None, model=None):
    """A serving case's params (seed 0; a bias config's biases random; int8
    from ``quantize_params``), this position's slices with a ``model``."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params

    cfg = _cfg(arch)
    mod = encdec if cfg.is_enc_dec else tf
    params = mod.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                      device="cpu")
    g = torch.Generator().manual_seed(9)
    for blk in params.get("blocks", []):
        for proj in blk["mixer"].values():
            if isinstance(proj, dict) and "b" in proj:
                proj["b"] = 0.5 * torch.randn(proj["b"].shape, generator=g)
    if int8:
        params = quantize_params(params)
    if model is not None:
        params = tsh.place(params, tsh.param_specs(params, mesh, "ai_core_assignment"), mesh,
                           data, model)
    return cfg, params


class _Serving:
    """Records what a serving run makes: the caches' and cross K/V's leaf
    shapes and every head's logits."""

    def __init__(self):
        from repro_torch.models import encdec
        from repro_torch.models import transformer as tf

        self.spots = [(tf, "init_caches", "caches"), (encdec, "init_caches", "caches"),
                      (encdec, "cross_kv", "kv"), (tf, "head_logits", "logits"),
                      (encdec, "head_logits", "logits")]
        self.rec = {"caches": [], "kv": [], "logits": []}

    def __enter__(self):
        self.orig = [getattr(mod, name) for mod, name, _ in self.spots]
        for (mod, name, key), fn in zip(self.spots, self.orig):
            def recording(*a, _fn=fn, _key=key, **kw):
                out = _fn(*a, **kw)
                self.rec[_key].append(out)
                return out
            setattr(mod, name, recording)
        return self.rec

    def __exit__(self, *exc):
        for (mod, name, _), fn in zip(self.spots, self.orig):
            setattr(mod, name, fn)


def _shapes(tree):
    return {path: tuple(t.shape) for path, t in flatten_with_path(tree)
            if isinstance(t, torch.Tensor)}


def _serve_case(name, mesh=None, data=None, model=None):
    """A serving case (``SERVE_CASES``) on this position, or in one
    process: tokens, the logits of every step, the caches' and cross
    K/V's leaf shapes; ``generate``'s logits are its heads' outputs."""
    from repro_torch.launch.serve import run_static
    from repro_torch.serve.step import generate

    arch, entry, int8 = SERVE_CASES[name]
    cfg, params = _serve_params(arch, int8, mesh, data, model)
    with _Serving() as made:
        if entry == "run_static":
            res = run_static(params, cfg, _prompts(), new_tokens=SERVE_NEW, chunk=SERVE_CHUNK,
                             return_logits=True, mesh=mesh, group=data, model=model)
            tokens, logits = res["tokens"], torch.stack(res["logits"], dim=1)
        else:
            tokens = generate(params, cfg, _prompts(), SERVE_NEW, GENERATE_LEN,
                              dtype=torch.float32, model=model, **_front(arch))
            logits = torch.cat([x[:, -1:] for x in made["logits"]], dim=1)
    return {"tokens": tokens, "logits": logits, "caches": _shapes(made["caches"][0]),
            "kv": _shapes(made["kv"][0]) if made["kv"] else {}}


def _mamba_pieces(model, arch):
    """Layer 0's gathered ``in_proj`` and its ``out_norm`` across the group
    on this rank's slices, forward values and the grads of this rank's
    loss (``_mamba_inputs``)."""
    from repro_torch.models import layers, ssm

    cfg, p, x, c, y_in = _mamba_inputs(arch)
    d_inner = cfg.ssm_expand * cfg.d_model
    out = {}
    with tp.parallel(model=model):
        w = p["in_proj"]["w"].chunk(model.size, dim=1)[model.rank].clone().requires_grad_()
        xs = x.clone().requires_grad_()
        y = ssm._in_proj({"in_proj": {"w": w}}, cfg, xs, True)
        (y * c[model.rank]).sum().backward()
        out["in_proj"] = (y.detach(), w.grad, xs.grad)
        cols = slice(model.rank * d_inner // model.size, (model.rank + 1) * d_inner // model.size)
        ys = y_in[..., cols].clone().requires_grad_()
        scale = p["out_norm"]["scale"][cols].clone().requires_grad_()
        y = layers.rmsnorm_split_apply({"scale": scale}, ys, d_inner, cfg.norm_eps)
        (y * c[0][..., :d_inner][..., cols]).sum().backward()
        out["out_norm"] = (y.detach(), ys.grad, scale.grad)
    return out


def _mamba_inputs(arch):
    """``arch``'s scaled-down layer-0 Mamba2 params, an input x (B 2, L 5),
    every rank's loss weights c over the fused projection's width, and a
    (B 2, L 5, d_inner) input of ``out_norm`` with a random scale."""
    from repro_torch.models import ssm

    cfg = _cfg(arch)
    g = torch.Generator().manual_seed(11)
    p = ssm.mamba2_init(g, cfg, torch.float32, "cpu")
    p["out_norm"]["scale"] = torch.randn(p["out_norm"]["scale"].shape, generator=g)
    d_inner = cfg.ssm_expand * cfg.d_model
    wide = p["in_proj"]["w"].shape[1]
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    c = [torch.randn(2, 5, wide, generator=g) for _ in range(2)]
    return cfg, p, x, c, torch.randn(2, 5, d_inner, generator=g)


def _child(rank, nprocs, init_method, shape, ref_path, prompts, out_dir):
    torch.set_num_threads(1)
    mesh, data, model = _join(rank, nprocs, init_method, shape)
    rec = {"train": {c: _train(c, ref_path, mesh, data, model)
                     for c, spec in CASES.items() if spec[2] == shape}}
    if shape == (1, 2):
        rec["serve"] = _serve("ai_core_assignment", mesh, data, model, prompts)
        rec["functions"] = _functions(model)
        rec["serve_cases"] = {name: _serve_case(name, mesh, data, model) for name in SERVE_CASES}
        rec["mamba"] = {arch: _mamba_pieces(model, arch) for arch in MAMBA_ARCHS}
    if shape == (2, 2):
        rec["serve"] = _serve("fused", mesh, data, model, prompts)
    if shape == (2, 1):
        rec["router_grads"] = _router_grads(ref_path, data)
    torch.save(rec, os.path.join(out_dir, f"tp_{rank}.pt"))
    collective.close(data, model)


def _prompts():
    return torch.from_numpy(np.random.default_rng(7).integers(0, 512, (4, 24))).long()


@pytest.fixture(scope="module")
def runs(request, ref_inputs, tmp_path_factory):
    """Every process's records, per mesh shape of the module."""
    out = {}
    for shape in request.module.SHAPES:
        d, m = shape
        n = d * m
        path = tmp_path_factory.mktemp(f"tp_{d}x{m}")
        collective.spawn(_child, n, (shape, ref_inputs, _prompts(), str(path)),
                         timeout=SPAWN_TIMEOUT, workdir=str(path))
        out[shape] = [torch.load(path / f"tp_{r}.pt") for r in range(n)]
    return out


def _one_process(ref_path, case):
    """The port's one-process step: per-step metrics, the params after
    step 2 and the grads each step's AdamW update took."""
    from repro_torch.optim import adamw

    cfg, params, batches = _inputs(ref_path, case)
    state = _state(case, params)
    step = tstep.make_train_step(cfg, OPT, grad_accum=GA, compress=_compressor(case))
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
    return mets, state["params"], grads, state.get("ef")


@pytest.fixture(scope="module")
def one_process(request, ref_inputs):
    """Each of the module's cases' one-process run; one run serves every
    case whose arch, capacity factor and compressor are the same (the mesh
    does not enter it)."""
    mine, runs = _mine(request.module), {}
    for case, (arch, _, _, cf) in mine.items():
        key = (arch, cf, COMPRESS.get(case))
        if key not in runs:
            runs[key] = _one_process(ref_inputs, case)
    return {case: runs[(arch, cf, COMPRESS.get(case))]
            for case, (arch, _, _, cf) in mine.items()}


def _close(a, b, rtol):
    return abs(a - b) <= rtol * abs(b)


def _recs(runs, case):
    return [r["train"][case] for r in runs[CASES[case][2]]]


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
    _, one, grads, _ = one_process[case]
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
            shard = z[f"{case}/shard_params" + _ref_key(path)]
            want = tuple(int(x) for x in shard[len(shard) - leaf.dim():])
            assert tuple(leaf.shape) == want, (case, rank, path, tuple(leaf.shape), want)
            expect = whole[path]
            for sh, index, count in ((dsh[path], p, d), (msh[path], k, m)):
                if sh is not None:
                    dim, n = sh
                    size = expect.shape[dim] // n
                    expect = expect.narrow(dim, (index // (count // n)) * size, size)
            assert torch.equal(leaf, expect), (case, rank, path)


def test_placed_state_bytes_equal_the_stand_in(runs, reference, case):
    """Every process's placed train state (params and both moments, its
    slices) holds exactly the bytes ``launch.dryrun.tree_bytes`` gives a
    device for the state under the case's specs."""
    from repro_torch.launch.dryrun import tree_bytes

    _, strategy, (d, m), _ = CASES[case]
    mesh = make_mesh_for([CPU] * (d * m), model_axis=m)
    _, params, _ = _inputs(reference, case)
    state = _state(case, params)
    want = tree_bytes(state, state_shardings(state, mesh, strategy), mesh)
    for rec in _recs(runs, case):
        assert rec["placed_bytes"] == want, (case, rec["placed_bytes"], want)


def test_compressor_error_feedback(runs, reference, one_process, case):
    """A compressor's ``ef`` after two steps: every process holds exactly
    the reference's shard of each leaf (``shard_shape`` of its sharded
    state, ``ef`` placed as the params), and the gathered tree is within
    1e-5 of the reference's and of the one-process port's: the int8
    scale is the whole leaf's ``amax`` across the model group (and its
    layers: the reference's stacked leaf), top-k's threshold the whole
    leaf's k-th largest ``|g + ef|``.  An int8 code whose ``g + ef`` sits
    at a rounding tie may land one step apart (its errors then straddle
    half a step, equal and opposite); those are counted and printed."""
    arch, strategy, (d, m), _ = CASES[case]
    cfg = _cfg(arch)
    z = np.load(reference)
    want = dict(flatten_with_path(convert.params_from_numpy(_nest(z, f"{case}/ef"), cfg, "cpu")))
    one = dict(flatten_with_path(one_process[case][3]))
    recs = _recs(runs, case)
    for rank, rec in enumerate(recs):
        for path, leaf in flatten_with_path(rec["ef_local"]):
            shard = z[f"{case}/shard_ef" + _ref_key(path)]
            assert tuple(leaf.shape) == tuple(int(x) for x in shard[len(shard) - leaf.dim():]), (
                case, rank, path)
    flips = 0
    for path, a in flatten_with_path(recs[0]["ef_params"]):
        assert a.shape == want[path].shape, (case, path)
        for label, b in (("reference", want[path]), ("one process", one[path])):
            off = (a - b).abs() > PARAM_TOL
            if COMPRESS[case] == "int8":
                # a code at a rounding tie: the two errors straddle half a
                # step, a = -b (the two gradients differ by rounding)
                tie = (a + b).abs() <= PARAM_TOL
                flips += int((off & tie).sum())
                off &= ~tie
            assert not off.any(), (case, label, path, float((a - b).abs().max()))
    print(f"{case}: {flips} int8 codes at a rounding tie flipped")


def _keep(routes, cap):
    """The reference's kept set: token-major positions over the
    microbatch's choices, against ``cap``."""
    flat = routes.reshape(-1)
    onehot = np.eye(int(flat.max()) + 1, dtype=np.int64)[flat]
    pos = ((np.cumsum(onehot, axis=0) - 1) * onehot).sum(-1)
    return pos < cap


def test_routing_across_a_model_group(request, runs):
    """Every rank of a model group routes the same tokens the same way."""
    for case, (arch, _, (d, m), _) in _mine(request.module).items():
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
    for rec in recs:
        assert torch.equal(rec["tokens"], recs[0]["tokens"])
        assert rec["tokens"].shape == (4, SERVE_NEW)
    _hold_to_one_process(shape, recs[0]["tokens"], torch.stack(recs[0]["logits"], dim=1),
                         one["tokens"], torch.stack(one["logits"], dim=1))


def _hold_to_one_process(label, tokens, logits, one_tokens, one_logits):
    """The margin rule: tokens equal to one process's but at a top-2 margin
    below ``MARGIN_TOL`` (printed); a row equal throughout has its logits
    within 1e-5 of max|logit|."""
    top2 = one_logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    for row in range(tokens.shape[0]):
        diff = (tokens[row] != one_tokens[row]).nonzero()
        if len(diff):
            at = int(diff[0])
            print(f"{label} row {row}: first differing token at {at}, one-process margin "
                  f"{float(margin[row, at]):.3e}")
            assert float(margin[row, at]) < MARGIN_TOL
            continue
        err = float((logits[row] - one_logits[row]).abs().max())
        assert err <= 1e-5 * float(one_logits[row].abs().max()), (label, row, err)


@pytest.fixture(scope="module")
def one_process_serving():
    return {name: _serve_case(name) for name in SERVE_CASES}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_family_serving_per_mesh_position(runs, one_process_serving, case):
    """The SSM and hybrid families through ``run_static``, enc-dec and VLM
    through ``generate``, and int8 trees, on (1, 2): every process reads
    the same tokens, held to one process under the margin rule.  int8
    qwen2_72b keeps whole ``qw`` leaves beside its split column-parallel
    biases (gathered: without that the bias slice meets a whole product);
    int8 zamba2 computes its Mamba2 blocks whole against an SSM cache of
    this rank's heads."""
    arch, _, int8 = SERVE_CASES[case]
    recs = [r["serve_cases"][case] for r in runs[(1, 2)]]
    one = one_process_serving[case]
    for rec in recs:
        assert torch.equal(rec["tokens"], recs[0]["tokens"])
        assert rec["tokens"].shape == (4, SERVE_NEW)
        assert rec["logits"].shape == one["logits"].shape
    _hold_to_one_process(case, recs[0]["tokens"], recs[0]["logits"], one["tokens"],
                         one["logits"])
    cfg = _cfg(arch)
    if cfg.ssm_state:
        heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        for rec in recs:
            for path, shape in rec["caches"].items():
                if path[-1] == "ssm":
                    assert shape[1] == heads // 2, (case, path, shape)
                if path[-1] == "conv":
                    assert shape == one["caches"][path], (case, path, shape)


@pytest.mark.parametrize("case", [c for c, spec in SERVE_CASES.items() if not spec[2]])
def test_serving_caches_hold_the_reference_slices(runs, reference, case):
    """Every process's caches (SSM state heads split, conv states whole, KV
    heads split) and an enc-dec's cross K/V (this rank's heads) are the
    reference's ``shard_shape`` of them on (1, 2) (an enc-dec's caches are
    the reference's stacked dict under ``blocks``)."""
    z = np.load(reference)
    want = {k[len(f"{case}/cache"):]: tuple(int(x) for x in v[1:])
            for k, v in z.items() if k.startswith(f"{case}/cache") and not k.endswith("['len']")}
    encdec = _cfg(SERVE_CASES[case][0]).is_enc_dec
    for rec in (r["serve_cases"][case] for r in runs[(1, 2)]):
        got = {f"['{key}']" + _ref_key(path[1:] if encdec and key == "caches" else path): shape
               for key in ("caches", "kv") for path, shape in rec[key].items()}
        assert got == want, case


@pytest.mark.parametrize("arch", MAMBA_ARCHS)
def test_mamba2_in_proj_and_out_norm_against_the_whole_computation(runs, arch):
    """On 2 processes: ``in_proj``'s column slice gathered whole (the ranks
    read it differently: its weight's gradient sums both ranks' reads) and
    ``out_norm`` over the split ``d_inner`` (the sum of squares across the
    group), forward and backward against the whole computation."""
    from repro_torch.models import layers

    cfg, p, x, c, y_in = _mamba_inputs(arch)
    d_inner = cfg.ssm_expand * cfg.d_model
    w = p["in_proj"]["w"].clone().requires_grad_()
    xs = x.clone().requires_grad_()
    y = xs @ w
    (y * (c[0] + c[1])).sum().backward()
    ys = y_in.clone().requires_grad_()
    scale = p["out_norm"]["scale"].clone().requires_grad_()
    normed = layers.rmsnorm_apply({"scale": scale}, ys, cfg.norm_eps)
    (normed * c[0][..., :d_inner]).sum().backward()
    for rank, rec in enumerate(runs[(1, 2)]):
        got_y, got_w, got_x = rec["mamba"][arch]["in_proj"]
        torch.testing.assert_close(got_y, y.detach())
        torch.testing.assert_close(got_w, w.grad.chunk(2, dim=1)[rank])
        torch.testing.assert_close(got_x, xs.grad)
        alone = torch.einsum("bli,blo->io", x, c[rank]).chunk(2, dim=1)[rank]
        assert not torch.allclose(got_w, alone)
        cols = slice(rank * d_inner // 2, (rank + 1) * d_inner // 2)
        got_y, got_ys, got_scale = rec["mamba"][arch]["out_norm"]
        torch.testing.assert_close(got_y, normed.detach()[..., cols])
        torch.testing.assert_close(got_ys, ys.grad[..., cols])
        torch.testing.assert_close(got_scale, scale.grad[cols])


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


def test_check_supported_refuses_only_the_cnn():
    """Under a model group every LM family runs; a CNN config is refused
    (its model is ``models/resnet``)."""
    from repro_torch.models import transformer as tf

    model = collective.ModelGroup(0, 2, "gloo")
    with tp.parallel(model=model):
        with pytest.raises(NotImplementedError, match="CNN"):
            tf.check_supported(get_config("resnet18_vta"))
        for arch in ("mamba2_2p7b", "zamba2_2p7b", "seamless_m4t_large_v2", "internvl2_76b",
                     "deepseek_v2_236b"):
            tf.check_supported(get_config(arch).scaled_down())


def _torchrun(nproc, module, args, cwd, timeout=60):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(nproc), "-m", module, *args],
                       capture_output=True, text=True, env=env, cwd=cwd, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return [x for x in r.stdout.splitlines() if x and not x.startswith("*")]


@pytest.mark.parametrize("family", ["dense_moe", "ssm_hybrid"])
def test_launchers_per_mesh_position(tmp_path, family):
    """Both launchers under ``torchrun --nproc-per-node 4`` on the CPU, one
    process per position of the (2, 2) mesh: process 0 alone prints.  The
    dense and MoE families: the fused checkpoint (gathered over both groups
    by process 0) resumes in one process, mixtral serves.  The SSM and
    hybrid families: mamba2 trains under fused, zamba2 serves under
    ai_core_assignment."""
    from repro_torch.launch import train as ttrain

    smoke = ["--device", "cpu", "--smoke", "--seq", "32", "--batch", "4"]
    serve = ["--device", "cpu", "--smoke", "--batch", "4", "--prompt", "32", "--new-tokens",
             "4", "--strategy", "ai_core_assignment"]
    if family == "dense_moe":
        ck = tmp_path / "ck"
        out = _torchrun(4, "repro_torch.launch.train",
                        smoke + ["--steps", "2", "--ckpt", str(ck), "--ckpt-every", "2"],
                        tmp_path)
        assert out == ["device cpu  arch qwen3_0p6b  strategy fused  mesh {'data': 2, "
                       "'model': 2}", "done"]
        state = ttrain.main(smoke + ["--steps", "3", "--ckpt", str(ck)])
        assert int(state["step"]) == 3
        arch = "mixtral_8x22b"
    else:
        out = _torchrun(4, "repro_torch.launch.train",
                        smoke + ["--steps", "2", "--arch", "mamba2_2p7b", "--strategy", "fused"],
                        tmp_path)
        assert out == ["device cpu  arch mamba2_2p7b  strategy fused  mesh {'data': 2, "
                       "'model': 2}", "done"]
        arch = "zamba2_2p7b"
    out = _torchrun(4, "repro_torch.launch.serve", serve + ["--arch", arch], tmp_path)
    assert out[0] == f"mesh {{'data': 2, 'model': 2}}  arch {arch}  strategy ai_core_assignment"
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

