#!/usr/bin/env python3
"""Does training under tensor parallelism drift from one process over many
steps?  A CPU study of the SSM and hybrid families (not a tier-1 test).

    PYTHONPATH=src python3 tools/tp_drift_study.py [--steps 20]

mamba2_2p7b and zamba2_2p7b ``scaled_down()`` in float32, S 32, batch 8,
grad_accum 2, AdamW (lr 1e-3, warmup 2), the reference's params
(``PRNGKey(0)``) and one batch a step from a seeded numpy generator, each
trained four ways for ``--steps`` steps:

* the port under ai_core_assignment on a (1, 2) mesh, one gloo process per
  mesh position (``dist.collective.spawn``);
* the port in one process;
* the reference's jitted step sharded on an Auto-axis (1, 2) mesh of two
  fake CPU devices, and the same step unsharded on one device (one JAX
  subprocess, ``--xla_force_host_platform_device_count=2``).

It prints every step's four losses and, per arch, the largest relative
loss gap between the port's processes and one process beside the largest
gap between the reference's sharded and unsharded runs: two summation
orders of one computation in each package.  The gate rule of ``[tp]``
(params held where every update is decided) assumes the port's gap stays
within the reference's own.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

ARCHS = ("mamba2_2p7b", "zamba2_2p7b")
B, S, GA = 8, 32, 2

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.dist.sharding import data_specs, param_specs
from repro.optim.adamw import AdamWConfig, OptState
from repro.train.step import init_state, make_train_step

out = {}
opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
for arch in ARCHS:
    cfg = get_config(arch).scaled_down()
    state0 = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
    params = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(state0["params"])[0]}
    np.savez(os.path.join(OUT, arch + "_inputs.npz"), **{"params" + k: v
             for k, v in params.items()}, **{f"tokens{i}": t for i, t in enumerate(batches)})
    step = make_train_step(cfg, opt, grad_accum=GA)
    runs = {}
    one = jax.jit(step)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    ps = param_specs(state0["params"], mesh, "ai_core_assignment")
    ss = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      {"params": ps, "opt": OptState(mu=ps, nu=ps, step=P()), "step": P()},
                      is_leaf=lambda x: isinstance(x, P))
    bs = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      data_specs({"tokens": jnp.asarray(batches[0])}, mesh),
                      is_leaf=lambda x: isinstance(x, P))
    with mesh:
        sharded = jax.jit(step, in_shardings=(ss, bs), out_shardings=(ss, None))
    for name, fn in (("unsharded", one), ("sharded", sharded)):
        state, losses = state0, []
        with mesh:
            for t in batches:
                state, met = fn(state, {"tokens": jnp.asarray(t)})
                losses.append(float(met["loss"]))
        runs[name] = losses
    out[arch] = runs
with open(os.path.join(OUT, "ref.json"), "w") as f:
    json.dump(out, f)
"""


def _nest(z, prefix):
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


def _port_run(arch, out, steps, mesh=None, data=None, model=None):
    import torch

    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.dist import sharding as tsh
    from repro_torch.ft.elastic import state_shardings
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep

    cfg = get_config(arch).scaled_down()
    z = dict(np.load(os.path.join(out, arch + "_inputs.npz")))
    params = convert.params_from_numpy(_nest(z, "params"), cfg, "cpu")
    state = tstep.make_state(params)
    shards = mshards = None
    if model is not None:
        specs = state_shardings(state, mesh, "ai_core_assignment")
        state = tsh.place(state, specs, mesh, data, model)
        mshards = tsh.model_shards(specs["params"], mesh)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    step = tstep.make_train_step(cfg, opt, grad_accum=GA, group=data, shards=shards,
                                 model=model, model_shards=mshards)
    losses = []
    for i in range(steps):
        state, met = step(state, {"tokens": torch.from_numpy(z[f"tokens{i}"]).long()})
        losses.append(float(met["loss"]))
    return losses


def _child(rank, nprocs, init_method, arch, out, steps):
    import torch

    from repro_torch.dist import collective
    from repro_torch.ft.elastic import make_mesh_for

    torch.set_num_threads(1)
    mesh = make_mesh_for([torch.device("cpu")] * 2, model_axis=2)
    data, model = collective.mesh_groups(mesh, init_method=init_method, rank=rank,
                                         world_size=nprocs)
    losses = _port_run(arch, out, steps, mesh, data, model)
    if rank == 0:
        with open(os.path.join(out, arch + "_procs.json"), "w") as f:
            json.dump(losses, f)
    collective.close(data, model)


def _gap(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as out:
        code = (f"ARCHS, B, S, GA, STEPS, OUT = {ARCHS!r}, {B}, {S}, {GA}, {args.steps}, "
                f"{out!r}\n" + _REF)
        subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                       env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
                                JAX_PLATFORMS="cpu"))
        with open(os.path.join(out, "ref.json")) as f:
            ref = json.load(f)
        import torch

        from repro_torch.dist import collective

        torch.set_num_threads(1)
        for arch in ARCHS:
            collective.spawn(_child, 2, (arch, out, args.steps), workdir=out)
            with open(os.path.join(out, arch + "_procs.json")) as f:
                procs = json.load(f)
            one = _port_run(arch, out, args.steps)
            r = ref[arch]
            print(f"{arch}: step, port (1, 2) processes, port one process, reference sharded "
                  f"(1, 2), reference unsharded")
            for i in range(args.steps):
                print(f"  {i + 1:3d} {procs[i]:.8f} {one[i]:.8f} {r['sharded'][i]:.8f} "
                      f"{r['unsharded'][i]:.8f}")
            port_gap, ref_gap = _gap(procs, one), _gap(r["sharded"], r["unsharded"])
            print(f"{arch}: largest relative loss gap over {args.steps} steps: port processes "
                  f"vs one process {port_gap:.3e}; reference sharded vs unsharded "
                  f"{ref_gap:.3e}; port one process vs reference unsharded "
                  f"{_gap(one, r['unsharded']):.3e}")


if __name__ == "__main__":
    main()
