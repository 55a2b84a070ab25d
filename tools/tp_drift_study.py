#!/usr/bin/env python3
"""How far does the port's training drift from the reference over many
steps, measured against each package's own sensitivity to one rounding?
A CPU study of the SSM and hybrid families (not a tier-1 test).

    PYTHONPATH=src python3 tools/tp_drift_study.py [--steps 20] [--archs mamba2_2p7b ...]
    PYTHONPATH=src python3 tools/tp_drift_study.py --leaves zamba2_2p7b

mamba2_2p7b and zamba2_2p7b ``scaled_down()`` in float32, S 32, batch 8,
grad_accum 2, AdamW (lr 1e-3, warmup 2), the reference's params
(``PRNGKey(0)``) and one batch a step from a seeded numpy generator, each
trained for ``--steps`` steps:

* the port under ai_core_assignment on a (1, 2) mesh, one gloo process per
  mesh position (``dist.collective.spawn``);
* the port in one process;
* the reference's jitted step sharded on an Auto-axis (1, 2) mesh of two
  fake CPU devices, and the same step unsharded on one device (one JAX
  subprocess, ``--xla_force_host_platform_device_count=2``);
* the envelopes: the reference's unsharded run, and the port's one
  process, from initial params moved by one rounding, three ways
  (``PERTURBATIONS``): (a) every f32 element ``nextafter(+inf)``, (b)
  every element ``nextafter(-inf)``, (c) each element one ulp up or down,
  the sign drawn by ``numpy.random.default_rng(SIGN_SEED)`` on the
  reference's leaves (the port's signs are those arrays carried over by
  ``convert.params_from_numpy``).  A package's envelope is the largest
  relative loss gap of its three perturbed runs against its unperturbed
  one.

It prints every step's losses and, per arch, the largest relative loss gap
``max_t |a_t - b_t| / |b_t|`` of: the port's processes against its one
process, the port's one process against the reference unsharded, the
reference sharded against unsharded, and both envelopes.  The rule of
ROADMAP queue 3: a port gap within 2x the reference's envelope is the
training's own sensitivity to rounding, not a port fault.

``--leaves ARCH`` compares one gradient, leaf by leaf: the port's
``value_and_grad`` of the train loss (one process, the first batch whole)
against the reference's jitted one on the same params and tokens, each
leaf's gap scaled by the reference's own spread on that leaf (its jitted
gradient against the same computation under ``jax.disable_jit()``: two
orders of one computation).  It also compares the params after one train
step (grad_accum 2, clipping, AdamW) the same way.  Leaves are printed in
the order the backward reaches them (head first).
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
PERTURBATIONS = ("up", "down", "rand")
SIGN_SEED = 11
WORST = 10.0  # a leaf's gap / spread past which --leaves prints its worst element

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_config
from repro.dist.sharding import data_specs, param_specs
from repro.optim.adamw import AdamWConfig, OptState
from repro.train.step import init_state, make_loss_fn, make_train_step


def perturb(params, signs):
    return jax.tree.map(lambda p, s: jnp.nextafter(p, s * jnp.inf), params, signs)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


out = {}
opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
for arch in ARCHS:
    cfg = get_config(arch).scaled_down()
    state0 = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
    srng = np.random.default_rng(SIGN_SEED)
    signs = {"up": jax.tree.map(jnp.ones_like, state0["params"]),
             "down": jax.tree.map(lambda p: -jnp.ones_like(p), state0["params"]),
             "rand": jax.tree.map(lambda p: jnp.asarray(
                 srng.choice(np.float32([-1, 1]), p.shape)), state0["params"])}
    np.savez(os.path.join(OUT, arch + "_inputs.npz"),
             **{"params" + k: v for k, v in flat(state0["params"]).items()},
             **{"sign" + k: v for k, v in flat(signs["rand"]).items()},
             **{f"tokens{i}": t for i, t in enumerate(batches)})
    step = make_train_step(cfg, opt, grad_accum=GA)
    one = jax.jit(step)
    if LEAVES:
        grad = jax.value_and_grad(make_loss_fn(cfg), has_aux=True)
        b0 = {"tokens": jnp.asarray(batches[0])}
        (lj, _), gj = jax.jit(grad)(state0["params"], b0)
        s1j, mj = one(state0, b0)
        with jax.disable_jit():
            (ln, _), gn = grad(state0["params"], b0)
            s1n, mn = step(state0, b0)
        np.savez(os.path.join(OUT, arch + "_leaves.npz"),
                 **{"gjit" + k: v for k, v in flat(gj).items()},
                 **{"gnojit" + k: v for k, v in flat(gn).items()},
                 **{"pjit" + k: v for k, v in flat(s1j["params"]).items()},
                 **{"pnojit" + k: v for k, v in flat(s1n["params"]).items()})
        out[arch] = {"loss": [float(lj), float(ln)],
                     "grad_norm": [float(mj["grad_norm"]), float(mn["grad_norm"])]}
        continue
    runs = {}
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
    starts = {"unsharded": (one, state0), "sharded": (sharded, state0)}
    for name in PERTURBATIONS:
        starts[name] = (one, dict(state0, params=perturb(state0["params"], signs[name])))
    for name, (fn, state) in starts.items():
        losses = []
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
        if not key.startswith(prefix) or not key[len(prefix):].startswith("["):
            continue
        names = re.findall(r"\['([^']+)'\]", key[len(prefix):])
        node = out
        for n in names[:-1]:
            node = node.setdefault(n, {})
        node[names[-1]] = val
    return out


def _perturbed(params, how, signs):
    """``params`` with every element moved one ulp: up, down, or by the
    sign tree ``signs`` (``rand``)."""
    import torch

    from repro_torch.tree import tree_map

    if how == "up":
        return tree_map(lambda p: torch.nextafter(p, torch.full_like(p, float("inf"))), params)
    if how == "down":
        return tree_map(lambda p: torch.nextafter(p, torch.full_like(p, float("-inf"))), params)
    return tree_map(lambda p, s: torch.nextafter(p, s * float("inf")), params, signs)


def _port_run(arch, out, steps, mesh=None, data=None, model=None, perturb=None):
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
    if perturb is not None:
        signs = convert.params_from_numpy(_nest(z, "sign"), cfg, "cpu")
        params = _perturbed(params, perturb, signs)
    state = tstep.make_state(params)
    mshards = None
    if model is not None:
        specs = state_shardings(state, mesh, "ai_core_assignment")
        state = tsh.place(state, specs, mesh, data, model)
        mshards = tsh.model_shards(specs["params"], mesh)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    step = tstep.make_train_step(cfg, opt, grad_accum=GA, group=data, model=model,
                                 model_shards=mshards)
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


def _run_reference(repo, out, archs, steps, leaves):
    code = (f"ARCHS, B, S, GA, STEPS, OUT = {tuple(archs)!r}, {B}, {S}, {GA}, {steps}, "
            f"{out!r}\nPERTURBATIONS, SIGN_SEED, LEAVES = {PERTURBATIONS!r}, {SIGN_SEED}, "
            f"{leaves!r}\n" + _REF)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo,
                   env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
                            JAX_PLATFORMS="cpu"))
    with open(os.path.join(out, "ref.json")) as f:
        return json.load(f)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _backward_order(path):
    """Head first, then the blocks from the last layer down (a hybrid's
    shared block with its last group), the embedding last."""
    top = path[0]
    if top in ("final_norm", "head"):
        return (0, 0)
    if top == "blocks":
        return (1, -path[1])
    if top == "shared_attn":
        return (1, 0.5)
    return (2, 0)


def _leaf_table(title, port, jit, nojit, extra=()):
    """One line a leaf: max|ref jit|, the reference's jit-vs-nojit spread,
    the port's gap to the jitted reference and their ratio (all max|.|
    over the leaf).  A leaf whose ratio passes ``WORST`` also prints its
    worst element's index and its value in ``port``, ``jit``, ``nojit``
    and each tree of ``extra`` ((name, tree) pairs of the same shape)."""
    rows = []
    walks = [_walk(t) for _, t in extra]
    for (path, p), (_, j), (_, n), *more in zip(_walk(port), _walk(jit), _walk(nojit), *walks):
        scale = float(j.abs().max())
        spread = float((j - n).abs().max())
        gap = float((p - j).abs().max())
        at = int((p - j).abs().argmax())
        vals = [float(t.flatten()[at]) for t in (p, j, n, *(m for _, m in more))]
        rows.append((_backward_order(path), "/".join(map(str, path)), scale, spread, gap,
                     np.unravel_index(at, tuple(p.shape)), vals))
    rows.sort(key=lambda r: r[0])
    print(f"{title}: leaf, max|ref jit|, ref spread (jit vs disable_jit), port gap "
          f"(vs ref jit), gap / spread")
    names = ["port", "ref jit", "ref disable_jit", *(n for n, _ in extra)]
    for _, name, scale, spread, gap, at, vals in rows:
        ratio = gap / spread if spread else (float("inf") if gap else 0.0)
        print(f"  {name:40s} {scale:.3e} {spread:.3e} {gap:.3e} {ratio:9.2f}")
        if ratio > WORST:
            print(f"      worst element {tuple(int(i) for i in at)}: "
                  + ", ".join(f"{n} {v:.9e}" for n, v in zip(names, vals)))


def leaves_main(repo, arch):
    import torch

    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as tstep

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as out:
        ref = _run_reference(repo, out, [arch], 1, True)[arch]
        cfg = get_config(arch).scaled_down()
        z = dict(np.load(os.path.join(out, arch + "_inputs.npz")))
        lz = dict(np.load(os.path.join(out, arch + "_leaves.npz")))
        conv = lambda prefix: convert.params_from_numpy(_nest(lz, prefix), cfg, "cpu")  # noqa: E731
        params = convert.params_from_numpy(_nest(z, "params"), cfg, "cpu")
        batch = {"tokens": torch.from_numpy(z["tokens0"]).long()}
        (loss, _), grads = tstep.value_and_grad(tstep.make_loss_fn(cfg), params, batch)
        print(f"{arch}: loss port {float(loss):.9f}, reference jit {ref['loss'][0]:.9f}, "
              f"disable_jit {ref['loss'][1]:.9f}")
        _leaf_table(f"{arch}: gradient of the train loss", grads, conv("gjit"), conv("gnojit"))
        opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=1)
        state, met = tstep.make_train_step(cfg, opt, grad_accum=GA)(
            tstep.make_state(params), batch)
        print(f"{arch}: grad norm port {float(met['grad_norm']):.9f}, reference jit "
              f"{ref['grad_norm'][0]:.9f}, disable_jit {ref['grad_norm'][1]:.9f}")
        _leaf_table(f"{arch}: params after one train step", state["params"], conv("pjit"),
                    conv("pnojit"), [("initial", params), ("port grad", grads),
                                     ("ref jit grad", conv("gjit")),
                                     ("ref disable_jit grad", conv("gnojit"))])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--archs", nargs="+", default=list(ARCHS))
    ap.add_argument("--leaves", metavar="ARCH",
                    help="print the one-step per-leaf gradient table of ARCH and exit")
    args = ap.parse_args()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.leaves:
        leaves_main(repo, args.leaves)
        return
    with tempfile.TemporaryDirectory() as out:
        ref = _run_reference(repo, out, args.archs, args.steps, False)
        import torch

        from repro_torch.dist import collective

        torch.set_num_threads(1)
        for arch in args.archs:
            collective.spawn(_child, 2, (arch, out, args.steps), workdir=out)
            with open(os.path.join(out, arch + "_procs.json")) as f:
                procs = json.load(f)
            one = _port_run(arch, out, args.steps)
            pert = {p: _port_run(arch, out, args.steps, perturb=p) for p in PERTURBATIONS}
            r = ref[arch]
            print(f"{arch}: step, port (1, 2) processes, port one process, reference sharded "
                  f"(1, 2), reference unsharded; then the reference's perturbed runs "
                  f"{', '.join(PERTURBATIONS)} and the port's")
            for i in range(args.steps):
                print(f"  {i + 1:3d} {procs[i]:.8f} {one[i]:.8f} {r['sharded'][i]:.8f} "
                      f"{r['unsharded'][i]:.8f} | "
                      + " ".join(f"{r[p][i]:.8f}" for p in PERTURBATIONS) + " | "
                      + " ".join(f"{pert[p][i]:.8f}" for p in PERTURBATIONS))
            ref_env = {p: _gap(r[p], r["unsharded"]) for p in PERTURBATIONS}
            port_env = {p: _gap(pert[p], one) for p in PERTURBATIONS}
            envelope = max(ref_env.values())
            gaps = {"port (1, 2) processes vs port one process": _gap(procs, one),
                    "port one process vs reference unsharded": _gap(one, r["unsharded"]),
                    "reference sharded (1, 2) vs unsharded": _gap(r["sharded"], r["unsharded"])}
            print(f"{arch}: largest relative loss gap over {args.steps} steps")
            print("  reference envelope " + ", ".join(f"{p} {g:.3e}" for p, g in ref_env.items())
                  + f"; max {envelope:.3e}")
            print("  port envelope      " + ", ".join(f"{p} {g:.3e}" for p, g in port_env.items())
                  + f"; max {max(port_env.values()):.3e}")
            for name, g in gaps.items():
                print(f"  {name}: {g:.3e} ({g / envelope:.2f}x the reference envelope)")
            port_ok = all(g <= 2 * envelope for name, g in gaps.items()
                          if name.startswith("port"))
            print(f"{arch}: both port gaps within 2x the reference envelope: {port_ok}")


if __name__ == "__main__":
    main()
