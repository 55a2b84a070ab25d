"""Training launcher (PyTorch port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3_0p6b --steps 100 --seq 512
    python -m repro_torch.launch.train --strategy pipeline --seq 512 --batch 4
    python -m repro_torch.launch.train --device cpu --smoke --steps 4 --seq 32 --batch 2

Runs the reference's unsupervised loop: a mesh from
``ft.elastic.make_mesh_for`` over the devices of ``--device`` (all the
CUDA devices torch sees for ``cuda``; ``--production-mesh`` asks for the
16 x 16 production mesh, which needs 256 devices), an f32 train state
from seed 0 placed per ``dist.sharding.param_specs`` under
``--strategy``, ``AdamWConfig(lr=1e-3, warmup_steps=10,
total_steps=steps)``, ``SyntheticLM`` batches (seed 0) through a
``Prefetcher``, a resume from the latest checkpoint under ``--ckpt``, a
line every 20 steps (loss, grad norm, stragglers), an
``AsyncCheckpointer`` save every ``--ckpt-every`` steps, and ``done`` at
the end.  ``--strategy pipeline`` cuts the stack at the planner's
cost-balanced boundaries (``core.placement.pipeline_boundaries``) over
the mesh's 'model' axis, picks the microbatch count with
``core.autotune.tune_microbatches`` unless ``--microbatches`` gives one,
and runs ``train.step.make_pipeline_train_step`` under
``--pipeline-schedule``; the other strategies run ``make_train_step``.
A mesh whose layout spreads over distinct devices is refused (ROADMAP.md
item 16).  It runs on the CUDA card by default; ``--device cpu`` runs the
same path on the CPU with the kernels' plain versions, and nothing falls
back.  On the card the attention of a sequence shorter than 512 tokens
(``FLASH_MIN_SEQ``) runs no kernel: the reference's default ``--seq
128`` is one such.  Options of the JAX launcher that belong to later
slices of the port exit with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.dist.sharding import SHARDING_STRATEGIES, param_specs, place
from repro_torch.ft.checkpoint import AsyncCheckpointer
from repro_torch.ft.elastic import make_mesh_for
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch.mesh import make_production_mesh, mesh_devices
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    init_pipeline_state,
    init_state,
    make_pipeline_train_step,
    make_train_step,
)

# option -> (the values this slice runs, the ROADMAP.md item that ports the rest)
_UNPORTED = {
    "supervise": ((False,), "queue 1, item 11's remainder (TrainSupervisor)"),
    "fault_plan": (("",), "queue 1, item 11's remainder (TrainSupervisor)"),
    "autotune": ((False,), "queue 1, item 13 (measurement and tuning)"),
    "tuning_file": ((None,), "queue 1, item 13 (measurement and tuning)"),
}


def _batch(np_batch, device):
    return {k: torch.from_numpy(v).long().to(device) for k, v in np_batch.items()}


def place_state(state, mesh, strategy: str):
    """The train state with params and moments placed per ``param_specs``."""
    specs = param_specs(state["params"], mesh, strategy)
    opt = state["opt"]
    return dict(state, params=place(state["params"], specs, mesh),
                opt=opt._replace(mu=place(opt.mu, specs, mesh),
                                 nu=place(opt.nu, specs, mesh)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20,
                    help="checkpoint period in steps (with --ckpt)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs only when asked")
    ap.add_argument("--strategy", default="fused", choices=list(SHARDING_STRATEGIES))
    ap.add_argument("--pipeline-schedule", default="1f1b", choices=["gpipe", "1f1b"])
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatches (0 -> bubble-tuned)")
    ap.add_argument("--production-mesh", action="store_true")
    # options of the JAX launcher that later slices of the port bring
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--fault-plan", default="")
    ap.add_argument("--tuning-file", default=None)
    ap.add_argument("--autotune", action="store_true")
    args = ap.parse_args(argv)

    for name, (ported, item) in _UNPORTED.items():
        if getattr(args, name) not in ported:
            raise SystemExit(f"--{name.replace('_', '-')} {getattr(args, name)} is "
                             f"not ported yet: ROADMAP.md {item}")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down()
    device = torch.device(args.device)
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {args.device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    if cfg.is_enc_dec:
        # the loop's batches hold tokens only; the reference's fails on them
        raise SystemExit(f"{cfg.name} is enc-dec and the launcher's batches hold no "
                         "frames: train it through repro_torch.train.step")
    # f32 matmuls in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    devices = mesh_devices(device)
    mesh = (make_production_mesh(devices=devices) if args.production_mesh
            else make_mesh_for(devices))
    print(f"device {name}  arch {cfg.name}  strategy {args.strategy}  mesh {mesh.shape}")

    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    if args.strategy == "pipeline":
        # close the planner->runtime loop: cost-balanced cuts from the
        # config's per-layer cost graph, bubble-tuned microbatch count
        from repro_torch.core.autotune import tune_microbatches
        from repro_torch.core.placement import pipeline_boundaries

        stages = mesh.shape.get("model", 1)
        boundaries = pipeline_boundaries(cfg, args.seq, stages)
        microbatches = args.microbatches or tune_microbatches(
            stages, args.batch, args.pipeline_schedule)
        print(f"pipeline stages {stages}  boundaries {boundaries}  "
              f"microbatches {microbatches}  schedule {args.pipeline_schedule}")
        step_fn = make_pipeline_train_step(
            cfg, opt, mesh, num_microbatches=microbatches, boundaries=boundaries,
            schedule=args.pipeline_schedule)
        state = init_pipeline_state(cfg, boundaries, generator=gen, dtype=torch.float32,
                                    device=device)
    else:
        step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)
        state = init_state(cfg, generator=gen, dtype=torch.float32, device=device)
    state = place_state(state, mesh, args.strategy)

    ckpt = AsyncCheckpointer(args.ckpt, keep=2) if args.ckpt else None
    start = 0
    if ckpt:
        restored, at = ckpt.restore_latest(state)
        if restored is not None:
            state, start = restored, at
            print(f"resumed at step {start}")

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    pf = Prefetcher(data, start_step=start)
    mon = StragglerMonitor()
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, _batch(pf.next(), device))
            loss = float(metrics["loss"])  # reads the step's result back
            mon.record(0, time.perf_counter() - t0)
            if (step + 1) % 20 == 0:
                print(f"step {step+1:>5} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"stragglers {mon.report().stragglers}")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(state, step + 1)
    finally:
        pf.close()
        if ckpt:
            ckpt.wait()
    print("done")
    return state


if __name__ == "__main__":
    main()
