"""Training launcher (PyTorch port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3_0p6b --steps 100 --seq 512
    python -m repro_torch.launch.train --strategy pipeline --seq 512 --batch 4
    python -m repro_torch.launch.train --device cpu --smoke --steps 4 --seq 32 --batch 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --seq 512 --batch 4
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --strategy pipeline --seq 512

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

Across cards it runs one process per data position of the mesh, under
``torchrun --nproc-per-node <positions>`` (``dist.collective.data_group``
reads torchrun's environment; under ``pipeline`` each process drives its
row's stages), or under ``ai_core_assignment`` / ``fused`` / ``pipeline``
one process per mesh position, ``torchrun --nproc-per-node <mesh size>``
(``dist.collective.mesh_groups``: tensor and expert parallelism over the
'model' axis, ``dist.tensor``, or one process a pipeline stage, its
neighbours fed by point-to-point sends): each process draws the same
global batch and trains on its rows with its slices (a stage its own
layers), and only process 0 prints the reference's lines (the ``mesh``
line shows the global mesh) and writes checkpoints, in today's format, of
the state gathered whole over both groups (a pipeline's stages' layers
too); every process restores a checkpoint whole and keeps its slices.
Run alone on a mesh with several data positions, or a 'model' axis it
would split, over distinct cards it exits naming the torchrun commands,
and so does any other world; ``--device cpu`` under torchrun lists the
CPU once per process.  It runs on the CUDA card
by default; ``--device cpu`` runs the same path on the CPU with the
kernels' plain versions, and nothing falls back.  On the card the attention of a sequence shorter than 512 tokens
(``FLASH_MIN_SEQ``) runs no kernel: the reference's default ``--seq
128`` is one such.

``--supervise`` (implied by ``--fault-plan``) runs the same training
under ``ft.supervisor.TrainSupervisor`` over the devices of
``--device`` (straggler re-cut, elastic restore, NaN rollback,
checkpoint-crash retry; checkpoints under ``--ckpt`` every
``--ckpt-every`` steps) and prints the reference's summary: the final
loss, the mean step ms and one line per recovery event, then ``done``.
Under torchrun every process runs the supervisor over the world's
devices (one process per mesh position under ai_core_assignment /
fused with a 'model' axis, else one per data position; ``--device cpu``
lists the CPU once per process) and process 0 alone prints; the
pipeline supervisor keeps its ``(1, stages)`` mesh in one process, as
the reference's does, and exits under torchrun naming that command.
``--autotune`` tunes flash's blocks with ``core.autotune.tune_runtime``
on the device before training (saved to ``--tuning-file`` when given);
``--tuning-file`` alone installs a saved table (``launch.tuning``).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.dist.collective import (
    barrier,
    close,
    gather_stages_first,
    gather_tree_first,
    process_index,
    requested_world,
)
from repro_torch.dist.sharding import (
    SHARDING_STRATEGIES,
    data_shards,
    model_shards,
    place,
    stage_slice,
)
from repro_torch.ft.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.ft.elastic import state_shardings
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch.mesh import join_groups, launch_mesh, mesh_devices
from repro_torch.launch.tuning import tuning_from
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    init_pipeline_state,
    init_state,
    make_pipeline_train_step,
    make_train_step,
)


def _batch(np_batch, device):
    return {k: torch.from_numpy(v).long().to(device) for k, v in np_batch.items()}


def run_supervised(cfg, args, devices):
    """The reference's supervised branch: a ``TrainSupervisor`` run, its
    summary and ``done``.  Returns the ``SupervisorResult``."""
    from repro_torch.ft.faults import FaultPlan
    from repro_torch.ft.supervisor import TrainSupervisor

    plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    world = requested_world()
    if world and world[1] > 1 and devices[0].type == "cpu":
        devices = devices * world[1]
    sup = TrainSupervisor(
        cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
        steps=args.steps, seq=args.seq, batch=args.batch,
        strategy=args.strategy, schedule=args.pipeline_schedule,
        microbatches=args.microbatches, grad_accum=args.grad_accum,
        ckpt_dir=args.ckpt or None, ckpt_every=args.ckpt_every,
        fault_plan=plan, devices=devices, verbose=True)
    try:
        res = sup.run()
    finally:
        sup.close()
    if process_index(sup.world):
        return res
    print(f"final loss {res.final_loss:.4f}  "
          f"mean step {1e3 * sum(res.step_times) / len(res.step_times):.1f}ms  "
          f"events {len(res.events)}")
    for ev in res.events:
        print(f"  [{ev.kind}] at step {ev.step}: lost {ev.steps_lost} "
              f"steps, recovered in {ev.recovery_s * 1e3:.0f}ms  "
              f"{ev.detail}")
    print("done")
    return res


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
    ap.add_argument("--supervise", action="store_true",
                    help="run under the fault-tolerant TrainSupervisor "
                         "(straggler re-cut, elastic restore, NaN rollback)")
    ap.add_argument("--fault-plan", default="",
                    help="injected faults, e.g. "
                         "'slowdown:step=6,stage=2,factor=3;kill:step=20'")
    ap.add_argument("--tuning-file", default=None,
                    help="TuningTable JSON to install before building the step "
                         "(tuned flash blocks); with --autotune, where to save "
                         "the search result")
    ap.add_argument("--autotune", action="store_true",
                    help="run the measured knob search (core.autotune."
                         "tune_runtime) on the device before training")
    args = ap.parse_args(argv)

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
    with tuning_from(args.autotune, args.tuning_file, cfg=cfg, kinds=("flash_prefill",),
                     device=device):
        if args.supervise or args.fault_plan:
            world = requested_world()
            if world and world[1] > 1 and args.strategy == "pipeline":
                raise SystemExit(f"the pipeline supervisor runs its (1, stages) mesh in one "
                                 f"process, as the reference's does: run python -m "
                                 f"repro_torch.launch.train --strategy pipeline --supervise "
                                 f"..., not torchrun with {world[1]} processes")
            return run_supervised(cfg, args, mesh_devices(device))
        return run(cfg, args, device)


def run(cfg, args, device):
    """The reference's unsupervised loop (module docstring); returns the
    final state (this process's slices across processes)."""
    world = requested_world()
    mesh = launch_mesh(device, world[1] if world else 1, args.production_mesh)
    group, model = join_groups(mesh, args.strategy, "repro_torch.launch.train")
    lead = process_index(group) == 0 and process_index(model) == 0
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if lead:
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
        if lead:
            print(f"pipeline stages {stages}  boundaries {boundaries}  "
                  f"microbatches {microbatches}  schedule {args.pipeline_schedule}")
        state = init_pipeline_state(cfg, boundaries, generator=gen, dtype=torch.float32,
                                    device=device)
    else:
        state = init_state(cfg, generator=gen, dtype=torch.float32, device=device)
    specs = state_shardings(state, mesh, args.strategy)
    # what this process holds: a pipeline stage process its stage's layers
    local = stage_slice(specs, specs, model)
    shards = data_shards(local, mesh) if group is not None else None
    mshards = model_shards(local, mesh) if model is not None else None
    pshards = shards["params"] if shards is not None else None
    if args.strategy == "pipeline":
        step_fn = make_pipeline_train_step(
            cfg, opt, mesh, num_microbatches=microbatches, boundaries=boundaries,
            schedule=args.pipeline_schedule, group=group, shards=pshards, model=model)
    else:
        step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum, group=group,
                                  shards=pshards, model=model,
                                  model_shards=mshards and mshards["params"])

    # process 0 writes the canonical (gathered) state; every process
    # restores it whole and keeps its slices
    ckpt = AsyncCheckpointer(args.ckpt, keep=2) if args.ckpt and lead else None
    barrier(model, group)
    start = 0
    if args.ckpt:
        at = latest_step(args.ckpt)
        if at is not None:
            state = restore(os.path.join(args.ckpt, f"step_{at}"), state)
            start = at
            if lead:
                print(f"resumed at step {start}")
    state = place(state, specs, mesh, group, model)

    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=0)
    pf = Prefetcher(data, start_step=start)
    mon = StragglerMonitor()
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, _batch(pf.next(), device))
            loss = float(metrics["loss"])  # reads the step's result back
            mon.record(0, time.perf_counter() - t0)
            if (step + 1) % 20 == 0 and lead:
                print(f"step {step+1:>5} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"stragglers {mon.report().stragglers}")
            if args.ckpt and (step + 1) % args.ckpt_every == 0:
                # the state whole on process 0, which writes
                whole = gather_tree_first(state, shards, group)
                if process_index(group) == 0:
                    whole = gather_tree_first(whole, mshards, model)
                    whole = gather_stages_first(whole, specs, model)
                if ckpt:
                    ckpt.save(whole, step + 1)
                del whole
    finally:
        pf.close()
        if ckpt:
            ckpt.wait()
    barrier(model, group)
    if lead:
        print("done")
    close(group, model)
    return state


if __name__ == "__main__":
    main()
