"""Training launcher, single device (PyTorch port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch qwen3_0p6b --steps 100 --seq 512
    python -m repro_torch.launch.train --device cpu --smoke --steps 4 --seq 32 --batch 2

Runs the reference's unsupervised loop with ``--strategy fused`` on one
device: an f32 train state from seed 0 (``train.step.init_state``),
``AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)``,
``SyntheticLM`` batches (seed 0) through a ``Prefetcher``, a resume from
the latest checkpoint under ``--ckpt``, a line every 20 steps (loss,
grad norm, stragglers), an ``AsyncCheckpointer`` save every
``--ckpt-every`` steps, and ``done`` at the end.  It runs on the CUDA card
by default; ``--device cpu`` runs the same path on the CPU with the
kernels' plain versions, and nothing falls back.  On the card the
attention of a sequence shorter than 512 tokens (``FLASH_MIN_SEQ``) runs
no kernel: the reference's default ``--seq 128`` is one such.  Options of
the JAX launcher that belong to later slices of the port exit with the
ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.ft.checkpoint import AsyncCheckpointer
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_state, make_train_step

# option -> (the values this slice runs, the ROADMAP.md item that ports the rest)
_UNPORTED = {
    "strategy": (("fused",), "queue 1, item 12 (distributed runtime)"),
    "pipeline_schedule": ((None,), "queue 1, item 12 (distributed runtime)"),
    "microbatches": ((0,), "queue 1, item 12 (distributed runtime)"),
    "production_mesh": ((False,), "queue 1, item 12 (distributed runtime)"),
    "supervise": ((False,), "queue 1, item 11's remainder (TrainSupervisor)"),
    "fault_plan": (("",), "queue 1, item 11's remainder (TrainSupervisor)"),
    "autotune": ((False,), "queue 1, item 13 (measurement and tuning)"),
    "tuning_file": ((None,), "queue 1, item 13 (measurement and tuning)"),
}


def _batch(np_batch, device):
    return {k: torch.from_numpy(v).long().to(device) for k, v in np_batch.items()}


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
    # options of the JAX launcher that later slices of the port bring
    ap.add_argument("--strategy", default="fused")
    ap.add_argument("--pipeline-schedule", default=None)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true")
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
    print(f"device {name}  arch {cfg.name}  strategy {args.strategy}")

    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(cfg, generator=gen, dtype=torch.float32, device=device)

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
