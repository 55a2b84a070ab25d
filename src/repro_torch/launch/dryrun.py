"""Meta-device stand-in for the reference's multi-pod dry-run
(``repro.launch.dryrun``).

The reference lowers and compiles every (arch x shape x mesh) cell with
XLA against 512 fake host devices and reads the compiled module's memory
and cost analyses.  Eager PyTorch has no such compiler, so for each cell
this module:

  1. builds the production mesh as a :class:`~repro_torch.dist.sharding.Mesh`
     of ``meta`` entries (16 x 16, or 2 x 16 x 16 with ``--multi-pod``),
  2. builds the step's inputs on ``meta`` (:mod:`repro_torch.launch.specs`)
     and their specs (``param_specs`` / ``cache_specs`` / ``data_specs`` /
     ``state_shardings``, after ``fix_spec``),
  3. computes ``arg_bytes``: the per-device bytes of the step's inputs,
     each leaf's bytes divided by the product of the mesh axis sizes its
     spec names (a host-int cache ``len`` counts as the reference's int32
     scalar).  This is exactly what the reference reads from
     ``memory_analysis().argument_size_in_bytes``;
  4. runs the port's step (``make_train_step`` with the cell's
     ``grad_accum``, ``make_pipeline_train_step``, ``make_prefill_step``
     or ``make_serve_step``) on the ``meta`` inputs under
     ``torch.utils.flop_counter.FlopCounterMode`` and records
     ``flops_global``: the WHOLE step's count, every device's work
     together.  It is not comparable with the reference's per-device
     ``flops`` from XLA's cost analysis;
  5. appends one JSON record per cell to ``--out``.

A record holds ``arch``, ``shape``, ``mesh``, ``strategy``, ``status``,
``arg_bytes``, ``flops_global`` and ``"stand_in": "meta"``.  The
reference's keys that need a compiler are left out, never written as 0:
``temp_bytes``, ``output_bytes``, ``per_device_mem_bytes``,
``collective_bytes``, ``bytes_accessed``, ``lower_s`` and ``compile_s``.
On ``meta`` the kernel dispatch takes the plain versions; a family whose
plain path reads a value (``.item()``, a data-dependent shape) records
``status: "error"`` with the message, as the reference records a cell
that fails to lower.  Skipped cells carry the reference's ``reason``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0p6b \\
      --shape train_4k [--multi-pod] [--out dryrun_results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.dist.sharding import (
    _axes,
    _axis_size,
    _dp,
    _is_named_tuple,
    cache_specs,
    data_specs,
    fix_spec,
    param_specs,
)
from repro_torch.ft.elastic import state_shardings
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.optim.adamw import AdamWConfig

STRATEGIES = ("fused", "ai_core_assignment", "scatter_gather", "pipeline")
#: bytes of a host-int cache ``len``: the reference's int32 scalar
LEN_BYTES = 4


def meta_mesh(multi_pod: bool = False):
    """The production mesh with every position on ``meta``."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=[specs_mod.META] * n)


def _mesh_name(mesh) -> str:
    return "x".join(str(v) for v in mesh.shape.values())


def tree_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of ``tree`` laid out per ``specs``: each tensor's
    bytes over the product of the mesh axis sizes its (repaired) spec
    names, a per-layer list's over its ``LayerSpecs.layer`` entry; a host
    int counts ``LEN_BYTES``, replicated."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if _is_named_tuple(tree):
        return sum(tree_bytes(getattr(tree, f), getattr(specs, f), mesh)
                   for f in tree._fields)
    if isinstance(tree, (list, tuple)):
        total = sum(tree_bytes(v, s, mesh) for v, s in zip(tree, specs))
        # a per-layer list split over the stacked layer axis ('model' under
        # pipeline): each device holds len / size of its layers
        return total // _axis_size(mesh, getattr(specs, "layer", None))
    if isinstance(tree, torch.Tensor):
        spec = fix_spec(specs, tuple(tree.shape), mesh)
        split = 1
        for a in _axes(spec):
            split *= _axis_size(mesh, a)
        return tree.numel() * tree.element_size() // split
    if isinstance(tree, int):
        return LEN_BYTES
    return 0


def _kv_specs(kv, mesh):
    """The reference's enc-dec cross K/V layout: batch over the data axes,
    heads over 'model' (a stacked (L, B, T, H, D) leaf there)."""
    return [{k: fix_spec((_dp(mesh), None, "model", None), tuple(v.shape), mesh)
             for k, v in layer.items()} for layer in kv]


def cell_inputs(cfg, shape_name: str, mesh, strategy: str = "fused",
                grad_accum: int | None = None):
    """``(step, args, specs)``: the port's step for the cell, its ``meta``
    arguments and their spec trees (one per argument)."""
    from repro_torch.serve.step import make_prefill_step, make_serve_step
    from repro_torch.train.step import make_pipeline_train_step, make_train_step

    shape = SHAPES[shape_name]
    specs = specs_mod.input_specs(cfg, shape)
    if shape.kind == "train":
        ga = grad_accum if grad_accum is not None else specs_mod.TRAIN_GRAD_ACCUM.get(
            cfg.name, 1)
        if strategy == "pipeline":
            from repro_torch.core.placement import pipeline_boundaries

            stages = mesh.shape.get("model", 1)
            bounds = pipeline_boundaries(cfg, shape.seq_len, stages)
            step = make_pipeline_train_step(cfg, AdamWConfig(), mesh,
                                            num_microbatches=max(ga, 1), boundaries=bounds)
            state = specs_mod.pipeline_state_shapes(cfg, bounds)
        else:
            step = make_train_step(cfg, AdamWConfig(), grad_accum=ga)
            state = specs["state"]
        batch = specs["batch"]
        return step, (state, batch), (state_shardings(state, mesh, strategy),
                                      data_specs(batch, mesh))
    params = specs_mod.param_shapes(cfg)
    pspecs = param_specs(params, mesh, strategy)
    caches = specs["caches"]
    cspecs = cache_specs(caches, mesh)
    if shape.kind == "prefill":
        pstep = make_prefill_step(cfg)
        args = [params, specs["tokens"], caches]
        arg_specs = [pspecs, data_specs(specs["tokens"], mesh), cspecs]
        if cfg.frontend == "vision":
            extra = "embeds"
        elif cfg.is_enc_dec:
            extra = "frames"
        else:
            return pstep, tuple(args), tuple(arg_specs)
        args.append(specs[extra])
        arg_specs.append(data_specs(specs[extra], mesh))

        def step(p, t, c, e):
            return pstep(p, t, c, **{extra: e})

        return step, tuple(args), tuple(arg_specs)
    sstep = make_serve_step(cfg)
    args = [params, specs["token"], caches]
    arg_specs = [pspecs, data_specs(specs["token"], mesh), cspecs]
    if cfg.is_enc_dec:
        args.append(specs["kv"])
        arg_specs.append(_kv_specs(specs["kv"], mesh))
    return sstep, tuple(args), tuple(arg_specs)


def arg_bytes(cfg, shape_name: str, mesh, strategy: str = "fused",
              grad_accum: int | None = None) -> int:
    """The cell's per-device input bytes (the reference's
    ``argument_size_in_bytes``)."""
    _, args, arg_specs = cell_inputs(cfg, shape_name, mesh, strategy, grad_accum)
    return sum(tree_bytes(a, s, mesh) for a, s in zip(args, arg_specs))


def skip_reason(cfg, shape_name: str, strategy: str) -> str | None:
    """The reference's reason for skipping a cell, or None."""
    if strategy == "pipeline" and (SHAPES[shape_name].kind != "train" or cfg.attn_every
                                   or cfg.is_enc_dec or cfg.frontend):
        return ("pipeline strategy lowers the homogeneous token-only decoder "
                "train path only")
    if shape_name in cfg.skip_shapes:
        return "full-attention arch at 500k (DESIGN.md §5)"
    return None


def cell_record(cfg, shape_name: str, mesh, strategy: str = "fused",
                grad_accum: int | None = None, verbose: bool = True) -> dict:
    """One cell's record (module docstring)."""
    head = {"arch": cfg.name, "shape": shape_name, "mesh": _mesh_name(mesh)}
    reason = skip_reason(cfg, shape_name, strategy)
    if reason is not None:
        return dict(head, status="skipped", reason=reason)
    step, args, arg_specs = cell_inputs(cfg, shape_name, mesh, strategy, grad_accum)
    nbytes = sum(tree_bytes(a, s, mesh) for a, s in zip(args, arg_specs))
    counter = FlopCounterMode(display=False)
    grad = SHAPES[shape_name].kind == "train"
    with counter, torch.set_grad_enabled(grad):
        step(*args)
    rec = dict(head, strategy=strategy, status="ok", arg_bytes=nbytes,
               flops_global=float(counter.get_total_flops()), stand_in="meta")
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape_name} x {rec['mesh']} ({strategy}, meta): "
              f"args {nbytes / 2**30:.3f} GiB/dev, flops (whole step) "
              f"{rec['flops_global']:.4g}")
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, strategy: str = "fused",
             grad_accum: int | None = None, verbose: bool = True) -> dict:
    return cell_record(get_config(arch), shape_name, meta_mesh(multi_pod), strategy,
                       grad_accum, verbose)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--strategy", default="fused", choices=list(STRATEGIES))
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]
    failures = 0
    with open(args.out, "a") as f:
        for a in archs:
            for s in shapes:
                for mp in meshes:
                    try:
                        rec = run_cell(a, s, multi_pod=mp, strategy=args.strategy,
                                       grad_accum=args.grad_accum)
                    except Exception as e:  # noqa: BLE001 — report and continue
                        failures += 1
                        rec = {"arch": a, "shape": s, "mesh": "2x16x16" if mp else "16x16",
                               "status": "error",
                               "error": f"{type(e).__name__}: {e}"[:500]}
                        print(f"[dryrun] FAIL {a} x {s}: {rec['error'][:200]}",
                              file=sys.stderr)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
