"""Per-position dry-run: the port's counterpart of the reference's
multi-pod dry-run (``repro.launch.dryrun``).

The reference lowers and compiles every (arch x shape x mesh x strategy)
cell with XLA against 512 fake host devices and reads the compiled
module's memory and cost analyses, per device.  Eager PyTorch has no
compiler, but the port runs one process per mesh position (or per data
position), so one position's own program can run alone on ``meta``.  For
each cell this module:

  1. builds the production mesh as a :class:`~repro_torch.dist.sharding.Mesh`
     of ``meta`` entries (16 x 16, or 2 x 16 x 16 with ``--multi-pod``),
     the step's inputs on ``meta`` (:mod:`repro_torch.launch.specs`) and
     their specs (``param_specs`` / ``cache_specs`` / ``data_specs`` /
     ``state_shardings``, after ``fix_spec``);
  2. computes ``arg_bytes``: each leaf's bytes over the product of the
     mesh axis sizes its spec names (a host-int cache ``len`` counts as the
     reference's int32 scalar), exactly the reference's
     ``memory_analysis().argument_size_in_bytes``;
  3. opens a world of the mesh's size over torch's ``fake`` backend in this
     process (``dist.collective.fake_world``; a process that has a default
     group raises) and forms rank 0's groups by the launchers' rule
     (``launch.mesh.per_position``): one process per mesh position under
     ``fused`` / ``ai_core_assignment`` / ``pipeline`` with a 'model' axis
     of 2 or more (under ``pipeline`` one process a stage, holding its
     stage's layers and sending to its neighbours), else one per data
     position (``dist.collective.subgroups``);
  4. places rank 0's slices of the inputs (``place(tree, specs, mesh, data,
     model)``) and checks their storage bytes against ``arg_bytes``; as the
     launchers do, a train step takes the GLOBAL batch (each process takes
     its rows), and a serving process gathers its FSDP param slices whole
     over the data group before it serves (``gather_tree``, at load);
  5. runs the launchers' step for that rank under
     :class:`~repro_torch.launch.counters.Counters`: ``make_train_step``
     (the cell's ``grad_accum``) or ``make_pipeline_train_step`` with the
     groups and shard trees, or ``make_prefill_step`` / ``make_serve_step``
     under ``dist.tensor.parallel(model=...)`` and inference mode, as
     ``launch.serve.run_static`` does; collectives over the fake groups
     return at once with their shapes;
  6. closes the world and appends one JSON record per cell to ``--out``.

On ``meta`` the attention and GEMM calls take the kernels' wrappers, as on
the card (``route="kernel"``): each allocates what it allocates there and
reports its analytic work; ``route="plain"`` takes the plain versions, the
CPU's path, which the tests hold to real processes.

A record holds ``arch``, ``shape``, ``mesh``, ``strategy``, ``status``,
``position`` (``"mesh"``: rank 0 of one process per mesh position, under
``pipeline`` stage 0 of row 0; ``"data"``: of one per data position),
``route``, ``stand_in: "meta"``, ``kernel_calls`` (wrapper calls on
``meta``), and the reference's per-device keys:

  * ``arg_bytes`` (above);
  * ``output_bytes``: the bytes of the step's outputs that share no
    storage with an input.  The port writes its KV caches in place, so a
    serving step's caches are not outputs (the reference's donated caches
    are);
  * ``per_device_mem_bytes``: the peak of live storage bytes over the step,
    the arguments counted (the caller keeps them: no buffer is donated, so
    a train step holds the old state and the new one at once); ``temp_bytes
    = per_device_mem_bytes - arg_bytes - output_bytes``, the reference's
    algebra.  What the process holds beyond ``arg_bytes`` counts in
    ``temp_bytes``: the global train batch's other rows, a serving
    process's params gathered whole over the data group;
  * ``flops``: this position's operations (``FlopCounterMode``'s aten count
    plus each kernel call's analytic count), not the whole step's;
  * ``bytes_accessed``: the bytes the eager ops read and write (the
    counters' sum over aten ops' inputs and outputs plus each kernel call's
    analytic bytes), not XLA's post-fusion estimate;
  * ``collective_bytes``: this position's c10d results by the reference's
    five kinds plus ``total`` (another kind under its c10d name).  Under
    ``fused`` a train step all-gathers the params whole at its start; a
    serving step has no param gather (the load's runs once); a pipeline
    stage's ``collective-permute`` is what it receives, m activations
    from stage k - 1 and m gradients from stage k + 1, ``mb x S x D``
    each (the reference's ring moves both every round, idle ones too).

Under ``pipeline`` the record also holds ``per_stage``: those per-device
keys (and ``stage``) for each stage of row 0, ranks 0 .. S - 1, each run
in a fake world of its own; the verbose line names the stage with the
largest ``per_device_mem_bytes``, the one that decides whether the cell
fits a card.

``lower_s`` and ``compile_s`` are left out: there is no compiler.  A family
whose path reads a value on ``meta`` (``.item()``, a data-dependent shape)
records ``status: "error"`` with the message, as the reference records a
cell that fails to lower.  Skipped cells carry the reference's ``reason``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0p6b \\
      --shape train_4k [--strategy fused] [--multi-pod] [--out dryrun_results.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.dist import collective
from repro_torch.dist import tensor as tp
from repro_torch.dist.sharding import (
    _axes,
    _axis_size,
    _dp,
    _is_named_tuple,
    cache_specs,
    data_shards,
    data_specs,
    fix_spec,
    model_shards,
    param_specs,
    place,
    stage_slice,
)
from repro_torch.ft.elastic import state_shardings
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.counters import Counters, storages
from repro_torch.launch.mesh import make_production_mesh, per_position
from repro_torch.models.layers import meta_route
from repro_torch.optim.adamw import AdamWConfig

STRATEGIES = ("fused", "ai_core_assignment", "scatter_gather", "pipeline")
#: bytes of a host-int cache ``len``: the reference's int32 scalar
LEN_BYTES = 4
GIB, MIB = 2 ** 30, 2 ** 20


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


def held_bytes(tree) -> int:
    """What a process holding ``tree`` holds: its tensors' storage bytes,
    each storage once, and ``LEN_BYTES`` a host int."""
    ints = sum(isinstance(x, int) for x in tree_leaves(tree))
    return sum(storages(tree).values()) + LEN_BYTES * ints


def _kv_specs(kv, mesh):
    """The reference's enc-dec cross K/V layout: batch over the data axes,
    heads over 'model' (a stacked (L, B, T, H, D) leaf there)."""
    return [{k: fix_spec((_dp(mesh), None, "model", None), tuple(v.shape), mesh)
             for k, v in layer.items()} for layer in kv]


@dataclasses.dataclass
class Cell:
    """One cell's step inputs: ``kind`` ("train", "prefill" or "decode"),
    the GLOBAL argument trees (``meta`` or any device) and one spec tree
    each; ``grad_accum`` and the pipeline's ``boundaries`` for train;
    ``extra`` names a prefill's last argument (``"embeds"`` / ``"frames"``)
    where it has one; ``schedule`` a pipeline's."""
    kind: str
    args: tuple
    specs: tuple
    grad_accum: int = 1
    boundaries: tuple | None = None
    extra: str | None = None
    schedule: str = "1f1b"


def cell_inputs(cfg, shape_name: str, mesh, strategy: str = "fused",
                grad_accum: int | None = None) -> Cell:
    """The cell's ``meta`` inputs and their specs."""
    shape = SHAPES[shape_name]
    specs = specs_mod.input_specs(cfg, shape)
    if shape.kind == "train":
        ga = grad_accum if grad_accum is not None else specs_mod.TRAIN_GRAD_ACCUM.get(
            cfg.name, 1)
        bounds = None
        state = specs["state"]
        if strategy == "pipeline":
            from repro_torch.core.placement import pipeline_boundaries

            bounds = pipeline_boundaries(cfg, shape.seq_len, mesh.shape.get("model", 1))
            state = specs_mod.pipeline_state_shapes(cfg, bounds)
        batch = specs["batch"]
        return Cell("train", (state, batch),
                    (state_shardings(state, mesh, strategy), data_specs(batch, mesh)),
                    grad_accum=ga, boundaries=bounds)
    params = specs_mod.param_shapes(cfg)
    caches = specs["caches"]
    first = "tokens" if shape.kind == "prefill" else "token"
    args = [params, specs[first], caches]
    arg_specs = [param_specs(params, mesh, strategy), data_specs(specs[first], mesh),
                 cache_specs(caches, mesh)]
    extra = None
    if shape.kind == "prefill":
        if cfg.frontend == "vision":
            extra = "embeds"
        elif cfg.is_enc_dec:
            extra = "frames"
        if extra:
            args.append(specs[extra])
            arg_specs.append(data_specs(specs[extra], mesh))
    elif cfg.is_enc_dec:
        args.append(specs["kv"])
        arg_specs.append(_kv_specs(specs["kv"], mesh))
    return Cell(shape.kind, tuple(args), tuple(arg_specs), extra=extra)


def arg_bytes(cfg, shape_name: str, mesh, strategy: str = "fused",
              grad_accum: int | None = None) -> int:
    """The cell's per-device input bytes (the reference's
    ``argument_size_in_bytes``)."""
    cell = cell_inputs(cfg, shape_name, mesh, strategy, grad_accum)
    return sum(tree_bytes(a, s, mesh) for a, s in zip(cell.args, cell.specs))


def skip_reason(cfg, shape_name: str, strategy: str) -> str | None:
    """The reference's reason for skipping a cell, or None."""
    if strategy == "pipeline" and (SHAPES[shape_name].kind != "train" or cfg.attn_every
                                   or cfg.is_enc_dec or cfg.frontend):
        return ("pipeline strategy lowers the homogeneous token-only decoder "
                "train path only")
    if shape_name in cfg.skip_shapes:
        return "full-attention arch at 500k (DESIGN.md §5)"
    return None


def position_step(cfg, cell: Cell, mesh, strategy: str, data, model):
    """The launchers' step for this process's groups: ``fn(*args)``."""
    from repro_torch.serve.step import make_prefill_step, make_serve_step
    from repro_torch.train.step import make_pipeline_train_step, make_train_step

    if cell.kind == "train":
        # what this process holds (a pipeline stage process: its layers)
        specs = stage_slice(cell.specs[0], cell.specs[0], model)
        shards = data_shards(specs, mesh)["params"] if data is not None else None
        if strategy == "pipeline":
            return make_pipeline_train_step(
                cfg, AdamWConfig(), mesh, num_microbatches=max(cell.grad_accum, 1),
                boundaries=cell.boundaries, schedule=cell.schedule, group=data, shards=shards,
                model=model)
        mshards = model_shards(specs, mesh)["params"] if model is not None else None
        return make_train_step(cfg, AdamWConfig(), grad_accum=cell.grad_accum, group=data,
                               shards=shards, model=model, model_shards=mshards)
    if cell.kind == "prefill":
        pstep = make_prefill_step(cfg)

        def serve(p, t, c, *rest):
            return pstep(p, t, c, **({cell.extra: rest[0]} if cell.extra else {}))
    else:
        serve = make_serve_step(cfg)

    @torch.inference_mode()
    def step(*args):
        with tp.parallel(model=model):
            return serve(*args)

    return step


def run_position(cfg, cell: Cell, mesh, strategy: str = "fused", *,
                 route: str = "kernel", rank: int = 0) -> dict:
    """Rank ``rank``'s step of ``cell`` on ``mesh`` in a fake world (module
    docstring, 3-5): the counters' record (``launch.counters``) with
    ``arg_bytes`` (the reference's), ``held_ints`` (``LEN_BYTES`` a host
    int of the arguments) and ``position``."""
    expect = [tree_bytes(a, s, mesh) for a, s in zip(cell.args, cell.specs)]
    world = collective.fake_world(mesh.size, rank)
    try:
        data, model, _ = collective.subgroups(mesh, rank, collective.FAKE,
                                              per_position(mesh, strategy))
        # this process's slices (module docstring, 4); the train batch global
        batch = 1 if cell.kind == "train" else None
        placed = [tree if i == batch else place(tree, specs, mesh, data, model)
                  for i, (tree, specs) in enumerate(zip(cell.args, cell.specs))]
        for i, (tree, want) in enumerate(zip(placed, expect)):
            if i != batch and held_bytes(tree) != want:
                raise RuntimeError(f"rank {rank}'s placed argument {i} holds "
                                   f"{held_bytes(tree)} B where its specs give {want} B")
        if cell.kind != "train":
            # a serving process gathers its FSDP slices whole at load
            placed[0] = collective.gather_tree(placed[0], data_shards(cell.specs[0], mesh),
                                               data)
        step = position_step(cfg, cell, mesh, strategy, data, model)
        with (meta_route(route), torch.set_grad_enabled(cell.kind == "train"),
              Counters(args=placed) as c):
            out = step(*placed)
        rec = c.record(out)
        del out, placed, step
    finally:
        collective.close(world)
    position = "mesh" if per_position(mesh, strategy) else "data"
    rec.update(arg_bytes=sum(expect), position=position, rank=rank,
               held_ints=held_bytes(cell.args) - sum(storages(cell.args).values()))
    return rec


def per_device(r: dict) -> dict:
    """The reference's per-device keys of a :func:`run_position` record."""
    peak = r["peak_bytes"] + r["held_ints"]
    return dict(arg_bytes=r["arg_bytes"], output_bytes=r["output_bytes"],
                temp_bytes=peak - r["arg_bytes"] - r["output_bytes"],
                per_device_mem_bytes=peak, flops=r["flops"],
                bytes_accessed=r["bytes_accessed"], collective_bytes=r["collective_bytes"])


def cell_record(cfg, shape_name: str, mesh, strategy: str = "fused",
                grad_accum: int | None = None, verbose: bool = True) -> dict:
    """One cell's record (module docstring); under ``pipeline`` with one
    process a stage, ``per_stage`` holds each stage of row 0's."""
    head = {"arch": cfg.name, "shape": shape_name, "mesh": _mesh_name(mesh)}
    reason = skip_reason(cfg, shape_name, strategy)
    if reason is not None:
        return dict(head, status="skipped", reason=reason)
    cell = cell_inputs(cfg, shape_name, mesh, strategy, grad_accum)
    r = run_position(cfg, cell, mesh, strategy)
    rec = dict(head, strategy=strategy, status="ok", position=r["position"], route="kernel",
               **per_device(r), kernel_calls=r["kernel_calls"], stand_in="meta")
    if strategy == "pipeline" and per_position(mesh, strategy):
        # row 0's stages: ranks 0 .. S - 1, each in a fake world of its own
        rec["per_stage"] = [dict(stage=0, **per_device(r))] + [
            dict(stage=k, **per_device(run_position(cfg, cell, mesh, strategy, rank=k)))
            for k in range(1, mesh.shape["model"])]
    if verbose:
        print(f"[dryrun] {cfg.name} x {shape_name} x {rec['mesh']} ({strategy}, "
              f"{rec['position']} rank 0, meta): temp {rec['temp_bytes'] / GIB:.2f} GiB/dev, "
              f"peak {rec['per_device_mem_bytes'] / GIB:.2f} GiB/dev, flops "
              f"{rec['flops']:.3g}, coll {rec['collective_bytes']['total'] / MIB:.1f} MiB/dev")
        if "per_stage" in rec:
            top = max(rec["per_stage"], key=lambda x: x["per_device_mem_bytes"])
            print(f"[dryrun]   per stage: the largest peak is stage {top['stage']}'s, "
                  f"{top['per_device_mem_bytes'] / GIB:.2f} GiB/dev (temp "
                  f"{top['temp_bytes'] / GIB:.2f}, flops {top['flops']:.3g}, coll "
                  f"{top['collective_bytes']['total'] / MIB:.1f} MiB/dev)")
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
                               "strategy": args.strategy, "status": "error",
                               "error": f"{type(e).__name__}: {e}"[:500]}
                        print(f"[dryrun] FAIL {a} x {s}: {rec['error'][:200]}",
                              file=sys.stderr)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
