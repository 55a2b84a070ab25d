"""Sharding-spec engine: the paper's cluster plans as per-leaf specs (the
port of ``repro.dist.sharding``).

This is the runtime half of the planner/runtime split.  The planner
(``repro_torch.core.strategies`` -> ``repro_torch.core.placement``) picks
one of the paper's strategies; this module lowers that choice onto a
device :class:`Mesh`:

  scatter_gather      -> params fully replicated, batch split over the
                         data axes (the paper's frame round-robin)
  ai_core_assignment  -> tensor/expert parallelism: the bottleneck
                         matmuls (QKV/MLP/expert FFN — the highest-MAC
                         operators) get the ``model`` axis
  fused               -> FSDP x TP 2D: the AI-core TP split plus the
                         data axes sharding the complementary weight dim
  pipeline            -> the 'model' axis shards the *layer axis* of
                         the block lists (stage k holds its — possibly
                         padded, uneven-cut — contiguous layer slice, as
                         :mod:`repro_torch.dist.pipeline` runs it);
                         non-stacked params (embed / head / final norm)
                         stay off 'model' and FSDP over the data axes only

A spec is a plain tuple with one entry per tensor dim: ``None``, an axis
name, or a tuple of axis names (what ``tuple(PartitionSpec)`` gives in
the reference).  The engine reads only a mesh's ``.shape`` (ordered axis
-> size) and ``.axis_names``, so any object with those two works.  Every
emitted spec runs through :func:`fix_spec`, which drops any sharding
whose dimension does not divide the mesh axis.

The reference stacks each layer's leaves on a leading axis; the port
keeps a list of per-layer subtrees.  A list's specs are a
:class:`LayerSpecs`: one spec tree per layer (the reference's spec
without its leading entry) and, in ``.layer``, the leading entry itself
(``"model"`` under ``pipeline`` where the stage count divides the
list's length, else ``None``).

:func:`place` puts a tree on a mesh's devices: with a data group
(``dist.collective``: one process per data position, each owning its
mesh row, :func:`local_mesh`) this process's FSDP slices
(:func:`data_shards`) on its row; with a model group as well (one process
per mesh position) also its slices of every dim split over 'model'
(:func:`model_shards`), on its own device (:func:`position_device`).
Eager PyTorch has no sharding constraint: the collectives that the
reference's activation hints (``hint``, ``hint_dp``) lead XLA to insert
are written by hand in :mod:`repro_torch.dist.tensor`.
"""

from __future__ import annotations

import numpy as np
import torch

#: mesh axis names.  ``DP`` is the canonical data axis; a multi-pod mesh
#: adds a leading "pod" axis which :func:`dp_axes` folds into the
#: data-parallel group.  ``MDL`` carries TP/EP/pipeline-stage sharding.
DP = "data"
MDL = "model"

#: weight matrices split column-wise (output-dim) under TP — each shard
#: computes a slice of the output features
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "w_gate", "w_up", "wuk", "wuv", "wdkv", "wdq",
    "in_proj", "lm_head",
})
#: weight matrices split row-wise (input-dim) under TP — they consume
#: the column-parallel outputs, so the contraction dim is sharded and
#: the result is sum-reduced
_ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj"})

#: param subtrees whose leaves carry the reference's leading stacked-layer
#: axis (per-layer lists in the port) — FSDP avoids that axis
_STACKED_SUBTREES = frozenset({"blocks", "encoder", "decoder"})

SHARDING_STRATEGIES = ("scatter_gather", "ai_core_assignment", "fused",
                       "pipeline")

#: what the port's refusals of a layout it cannot run over distinct devices
#: cite (tensor / expert parallelism there, a data axis over distinct
#: devices in one process)
MULTI_CARD_ITEM = "ROADMAP.md queue 1, item 16 (multi-card execution)"

#: the strategies whose 'model' axis splits tensors (tensor and expert
#: parallelism): over distinct devices they run one process per mesh
#: position
TP_STRATEGIES = ("ai_core_assignment", "fused")


def per_position_hint(mesh) -> str:
    """How a tensor split over 'model' on distinct devices runs."""
    return (f"run one process per mesh position: torchrun --nproc-per-node {mesh.size} "
            f"(--strategy ai_core_assignment or fused)")


class Mesh:
    """Devices arranged on named axes: ``devices`` an ndarray (dtype
    object) of ``torch.device``s with one dim per name in ``axis_names``.
    A device may appear more than once: one card then plays several mesh
    positions, as the reference's tests fake host devices."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        return _distinct(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices {self.distinct_devices()})"


def _distinct(devices) -> list:
    out = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis that carries data parallelism (all but 'model')."""
    return tuple(a for a in mesh.axis_names if a != MDL)


def _dp(mesh):
    """dp_axes as a spec entry: name, tuple of names, or None."""
    axes = dp_axes(mesh)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axis_size(mesh, axis) -> int:
    """Size of a spec entry: an axis name or a tuple of axis names."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape[axis]


def fix_spec(spec, shape, mesh) -> tuple:
    """Repair ``spec`` against ``shape``: any entry whose mesh-axis size
    does not divide its dimension is trimmed (tuple entries drop axes
    from the right) or dropped entirely.  Unknown axis names are dropped.
    The result always satisfies ``dim % _axis_size(mesh, entry) == 0``
    and is padded with None to ``len(shape)``.
    """
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        if entry is None:
            fixed.append(None)
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        axes = tuple(a for a in axes if a in mesh.shape)
        while axes and dim % _axis_size(mesh, axes) != 0:
            axes = axes[:-1]
        if not axes:
            fixed.append(None)
        elif len(axes) == 1:
            fixed.append(axes[0])
        else:
            fixed.append(axes)
    return tuple(fixed)


# ---------------------------------------------------------------------------
# tree walking: per-layer lists stand for the reference's stacked axis
# ---------------------------------------------------------------------------


class LayerSpecs(list):
    """The specs of a per-layer list: one spec tree per layer, and in
    ``layer`` the entry of the reference's leading stacked-layer axis."""

    layer = None


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _map_specs(tree, leaf, names=(), lead=None, firsts=None):
    """``leaf(names, shape)`` -> full spec for every leaf, ``names`` the
    dict keys from the root (list indices skipped, as the reference's
    paths through a stacked subtree have none).  A list's leaves are
    asked with the list's length prepended to their shape — the stacked
    leaf the reference sees — and keep their spec without its leading
    entry, which becomes the list's ``LayerSpecs.layer``."""
    if isinstance(tree, dict):
        return {k: _map_specs(v, leaf, names + (str(k),), lead, firsts)
                for k, v in tree.items()}
    if isinstance(tree, list):
        if lead is not None:
            raise ValueError(f"nested layer lists under {'/'.join(names)}")
        seen: set = set()
        out = LayerSpecs(_map_specs(v, leaf, names, len(tree), seen) for v in tree)
        if len(seen) > 1:
            raise ValueError(f"layers of {'/'.join(names)} disagree on the layer "
                             f"axis: {seen}")
        out.layer = seen.pop() if seen else None
        return out
    if lead is None:
        return leaf(names, _shape(tree))
    full = leaf(names, (lead,) + _shape(tree))
    firsts.add(full[0] if full else None)
    return full[1:]


# ---------------------------------------------------------------------------
# input / cache specs
# ---------------------------------------------------------------------------


def batch_spec(mesh, ndim: int = 2) -> tuple:
    """Batch-leading array: dim 0 over the data axes, rest replicated."""
    return (_dp(mesh),) + (None,) * (ndim - 1)


def data_specs(batch, mesh):
    """Specs for a tree of input tensors (tokens/embeds/frames): the
    leading batch dim is split over the data axes."""

    def leaf(names, shape):
        if not shape:
            return ()
        return fix_spec((_dp(mesh),), shape, mesh)

    return _map_specs(batch, leaf)


def cache_specs(caches, mesh):
    """Specs for KV/SSM cache trees (per-layer lists; batch at dim 0 of a
    layer's leaf, dim 1 of the reference's stacked one).  Attention k/v
    additionally put their heads dim on 'model' (TP serving keeps each
    shard's heads local); 'len' counters (host ints here) and conv states
    replicate.
    """

    def leaf(names, shape):
        name = names[-1] if names else ""
        ndim = len(shape)
        if ndim < 2 or name == "len":
            return ()
        spec = [None] * ndim
        spec[1] = _dp(mesh)
        if name in ("k", "v") and ndim >= 4:
            spec[ndim - 2] = MDL  # heads dim of (L, B, T, H, D)
        elif name == "ssm" and ndim >= 4:
            spec[2] = MDL  # heads dim of (L, B, H, N, P)
        return fix_spec(tuple(spec), shape, mesh)

    return _map_specs(caches, leaf)


# ---------------------------------------------------------------------------
# param specs — the strategy engine
# ---------------------------------------------------------------------------


def _tp_dim(names, ndim: int) -> int | None:
    """Which dim the 'model' axis shards under AI-core assignment (TP/EP).

    Mirrors the paper's rule — the highest-MAC operators get the
    accelerator axis: QKV/MLP matmuls split column-wise, their consumers
    row-wise, MoE experts split across the expert axis, the embedding
    across its vocabulary.  Norm scales, biases of row-parallel layers,
    routers and the small SSM vectors stay replicated.  ``ndim`` counts
    the stacked layer axis of a per-layer leaf.
    """
    if ndim < 2 or not names:
        return None
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    if "experts" in names or "shared" in names:
        # (L, E, d_in, d_out) stacked / (E, d_in, d_out) unstacked: EP
        # over the expert axis
        return ndim - 3 if leaf == "w" else None
    if leaf == "table":
        # embedding (V, D): vocab-parallel (Megatron convention)
        return ndim - 2
    if leaf == "w":
        if parent in _ROW_PARALLEL:
            return ndim - 2
        if parent in _COL_PARALLEL:
            return ndim - 1
        return None  # router & friends replicate
    if leaf == "b" and parent in _COL_PARALLEL:
        return ndim - 1  # bias follows its column-split output dim
    return None


def _fsdp_dim(names, shape, tp: int | None) -> int | None:
    """Which dim the data axes shard under 'fused' (FSDP x TP): the
    largest weight dim not already taken by TP, skipping the stacked
    layer axis."""
    if len(shape) < 2 or not names:
        return None
    if names[-1] not in ("w", "table", "conv_w"):
        return None  # scales/biases/vectors are too small to matter
    start = 1 if names[0] in _STACKED_SUBTREES else 0
    candidates = [d for d in range(start, len(shape)) if d != tp]
    if not candidates:
        return None
    return max(candidates, key=lambda d: shape[d])


def param_specs(params, mesh, strategy: str = "fused"):
    """Spec tree for a param tree under ``strategy`` (tensors of any
    device, ``meta`` included: only shapes are read).

    Under 'pipeline' the block lists put 'model' on their layer axis
    (``LayerSpecs.layer``) — the layout :mod:`repro_torch.dist.pipeline`
    runs, stage k holding a contiguous slice of the (padded) list — while
    non-stacked params (embed, head, final norm) keep FSDP over the data
    axes only.  Every spec is repaired with :func:`fix_spec`, so the
    result is legal on any mesh.
    """
    if strategy not in SHARDING_STRATEGIES:
        raise ValueError(
            f"unknown sharding strategy {strategy!r}; "
            f"choose from {SHARDING_STRATEGIES}"
        )
    dp_entry = _dp(mesh)

    def leaf(names, shape):
        if strategy == "scatter_gather" or not shape:
            return ()
        spec = [None] * len(shape)
        if strategy == "pipeline":
            if names and names[0] in _STACKED_SUBTREES:
                # layer axis only: any extra dp sharding here would be
                # gathered on every pipelined call
                spec[0] = MDL if MDL in mesh.shape else None
                return fix_spec(tuple(spec), shape, mesh)
            # non-stacked params stay OFF the 'model' axis: the train
            # pipe folds the loss head into the last stage
            fs = _fsdp_dim(names, shape, None)
            if fs is not None:
                spec[fs] = dp_entry
            return fix_spec(tuple(spec), shape, mesh)
        tp = _tp_dim(names, len(shape))
        if tp is not None and MDL in mesh.shape:
            spec[tp] = MDL
        if strategy == "fused":
            fs = _fsdp_dim(names, shape, tp)
            if fs is not None:
                spec[fs] = dp_entry
        return fix_spec(tuple(spec), shape, mesh)

    return _map_specs(params, leaf)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _axes(spec) -> set:
    """The mesh axis names a spec mentions."""
    return {a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,))}


def data_positions(mesh) -> int:
    """The mesh's data positions: the product of its data axes."""
    return _axis_size(mesh, dp_axes(mesh))


def row_devices(mesh) -> list:
    """Each data position's row (row-major over the data axes): the list
    of its devices along 'model' (one device without a 'model' axis)."""
    devs = mesh.devices
    if MDL in mesh.shape:
        devs = np.moveaxis(devs, mesh.axis_names.index(MDL), -1)
    else:
        devs = devs[..., None]
    return [list(row) for row in devs.reshape(-1, devs.shape[-1])]


def local_mesh(mesh, group) -> Mesh:
    """This process's row of ``mesh``: a mesh over its 'model' devices with
    every data axis of size 1.  The process count must equal the mesh's
    data positions."""
    positions = data_positions(mesh)
    count = 1 if group is None else group.size
    if count != positions:
        raise ValueError(f"{count} processes for a mesh with {positions} data positions "
                         f"{mesh.shape}: run one process per data position")
    row = row_devices(mesh)[0 if group is None else group.rank]
    names = mesh.axis_names + (() if MDL in mesh.shape else (MDL,))
    shape = [len(row) if a == MDL else 1 for a in names]
    return Mesh(np.asarray(row, dtype=object).reshape(shape), names)


def position_device(mesh, data=None, model=None):
    """The device of this process's mesh position (one process per
    position): row ``data.rank``'s device ``model.rank``."""
    row = row_devices(mesh)[0 if data is None else data.rank]
    return row[0 if model is None else model.rank]


def data_shards(specs, mesh):
    """The FSDP layout a spec tree gives on ``mesh``: per leaf ``(dim, n)``
    when dim ``dim`` is split ``n`` ways over the data axes, else None; a
    per-layer list (:class:`LayerSpecs`) gives a list."""
    return _axis_shards(specs, mesh, set(dp_axes(mesh)))


def model_shards(specs, mesh):
    """:func:`data_shards`' twin for the 'model' axis: per leaf ``(dim,
    n)`` when dim ``dim`` is split ``n`` ways over 'model' (tensor and
    expert parallelism), else None.  The pipeline's layer axis is not a
    tensor dim and gives None."""
    return _axis_shards(specs, mesh, {MDL})


def _axis_shards(specs, mesh, names: set):
    def one(spec):
        for dim, entry in enumerate(spec):
            axes = entry if isinstance(entry, tuple) else (entry,)
            n = _axis_size(mesh, tuple(a for a in axes if a in names))
            if n > 1:
                return (dim, n)
        return None

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if _is_named_tuple(node):
            return type(node)(*[walk(getattr(node, f)) for f in node._fields])
        if isinstance(node, list):
            return [walk(v) for v in node]
        return one(node)

    return walk(specs)


def stage_devices(mesh) -> list:
    """The device of each pipeline stage: slice k of the mesh along
    'model'.  A slice that spans distinct devices (a data axis over
    several cards in one process) raises: each data position is a process
    of its own (:func:`local_mesh`)."""
    if MDL in mesh.shape:
        axis = mesh.axis_names.index(MDL)
        cols = [np.take(mesh.devices, k, axis=axis) for k in range(mesh.shape[MDL])]
    else:
        cols = [mesh.devices]
    out = []
    for k, col in enumerate(cols):
        devs = _distinct(col.flat)
        if len(devs) > 1:
            raise NotImplementedError(
                f"stage {k} spans devices {devs}: a data axis over several devices runs "
                f"one process per data position (torchrun --nproc-per-node "
                f"{data_positions(mesh)}; dist.collective.data_group), not in one process "
                f"({MULTI_CARD_ITEM})")
        out.append(devs[0])
    return out


def _mentions_model(specs) -> bool:
    if isinstance(specs, dict):
        return any(_mentions_model(v) for v in specs.values())
    if isinstance(specs, list):
        return specs.layer == MDL or any(_mentions_model(v) for v in specs)
    if _is_named_tuple(specs):
        return any(_mentions_model(v) for v in specs)
    return MDL in _axes(specs)


def place(tree, specs, mesh, group=None, model=None):
    """``tree`` with every tensor on the mesh's devices per ``specs``
    (from :func:`param_specs`, :func:`cache_specs` or
    ``ft.elastic.state_shardings``; a named tuple's spec is the same named
    tuple of specs).

    With a ``group`` (``dist.collective.data_group``: one process per data
    position) each leaf first keeps this process's slice of its dim split
    over the data axes (:func:`data_shards`), every replicated leaf whole,
    and the rest is placed on this process's row (:func:`local_mesh`).
    With a ``model`` group (``dist.collective.mesh_groups``: one process
    per mesh position; ``group`` its data group, None for one data
    position) each leaf also keeps its slice of the dim split over 'model'
    (:func:`model_shards`), and everything goes to this position's device.

    On a mesh (or row) of one device, however often it is listed, every
    tensor moves there — the identity for a tree already on it.  On a row
    over distinct devices a tree with nothing on 'model' (scatter_gather's
    replicas) is placed, and computed, once on the row's first device;
    the pipeline layout sends each per-layer list whose layer axis is on
    'model' its contiguous slice k to stage k's device, everything else to
    stage 0's.  A tensor dim on 'model' over distinct devices (tensor or
    expert parallelism) or a data axis over distinct devices in one
    process raises ``NotImplementedError`` naming the torchrun command.
    """
    if model is not None:
        from repro_torch.dist.collective import slice_tree

        tree = slice_tree(tree, data_shards(specs, mesh), group)
        tree = slice_tree(tree, model_shards(specs, mesh), model)
        return _place_all(tree, position_device(mesh, group, model))
    whole_mesh = mesh
    if group is not None:
        from repro_torch.dist.collective import slice_tree

        tree = slice_tree(tree, data_shards(specs, mesh), group)
        mesh = local_mesh(mesh, group)
    devs = mesh.distinct_devices()
    if len(devs) == 1:
        return _place_all(tree, devs[0])
    stage_dev = stage_devices(mesh)
    if not _mentions_model(specs):
        return _place_all(tree, stage_dev[0])
    stages = len(stage_dev)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if _is_named_tuple(node):
            return type(node)(*[walk(getattr(node, f), getattr(spec, f)) for f in node._fields])
        if isinstance(node, list):
            if stages > 1 and spec.layer != MDL:
                raise NotImplementedError(
                    f"a layer list not split over the {stages} stages on distinct "
                    f"devices is {MULTI_CARD_ITEM}: {per_position_hint(whole_mesh)}")
            per = len(node) // stages
            return [_place_all(v, stage_dev[i // per]) for i, v in enumerate(node)]
        if isinstance(node, torch.Tensor):
            if stages > 1 and MDL in _axes(spec):
                raise NotImplementedError(
                    f"a tensor split over 'model' on distinct devices in one process is "
                    f"{MULTI_CARD_ITEM}: {per_position_hint(whole_mesh)}")
            return node.to(stage_dev[0])
        return node

    return walk(tree, specs)


def _is_named_tuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _place_all(tree, device):
    if isinstance(tree, dict):
        return {k: _place_all(v, device) for k, v in tree.items()}
    if _is_named_tuple(tree):
        return type(tree)(*[_place_all(v, device) for v in tree])
    if isinstance(tree, list):
        return [_place_all(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
