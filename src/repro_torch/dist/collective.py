"""Collectives across the mesh's positions (``torch.distributed``), the
port's counterpart of the ``pmean`` / ``psum`` and FSDP gathers that XLA
inserts into the reference's jitted steps.

Two layouts:

  * one process per data position (:func:`data_group`): each process owns
    its mesh row, the devices of its ``model`` axis
    (``dist.sharding.local_mesh``), and within a process everything runs
    as with one process;
  * one process per mesh position (:func:`mesh_groups`, under
    ``ai_core_assignment`` / ``fused`` / ``pipeline``): each process owns
    one device and belongs to two subgroups, its *model group* (the
    positions that share its data position: tensor and expert parallelism,
    ``dist.tensor``, or a row's pipeline stages, which pass activations
    and gradients to their neighbours with :func:`send_to` /
    :func:`recv_from`) and its *data group* (the positions that share its
    model index).

A :class:`DataGroup` is this process's view of the data axes: a
``torch.distributed`` process group (``pg``; ``None`` is the default
group), this process's data position (``rank``: the row-major index over
the mesh's ``pod`` x ``data`` axes) and the position count.  A
:class:`ModelGroup` is the same for the 'model' axis.  Every collective
below runs over the group it is given, so the FSDP gathers and the grad
means of the mesh-position layout stay among positions with the same
model index.

The backend follows the layout, never a failure:

  * ``gloo`` when the processes' devices are CPUs;
  * ``nccl`` when every process owns distinct CUDA devices;
  * ``gloo`` when processes share a card (NCCL refuses two ranks on one
    GPU);
  * ``fake`` for the dry-run stand-in (:func:`fake_world`: one process
    runs one position of a world of any size on ``meta``).

Every backend runs the same collectives: a bucketed ``all_reduce`` for
replicated leaves, ``all_gather_into_tensor`` and ``reduce_scatter_tensor``
for FSDP slices, blocking ``send`` / ``recv`` between pipeline stages.
gloo has a CUDA ``all_reduce`` but no CUDA ``all_gather``,
``reduce_scatter``, ``send`` or ``recv``: under gloo those stage CUDA
tensors through a pinned host buffer.

The rendezvous comes from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from an explicit
``init_method`` (``file://...`` or ``tcp://...``).  With neither there is
no group: :func:`data_group` returns ``None`` and the count is 1.

A shard tree (``dist.sharding.data_shards``) gives each leaf's FSDP
layout: ``(dim, n)`` when the leaf's dim ``dim`` is split in ``n`` over
the data axes (``n`` divides the position count; positions ``p`` and
``q`` hold the same slice when ``p // (count // n) == q // (count // n)``),
else ``None`` (replicated).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten

#: how long a collective may wait for the other processes
TIMEOUT = datetime.timedelta(seconds=600)


class DataGroup:
    """This process's data group: ``rank`` of ``size`` positions over
    ``backend``, on the process group ``pg`` (None: the default group)."""

    def __init__(self, rank: int, size: int, backend: str, pg=None):
        self.rank, self.size, self.backend, self.pg = rank, size, backend, pg

    def close(self) -> None:
        """Leave the world (each process at its end): every group goes."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(rank {self.rank} of {self.size}, {self.backend})"


class ModelGroup(DataGroup):
    """This process's model group (one process per mesh position): its
    index ``rank`` along the mesh's 'model' axis of ``size``."""


def close(*groups) -> None:
    """Leave the world once, whichever of ``groups`` exist."""
    if any(g is not None for g in groups) and dist.is_initialized():
        dist.destroy_process_group()


def process_index(group) -> int:
    """``jax.process_index()``: 0 without a group."""
    return 0 if group is None else group.rank


def process_count(group) -> int:
    """``jax.process_count()``: 1 without a group."""
    return 1 if group is None else group.size


def backend_for(mesh, per_position: bool = False) -> str:
    """The backend the mesh's layout asks for (module docstring): each
    process's device is its row's first, or with ``per_position`` its own
    mesh position's."""
    from repro_torch.dist.sharding import row_devices

    rows = row_devices(mesh)
    firsts = [d for row in rows for d in row] if per_position else [row[0] for row in rows]
    if all(d.type == "cuda" for d in firsts) and len(set(firsts)) == len(firsts):
        return "nccl"
    return "gloo"


def requested_world() -> tuple[int, int] | None:
    """``(rank, world size)`` from torchrun's environment, or None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return int(os.environ.get("RANK", "0")), int(os.environ["WORLD_SIZE"])


def data_group(mesh, *, init_method: str | None = None, rank: int | None = None,
               world_size: int | None = None):
    """Join the data group of ``mesh`` (one process per data position):
    ``rank`` / ``world_size`` from the arguments or torchrun's
    environment.  Returns ``None`` (no group, count 1) when neither an
    ``init_method`` nor the environment names a world, or the world has
    one process.  A world size other than the mesh's data positions raises
    ``ValueError`` naming both.  On the card, the process's row's first
    device becomes the current CUDA device before the group is made."""
    from repro_torch.dist.sharding import data_positions, row_devices

    env = requested_world()
    if rank is None or world_size is None:
        if init_method is None and env is None:
            return None
        if env is None:
            raise ValueError("an init_method needs rank and world_size")
        rank, world_size = env
    positions = data_positions(mesh)
    if world_size != positions:
        raise ValueError(f"{world_size} processes for a mesh with {positions} data "
                         f"positions {mesh.shape}: run one process per data position")
    if world_size == 1:
        return None
    first = row_devices(mesh)[rank][0]
    if first.type == "cuda" and first.index is not None:
        torch.cuda.set_device(first)
    backend = backend_for(mesh)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return DataGroup(rank, world_size, backend)


def init_world(backend: str, *, init_method: str | None = None, rank: int,
               world_size: int) -> DataGroup:
    """Join a world of ``world_size`` processes over ``backend`` (the
    default process group) and return it as a group (``pg`` None); the
    caller has made its device current."""
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    return DataGroup(rank, world_size, backend)


#: the backend of a world of one process standing in for many (``fake``:
#: collectives return at once, their outputs' shapes only), which the
#: dry-run stand-in runs one mesh position in; neither ``nccl`` nor ``gloo``,
#: so a collective runs where its tensor is, with no host staging
FAKE = "fake"


def fake_world(world_size: int, rank: int = 0) -> DataGroup:
    """A world of ``world_size`` positions over the ``fake`` backend in
    this one process, as ``rank``: the default group, as a group.  A
    process that already has a default group raises ``RuntimeError``
    naming it; :func:`close` ends the world."""
    if dist.is_initialized():
        raise RuntimeError(f"a fake world of {world_size} needs a process with no default "
                           f"group; this one is rank {dist.get_rank()} of "
                           f"{dist.get_world_size()} over {dist.get_backend()}")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group(FAKE, store=FakeStore(), rank=rank, world_size=world_size)
    return DataGroup(rank, world_size, FAKE)


def subgroups(mesh, rank: int, backend: str, per_position: bool):
    """This process's ``(data, model, active)`` groups for ``mesh`` inside a
    world that exists already (:func:`init_world`): one process per mesh
    position (``per_position``, 'model' over 2 or more positions: rank
    ``r`` at ``(r // m, r % m)``) or one per data position (rank ``r`` at
    data position ``r``).  The layout's processes are the world's first
    ``n`` ranks; ``active`` holds all ``n`` (the default group when ``n``
    is the world).  A group of one position is None, and so is each
    group of a rank past ``n`` (a process whose devices left the mesh).
    Every process of the world calls this, in the same order, for every
    mesh it forms: ``new_group`` asks that of members and non-members
    alike."""
    from repro_torch.dist.sharding import MDL, data_positions

    m = mesh.shape.get(MDL, 1) if per_position else 1
    dp = data_positions(mesh)
    n = dp * m
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh {mesh.shape} of {n} processes in a world of {world}")
    active_pg = None
    if 1 < n < world:
        active_pg = dist.new_group(list(range(n)), timeout=TIMEOUT, backend=backend)
    model_pg = data_pg = active_pg
    p, k = divmod(rank, m)
    if m > 1:
        for q in range(dp):
            g = dist.new_group([q * m + j for j in range(m)], timeout=TIMEOUT, backend=backend)
            if q == p:
                model_pg = g
        for j in range(m):
            g = dist.new_group([q * m + j for q in range(dp)], timeout=TIMEOUT,
                               backend=backend) if dp > 1 else None
            if j == k:
                data_pg = g
    if rank >= n:
        return None, None, None
    return (DataGroup(p, dp, backend, data_pg) if dp > 1 else None,
            ModelGroup(k, m, backend, model_pg) if m > 1 else None,
            DataGroup(rank, n, backend, active_pg) if n > 1 else None)


def mesh_groups(mesh, *, init_method: str | None = None, rank: int | None = None,
                world_size: int | None = None):
    """Join a world of one process per mesh position (``rank`` / ``world_size``
    from the arguments or torchrun's environment): returns ``(data,
    model)``, this process's :class:`DataGroup` (None where the mesh has
    one data position) and :class:`ModelGroup`.  Rank ``r`` is position
    ``(r // m, r % m)`` of the (data positions, m) grid, ``m`` the 'model'
    axis; its device (``dist.sharding.position_device``) becomes the
    current CUDA device before the groups are made.  Every process makes
    every subgroup, in the same order, as ``new_group`` asks."""
    from repro_torch.dist.sharding import MDL, data_positions, row_devices

    if rank is None or world_size is None:
        env = requested_world()
        if env is None:
            raise ValueError("mesh_groups needs rank and world_size or torchrun's "
                             "environment")
        rank, world_size = env
    m = mesh.shape.get(MDL, 1)
    dp = data_positions(mesh)
    if world_size != mesh.size or m < 2:
        raise ValueError(f"{world_size} processes for a mesh {mesh.shape} of {mesh.size} "
                         f"positions: one process per mesh position needs a 'model' axis "
                         f"over 2 or more positions and a process for each")
    p, k = divmod(rank, m)
    device = row_devices(mesh)[p][k]
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    backend = backend_for(mesh, per_position=True)
    init_world(backend, init_method=init_method, rank=rank, world_size=world_size)
    data, model, _ = subgroups(mesh, rank, backend, per_position=True)
    return data, model


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _peer(group, r: int) -> int:
    """The world rank of ``group``'s position ``r``."""
    return r if group.pg is None else dist.get_global_rank(group.pg, r)


def send_to(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to position ``dst`` of ``group`` (a neighbouring stage of
    a model group), a blocking ``send``: its receiver must post the
    matching :func:`recv_from` in the same order.  Under gloo a CUDA tensor
    goes through a pinned host buffer; NCCL sends it from the card."""
    src = t.detach().contiguous()
    if group.backend == "gloo" and src.device.type == "cuda":
        src = _to_host(src)
    dist.send(src, _peer(group, dst), group=group.pg)


def recv_from(buf: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive into ``buf`` (its shape and dtype those of the sent tensor)
    from position ``src`` of ``group``, a blocking ``recv``; returns
    ``buf``.  Under gloo a CUDA buffer is filled through a pinned host
    buffer."""
    if group.backend == "gloo" and buf.device.type == "cuda":
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        dist.recv(host, _peer(group, src), group=group.pg)
        return buf.copy_(host)
    dist.recv(buf, _peer(group, src), group=group.pg)
    return buf


def gather_stages_first(tree, specs, model):
    """``tree`` with every per-layer list whose layer axis is on 'model'
    (``specs``' :class:`~repro_torch.dist.sharding.LayerSpecs` with
    ``layer == "model"``; the tree holds stage ``model.rank``'s slice of
    it, one process per mesh position under ``pipeline``) made whole on
    the model group's first process, the stages' slices in stage order
    (one ``gather`` a leaf); on the others those lists are None.  The
    identity without a model group (a checkpoint's writer)."""
    if model is None:
        return tree
    from repro_torch.dist.sharding import MDL, _is_named_tuple

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if _is_named_tuple(node):
            return type(node)(*[walk(getattr(node, f), getattr(spec, f))
                                for f in node._fields])
        if isinstance(node, list) and getattr(spec, "layer", None) == MDL:
            parts = [gather_first(t[None], (0, model.size), model) for t in leaves(node)]
            if model.rank:
                return None
            return [layer for s in range(model.size)
                    for layer in unflatten(node, [p[s] for p in parts])]
        return node

    return walk(tree, specs)


def barrier(*groups) -> None:
    """Wait for every process of each group in turn (the model group then
    the data group covers a world of mesh positions)."""
    for group in groups:
        if group is None:
            continue
        if group.backend == "nccl":
            dist.barrier(group=group.pg, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group.pg)


def _home(group, t: torch.Tensor) -> torch.device:
    """Where a collective over ``t`` runs: under NCCL this process's own
    card (the row's first, current since ``data_group``), so that every
    rank's communicator pairs the same cards whichever stage a tensor
    sits on; under gloo the tensor's device."""
    if group.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def all_reduce_sum(tensors: list, group) -> list:
    """The elementwise sums across processes of a list of tensors, one
    ``all_reduce`` per dtype bucket (packed in list order, on the first
    tensor's home device), each sum returned on its tensor's device."""
    return _all_reduce(tensors, group, dist.ReduceOp.SUM)


def all_reduce_max(tensors: list, group) -> list:
    """:func:`all_reduce_sum`'s twin for the elementwise maxima."""
    return _all_reduce(tensors, group, dist.ReduceOp.MAX)


def _all_reduce(tensors: list, group, op) -> list:
    out = list(tensors)
    buckets: dict = {}
    for i, t in enumerate(tensors):
        buckets.setdefault(t.dtype, []).append(i)
    for idx in buckets.values():
        home = _home(group, tensors[idx[0]])
        flat = torch.cat([tensors[i].reshape(-1).to(home) for i in idx])
        dist.all_reduce(flat, op=op, group=group.pg)
        pos = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[pos:pos + n].view(tensors[i].shape).to(tensors[i].device)
            pos += n
    return out


def pmean(tree, group):
    """The reference's ``pmean`` of a tree of tensors: the sum across
    processes (one ``all_reduce`` per dtype and device) over the count.
    The identity without a group."""
    if group is None:
        return tree
    flat = all_reduce_sum([t.detach() for t in leaves(tree)], group)
    return unflatten(tree, [t / group.size for t in flat])


def local_slice(t: torch.Tensor, shard, group) -> torch.Tensor:
    """This process's slice of ``t`` under ``shard`` ((dim, n) or None),
    in storage of its own."""
    if shard is None:
        return t
    dim, n = shard
    size = t.shape[dim] // n
    index = group.rank // (group.size // n)
    return t.narrow(dim, index * size, size).clone()


def _shard_pairs(tree, shards):
    """[(leaf, shard)] of a tree and its shard tree (None: every leaf
    replicated), in leaf order."""
    flat = leaves(tree)
    spec = [None] * len(flat) if shards is None else _shard_leaves(shards)
    if len(spec) != len(flat):
        raise ValueError(f"shard tree has {len(spec)} leaves for a tree of {len(flat)}")
    return list(zip(flat, spec))


def _shard_leaves(shards) -> list:
    """The shard tree's leaves ((dim, n) pairs or None) in tree order."""
    if isinstance(shards, dict):
        return [x for k in sorted(shards) for x in _shard_leaves(shards[k])]
    if isinstance(shards, tuple) and hasattr(shards, "_fields"):
        return [x for f in shards._fields for x in _shard_leaves(getattr(shards, f))]
    if isinstance(shards, list):
        return [x for v in shards for x in _shard_leaves(v)]
    return [shards]


def _leading(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` with ``dim`` moved first, contiguous, where a gather or scatter
    over it runs: its home device, or a pinned host buffer for a CUDA
    tensor under gloo (no CUDA ``all_gather`` or ``reduce_scatter``)."""
    src = t.detach().movedim(dim, 0).contiguous()
    if group.backend == "gloo" and src.device.type == "cuda":
        return _to_host(src)
    return src.to(_home(group, t))


def _gathered(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every process's ``t`` stacked on a new leading dim of its dim
    ``dim`` moved first: (size * t.shape[dim], ...)."""
    src = _leading(t, dim, group)
    whole = src.new_empty((group.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(whole, src, group=group.pg)
    return whole


def all_gather(t: torch.Tensor, shard, group) -> torch.Tensor:
    """The whole of a leaf from each process's slice (``shard`` (dim, n))."""
    dim, n = shard
    whole = _gathered(t, dim, group)
    # positions holding one slice gathered it repeatedly: keep one of each;
    # the whole leaf contiguous, as one process holds it (a GEMM on a
    # transposed layout rounds differently)
    pieces = whole.chunk(group.size)[::group.size // n]
    return torch.cat(pieces, dim=0).to(t.device).movedim(0, dim).contiguous()


def gather_first(t: torch.Tensor, shard, group):
    """The whole of a leaf from each process's slice (``shard`` (dim, n)),
    on the group's first process alone (where the gather ran: the host
    for a CUDA tensor under gloo); None on the others."""
    dim, n = shard
    src = _leading(t, dim, group)
    parts = [torch.empty_like(src) for _ in range(group.size)] if group.rank == 0 else None
    dst = 0 if group.pg is None else dist.get_global_rank(group.pg, 0)
    dist.gather(src, parts, dst=dst, group=group.pg)
    if group.rank:
        return None
    return torch.cat(parts[::group.size // n], dim=0).movedim(0, dim).contiguous()


def gather_tree_first(tree, shards, group):
    """``tree`` with every sharded leaf gathered whole on the group's first
    process (:func:`gather_first`; a checkpoint's writer); on the others
    those leaves are None.  The identity without a group."""
    if group is None or shards is None:
        return tree
    return unflatten(tree, [t if s is None else gather_first(t, s, group)
                            for t, s in _shard_pairs(tree, shards)])


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every process's ``t`` concatenated along ``dim`` in rank order."""
    return _gathered(t, dim, group).to(t.device).movedim(0, dim).contiguous()


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This process's slice (its rank's ``1 / size`` of dim ``dim``) of the
    sum of every process's ``t``."""
    src = _leading(t, dim, group)
    part = src.new_empty((src.shape[0] // group.size,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(part, src, op=dist.ReduceOp.SUM, group=group.pg)
    return part.to(t.device).movedim(0, dim).contiguous()


def gather_tree(tree, shards, group):
    """``tree`` with every sharded leaf gathered whole; the identity
    without a group."""
    if group is None or shards is None:
        return tree
    return unflatten(tree, [t if s is None else all_gather(t, s, group)
                            for t, s in _shard_pairs(tree, shards)])


def slice_tree(tree, shards, group):
    """``tree`` with every sharded leaf cut to this process's slice."""
    if group is None or shards is None:
        return tree
    return unflatten(tree, [local_slice(t, s, group) for t, s in _shard_pairs(tree, shards)])


def pmean_scatter(tree, shards, group):
    """``pmean`` of whole per-process leaves, each sharded leaf left as this
    process's slice of the mean: one ``reduce_scatter`` per sharded leaf
    (its ``n`` slices each repeated for the ``count / n`` positions that
    hold it), one bucketed ``all_reduce`` for the replicated rest."""
    if group is None:
        return tree
    pairs = _shard_pairs(tree, shards)
    out = [None] * len(pairs)
    rest = []
    for i, (t, s) in enumerate(pairs):
        if s is None:
            rest.append(i)
            continue
        dim, n = s
        src = _leading(t, dim, group)
        rows = tuple(src.shape[1:])
        src = src.reshape((n, -1) + rows).repeat_interleave(group.size // n, dim=0)
        part = src.new_empty(src.shape[1:])
        dist.reduce_scatter_tensor(part, src.reshape((-1,) + rows), op=dist.ReduceOp.SUM,
                                   group=group.pg)
        out[i] = (part / group.size).to(t.device).movedim(0, dim).contiguous()
    summed = all_reduce_sum([pairs[i][0].detach() for i in rest], group)
    for i, t in zip(rest, summed):
        out[i] = t / group.size
    return unflatten(tree, out)


def global_norm(tree, shards, group, model_shards=None, model=None) -> torch.Tensor:
    """The global L2 norm of a tree whose sharded leaves hold this
    process's slice: the squares of the slices split over the data axes
    (``shards``, each slice counted once however many positions hold it)
    summed over ``group``, those split over 'model' (``model_shards``)
    summed over ``model``, and each replicated leaf's square counted once,
    on the first leaf's device."""
    pairs = _shard_pairs(tree, shards if group is not None else None)
    msplit = [s is not None for _, s in _shard_pairs(tree, model_shards)]
    dev = pairs[0][0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # [replicated, data only, model only, both]
    part = [zero, zero, zero, zero]
    for (t, s), m in zip(pairs, msplit):
        sq = t.float().square().sum().to(dev)
        if s is not None:
            sq = sq * (s[1] / group.size)
        i = (s is not None) + 2 * m
        part[i] = part[i] + sq
    if group is not None:
        part[1], part[3] = all_reduce_sum([part[1], part[3]], group)
    if model is not None:
        (part[2],) = all_reduce_sum([part[2] + part[3]], model)
    elif any(msplit):
        raise ValueError("leaves split over 'model' need the model group")
    return torch.sqrt(part[1] + part[2] + part[0])


def shard_rows(batch: dict, m: int, ndp: int, j: int) -> dict:
    """Shard ``j`` of ``ndp`` of a global batch split into ``m``
    microbatches: rows ``[i*mb + j*r, i*mb + (j+1)*r)`` of each microbatch
    ``i`` (``mb = B / m``, ``r = mb / ndp``), the row layout of the
    pipeline's data shards.  Microbatch ``i`` of the result (``r`` rows)
    holds this shard's part of the global microbatch ``i``."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % m or (b // m) % ndp:
            raise ValueError(f"batch {b} ({k}) does not split into {m} microbatches "
                             f"of {ndp} data shards")
        mb = b // m
        r = mb // ndp
        out[k] = v.reshape(m, mb, *v.shape[1:])[:, j * r:(j + 1) * r].reshape(
            m * r, *v.shape[1:])
    return out


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every process's rows of ``x`` (dim 0), in process order."""
    if group is None:
        return x
    return all_gather(x, (0, group.size), group)


def spawn(fn, nprocs: int, args=(), *, timeout: float = 600.0, workdir: str | None = None):
    """Run ``fn(rank, nprocs, init_method, *args)`` in ``nprocs`` fresh
    processes that meet through a file store under ``workdir`` (a new
    temporary directory by default).  Every child is joined within
    ``timeout`` seconds: a child that raises re-raises its traceback here
    (the others are stopped), and a join that times out kills them all and
    raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    workdir = workdir or tempfile.mkdtemp(prefix="repro_torch_dp_")
    store = os.path.join(workdir, f"rendezvous_{os.getpid()}_{time.monotonic_ns()}")
    ctx = mp.start_processes(fn, args=(nprocs, f"file://{store}", *args), nprocs=nprocs,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} processes did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(5)
