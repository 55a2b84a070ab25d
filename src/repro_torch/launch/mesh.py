"""Mesh factories (the port of ``repro.launch.mesh``).

Defined as functions so importing this module touches no device state.
The default devices are the CUDA devices torch sees; a caller may pass
any list of ``torch.device``s, the same one repeated included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.sharding import MDL, TP_STRATEGIES, Mesh, data_positions


def cuda_devices() -> list:
    """Every CUDA device torch sees, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_devices(device: torch.device) -> list:
    """The devices a launcher's ``--device`` names: every CUDA device
    torch sees for a bare ``cuda``, else that one device."""
    if device.type == "cuda" and device.index is None:
        return cuda_devices()
    return [device]


def _make_mesh(shape, axes, devices) -> Mesh:
    """The reference's ``jax.make_mesh``: the first ``prod(shape)``
    devices in order; fewer devices than that raise ``ValueError``."""
    n = math.prod(shape)
    if n > len(devices):
        raise ValueError(f"Number of devices {len(devices)} must be >= the product "
                         f"of mesh_shape {tuple(shape)}")
    return Mesh(np.asarray(devices[:n], dtype=object).reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, list(cuda_devices() if devices is None else devices))


def make_smoke_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """Tiny mesh over whatever devices exist (smoke tests)."""
    devices = list(cuda_devices() if devices is None else devices)
    n = len(devices)
    data = min(data, n)
    model = max(1, min(model, n // data))
    return _make_mesh((data, model), ("data", "model"), devices)


def launch_mesh(device: torch.device, group_size: int, production: bool = False) -> Mesh:
    """A launcher's global mesh: ``ft.elastic.make_mesh_for`` (or, with
    ``production``, the production mesh) over the devices of ``--device``;
    on the CPU, one CPU position per process of the group."""
    from repro_torch.ft.elastic import make_mesh_for

    devices = mesh_devices(device)
    if device.type == "cpu" and group_size > 1:
        devices = devices * group_size
    return make_production_mesh(devices=devices) if production else make_mesh_for(devices)


def layouts(mesh, module: str) -> str:
    """The torchrun commands that run ``mesh``: one process per data
    position, and where the mesh has a 'model' axis one per mesh position
    (tensor and expert parallelism, or one process a pipeline stage)."""
    n = data_positions(mesh)
    out = f"one process per data position, torchrun --nproc-per-node {n} -m {module} ..."
    if mesh.shape.get(MDL, 1) > 1:
        out += (f"; or one process per mesh position (--strategy ai_core_assignment, "
                f"fused or pipeline), torchrun --nproc-per-node {mesh.size} -m {module} ...")
    return out


def refuse_lone_process(mesh, module: str, strategy: str | None = None) -> None:
    """One process on a mesh with several data positions over distinct
    devices would leave cards idle, and one process cannot split tensors
    over distinct devices (``strategy`` ai_core_assignment or fused):
    exit naming the torchrun commands."""
    n = data_positions(mesh)
    distinct = len(mesh.distinct_devices()) > 1
    if n > 1 and distinct:
        raise SystemExit(f"the mesh {mesh.shape} has {n} data positions: run "
                         f"{layouts(mesh, module)}")
    if strategy in TP_STRATEGIES and mesh.shape.get(MDL, 1) > 1 and distinct:
        raise SystemExit(f"the mesh {mesh.shape} splits tensors over distinct devices "
                         f"under {strategy}: run {layouts(mesh, module)}")


def per_position(mesh, strategy: str) -> bool:
    """Whether ``strategy`` on ``mesh`` can run one process per mesh
    position (ai_core_assignment, fused or pipeline with a 'model' axis of
    2 or more: tensor and expert parallelism, or one process a pipeline
    stage) rather than one per data position.  Over distinct devices
    ai_core_assignment and fused must (:func:`refuse_lone_process`); the
    pipeline may also run its row layout, one process per data position
    driving its row's stages."""
    return strategy in TP_STRATEGIES + ("pipeline",) and mesh.shape.get(MDL, 1) > 1


def join_groups(mesh, strategy: str, module: str):
    """This process's ``(data, model)`` groups for the launcher's world
    (``dist.collective``): none for one process (which must fit the mesh,
    :func:`refuse_lone_process`), a data group for one process per data
    position (under pipeline the row layout: each process drives its
    row's stages), both for one process per mesh position under
    ai_core_assignment, fused or pipeline (one process a stage).  Any
    other world exits naming both commands."""
    from repro_torch.dist.collective import data_group, mesh_groups, requested_world

    world = requested_world()
    if world is None or world[1] == 1:
        refuse_lone_process(mesh, module, strategy)
        return None, None
    n = world[1]
    if n == data_positions(mesh):
        return data_group(mesh), None
    if n == mesh.size and per_position(mesh, strategy):
        return mesh_groups(mesh)
    raise SystemExit(f"{n} processes under --strategy {strategy} for the mesh {mesh.shape}: "
                     f"run {layouts(mesh, module)}")
