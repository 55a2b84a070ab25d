"""Mesh factories (the port of ``repro.launch.mesh``).

Defined as functions so importing this module touches no device state.
The default devices are the CUDA devices torch sees; a caller may pass
any list of ``torch.device``s, the same one repeated included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.dist.sharding import Mesh, data_positions


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


def refuse_lone_process(mesh, module: str) -> None:
    """One process on a mesh with several data positions over distinct
    devices would leave cards idle: exit naming the torchrun command."""
    n = data_positions(mesh)
    if n > 1 and len(mesh.distinct_devices()) > 1:
        raise SystemExit(f"the mesh {mesh.shape} has {n} data positions: run one process "
                         f"per position, torchrun --nproc-per-node {n} -m {module} ...")
