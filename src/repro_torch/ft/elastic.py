"""Elastic meshes (the port of ``repro.ft.elastic``, its
:func:`make_mesh_for`).

After a node fails or the pod is resized, the launcher reforms the mesh
from the devices that remain.  The reference's ``state_shardings`` and
``rescale`` (restore a checkpoint onto the new mesh) come with the
training supervisor.
"""

from __future__ import annotations

import numpy as np

from repro_torch.dist.sharding import Mesh
from repro_torch.launch.mesh import cuda_devices


def make_mesh_for(devices=None, model_axis: int | None = None) -> Mesh:
    """Form a (data, model) mesh from whatever devices survive (default:
    the CUDA devices torch sees).  A device listed ``n`` times fills ``n``
    mesh positions."""
    devices = list(devices if devices is not None else cuda_devices())
    n = len(devices)
    if not n:
        raise ValueError("no devices to form a mesh from")
    if model_axis is None:
        # largest power-of-two model axis <= sqrt(n)
        model_axis = 1
        while model_axis * 2 <= int(n ** 0.5):
            model_axis *= 2
    data_axis = n // model_axis
    devs = np.asarray(devices[: data_axis * model_axis], dtype=object)
    return Mesh(devs.reshape(data_axis, model_axis), ("data", "model"))
