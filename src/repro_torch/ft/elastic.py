"""Elastic rescale + failure recovery (the port of ``repro.ft.elastic``).

The recovery contract at pod scale:

  1. a node fails / the pod is resized,
  2. the launcher reforms the mesh from the devices that remain
     (``make_mesh_for(devices)``),
  3. ``rescale(ckpt_dir, like, new_mesh)`` restores the latest
     checkpoint placed onto the new mesh (checkpoints store FULL arrays,
     so any old-topology -> new-topology move is a placement),
  4. training resumes; the batch schedule recomputes from the restored
     step, so sample order is preserved modulo the resize.

The same path handles *scale-up* (new nodes join) — reconfigurability
is the paper's whole point, applied to fault tolerance.  Where the
reference returns ``NamedSharding``s, :func:`state_shardings` returns the
spec tree that ``dist.sharding.place`` takes.
"""

from __future__ import annotations

import numpy as np

from repro_torch.dist.sharding import Mesh, param_specs, place
from repro_torch.ft import checkpoint as ckpt
from repro_torch.launch.mesh import cuda_devices
from repro_torch.optim.adamw import OptState


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


def state_shardings(state_like, mesh, strategy: str = "fused"):
    """Spec tree of a train state: ``param_specs`` for the params and both
    moments, ``()`` (replicated) for the step counters."""
    pspecs = param_specs(state_like["params"], mesh, strategy)
    return {"params": pspecs, "opt": OptState(mu=pspecs, nu=pspecs, step=()), "step": ()}


def rescale(ckpt_dir: str, state_like, new_mesh, strategy: str = "fused"):
    """Restore a checkpoint placed for ``new_mesh``.  ``state_like`` gives
    the structure only (``meta`` tensors will do): the leaves are read
    onto the mesh's first device, then placed per :func:`state_shardings`."""
    state = ckpt.restore(ckpt_dir, state_like, device=new_mesh.distinct_devices()[0])
    return place(state, state_shardings(state, new_mesh, strategy), new_mesh)
