"""Counters of one process's step: its operations, the bytes its ops
touch, its collectives' bytes and the peak of its live memory.

:class:`Counters` is one ``TorchDispatchMode`` that works the same on
``meta``, CPU and CUDA tensors, so that the dry-run stand-in
(``launch.dryrun``, one mesh position on ``meta``), a real process on the
CPU (the tests) and a process on the card (``chip_smoke.py``) measure a
step with the same code::

    with Counters(args=(state, batch)) as c:
        out = step(state, batch)
    rec = c.record(out)

What it counts, for the ops of the calling thread and of the autograd
threads it starts:

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  aten ops, plus the analytic operations of every hand-written kernel call
  (each wrapper reports them through ``kernels._build.note_work`` where it
  launches, and on ``meta`` where it stands in for the launch);
* ``bytes_accessed``: the bytes of every aten op's tensor inputs and
  outputs (views and bare allocations move none), plus each kernel call's
  analytic bytes.  The eager port fuses nothing, so this is what its ops
  read and write in device memory, not XLA's post-fusion estimate;
* ``collective_bytes``: per c10d op, the bytes of the tensors of its first
  argument (its result on this process: an all-gather's gathered output,
  an all-reduce's tensors, a reduce-scatter's output shard, a ``recv``'s
  buffer), under the reference's kind (``KINDS``; a pipeline stage's
  ``recv`` is a ``collective-permute``, the reference's per-device
  result-shape count of its ``ppermute``), an op of another kind under its
  own c10d name, and ``total``.  A ``send`` counts nothing: its bytes are
  its receiver's result, so a transfer counts once, where it lands.  They
  count in neither of the two above, and neither does a backend's copy
  into a collective's result as it completes (gloo's reduce-scatter copies
  its output out in ``wait``; ``fake`` and NCCL make none);
* the live storage bytes on the step's device (the first argument
  tensor's): every storage there that an op returns and
  none of its inputs holds (a tensor constructor's fresh result
  included) is live from then until it is freed; the arguments' are live
  throughout (the caller keeps them, as the launchers' loops do).
  ``peak_bytes`` is the most that was live after any op.  A host tensor
  that a step copies to the card is the card's only once copied, as on
  ``meta``.

:meth:`Counters.record` adds ``output_bytes``: the bytes of the result's
storages that no argument holds.
"""

from __future__ import annotations

import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _build

#: the reference's collective kinds (``repro.launch.dryrun.collective_bytes``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "recv_": "collective-permute",
}
#: c10d ops whose bytes are another process's result (module docstring)
_UNCOUNTED = frozenset({"send"})
#: ops that allocate and touch nothing
_BARE = frozenset({"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like"})


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storages(tree) -> dict:
    """{storage key: bytes} of the tensors of ``tree``, each storage once."""
    return {_key(t): t.untyped_storage().nbytes() for t in _tensors(tree)}


class Counters(TorchDispatchMode):
    """The counters of the module docstring over the ops run inside the
    ``with`` block; ``args`` are the step's arguments.  ``allocated`` sums
    the bytes of every storage the block made, freed or not."""

    def __init__(self, args=()):
        super().__init__()
        first = _tensors(args)
        self.device = first[0].device if first else None
        self._flops = FlopCounterMode(display=False)
        self._lock = threading.RLock()
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernel_calls: dict = {}
        self.op_bytes = 0
        self.collective: dict = dict.fromkeys(KINDS, 0)
        self.args = storages(args)
        self.held = sum(self.args.values())
        self.live = self.held
        self.peak = self.held
        self.allocated = 0
        self._refs: dict = {}
        # storages of the last collective's results, until another op
        self._landing: set = set()

    def __enter__(self):
        self._flops.__enter__()
        _build.WORK_LISTENERS.append(self._work)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _build.WORK_LISTENERS.remove(self._work)
            self._flops.__exit__(*exc)

    def _work(self, name: str, flops: float, nbytes: float) -> None:
        with self._lock:
            self.kernel_flops += flops
            self.kernel_bytes += nbytes
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def _free(self, key: int) -> None:
        with self._lock:
            entry = self._refs.pop(key, None)
            if entry is not None:
                self.live -= entry[0]

    def _track(self, outs, ins) -> None:
        seen = {_key(t) for t in ins}
        with self._lock:
            for t in outs:
                if self.device is not None and t.device != self.device:
                    continue
                st = t.untyped_storage()
                key = st._cdata
                if key in seen or key in self.args or key in self._refs:
                    continue
                n = st.nbytes()
                self._refs[key] = (n, weakref.ref(st, lambda _, k=key: self._free(k)))
                self.live += n
                self.allocated += n
                seen.add(key)
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func._schema.name
        if name.startswith("c10d::"):
            op = name[len("c10d::"):]
            if op not in _UNCOUNTED:
                kind = _C10D_KINDS.get(op, op)
                nbytes = sum(t.nbytes for t in _tensors(args[0] if args else ()))
                with self._lock:
                    self.collective[kind] = self.collective.get(kind, 0) + nbytes
            self._landing = {_key(t) for t in _tensors(args[0] if args else ())}
        elif not func.is_view and func.overloadpacket.__name__ not in _BARE:
            if not (func is torch.ops.aten.copy_.default and _key(args[0]) in self._landing):
                nbytes = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs)
                with self._lock:
                    self.op_bytes += nbytes
                self._landing = set()
        # a constructor's tensor reaches dispatch first as lift_fresh's input
        self._track(outs, () if func is torch.ops.aten.lift_fresh.default else ins)
        return out

    @property
    def flops(self) -> float:
        return float(self._flops.get_total_flops() + self.kernel_flops)

    @property
    def bytes_accessed(self) -> float:
        return float(self.op_bytes + self.kernel_bytes)

    def collective_bytes(self) -> dict:
        out = {k: float(v) for k, v in self.collective.items()}
        out["total"] = sum(out.values())
        return out

    def record(self, outputs) -> dict:
        """The counts of the block, with ``output_bytes`` of ``outputs``."""
        outs = storages(outputs)
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": self.collective_bytes(),
                "output_bytes": sum(n for k, n in outs.items() if k not in self.args),
                "held_bytes": self.held, "peak_bytes": self.peak,
                "kernel_calls": dict(self.kernel_calls)}
