"""Atomic checkpoints of a port state: per-leaf ``.npy`` files + a JSON
manifest (PyTorch port of ``repro.ft.checkpoint``).

* **Atomicity**: writes go to ``<dir>.tmp`` and are renamed into place —
  a crash mid-save never corrupts the latest checkpoint.
* **Async**: ``AsyncCheckpointer`` snapshots to host memory on the
  caller's thread (a device-to-host copy of every leaf), then serializes
  on a background thread so training never blocks on the filesystem.
* **Rotation**: keeps the newest ``keep`` checkpoints; only integer
  ``step_N`` suffixes count, so a torn ``step_N.tmp`` is never a
  checkpoint.

A state is a nested tree (``repro_torch.tree``: dicts, lists, tuples and
named tuples such as ``optim.adamw.OptState``) with tensors at the
leaves.  Each leaf is stored under the path of its keys joined by ``__``
(``params__blocks__0__mixer__wq__w``).  numpy has
no bfloat16, so a bf16 tensor is stored as its ``uint16`` bits with the
logical dtype in the manifest (the reference stores ml_dtypes' bits the
same way).  ``restore`` puts every leaf back on the device of the
matching leaf of ``like`` (or on ``device``), in the manifest's dtype.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, leaves, unflatten


def _leaf_name(path) -> str:
    return "__".join(str(p) for p in path) or "root"


def _to_host(leaf):
    """A host copy of one leaf, never a view of device or live memory."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


#: test/fault-injection hook: called as ``hook(leaf_index, leaf_name)``
#: after each leaf file lands in the .tmp dir.  Raising from it
#: simulates the process dying mid-write — the torn .tmp stays behind
#: and the rename into place never happens (exactly the crash the
#: atomic-rename design defends against).  See ft/faults.py.
_write_fault = None


def set_write_fault(hook) -> None:
    """Install (or clear, with None) the per-leaf write fault hook."""
    global _write_fault
    _write_fault = hook


def _snapshot(state):
    """The state with every leaf copied to host memory."""
    return unflatten(state, [_to_host(leaf) for leaf in leaves(state)])


def save(directory: str, state, step: int | None = None) -> str:
    """Synchronous atomic checkpoint save.  Returns the final path."""
    return _write(directory, _snapshot(state), step)


def _write(directory: str, host_state, step) -> str:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "format": 1, "time": time.time()}
    for i, (path, leaf) in enumerate(flatten_with_path(host_state)):
        name = _leaf_name(path)
        if isinstance(leaf, torch.Tensor):
            logical = str(leaf.dtype).removeprefix("torch.")
            if leaf.dtype == torch.bfloat16:
                # np.load can't hold bf16 — store the bit pattern and
                # record the logical dtype in the manifest
                arr = leaf.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = leaf.numpy()
        else:
            arr = np.asarray(leaf)
            logical = str(arr.dtype)
        np.save(os.path.join(tmp, name + ".npy"), arr, allow_pickle=False)
        if _write_fault is not None:
            _write_fault(i, name)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": logical})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)
    return directory


def restore(directory: str, like, device=None):
    """Restore into the structure of ``like`` (a tree of tensors).  Each
    leaf lands on ``device`` when given, else on the device of the
    matching leaf of ``like`` (CPU for a non-tensor leaf)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    out = []
    for path, ref in flatten_with_path(like):
        name = _leaf_name(path)
        arr = np.load(os.path.join(directory, name + ".npy"), allow_pickle=False)
        t = torch.from_numpy(arr)
        if dtypes.get(name) == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return unflatten(like, out)


def _step_dirs(root: str) -> dict[int, str]:
    """Complete ``step_N`` checkpoint dirs under ``root`` as {N: name}.

    Only integer suffixes count: a torn ``step_12.tmp`` left by a crash
    (which can contain a manifest if the crash hit between the manifest
    write and the rename) must never parse as ``int("12.tmp")``, and
    stray files/dirs are ignored rather than crashing the scan.
    """
    out: dict[int, str] = {}
    if not os.path.isdir(root):
        return out
    for d in os.listdir(root):
        if not d.startswith("step_"):
            continue
        suffix = d.split("_", 1)[1]
        if not suffix.isdigit():
            continue
        if os.path.isfile(os.path.join(root, d, "manifest.json")):
            out[int(suffix)] = d
    return out


def sweep_tmp(root: str) -> list[str]:
    """Remove orphaned ``*.tmp`` dirs (torn writes from a crashed saver);
    returns the names removed.  Safe to call any time — a live writer
    never shares a root with another writer by construction (one
    AsyncCheckpointer per job)."""
    removed = []
    if not os.path.isdir(root):
        return removed
    for d in os.listdir(root):
        p = os.path.join(root, d)
        if d.endswith(".tmp") and os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
            removed.append(d)
    return removed


def latest_step(root: str) -> int | None:
    """Scan ``root`` for step_N checkpoint dirs; return max N or None."""
    steps = _step_dirs(root)
    return max(steps) if steps else None


class AsyncCheckpointer:
    """Double-buffered background checkpointing with rotation.

    save() blocks only for the device->host snapshot; serialization
    happens on the worker thread.  wait() joins the in-flight write
    (call before process exit / before restoring).
    """

    def __init__(self, root: str, keep: int = 2):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(root, exist_ok=True)
        # a previous incarnation may have died mid-write: torn .tmp dirs
        # are garbage (the rename never happened), reclaim the disk
        self.swept = sweep_tmp(root)

    def save(self, state, step: int) -> None:
        host_state = _snapshot(state)  # synchronous snapshot
        self.wait()  # at most one write in flight; raises a prior failure

        def work():
            try:
                _write(os.path.join(self.root, f"step_{step}"), host_state, step)
                self._rotate()
            except BaseException as e:  # surfaced on the next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write.  A background-thread failure is
        re-raised HERE (and from the next ``save``, which waits first) —
        a failed write must not masquerade as a successful save while
        rotation silently stops."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            try:
                raise err
            finally:
                del err  # the traceback holds this frame: no cycle through it

    def _rotate(self) -> None:
        for s in sorted(_step_dirs(self.root))[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s}"), ignore_errors=True)

    def restore_latest(self, like, device=None):
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None, None
        state = restore(os.path.join(self.root, f"step_{step}"), like, device)
        return state, step
