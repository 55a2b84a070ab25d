"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` entry points and is
compiled on first use by ``nvcc`` into ``build/kernels/lib<name>-<hash>.so``
at the root of the checkout (listed in ``.gitignore``), then loaded with
``ctypes``.  The file name carries a hash of the source and the flags, so
an edited kernel is rebuilt and a stale library is never loaded.  A
failed build raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention", "decode_attention", "paged_decode_attention", "vta_gemm",
           "vta_alu")

_LIBS: dict[str, ctypes.CDLL] = {}
_SMS: dict[int, int] = {}
#: SMs of an NVIDIA H100 SXM: what a wrapper plans with on a ``meta`` tensor,
#: the card the dry-run stand-in predicts
H100_SMS = 132
#: listeners of the kernels' analytic work (``launch.counters``), each called
#: as ``fn(name, flops, nbytes)`` (:func:`note_work`)
WORK_LISTENERS: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start one nvcc process for ``name``; returns (popen, tmp, target) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every kernel source at once, one nvcc per source, all
    started together, and wait for all of them.  Returns each build's
    compiler output (the ptxas register and spill report); empty for a
    library already built.  Raises if any build failed."""
    started = {n: _start(n) for n in names}
    reports, failures = {}, []
    for name, job in started.items():
        if job is None:
            reports[name] = ""
            continue
        proc, tmp, target = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
        reports[name] = out
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return lib


def sm_count(device) -> int:
    """The number of SMs of CUDA ``device`` (a ``torch.device``), looked up
    once per device; an H100's for ``meta``."""
    import torch

    if device.type == "meta":
        return H100_SMS
    idx = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return sms


def check_rows4(what: str, *tensors) -> None:
    """The kernels read and write rows as groups of 4 elements: the last
    dimension must be contiguous and a multiple of 4, and every other
    stride (of a dimension longer than 1) and the data pointer 4-element
    aligned."""
    for x in tensors:
        if (x.stride(-1) != 1 or x.shape[-1] % 4
                or any(st % 4 for st, n in zip(x.stride()[:-1], x.shape[:-1]) if n > 1)
                or x.data_ptr() % (4 * x.element_size())):
            raise ValueError(f"{what}: the kernel takes tensors whose last dimension "
                             f"is contiguous and a multiple of 4, with 4-element "
                             f"aligned strides and data; got shape {tuple(x.shape)}, "
                             f"strides {x.stride()}")


class KernelLaunchError(RuntimeError):
    """A kernel's entry point returned a CUDA error at its launch.  Its own
    class, so that a caller that recovers from other errors (the serving
    supervisor) can let it through."""


def check(rc: int, what: str, error_string) -> None:
    """Raise :class:`KernelLaunchError` on a non-zero ``cudaError_t``
    returned by an entry point; ``error_string`` is the library's
    ``cudaGetErrorString``."""
    if rc != 0:
        msg = error_string(rc).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {rc} at launch ({msg})")


def refuse_grad(what: str, *tensors) -> None:
    """Raise a ``ValueError`` when grad is enabled and an input requires
    it: the kernel writes its output through a raw pointer, so PyTorch
    would see no path back to its inputs and a gradient would be silently
    zero.  Only flash has a differentiable route (its autograd Function)."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in tensors):
        raise ValueError(f"{what}: the kernel has no backward; call it under "
                         f"torch.no_grad() or on tensors that do not require grad")


def note_work(name: str, flops: float, nbytes: float) -> None:
    """Tell every listener (:data:`WORK_LISTENERS`) the analytic operations
    and bytes of one call of kernel ``name``: where its wrapper launches it,
    and where a ``meta`` tensor stands in for the launch."""
    for fn in WORK_LISTENERS:
        fn(name, flops, nbytes)
