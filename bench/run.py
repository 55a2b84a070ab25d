"""The benchmark of the PyTorch / CUDA port: one run of one cell.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, sets it up (weights from the
seed, documents, warm-up), measures for ``--seconds``, checks what the
window served against the plain reference, and prints the result as the
last line of standard output: the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``.  It needs a CUDA
device; without one, or without as many as the cell asks for, it exits
non-zero and prints no result.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the run lives at a fixed place in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.harness import cell, manifest

    spec = manifest.cell(manifest.load(), args.workload)
    need = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {need} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = cell.run(spec, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                      device=device, t_start=T_START)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"bench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, row in result["compared"].items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(cell.ordered(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
