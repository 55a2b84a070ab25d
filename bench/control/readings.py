"""The readings a cell's correctness limit is set from, on the chip.

    python3 bench/control/readings.py --workload <cell> --seeds 12 [--first 7000001]
        [--seconds 51] [--control-seeds 3] [--out readings.json]

Runs the cell as ``bench/run.py`` does (``harness.cell.run``: its set-up,
window, sample and comparison), once a seed, in one process.  The
program's reading is the widest gap the run compares; on the first
``--control-seeds`` seeds the control's is read too: the same requests at
the same positions, judged with the reference computed at TF32 in the
program's place.  Prints one JSON line a seed, then the lower reading
(the program's largest) and the upper one (the control's smallest).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=7_000_001)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from bench.harness import cell, manifest

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    spec = manifest.cell(manifest.load(), args.workload)
    buf, rows = None, []
    for k in range(args.seeds):
        seed = args.first + 7919 * k
        t = time.monotonic()
        out = cell.run(spec, seed=seed, seconds=args.seconds, traced=False, device=device,
                       t_start=t, control=k < args.control_seeds, weights_buffer=buf)
        buf = out.pop("buffer")
        got = out["readings"]
        row = {"seed": seed, "correct": out["correct"],
               "program": out["compared"]["max_logit_gap"]["value"],
               "control": max(got["control"]) if "control" in got else None,
               "requests": out["compared"]["requests_checked"]["value"],
               "tokens": got["tokens"], "control_flips": got.get("control_flips"),
               "program_each": got["program"], "control_each": got.get("control"),
               "check_s": got["check_s"], "metrics": out["metrics"],
               "seconds": time.monotonic() - t}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    uppers = [r["control"] for r in rows if r["control"] is not None]
    summary = {"workload": args.workload, "lower": max(r["program"] for r in rows),
               "upper": min(uppers) if uppers else None, "seeds": len(rows),
               "kind": torch.cuda.get_device_name(device)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"summary": summary, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
