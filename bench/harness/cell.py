"""One run of one cell: set-up, the measured window, the metrics its
entries name, and the check that decides ``correct``.

``correct`` compares what the window served.  Once the window has closed
and the peak memory is read, the engine is freed, a sample of the
requests finished in the window is drawn from the seed (the one served
the most tokens first), and the plain reference runs once over each
prompt and its served tokens.  The number compared is the widest gap by
which a served token's logit lies below the reference's best at its
position; the cell's file (``cells/<name>.json``) gives its limit.  With
``control`` the same requests at the same positions are judged again
with the reference computed at TF32 in the program's place: the reading
that a limit's upper end is set from (``control/readings.py``).
"""

from __future__ import annotations

import sys
import time

import torch

from bench.harness import manifest, model, serve
from bench.harness.readings import Run


def reader(name: str, bench=manifest.BENCH):
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return model.load_module(bench / "metrics" / f"{name}.py", f"bench_metric_{name}")


def run(spec: dict, *, seed: int, seconds: float, traced: bool, device, t_start: float,
        control: bool = False, weights_buffer=None) -> dict:
    """The result of one run of cell ``spec`` (``manifest.cell``): the
    keys of the result line, ``compared`` last; besides, ``readings`` (the
    gaps, and with ``control`` the control's) and the weights' ``buffer``,
    which a further run in the process may draw into again."""
    c, mix = spec["c"], spec["mix"]
    cell = serve.Cell(c, mix, seed, device, weights_buffer, traced=traced)
    setup_s = time.monotonic() - t_start
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in cell.phases.items())
          + f" total {setup_s:.3f}", file=sys.stderr)
    win = cell.measure(seconds, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    records = cell.loop.records
    out = Run(c, mix, records, win, setup_s)
    metrics = {}
    for m in spec["per_layer"] if traced else spec["end_to_end"]:
        value = reader(m["name"], spec.get("bench", manifest.BENCH)).read(out)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"attempted": 0, "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = win.trace.busy_s, win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.top_ops(), "idle_gaps": win.trace.top_gaps()}
    live = [r for r in records if r.t_sent <= win.t1 and (not r.times or r.times[-1] >= win.t0)]
    refused = sum(win.stats1[k] - win.stats0[k] for k in ("rejected", "cancelled"))
    finished = serve.finished_in(records, win.t0, win.t1)
    check = mix["check"]
    picked = serve.sample(finished, seed, int(check["served_tokens"]), int(check["max_requests"]))
    cell.release_engine()
    t_check = time.monotonic()
    gaps = [serve.logit_gaps(cell.ref, c, cell.weights, r, device) for r in picked]
    tokens = sum(len(g) for g in gaps)
    print(f"check {time.monotonic() - t_check:.3f} s over {len(picked)} requests, "
          f"{tokens} served tokens", file=sys.stderr)
    result["readings"] = {"program": [float(g.max()) for g in gaps], "tokens": tokens,
                          "check_s": time.monotonic() - t_check}
    if control:
        low = [serve.logit_gaps(cell.ref, c, cell.weights, r, device, control=True)
               for r in picked]
        result["readings"]["control"] = [float(g.max()) for g in low]
        result["readings"]["control_flips"] = int(sum((g > 0).sum() for g in low))
    result["buffer"] = cell.buffer
    limit = float(spec["limits"]["max_logit_gap"]["limit"])
    widest = max((float(g.max()) for g in gaps), default=float("inf"))
    over = sum(1 for g in gaps if g.max() > limit)
    short = sum(1 for r in finished if len(r.req.tokens) != r.item.max_new)  # an early stop
    result["attempted"] = len(live)
    result["failed"] = int(refused + over + short)
    result["correct"] = bool(picked) and widest <= limit and result["failed"] == 0
    result["compared"] = {
        "max_logit_gap": {"value": widest, "limit": limit},
        "requests_checked": {"value": len(picked), "limit": 1},
        "failed_requests": {"value": int(refused + over + short), "limit": 0},
    }
    return result


def ordered(result: dict) -> dict:
    """The result line's keys in order, ``compared`` last."""
    keys = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"]
    return {k: result[k] for k in keys if k in result}
