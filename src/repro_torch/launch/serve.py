"""Serving launcher, static engine: one fixed batch through chunked
prefill and greedy decode (PyTorch port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3_0p6b --prompt 2048

runs on the CUDA card by default; ``--device cpu`` runs the same path on
the CPU with the kernels' plain versions.  Weights and prompts are random,
made from fixed seeds.  It prints the prefill time and decode tok/s next to
the device name.  Options of the JAX launcher that belong to later slices
of the port exit with the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.models import transformer as tf
from repro_torch.serve.step import make_prefill_step, make_serve_step

# option -> (value that means "unset", the ROADMAP.md item that ports it)
_UNPORTED = {
    "engine": ("static", "queue 1, items 5-6 (paged KV cache, ServingEngine)"),
    "page_size": (None, "queue 1, items 5-6 (paged KV cache)"),
    "kv_dtype": ("f32", "queue 1, item 7 (int8 serving)"),
    "prefix_cache": (False, "queue 1, item 6 (ServingEngine prefix cache)"),
    "draft": (None, "queue 1, item 6 (speculative decoding)"),
    "prefill_budget": (None, "queue 1, item 6 (SLO scheduler)"),
    "slo_ms": (None, "queue 1, item 6 (SLO scheduler)"),
    "priority": (None, "queue 1, item 6 (SLO scheduler)"),
    "supervise": (False, "queue 1, item 10 (serving supervisor)"),
    "fault_plan": (None, "queue 1, item 10 (serving supervisor)"),
    "deadline_ms": (None, "queue 1, item 10 (serving supervisor)"),
    "autotune": (False, "queue 1, item 13 (measurement and tuning)"),
    "tuning_file": (None, "queue 1, item 13 (measurement and tuning)"),
    "strategy": ("fused", "queue 1, item 12 (distributed runtime)"),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_static(params, cfg, prompts, *, new_tokens: int, chunk: int,
               return_logits: bool = False):
    """Prefill ``prompts`` (B, S) in chunks of ``chunk``, then decode
    ``new_tokens - 1`` greedy steps.  Returns a dict with ``tokens``
    (B, new_tokens), ``prefill_s``, ``decode_s`` (host clock around work
    that ends in a device sync) and, with ``return_logits``, ``logits``:
    the prefill head then every decode step's, each (B, V).  The caches
    take the params' dtype and hold the right-padded final chunk."""
    device = prompts.device
    b, s = prompts.shape
    max_len = -(-s // chunk) * chunk + new_tokens
    caches = tf.init_caches(cfg, b, max_len, params["embed"]["table"].dtype, device)
    prefill = make_prefill_step(cfg, chunk, return_logits=return_logits)
    decode = make_serve_step(cfg, return_logits=return_logits)
    logits = []

    _sync(device)
    t0 = time.perf_counter()
    res = prefill(params, prompts, caches)
    tok, caches = res[0][:, None], res[-1]
    if return_logits:
        logits.append(res[1][:, -1])
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        res = decode(params, out[-1], caches)
        out.append(res[0])
        caches = res[-1]
        if return_logits:
            logits.append(res[1][:, -1])
    _sync(device)
    decode_s = time.perf_counter() - t0
    result = {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
              "decode_s": decode_s}
    if return_logits:
        result["logits"] = logits
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0p6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; the CPU runs only when asked")
    # options of the JAX launcher that later slices of the port bring
    ap.add_argument("--strategy", default="fused")
    ap.add_argument("--engine", choices=["static", "paged"], default="static")
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--tuning-file", default=None)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--kv-dtype", choices=["f32", "bf16", "int8"], default="f32")
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--draft", default=None)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--prefill-budget", type=int, default=None)
    ap.add_argument("--slo-ms", type=float, default=None)
    ap.add_argument("--priority", default=None)
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("--fault-plan", default=None)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=None)
    args = ap.parse_args(argv)

    for name, (unset, item) in _UNPORTED.items():
        if getattr(args, name) != unset:
            raise SystemExit(f"--{name.replace('_', '-')} is not ported yet: "
                             f"ROADMAP.md {item}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {args.device}")
    # f32 matmuls in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down()
    tf.check_supported(cfg)
    # random weights from seed 0 and prompts from seed 1, as the reference
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init(cfg, generator=gen, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                            generator=gen, device=device)
    res = run_static(params, cfg, prompts, new_tokens=args.new_tokens,
                     chunk=max(16, args.prompt // 4))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"prefill {args.batch}x{args.prompt} in {res['prefill_s'] * 1e3:.1f} ms "
          f"on {name}")
    steps = args.new_tokens - 1
    rate = args.batch * steps / res["decode_s"] if steps else 0.0
    print(f"decode {steps} steps: {rate:.1f} tok/s on {name}")
    return res


if __name__ == "__main__":
    main()
