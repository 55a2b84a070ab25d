#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each kernel against its plain PyTorch version at the serving
path's shapes, drives the static serving path of
``repro_torch.launch.serve`` at the full width of qwen3_0p6b (f32, random
weights from a seed, batch 4, prompt 2048 in four 512-token prefill
chunks, 32 new tokens), checks that every attention call of that run went
through the kernels, compares its logits with a teacher-forced reference
run on the card, and times each kernel beside its plain version, a
PyTorch library call computing the same function, and its bound.

It imports no JAX and nothing of the JAX package.  It exits non-zero
without a result when torch sees no CUDA device, when the repository's
sources are missing, or when any phase fails.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit from nvidia-smi, and the one before that the per-kernel
JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): the main path is f32 and must
# not use TF32, so f32 work is bounded by the SIMT f32 rate
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# kernel vs plain version on the same card and inputs:
#   f32  — both sum in f32, in another order (32-key tiles / per-warp
#          partials vs whole chunks); errors are ~1e-6 of |out| <= ~4
#   bf16 — both round the output to bf16 (ulp 2**-6 at |x| < 4) and the
#          kernel also rounds P to bf16 before the PV product
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# teacher-forced logits, kernel run vs reference run: 28 f32 layers
# amplify the ~1e-6 attention differences; logits are ~0.6 in scale
LOGIT_TOL = 1e-3

ARCH, BATCH, PROMPT, NEW_TOKENS = "qwen3_0p6b", 4, 2048, 32
CHUNK = max(16, PROMPT // 4)  # the launcher's chunk rule: 512
EXPECT_FLASH = 28 * (PROMPT // CHUNK)   # 112
EXPECT_DECODE = 28 * (NEW_TOKENS - 1)   # 868


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (exit status 1, no result line) when ``ok`` is false."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(b, s, h, hkv, d, dv, q_offset, kv_len, esize):
    """Operations and bytes one causal flash call needs: every visible
    (query, key) pair costs 2*D + 2*Dv; q and the live K/V are read once,
    the output written once."""
    pairs = sum(min(q_offset + i + 1, kv_len) for i in range(s))
    flops = b * h * pairs * 2 * (d + dv)
    nbytes = esize * (b * s * h * d + b * kv_len * hkv * (d + dv) + b * s * h * dv)
    return flops, nbytes


def decode_work(b, h, hkv, d, dv, kv_len, esize):
    flops = b * h * kv_len * 2 * (d + dv)
    nbytes = esize * (b * h * d + b * kv_len * hkv * (d + dv) + b * h * dv)
    return flops, nbytes


def device_breakdown(torch, fn, top: int = 6):
    """Profile one call of ``fn`` (ending in a device sync): wall seconds,
    seconds of device kernel time, and the ``top`` kernels by device time
    as (name, microseconds, calls).  Wall time includes the profiler's own
    host overhead."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows) / 1e6, rows[:top]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref, decode_partition_counts,
        decode_partition_map)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref, flash_tile_counts, flash_tile_map)
    from repro_torch.launch.serve import run_static
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
        f"nvidia-smi: {smi}; devices {torch.cuda.device_count()}")

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"[build] {len(reports)} kernels with nvcc in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # ---- kernel parity: kernel vs plain version ---------------------------
    b, s, h, hkv, d, t = BATCH, CHUNK, 16, 8, 128, PROMPT + NEW_TOKENS
    flash_cases = []
    for dt in ("float32", "bfloat16"):
        for q_off in (0, PROMPT - CHUNK):
            flash_cases.append((f"main q_offset={q_off} {dt}",
                                dict(b=b, s=s, h=h, hkv=hkv, d=d, dv=d, t=t),
                                dict(q_offset=q_off, kv_len=q_off + s), dt))
    flash_cases.append(("window=256 q_offset=1536 float32",
                        dict(b=b, s=s, h=h, hkv=hkv, d=d, dv=d, t=t),
                        dict(q_offset=1536, kv_len=2048, window=256), "float32"))
    flash_cases.append(("odd b2 s100 t130 h6 hkv2 d24 dv8 float32",
                        dict(b=2, s=100, h=6, hkv=2, d=24, dv=8, t=130),
                        dict(q_offset=3, kv_len=101), "float32"))
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for name, sh, opts, dt in flash_cases:
        dtype = getattr(torch, dt)
        q = randn(sh["b"], sh["s"], sh["h"], sh["d"], dtype=dtype)
        k = randn(sh["b"], sh["t"], sh["hkv"], sh["d"], dtype=dtype)
        v = randn(sh["b"], sh["t"], sh["hkv"], sh["dv"], dtype=dtype)
        got, counts = flash_attention(q, k, v, return_counts=True, **opts)
        want = flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.isfinite(got).all(), f"flash {name}: non-finite output")
        check(err <= TOL[dt], f"flash {name}: max|err| {err} > {TOL[dt]}")
        tile_map = flash_tile_map(sh["s"], sh["t"], **opts).to(dev)
        check(torch.equal(counts, tile_map.expand_as(counts)), f"flash map {name}")
        executed, total = flash_tile_counts(sh["s"], sh["t"], **opts)
        check(int(counts[0, 0].sum()) == executed and counts[0, 0].numel() == total,
              f"flash {name}: tile count vs flash_tile_counts")
        if dt == "float32":
            errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"[parity] flash {name}: max|err| {err:.3e} (tol {TOL[dt]}), "
            f"map == flash_tile_counts ({executed}/{total} tiles)")

    decode_cases = [(n, "float32") for n in (1, 511, 512, 513, t)] + [(t, "bfloat16")]
    for kv_len, dt in decode_cases:
        dtype = getattr(torch, dt)
        q = randn(b, 1, h, d, dtype=dtype)
        k = randn(b, t, hkv, d, dtype=dtype)
        v = randn(b, t, hkv, d, dtype=dtype)
        got, counts = decode_attention(q, k, v, kv_len=kv_len, return_counts=True)
        want = decode_attention_ref(q, k, v, kv_len=kv_len)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.isfinite(got).all(), f"decode kv_len={kv_len} {dt}: non-finite output")
        check(err <= TOL[dt], f"decode kv_len={kv_len} {dt}: max|err| {err}")
        pmap = decode_partition_map(t, kv_len).to(dev)
        check(torch.equal(counts, pmap.expand_as(counts)), f"decode map {kv_len}")
        executed, total = decode_partition_counts(t, kv_len)
        check(int(counts[0, 0].sum()) == executed and counts[0, 0].numel() == total,
              f"decode kv_len={kv_len}: partition count vs decode_partition_counts")
        if dt == "float32":
            errs["decode_attention"] = max(errs["decode_attention"], err)
        log(f"[parity] decode kv_len={kv_len} {dt}: max|err| {err:.3e} "
            f"(tol {TOL[dt]}), map == decode_partition_counts "
            f"({executed}/{total} partitions)")

    # ---- the main path -----------------------------------------------------
    cfg = get_config(ARCH)
    wgen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = tf.init(cfg, generator=wgen, dtype=torch.float32, device=dev)
    pgen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=pgen, device=dev)
    torch.cuda.synchronize()
    log(f"[main] {ARCH} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}) f32 params made in {time.perf_counter() - t0:.2f} s")

    check(layers.attention_impl() == "auto", "the main path runs with attention impl auto")
    flash_attention.launches = 0
    decode_attention.launches = 0
    res = run_static(params, cfg, prompts, new_tokens=NEW_TOKENS, chunk=CHUNK,
                     return_logits=True)
    n_flash, n_decode = flash_attention.launches, decode_attention.launches
    log(f"[main] launches: flash_attention {n_flash} (expect {EXPECT_FLASH}), "
        f"decode_attention {n_decode} (expect {EXPECT_DECODE})")
    check(n_flash == EXPECT_FLASH and n_decode == EXPECT_DECODE,
          "the main path's attention calls all went through the kernels")
    tokens = res["tokens"]
    check(tokens.shape == (BATCH, NEW_TOKENS), f"token shape {tuple(tokens.shape)}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab, "token ids in the vocabulary")
    logits = torch.stack(res["logits"], dim=1)  # (B, NEW_TOKENS, V)
    check(logits.shape == (BATCH, NEW_TOKENS, cfg.vocab), f"logit shape {tuple(logits.shape)}")
    check(torch.isfinite(logits).all(), "finite logits")
    log(f"[main] first run: prefill {res['prefill_s'] * 1e3:.1f} ms, "
        f"decode {res['decode_s'] * 1e3:.1f} ms (includes warm-up)")

    # ---- teacher-forced reference run on the card ----------------------------
    prev = layers.set_attention_impl("ref")
    try:
        caches = tf.init_caches(cfg, BATCH, PROMPT + NEW_TOKENS, torch.float32, dev)
        with torch.inference_mode():
            _, lg, caches = make_prefill_step(cfg, CHUNK, return_logits=True)(
                params, prompts, caches)
            ref = [lg[:, -1]]
            step = make_serve_step(cfg, return_logits=True)
            for i in range(NEW_TOKENS - 1):
                _, lg, caches = step(params, tokens[:, i:i + 1], caches)
                ref.append(lg[:, -1])
    finally:
        layers.set_attention_impl(prev)
    check((flash_attention.launches, decode_attention.launches) == (n_flash, n_decode),
          "the reference run launched no kernel")
    ref = torch.stack(ref, dim=1)
    logit_err = (logits - ref).abs().max().item()
    log(f"[main] teacher-forced logits vs reference run: max|err| {logit_err:.3e} "
        f"(tol {LOGIT_TOL}), |logits| max {logits.abs().max().item():.3f}")
    check(logit_err <= LOGIT_TOL, f"logits vs the reference run: {logit_err} > {LOGIT_TOL}")
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = tokens == ref.argmax(-1)
    decided = margin > LOGIT_TOL
    check(bool(agree[decided].all()), "greedy token differs where the margin is clear")
    log(f"[main] greedy tokens equal to the reference's at {int(agree.sum())}/"
        f"{agree.numel()} positions; {int(decided.sum())} with margin > tol, all equal")

    # ---- timings ---------------------------------------------------------------
    warm = run_static(params, cfg, prompts, new_tokens=NEW_TOKENS, chunk=CHUNK)
    prefill_ms = warm["prefill_s"] * 1e3
    decode_tok_s = BATCH * (NEW_TOKENS - 1) / warm["decode_s"]
    log(f"[time] prefill {BATCH}x{PROMPT} (4 chunks of {CHUNK}) {prefill_ms:.2f} ms; "
        f"decode {NEW_TOKENS - 1} steps {decode_tok_s:.1f} tok/s "
        f"({warm['decode_s'] / (NEW_TOKENS - 1) * 1e3:.2f} ms/step); on {kind} ({smi})")

    # ---- where the time goes: device kernel time vs wall, by phase -----------
    caches = tf.init_caches(cfg, BATCH, PROMPT + NEW_TOKENS, torch.float32, dev)
    prefill_step, serve_step = make_prefill_step(cfg, CHUNK), make_serve_step(cfg)
    state = {}

    @torch.inference_mode()
    def run_prefill():
        state["tok"], state["caches"] = prefill_step(params, prompts, caches)

    @torch.inference_mode()
    def run_decode(steps=8):
        tok, c = state["tok"][:, None], state["caches"]
        for _ in range(steps):
            tok, c = serve_step(params, tok, c)

    for phase, fn in (("prefill 4 chunks", run_prefill), ("decode 8 steps", run_decode)):
        wall, busy, top = device_breakdown(torch, fn)
        log(f"[profile] {phase}: wall {wall * 1e3:.2f} ms (profiled), device kernels "
            f"{busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %")
        for name, us, calls in top:
            log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    del caches, state

    q = randn(b, s, h, d)
    k = randn(b, t, hkv, d)
    v = randn(b, t, hkv, d)
    rows = {}
    acc = {key: 0.0 for key in ("ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")}
    offsets = [i * CHUNK for i in range(PROMPT // CHUNK)]
    for q_off in offsets:
        kv_len = q_off + s
        mask = (torch.arange(kv_len, device=dev)[None, :]
                <= q_off + torch.arange(s, device=dev)[:, None])
        qt = q.transpose(1, 2)
        kt = k[:, :kv_len].repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vt = v[:, :kv_len].repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        ms = cuda_ms(torch, lambda: flash_attention(q, k, v, q_offset=q_off, kv_len=kv_len))
        plain = cuda_ms(torch, lambda: flash_attention_ref(q, k, v, q_offset=q_off,
                                                           kv_len=kv_len), reps=5)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=mask))
        flops, nbytes = flash_work(b, s, h, hkv, d, d, q_off, kv_len, 4)
        bnd, by = bound_ms(flops, nbytes, "float32")
        log(f"[time] flash q_offset={q_off} kv_len={kv_len}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bnd), ("flops", flops), ("bytes", nbytes)):
            acc[key] += val / len(offsets)
    bnd, by = bound_ms(acc["flops"], acc["bytes"], "float32")
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:196", launches=n_flash,
        max_abs_err=errs["flash_attention"], ms=acc["ms"], plain_ms=acc["plain_ms"],
        bound_ms=bnd, bound_by=by, library_ms=acc["library_ms"])
    log(f"[time] flash mean over the main path's 4 chunk offsets: kernel "
        f"{acc['ms']:.4f} ms, bound {bnd:.4f} ms ({by}), "
        f"{acc['flops'] / (acc['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")

    kv_len = PROMPT + NEW_TOKENS // 2  # the middle decode step of the main path
    qd = randn(b, 1, h, d)
    qdt = qd.transpose(1, 2)
    kdt = k[:, :kv_len].repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vdt = v[:, :kv_len].repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    ms = cuda_ms(torch, lambda: decode_attention(qd, k, v, kv_len=kv_len), reps=50)
    plain = cuda_ms(torch, lambda: decode_attention_ref(qd, k, v, kv_len=kv_len))
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qdt, kdt, vdt), reps=50)
    flops, nbytes = decode_work(b, h, hkv, d, d, kv_len, 4)
    bnd, by = bound_ms(flops, nbytes, "float32")
    log(f"[time] decode kv_len={kv_len}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}; {nbytes / 1e6:.2f} MB), "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    rows["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:215", launches=n_decode,
        max_abs_err=errs["decode_attention"], ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=lib)

    print(json.dumps({"kernels": [dict(name=n, **r) for n, r in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
