#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each kernel against its plain PyTorch version at the serving
paths' shapes, and drives both serving paths at the full width of
qwen3_0p6b (f32, random weights from seed 0):

* the static path of ``repro_torch.launch.serve`` (batch 4, prompt 2048 in
  four 512-token prefill chunks, 32 new tokens), with its logits held to a
  teacher-forced reference run on the card;
* the paged continuous-batching ``ServingEngine`` on a seeded trace of 16
  requests (prompts 512-2048, half sharing a 1024-token prefix, 16-64 new
  tokens, priorities 0/1 arriving one every two steps) with the prefix
  cache, a 512-token prefill budget and a pool small enough to preempt,
  auditing the pool on every step, with its tokens held to a run on the
  plain versions; then 8 of those requests with speculative decoding (the
  target as its own draft, k = 4, S = 5 verify calls).

Each path runs with every kernel's launch count set to 0 just before it
and read just after, and the counts must be exactly those the path's own
counters imply.  Each kernel is then timed beside its plain version, a
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

# the paged engine phase: 16 requests on 8 slots of 16-token pages, 512-token
# prefill chunks (every chunk runs the flash kernel) and budget; the pool
# (600 of the 8 * 132 pages full backing would take) forces preemptions
ENGINE = dict(max_slots=8, max_len=2048 + 64, page_size=16, prefill_chunk=512)
ENGINE_POOL, ENGINE_REQUESTS, SPEC_REQUESTS, SPEC_K = 600, 16, 8, 4


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


def paged_work(b, s, h, hkv, d, dv, kv_lens, esize, pages_per_seq):
    """Operations and bytes one paged call needs: each query row scores
    every key of its sequence's live span; q, the live K/V rows, the
    block table and lengths are read once, the output written once."""
    keys = sum(kv_lens)
    flops = s * h * keys * 2 * (d + dv)
    nbytes = (esize * (b * s * h * d + keys * hkv * (d + dv) + b * s * h * dv)
              + 4 * (b * pages_per_seq + b))
    return flops, nbytes


def paged_inputs(torch, gen, dev, dtype, b, s, h, hkv, d, w, pg, kv_lens, int8=False):
    """q and page pools with every sequence's pages at shuffled, non-
    contiguous pool indices and -1 tails; int8 pools with per-page,
    per-head scales.  Returns (args, kwargs) of ``paged_decode_attention``."""
    pages = [-(-n // pg) for n in kv_lens]
    max_pp, num_pages = max(pages) + 1, sum(pages) + 3
    perm = torch.randperm(num_pages, generator=gen, device=dev)
    bt = torch.full((b, max_pp), -1, dtype=torch.int32, device=dev)
    nxt = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[nxt:nxt + n].int()
        nxt += n
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    shape = (hkv, num_pages, pg, w)
    kw = {}
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
                  for _ in range(2))
        kw = {name: torch.rand(shape[:2], generator=gen, device=dev) * 0.02 + 1e-3
              for name in ("k_scales", "v_scales")}
    else:
        kp, vp = (torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(2))
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    return (q, kp, vp, bt, lens), kw


def engine_trace(vocab: int, n: int = ENGINE_REQUESTS, seed: int = 2):
    """The engine phase's requests: (prompt, max_new, priority, arrival
    step).  Prompts of 512-2048 tokens; the odd ones (half) are longer
    than 1024 and start with one shared 1024-token prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 1024)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(1088, 2049) if i % 2 else rng.integers(512, 2049))
        prompt = rng.integers(0, vocab, plen)
        if i % 2:
            prompt[:1024] = shared
        reqs.append((prompt.astype(np.int32), int(rng.integers(16, 65)), i % 2, 2 * i))
    return reqs


def drive_engine(eng, reqs):
    """Submit each request before its arrival step, step the engine with
    the pool audit on every step until every request retired; returns
    ({rid: tokens}, finished requests, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = step = 0
    while True:
        while i < len(reqs) and reqs[i][3] <= step:
            prompt, max_new, priority, _ = reqs[i]
            eng.submit(prompt, max_new, priority=priority)
            i += 1
        if i == len(reqs) and not eng.pending and eng.active == 0:
            break
        eng.step(debug_audit=True)
        step += 1
    done = eng.run()
    torch.cuda.synchronize()
    return {r.rid: r.tokens for r in done}, done, time.perf_counter() - t0


def engine_phases(torch, params, cfg, dev, card: str) -> int:
    """The paged ``ServingEngine`` at full width: the trace with the
    kernels (launch counts exact, preemption, prefix hits, audit green,
    no leaked page), the same trace on the plain versions (tokens equal
    under the margin rule), the speculative run, the timing line and a
    profile of decoding engine steps.  Returns the paged kernel's
    launches in the first run."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import ServingEngine, latency_stats

    layers_n = cfg.num_layers
    reqs = engine_trace(cfg.vocab)
    log(f"[engine] trace: {len(reqs)} requests, prompts {[len(r[0]) for r in reqs]}, "
        f"max_new {[r[1] for r in reqs]}, priorities 0/1, one arrival every 2 steps; "
        f"{ENGINE}, pool {ENGINE_POOL} pages, prefix cache, prefill budget 512")

    def engine(**kw):
        # aging off: admission order by priority alone, so the preemptions
        # do not depend on the host clock
        return ServingEngine(params, cfg, prefix_cache=True, aging_s=None, **ENGINE, **kw)

    def launch_counts():
        return flash_attention.launches, paged_decode_attention.launches

    def margin_check(got, ref, what):
        """Tokens of ``got`` equal ``ref`` request by request, except from a
        position where a teacher-forced forward of ref's sequence (plain
        versions) shows a top-2 logit margin <= LOGIT_TOL.  Returns the
        number of requests that diverge."""
        diverged = 0
        for rid, want in ref.items():
            have = got[rid]
            check(len(have) == len(want), f"{what}: request {rid} length")
            if have == want:
                continue
            j = next(i for i, (a, b_) in enumerate(zip(have, want)) if a != b_)
            seq = torch.tensor([list(reqs[rid][0]) + want[:j]], device=dev)
            prev = layers.set_attention_impl("ref")
            try:
                with torch.inference_mode():
                    lg = tf.forward(params, cfg, seq)[0][0, -1]
            finally:
                layers.set_attention_impl(prev)
            top2 = lg.topk(2).values
            margin = (top2[0] - top2[1]).item()
            check(margin <= LOGIT_TOL, f"{what}: request {rid} diverges at token {j} where "
                  f"the reference's top-2 margin is {margin} > {LOGIT_TOL}")
            diverged += 1
        return diverged

    flash_attention.launches = paged_decode_attention.launches = 0
    eng = engine(num_pages=ENGINE_POOL, prefill_budget=512)
    toks, done, engine_s = drive_engine(eng, reqs)
    n_eflash, n_paged = launch_counts()
    est = eng.stats()
    log(f"[engine] stats: {est}")
    log(f"[engine] launches: paged_decode_attention {n_paged} (expect {layers_n} x "
        f"{est['steps']} decode steps), flash_attention {n_eflash} (expect {layers_n} x "
        f"{est['prefill_chunk_calls']} prefill chunk calls)")
    check(n_paged == layers_n * est["steps"] and n_eflash == layers_n * est["prefill_chunk_calls"],
          "the engine's attention calls all went through the kernels")
    check(est["preemptions"] >= 1, "the engine trace preempts at least once")
    check(est["prefix_hits"] >= 1, "the engine trace hits the prefix cache")
    check(len(done) == len(reqs) and all(len(r.tokens) == r.max_new for r in done),
          "every request finished with its max_new tokens")
    check(all(0 <= t < cfg.vocab for ts in toks.values() for t in ts), "token ids in vocab")
    audit = eng.audit()
    check(eng.allocator.num_free + len(eng.prefix.pages()) == eng.num_pages
          and (eng.block_tables == -1).all(), "every page not held by the radix tree is free")
    log(f"[engine] audit after run: {audit}, {eng.allocator.num_free} free + "
        f"{len(eng.prefix.pages())} held by the radix tree = {eng.num_pages} pages")
    lat = latency_stats(done)
    n_tok = lat["tokens"]
    del eng

    prev = layers.set_attention_impl("ref")
    try:
        eng = engine(num_pages=ENGINE_POOL, prefill_budget=512)
        ref_toks, _, ref_s = drive_engine(eng, reqs)
        eng.audit()
        ref_stats = eng.stats()
        del eng
    finally:
        layers.set_attention_impl(prev)
    check(launch_counts() == (n_eflash, n_paged), "the reference engine run launched no kernel")
    diverged = margin_check(toks, ref_toks, "engine vs the plain-version run")
    log(f"[engine] tokens vs a run on the plain versions ({ref_s:.2f} s, "
        f"{ref_stats['preemptions']} preemptions): {len(ref_toks) - diverged}/{len(ref_toks)} "
        f"requests equal, {diverged} diverge where the reference's margin <= {LOGIT_TOL}")

    # speculative decoding: the target as its own draft, so every proposal
    # is accepted (S = 5 verify calls); fully backed pools, no preemption
    spec_reqs = reqs[:SPEC_REQUESTS]
    flash_attention.launches = paged_decode_attention.launches = 0
    eng = engine(prefill_budget=512, draft_params=params, draft_cfg=cfg, spec_k=SPEC_K)
    spec_toks, _, spec_s = drive_engine(eng, spec_reqs)
    n_sflash, n_spaged = launch_counts()
    sst = eng.stats()
    eng.audit()
    del eng
    draft_chunks = sum(-(-len(r[0]) // ENGINE["prefill_chunk"]) for r in spec_reqs)
    log(f"[engine] speculative k={SPEC_K}: {sst['accepted_per_spec_step']:.2f} tokens per "
        f"slot-step over {sst['spec_steps']} verify steps in {spec_s:.2f} s; launches: "
        f"paged {n_spaged} (expect {layers_n} x {sst['spec_steps']} x (1 verify + "
        f"{SPEC_K + 1} draft steps)), flash {n_sflash} (expect {layers_n} x "
        f"({sst['prefill_chunk_calls']} target + {draft_chunks} draft prefill chunks))")
    check(sst["preemptions"] == 0, "the speculative run does not preempt")
    check(n_spaged == layers_n * sst["spec_steps"] * (SPEC_K + 2)
          and n_sflash == layers_n * (sst["prefill_chunk_calls"] + draft_chunks),
          "the speculative run's attention calls all went through the kernels")
    spec_div = margin_check(spec_toks, {rid: toks[rid] for rid in spec_toks},
                            "speculative vs non-speculative")
    log(f"[engine] speculative tokens vs the non-speculative run: "
        f"{len(spec_toks) - spec_div}/{len(spec_toks)} requests equal, {spec_div} diverge "
        f"where the margin <= {LOGIT_TOL}")

    log(f"[time] engine: {len(reqs)} requests, {n_tok} tokens in {engine_s:.3f} s "
        f"({n_tok / engine_s:.1f} tok/s) over {est['steps']} decode steps, "
        f"{est['prefill_chunk_calls']} prefill chunks; TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} ms, "
        f"p99 {lat['ttft_p99_s'] * 1e3:.1f} ms; token latency p50 "
        f"{lat['token_p50_s'] * 1e3:.1f} ms, p99 {lat['token_p99_s'] * 1e3:.1f} ms; "
        f"on {card}")

    # where the time of a decoding engine step goes: 8 slots decoding
    eng = ServingEngine(params, cfg, **ENGINE)
    for prompt, _, _, _ in reqs[:8]:
        eng.submit(prompt, 64)
    eng.step()  # admits and prefills all eight, then one decode step
    check(all(sl.decoding for sl in eng.slots), "the profiled engine steps decode 8 slots")

    def engine_steps(steps=8):
        for _ in range(steps):
            eng.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine_steps()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    log(f"[time] engine decode-only steps at 8 slots: {step_ms:.2f} ms/step "
        f"({8 * 1e3 / step_ms:.1f} tok/s) on {card}")
    wall, busy, top = device_breakdown(torch, engine_steps)
    log(f"[profile] engine decode 8 steps at 8 slots: wall {wall * 1e3:.2f} ms (profiled), "
        f"device kernels {busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %")
    for name, us, calls in top:
        log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    del eng
    return n_paged


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
        decode_partition_map, paged_decode_attention, paged_decode_attention_ref,
        paged_partition_counts)
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
    errs = {"flash_attention": 0.0, "decode_attention": 0.0, "paged_decode_attention": 0.0}
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

    # paged: S 1 (decode) and 5 (verify), window 0 / 100, pages of 16 / 64,
    # kv_lens 0, 1, page-1, page, page+1, 2064 at shuffled pages with -1
    # tails; bf16; dv < W; int8 pages with scales
    paged_cases = [(f"s={sq} window={w} page={pg} float32", dict(s=sq, window=w, pg=pg),
                    "float32") for sq in (1, 5) for w in (0, 100) for pg in (16, 64)]
    paged_cases += [(f"s={sq} window=100 page=16 bfloat16", dict(s=sq, window=100, pg=16),
                     "bfloat16") for sq in (1, 5)]
    paged_cases += [("s=1 page=16 W=160 dv=96 float32", dict(s=1, window=0, pg=16, w=160, dv=96),
                     "float32"),
                    ("s=1 window=100 page=16 int8", dict(s=1, window=100, pg=16, int8=True),
                     "float32"),
                    ("s=5 page=64 int8", dict(s=5, window=0, pg=64, int8=True), "float32")]
    for name, c, dt in paged_cases:
        pg, sq = c["pg"], c["s"]
        kv_lens = [0, 1, pg - 1, pg, pg + 1, 2064]
        args, kw = paged_inputs(torch, gen, dev, getattr(torch, dt), 6, sq, h, hkv, d,
                                c.get("w", d), pg, kv_lens, int8=c.get("int8", False))
        opts = dict(window=c["window"], dv=c.get("dv"), **kw)
        got, counts = paged_decode_attention(*args, return_counts=True, **opts)
        want, want_map = paged_decode_attention_ref(*args, return_counts=True, **opts)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(torch.isfinite(got).all(), f"paged {name}: non-finite output")
        check(err <= TOL[dt], f"paged {name}: max|err| {err} > {TOL[dt]}")
        check(not got[0].any(), f"paged {name}: kv_len 0 must give exactly zero")
        check(torch.equal(counts, want_map), f"paged {name}: map vs the plain version's")
        if sq == 1:
            executed, total = paged_partition_counts(args[3].shape[1], kv_lens,
                                                     page_size=pg, window=c["window"])
            check(counts.shape[2] == total and counts[:, 0].sum(1).tolist() == executed,
                  f"paged {name}: map vs paged_partition_counts")
        if dt == "float32":
            errs["paged_decode_attention"] = max(errs["paged_decode_attention"], err)
        log(f"[paged] {name} kv_lens {kv_lens}: max|err| {err:.3e} (tol {TOL[dt]}), "
            f"map == plain version's{' == paged_partition_counts' if sq == 1 else ''} "
            f"({int(counts[:, 0].sum())} live pages)")

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

    # ---- the paged engine: the second main path ------------------------------
    n_paged = engine_phases(torch, params, cfg, dev, f"{kind} ({smi})")

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

    # paged at the dense decode row's shape: B 4, kv_len 2064, pages of 16
    # at shuffled pool indices, S 1
    kv_lens = [PROMPT + NEW_TOKENS // 2] * b
    args, _ = paged_inputs(torch, gen, dev, torch.float32, b, 1, h, hkv, d, d, 16, kv_lens)
    qp, kp, vp, bt, lens = args
    live = bt[:, :-(-kv_lens[0] // 16)].long()
    # no single PyTorch call reads a paged pool: SDPA runs on a dense copy
    # gathered beforehand (the gather is not timed)
    kdt = (kp[:, live].permute(1, 0, 2, 3, 4).reshape(b, hkv, -1, d)[:, :, :kv_lens[0]]
           .repeat_interleave(h // hkv, dim=1))
    vdt = (vp[:, live].permute(1, 0, 2, 3, 4).reshape(b, hkv, -1, d)[:, :, :kv_lens[0]]
           .repeat_interleave(h // hkv, dim=1))
    qpt = qp.transpose(1, 2)
    ms = cuda_ms(torch, lambda: paged_decode_attention(*args), reps=50)
    plain = cuda_ms(torch, lambda: paged_decode_attention_ref(*args))
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qpt, kdt, vdt), reps=50)
    flops, nbytes = paged_work(b, 1, h, hkv, d, d, kv_lens, 4, bt.shape[1])
    bnd, by = bound_ms(flops, nbytes, "float32")
    log(f"[time] paged kv_len={kv_lens[0]} page=16 shuffled: kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa on a pre-gathered dense copy {lib:.4f} ms, bound {bnd:.4f} ms "
        f"({by}; {nbytes / 1e6:.2f} MB), {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s")
    rows["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:402", launches=n_paged,
        max_abs_err=errs["paged_decode_attention"], ms=ms, plain_ms=plain,
        bound_ms=bnd, bound_by=by, library_ms=lib)

    print(json.dumps({"kernels": [dict(name=n, **r) for n, r in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
