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
  target as its own draft, k = 4, S = 5 verify calls);
* fault-tolerant serving (``[serve-ft]``): ``serve.supervisor.ServeSupervisor``
  over the same engine trace, clean (tokens and counters equal to the
  unsupervised run, no event), then one run per fault kind (decode_nan,
  device_loss on four listed boards, pool_corrupt, step_hang, a deadline
  that expires mid-trace, and a degrade after two decode_nans): exactly the
  planned events, the streams equal to the clean run's under the margin
  rule, no page leaked, no kernel launch after the degrade and ``auto``
  dispatch restored after it; decode_nan and device_loss again on int8
  weights and pools over the first 7 layers (depth cut for run time),
  every token, counter and event equal to the same run with the GEMMs on
  their plain version;
* single-device training (``[train]``): ``train.step.make_train_step`` on
  the same weights at batch 4, seq 2048, grad_accum 2, remat, with
  ``SyntheticLM`` batches, four steps through an ``AsyncCheckpointer``:
  step 1 held to the same step on the plain versions (loss and every
  gradient leaf), flash launched 2 x 28 x 2 times a step (forward and
  remat recompute; the backward recomputes the plain version), the state
  saved after step 2 restored bitwise into a fresh state, and step 3 from
  it held to the uninterrupted step 3;
* the pipeline runtime (``[pipeline]``): the same weights' first 16 layers
  (a depth cut for run time) and batch (B 4, seq 2048) through four stages
  on the one card
  (``make_mesh_for([dev] * 4, model_axis=4)``, m 4 from
  ``tune_microbatches``) on the planner's cuts and on an uneven cut with
  stage 0 at half speed (padding rows at full width): the pipelined
  forward against ``transformer.forward``, GPipe and 1F1B
  ``loss_and_grad`` bitwise equal and held to the single-device
  ``value_and_grad``, schedule counts against ``pipeline_bubble_counts``,
  and three ``make_pipeline_train_step`` steps, each launching flash
  3 x 16 x 4 times, timed against the single-device step;
* the training supervisor (``[train-ft]``): ``ft.supervisor.TrainSupervisor``
  on the same weights' first 12 layers (a depth cut for run time) at batch
  4, seq 512, checkpoints in a temporary
  directory under ``build/``: fused, 8 steps, a NaN batch at data index 3
  and a checkpoint write crash at step 4 (one rollback, one ``ckpt_retry``,
  a latest checkpoint at step 8); the 1F1B pipeline on four stages of the
  one card, 12 steps fault-free and with stage 2 three times slower from
  step 3 (a live re-cut that shrinks stage 2, the final loss within 5e-2 of
  the fault-free run's), and with a device lost at step 7 (a rescale to
  three stages from the latest checkpoint, at most 2 steps lost); flash
  launched exactly as the steps run imply, warm and replayed steps
  included; each event's ``recovery_s`` and each run's mean step printed;
* measured tuning (``[tune]``): ``core.autotune.tune_runtime`` at the main
  path's shapes (flash's blocks at S 2048, the paged kernel's page size at
  8 slots, the prefill chunk with the full-width params), the table saved,
  loaded back and installed; flash and the paged kernel at the tuned knobs
  held to their plain versions, then the engine trace with its page size
  and prefill chunk from the table at the same pool bytes, tokens equal to
  the untuned run's under the margin rule, both runs' tok/s printed; the
  table uninstalled after;
* multi-card execution over the data axes (``[multi]``): two processes,
  one per data position (``dist.collective``: spawned fresh, gloo as they
  share the one card; again over NCCL on distinct cards where there are
  two or more), each on its row of the global batch (B 2 x 512, f32):
  two train steps each under scatter_gather and fused on the (2, 1) mesh
  and pipeline on the (2, 2) mesh (two stages a process), then the static
  path (8 new tokens); every process's loss and grad norm, and the
  gathered params, within 1e-5 of the same work in one process, the
  gathered tokens equal to its tokens where the margin is clear, flash
  and decode launches a process exact, each process's placed state bytes
  equal to the dry-run stand-in's arithmetic (fused's below
  scatter_gather's), each step's time and its collectives' printed;
* tensor and expert parallelism (``[tp]``, after the MoE family): one
  process per mesh position (``dist.collective.mesh_groups``, spawned
  fresh, gloo as they share the one card; the qwen3 jobs again over NCCL
  on distinct cards where there are enough), flash and dense decode first
  held to their plain versions at the local head counts; qwen3_0p6b at
  full width, f32, B 2 x 512, two train steps under ai_core_assignment
  (1, 2) and fused (2, 2), loss and grad norm within 1e-5 of the same
  rows in one process, params within 1e-4, flash launches exact, placed
  bytes equal to the stand-in's, then the static path on (1, 2) (tokens
  equal under the margin rule, decode launches exact at 8 / 4 heads);
  deepseek_v2_236b's static path at the ``[moe]`` depth under
  ai_core_assignment (1, 2), tokens equal to the one-process ``[moe]``
  run's; mixtral_8x22b training with 4 experts a process (1 layer, bf16
  params and moments), loss and grad norm within 1e-2 of one process;
* the VTA path: ResNet-18's convolutions (batch 1, 224 x 224) as int8
  GEMMs through ``ops.vta_conv2d`` and ``ops.dense_requant_int8``, the
  conv weights packed K-major by ``ops.pack_conv_weight``;
* int8 serving: the same weights packed by ``optim.quant.quantize_params``
  through the static path (every projection on the VTA GEMM's dequant
  epilogue) and through the engine trace on int8 KV pools;
* the VTA ALU (``ops.alu``, all seven ops) on the VTA path's int32
  accumulators, a ragged shape, an int8 input and the int32 ends;
* ResNet-18 (``resnet18_vta``) at full width, 224 x 224, 1000 classes,
  random weights from seed 5: f32 against the same forward in f64 (so no
  TF32), bf16, and the int8 fc head on the dequant kernel, with its MACs
  held to the planner's ``resnet18_graph``, timed at batch 1 and 32;
* the cluster planner: ``auto_schedule`` of ResNet-18's graph on 1-12
  simulated Zynq-7020 boards;
* the MoE family at full width with depth cut to 2 layers, random weights
  from the port's ``init`` (seed 0), each model freed before the next:
  deepseek_v2_236b (MLA, 160 routed + 2 shared experts, top-6) through the
  static path (batch 2, prompt 1024 in two 512-token chunks — flash at
  MLA's G 1, D 192, Dv 128 — and 16 new tokens on the absorbed dense
  decode kernel) with its logits held to a teacher-forced run on the plain
  versions, and through the engine (8 requests of 512-1024 tokens, half
  sharing a 512-token prefix, prefix cache, MLA's one-pool pages) with its
  tokens held to a plain-version run; then the same two on int8 weights
  (every expert's GEMM one VTA GEMM launch) and int8 pools, held bitwise
  to runs with the GEMMs on their plain version; mixtral_8x22b (8 experts
  top-2, SWA 4096) through the static path (batch 2, prompt 4608: the
  rolling buffer wraps) and the engine (4 requests of 4200-4608 tokens:
  the paged kernel's window bites);
* the remaining families at full width (batch 2, f32, random weights from
  the port's ``init``, seed 0, each freed before the next), after flash
  and dense decode are held and timed at their new shapes (G 1 at D 80,
  bidirectional S = T = 1024, S 512 and S 1 against 1024 frames, a
  768-row first chunk at G 8): mamba2_2p7b (depth cut 64 -> 16, the
  static path, prompt 2048 in four 512-token chunks, 16 new tokens; its
  chunked prefill against one pass, prefill(2047) + one decode step
  against prefill(2048), and the chunked SSD against its recurrence in
  f64), zamba2_2p7b (depth cut 54 -> 12 Mamba2 layers in 2 groups with
  the shared attention block, the same static path, in f32 and on
  ``quantize_params`` weights, bitwise to a plain-GEMM run),
  seamless_m4t_large_v2 (decoder cut 24 -> 12, its 24 encoder layers
  whole, ``serve.step.generate`` with 1024 frames and a 1024-token prompt
  in two chunks) and internvl2_76b (depth cut to 2, ``generate`` with 256
  patch embeddings before a 1536-token prompt), their f32 logits held to
  runs on the plain versions.

Each path runs with every kernel's launch count set to 0 just before it
and read just after, and the counts must be exactly those the path's own
counters imply.  Each kernel is then timed beside its plain version, a
PyTorch library call computing the same function, and its bound.  The
dense decode kernel is also held and timed at one full-width layer of the
other dense configs (yi_34b's G 7, qwen2_72b's G 8, starcoder2_15b's G 12)
and at MLA's absorbed decode at full width (128 heads on one latent head,
D 576, V the leading 512 columns of K); flash at one full-width layer of
yi_34b, qwen2_72b and starcoder2_15b (G 7 / 8 / 12), mixtral_8x22b (G 6,
window 4096) and MLA's prefill (G 1, D 192, Dv 128).  ``--timings`` times
only the decode, paged and ALU kernels.

Each phase's wall seconds are printed on a ``[phase]`` line.

It imports no JAX and nothing of the JAX package.  It exits non-zero
without a result when torch sees no CUDA device, when the repository's
sources are missing, or when any phase fails.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit from nvidia-smi, and the one before that the per-kernel
JSON record.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense).  The main path is f32 and keeps
# f32 accuracy: f32 work outside the tensor cores is bounded by the SIMT f32
# rate; the flash kernel's f32 products run as three TF32 passes (3xTF32),
# so its f32 bound is 3 x its operations at the TF32 rate
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12
# a timed call held against that HBM rate must not find its operands in the
# 50 MB L2: its operands are cycled through distinct copies of COLD_BYTES
# in all (3x the L2), as a decode step streams each layer's own pool
L2_BYTES = 50 * 2 ** 20
COLD_BYTES = 3 * L2_BYTES

# kernel vs plain version on the same card and inputs:
#   f32  — both sum in f32, in another order (64-key tiles on the tensor
#          cores, products split 3xTF32 to ~2^-22, per-warp partials vs
#          whole chunks); errors are ~1e-6 of |out| <= ~4
#   bf16 — both round the output to bf16 (ulp 2**-6 at |x| < 4) and the
#          kernel also rounds P to bf16 before the PV product
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# teacher-forced logits, kernel run vs reference run: 28 f32 layers
# amplify the ~1e-6 attention differences; logits are ~0.6 in scale
LOGIT_TOL = 1e-3
# flash f32 against exact f64 attention: 3xTF32 keeps f32 accuracy (~1e-6);
# one TF32 pass (10-bit mantissas) would be ~1e-4 to 1e-3 off
F64_TOL = 1e-5

ARCH, BATCH, PROMPT, NEW_TOKENS = "qwen3_0p6b", 4, 2048, 32
CHUNK = max(16, PROMPT // 4)  # the launcher's chunk rule: 512
EXPECT_FLASH = 28 * (PROMPT // CHUNK)   # 112
EXPECT_DECODE = 28 * (NEW_TOKENS - 1)   # 868

# the paged engine phase: 16 requests on 8 slots of 16-token pages, 512-token
# prefill chunks (every chunk runs the flash kernel) and budget; the pool
# (600 of the 8 * 132 pages full backing would take) forces preemptions
ENGINE = dict(max_slots=8, max_len=2048 + 64, page_size=16, prefill_chunk=512)
ENGINE_POOL, ENGINE_REQUESTS, SPEC_REQUESTS, SPEC_K = 600, 16, 8, 4

# int8 serving.  Kernel vs plain version: none, requant and dequant with act
# none / relu are bitwise (the same int32 sums, the same two f32 roundings);
# silu / gelu within ACT_TOL of max(1, |y|) (the kernel's expf / tanhf
# against PyTorch's exp / tanh)
ACT_TOL = 1e-5
PROJ = [("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
        ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down")]
# 7 projections in each of 28 layers per forward call; the static path makes
# 4 prefill-chunk calls and 31 decode calls
EXPECT_DEQUANT = 7 * 28 * (PROMPT // CHUNK + NEW_TOKENS - 1)  # 6860
# the projection whose N-contiguous-weight time ``time_dequant`` logs
NCONTIG_PROJ = ("ffn", "w_down")
# ResNet-18 convolutions at batch 1, 224 x 224 (the paper's workload):
# (name, H = W, C in, C out, kernel, stride); their GEMMs are M = HO * WO,
# K = kernel^2 * C in, N = C out
RESNET = [("stem 7x7x3->64 s2", 224, 3, 64, 7, 2),
          ("3x3x64->64 at 56", 56, 64, 64, 3, 1),
          ("3x3x256->512 s2", 14, 256, 512, 3, 2),
          ("3x3x512->512 at 7", 7, 512, 512, 3, 1)]
REQUANT_SHIFT = 12


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what) -> None:
    """Fail the run (exit status 1, no result line) when ``ok`` is false."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class Laps:
    """A stopwatch over the run: each call logs, on a line of its own, the
    wall seconds of the phase that just ended (since the previous call)."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"[phase] {name}: {now - self.t:.1f} s (run {now - self.t0:.1f} s)")
        self.t = now


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, CUDA events.  ``fn``
    gets the call's index, so a caller can cycle through operands larger
    than the L2 cache, as a forward pass streams its layers' weights."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 20, replays: int = 5, keep: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph, the median over ``replays`` replays: for calls whose host-side
    launch cost exceeds their device time (a decode-row GEMM runs for
    microseconds), this times the device work and not the host's enqueue
    rate, and one slow replay does not move a reading of a few
    microseconds.  ``fn`` gets the call's index, as in :func:`cuda_ms`.
    With ``keep`` the calls' outputs stay allocated while the graph is
    timed, so each call writes its own output and not the last call's
    (which the L2 still holds)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(reps):
            out = fn(i)
            if keep:
                outs.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[replays // 2]


def cold_copies(nbytes: int, most: int = 200) -> int:
    """Distinct copies of operands of ``nbytes`` that a timed run cycles
    through so that a call finds none of them in the L2 (COLD_BYTES in
    all), at most ``most``."""
    return max(1, min(most, -(-COLD_BYTES // nbytes)))


def bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flash_work(b, s, h, hkv, d, dv, q_offset, kv_len, esize, window=0, bidirectional=False):
    """Operations and bytes one flash call needs: every visible (query,
    key) pair costs 2*D + 2*Dv (bidirectional: every query sees every live
    key); q and the live K/V (of a window: the keys some query sees) are
    read once, the output written once."""
    lo = (lambda p: max(0, p - window + 1)) if window else (lambda p: 0)
    if bidirectional:
        pairs, keys = s * kv_len, kv_len
    else:
        pairs = sum(min(q_offset + i + 1, kv_len) - lo(q_offset + i) for i in range(s))
        keys = kv_len - lo(q_offset)
    flops = b * h * pairs * 2 * (d + dv)
    nbytes = esize * (b * s * h * d + b * keys * hkv * (d + dv) + b * s * h * dv)
    return flops, nbytes


def decode_work(b, h, hkv, d, dv, kv_len, esize, shared=False):
    """Operations and bytes one dense decode call needs: each query head
    scores the live keys (2*D + 2*Dv a key); q and the live K/V rows are
    read once (a ``shared`` cache, V the leading columns of K's rows, once:
    D columns a key), the output written once."""
    flops = b * h * kv_len * 2 * (d + dv)
    nbytes = esize * (b * h * d + b * kv_len * hkv * (d if shared else d + dv) + b * h * dv)
    return flops, nbytes


def paged_work(b, s, h, hkv, d, dv, kv_lens, esize, pages_per_seq, kv_esize=None,
               shared=False, pg=16):
    """Operations and bytes one paged call needs: each query row scores
    every key of its sequence's live span; q, the live K/V rows, the
    block table and lengths are read once, the output written once.
    ``kv_esize`` is the pages' element size where it is not q's (int8
    pages also read two f32 scales a live page and head); a ``shared`` pool
    (MLA's keys and values in one) is read once, D columns a key."""
    kv_esize = esize if kv_esize is None else kv_esize
    keys = sum(kv_lens)
    flops = s * h * keys * 2 * (d + dv)
    pages = sum(-(-n // pg) for n in kv_lens) if kv_esize == 1 else 0
    nbytes = (esize * (b * s * h * d + b * s * h * dv)
              + kv_esize * keys * hkv * (d if shared else d + dv)
              + 4 * (b * pages_per_seq + b) + 8 * hkv * pages)
    return flops, nbytes


def gemm_work(m, k, n, out_bytes, extra_bytes=0):
    """Operations and bytes one int8 GEMM call needs: 2*M*N*K operations;
    a and w read once (int8), the output written once, plus its
    per-column vectors."""
    return 2 * m * n * k, m * k + k * n + out_bytes * m * n + extra_bytes


def paged_inputs(torch, gen, dev, dtype, b, s, h, hkv, d, w, pg, kv_lens, int8=False,
                 max_pp=None):
    """q and page pools with every sequence's pages at shuffled, non-
    contiguous pool indices and -1 tails (tables ``max_pp`` wide, by
    default one entry past the longest sequence); int8 pools with
    per-page, per-head scales.  Returns (args, kwargs) of
    ``paged_decode_attention``."""
    pages = [-(-n // pg) for n in kv_lens]
    max_pp = max(pages) + 1 if max_pp is None else max_pp
    num_pages = sum(pages) + 3
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


@contextlib.contextmanager
def plain_versions():
    """Run attention and the quantized GEMMs on their plain versions (the
    reference runs on the card); the dispatch is restored after."""
    from repro_torch.models import layers

    prev = layers.set_attention_impl("ref"), layers.set_gemm_impl("ref")
    try:
        yield
    finally:
        layers.set_attention_impl(prev[0])
        layers.set_gemm_impl(prev[1])


def margin_check(torch, params, cfg, dev, reqs, got, ref, what, tol):
    """Tokens of ``got`` equal ``ref`` request by request, except from a
    position where a teacher-forced prefill of ref's sequence (plain
    versions, in the engine's ``chunk``-token pieces, so that an MoE routes
    with the serving capacity as the engine did) shows a top-2 logit margin
    <= ``tol``.  Returns the number of requests that diverge."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import make_prefill_step

    chunk = ENGINE["prefill_chunk"]
    diverged = 0
    for rid, want in ref.items():
        have = got[rid]
        check(len(have) == len(want), f"{what}: request {rid} length")
        if have == want:
            continue
        j = next(i for i, (a, b_) in enumerate(zip(have, want)) if a != b_)
        seq = torch.tensor([list(reqs[rid][0]) + want[:j]], device=dev)
        with plain_versions(), torch.inference_mode():
            caches = tf.init_caches(cfg, 1, -(-seq.shape[1] // chunk) * chunk,
                                    torch.float32, dev)
            lg = make_prefill_step(cfg, chunk, return_logits=True)(params, seq, caches)[1][0, -1]
        top2 = lg.topk(2).values
        margin = (top2[0] - top2[1]).item()
        check(margin <= tol, f"{what}: request {rid} diverges at token {j} where "
              f"the reference's top-2 margin is {margin} > {tol}")
        log(f"[engine] {what}: request {rid} diverges at token {j}, reference margin "
            f"{margin:.3e} <= {tol}")
        diverged += 1
    return diverged


def engine_phases(torch, params, cfg, dev, card: str) -> dict:
    """The paged ``ServingEngine`` at full width: the trace with the
    kernels (launch counts exact, preemption, prefix hits, audit green,
    no leaked page), the same trace on the plain versions (tokens equal
    under the margin rule), the speculative run, the timing line and a
    profile of decoding engine steps.  Returns the first run's paged
    kernel launches (``n_paged``), tokens by rid (``toks``), ``stats()``
    and wall seconds."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
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

    def margins(got, ref, what):
        return margin_check(torch, params, cfg, dev, reqs, got, ref, what, LOGIT_TOL)

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

    with plain_versions():
        eng = engine(num_pages=ENGINE_POOL, prefill_budget=512)
        ref_toks, _, ref_s = drive_engine(eng, reqs)
        eng.audit()
        ref_stats = eng.stats()
        del eng
    check(launch_counts() == (n_eflash, n_paged), "the reference engine run launched no kernel")
    diverged = margins(toks, ref_toks, "engine vs the plain-version run")
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
    spec_div = margins(spec_toks, {rid: toks[rid] for rid in spec_toks},
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
    wall, busy, rows = device_breakdown(torch, engine_steps, top=10 ** 6)
    paged_us = sum(us for name, us, _ in rows if "paged_" in name)
    paged_calls = sum(calls for name, _, calls in rows if "paged_" in name)
    log(f"[profile] engine decode 8 steps at 8 slots: wall {wall * 1e3:.2f} ms (profiled), "
        f"device kernels {busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %; "
        f"paged attention kernels {paged_us / 1e3:.3f} ms in {paged_calls} launches")
    for name, us, calls in rows[:6]:
        log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    del eng
    return {"n_paged": n_paged, "toks": toks, "stats": est, "seconds": engine_s}


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


def _counters(stats: dict) -> dict:
    """An engine's ``stats()`` without its measured costs (host-clock
    EWMAs, which differ from run to run)."""
    return {k: v for k, v in stats.items() if not k.endswith("_cost_ms")}


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vta_alu import vta_alu
    from repro_torch.kernels.vta_gemm import vta_gemm

    flash_attention.launches = decode_attention.launches = 0
    paged_decode_attention.launches = 0
    vta_gemm.launches.update(none=0, requant=0, dequant=0)
    vta_alu.launches.update({op: 0 for op in vta_alu.launches})


def int8_operands(torch, gen, dev, *shape):
    return torch.randint(-128, 128, shape, generator=gen, device=dev).to(torch.int8)


def vta_parity(torch, gen, dev) -> dict:
    """The VTA GEMM against its plain version for all three epilogues, at
    the CPU tests' shapes and qwen3_0p6b's projection shapes at M 4, 8,
    512 and 2048, with W both K-major (as ``quantize_params`` packs it)
    and N-contiguous.  Returns the largest |err| per epilogue."""
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref
    from repro_torch.optim.quant import k_major

    shapes = [(16, 16, 16), (128, 128, 128), (100, 200, 300), (1, 2048, 512),
              (384, 64, 640)]
    shapes += [(m, k, n) for m in (4, 8, 512, 2048)
               for k, n in ((1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072),
                            (3072, 1024))]
    errs = {"none": 0.0, "requant": 0.0, "dequant": 0.0}
    for m, k, n in shapes:
        a, w = int8_operands(torch, gen, dev, m, k), int8_operands(torch, gen, dev, k, n)
        ibias = torch.randint(-(2 ** 14), 2 ** 14, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
        scale = torch.rand((n,), generator=gen, device=dev) * 1e-4 + 1e-6
        fbias = torch.randn((n,), generator=gen, device=dev)
        cases = [("none", {}),
                 ("requant", dict(bias=ibias, shift=8, relu=True)),
                 ("requant", dict(bias=ibias, shift=0, relu=False)),
                 ("dequant", dict(scale=scale)),
                 ("dequant", dict(scale=scale, bias=fbias, act="relu")),
                 ("dequant", dict(scale=scale, act="silu")),
                 ("dequant", dict(scale=scale, bias=fbias, act="gelu"))]
        worst = 0.0
        for (epi, kw), (layout, ww) in ((c, lw) for c in cases
                                        for lw in (("N-contiguous", w), ("K-major", k_major(w)))):
            got = vta_gemm(a, ww, epilogue=epi, **kw)
            want = vta_gemm_ref(a, w, epilogue=epi, **kw)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype and got.shape == (m, n),
                  f"vta_gemm {epi} {m}x{k}x{n} {layout}: dtype / shape")
            err = (got.double() - want.double()).abs().max().item()
            if kw.get("act") in ("silu", "gelu"):
                rel = ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()
                check(rel <= ACT_TOL, f"vta_gemm {epi} {kw['act']} {m}x{k}x{n} {layout}: "
                      f"err {rel} > {ACT_TOL} of max(1, |y|)")
            else:
                check(torch.equal(got, want), f"vta_gemm {epi} act={kw.get('act')} "
                      f"{m}x{k}x{n} {layout}: not bitwise equal to the plain version "
                      f"(max|err| {err})")
            errs[epi] = max(errs[epi], err)
            worst = max(worst, err)
        log(f"[vta_gemm] M {m} K {k} N {n}, W K-major and N-contiguous: none, requant "
            f"(shift 8 relu / 0), dequant (none, relu+bias bitwise; silu, gelu+bias "
            f"max|err| {worst:.3e})")
    return errs


def vta_phase(torch, gen, dev):
    """The VTA path: ResNet-18's convolutions at batch 1, 224 x 224, as int8
    GEMMs — ``ops.vta_conv2d`` (epilogue none) and ``ops.dense_requant_int8``
    on the same patches (requant), the conv weights packed K-major by
    ``ops.pack_conv_weight`` where they are made — with the launch counts set to 0 before
    and read after, then each output held bitwise to its plain version and
    the convolution also to an f64 ``conv2d`` with the reference's SAME
    padding.  Returns (launches none, launches requant, the GEMM operands
    and int32 accumulators)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref

    convs = []
    for name, hw, cin, cout, kk, stride in RESNET:
        x = int8_operands(torch, gen, dev, 1, hw, hw, cin)
        w = ops.pack_conv_weight(int8_operands(torch, gen, dev, kk, kk, cin, cout))
        check(w.reshape(-1, cout).stride() == (1, kk * kk * cin),
              f"{name}: the packed conv weight reaches the GEMM K-major")
        bias = torch.randint(-(2 ** 16), 2 ** 16, (cout,), generator=gen, device=dev,
                             dtype=torch.int32)
        convs.append((name, x, w, bias, kk, stride))
    torch.cuda.synchronize()
    reset_counts()
    outs = []
    for name, x, w, bias, kk, stride in convs:
        conv = ops.vta_conv2d(x, w, stride=stride)
        patches, _, _ = ops._im2col(x, kk, kk, stride)
        req = ops.dense_requant_int8(patches, w.reshape(-1, w.shape[-1]), bias,
                                     shift=REQUANT_SHIFT, relu=True)
        outs.append((conv, patches, req))
    torch.cuda.synchronize()
    n_none, n_req = vta_gemm.launches["none"], vta_gemm.launches["requant"]
    log(f"[vta] launches: vta_gemm none {n_none}, requant {n_req} (expect {len(RESNET)} each)")
    check(n_none == n_req == len(RESNET), "the VTA path's GEMMs all went through the kernel")
    operands = []
    for (name, x, w, bias, kk, stride), (conv, patches, req) in zip(convs, outs):
        wmat = w.reshape(-1, w.shape[-1])
        m, k = patches.shape
        n = wmat.shape[1]
        ho = -(-x.shape[1] // stride)
        pad = max((ho - 1) * stride + kk - x.shape[1], 0)
        xp = F.pad(x.permute(0, 3, 1, 2).double(),
                   (pad // 2, pad - pad // 2, pad // 2, pad - pad // 2))
        want = F.conv2d(xp, w.permute(3, 2, 0, 1).double(), stride=stride)
        check(torch.equal(conv, want.permute(0, 2, 3, 1).to(torch.int32)),
              f"vta_conv2d {name}: not bitwise equal to an f64 conv2d")
        check(torch.equal(conv.reshape(m, n), vta_gemm_ref(patches, wmat)),
              f"vta_conv2d {name}: not bitwise equal to the plain version")
        want_req = vta_gemm_ref(patches, wmat, bias, epilogue="requant",
                                shift=REQUANT_SHIFT, relu=True)
        check(torch.equal(req, want_req), f"dense_requant_int8 {name}: not bitwise equal")
        sat = (req == 127).float().mean().item()
        log(f"[vta] {name}: GEMM M {m} K {k} N {n}; conv bitwise == f64 conv2d == plain "
            f"version; requant (shift {REQUANT_SHIFT}, relu) bitwise, {sat:.1%} at 127")
        operands.append((name, patches, wmat, bias, conv.reshape(m, n)))
    return n_none, n_req, operands


def int8_static_phase(torch, params, qparams, cfg, prompts, dev, card: str):
    """Full-width int8 static serving: launches exact (every projection of
    every forward call on the dequant kernel), finite logits of the right
    shape, teacher-forced logits bitwise equal to a run with the GEMMs on
    their plain version and within int8 noise of a run on every plain
    version, tokens under the margin rule, then a timed warm run and a
    decode profile.  Returns the dequant kernel's launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vta_gemm import vta_gemm
    from repro_torch.launch.serve import run_static
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    check(layers.gemm_impl() == "auto" and layers.attention_impl() == "auto",
          "the int8 path runs with gemm and attention impl auto")
    reset_counts()
    res = run_static(qparams, cfg, prompts, new_tokens=NEW_TOKENS, chunk=CHUNK,
                     return_logits=True)
    counts = (flash_attention.launches, decode_attention.launches, vta_gemm.launches["dequant"])
    log(f"[int8 static] launches: vta_gemm dequant {counts[2]} (expect {EXPECT_DEQUANT} = 196 x "
        f"{PROMPT // CHUNK + NEW_TOKENS - 1} forward calls), flash {counts[0]}, decode {counts[1]}")
    check(counts == (EXPECT_FLASH, EXPECT_DECODE, EXPECT_DEQUANT),
          "the int8 path's projections and attention all went through the kernels")
    tokens = res["tokens"]
    check(tokens.shape == (BATCH, NEW_TOKENS), f"int8 token shape {tuple(tokens.shape)}")
    check(int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab, "int8 token ids in vocab")
    logits = torch.stack(res["logits"], dim=1)
    check(logits.shape == (BATCH, NEW_TOKENS, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "int8 logits finite, of shape (B, new tokens, vocab)")
    def teacher_forced(p):
        """(B, new tokens, vocab) logits of ``p`` fed the int8 run's tokens."""
        with torch.inference_mode():
            caches = tf.init_caches(cfg, BATCH, PROMPT + NEW_TOKENS, torch.float32, dev)
            _, lg, caches = make_prefill_step(cfg, CHUNK, return_logits=True)(p, prompts, caches)
            out = [lg[:, -1]]
            step = make_serve_step(cfg, return_logits=True)
            for i in range(NEW_TOKENS - 1):
                _, lg, caches = step(p, tokens[:, i:i + 1], caches)
                out.append(lg[:, -1])
        return torch.stack(out, dim=1)

    # the dequant kernel against its plain version along the whole path: the
    # same run with only the GEMMs on the plain version gives the same logits
    prev = layers.set_gemm_impl("ref")
    try:
        gemm_plain = teacher_forced(qparams)
    finally:
        layers.set_gemm_impl(prev)
    check(vta_gemm.launches["dequant"] == counts[2], "the plain-GEMM run launched no GEMM kernel")
    gerr = (logits - gemm_plain).abs().max().item()
    log(f"[int8 static] teacher-forced logits vs the run with the GEMMs on their plain "
        f"version: max|err| {gerr:.3e} (bitwise expected)")
    check(torch.equal(logits, gemm_plain), "int8 logits equal to the plain-GEMM run")
    # every kernel on its plain version, and the f32 weights: the attention
    # kernels' ~1e-6 differences move int8 codes at rounding ties, and over
    # 28 layers the two int8 runs part by int8 rounding noise; that noise is
    # measured by the f32 weights' distance from the int8 run, and the two
    # int8 runs must stay within twice it
    with plain_versions():
        plain = teacher_forced(qparams)
    f32 = teacher_forced(params)
    check(vta_gemm.launches["dequant"] == counts[2], "the reference runs launched no GEMM kernel")
    err = (logits - plain).abs().max().item()
    noise = (logits - f32).abs().max().item()
    tol = 2 * noise
    top2 = plain.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > tol
    agree = tokens == plain.argmax(-1)
    log(f"[int8 static] teacher-forced logits vs the plain-version run: max|err| {err:.3e}; "
        f"vs the f32 weights {noise:.3e} (tol {tol:.3e} = 2x that); |logits| max "
        f"{logits.abs().max().item():.3f}; greedy tokens equal at {int(agree.sum())}/"
        f"{agree.numel()}, {int(decided.sum())} with margin > tol; f32 weights' greedy "
        f"tokens equal at {int((f32.argmax(-1) == tokens).sum())}/{tokens.numel()}")
    check(err <= tol, f"int8 logits vs the plain-version run: {err} > {tol}")
    check(bool(agree[decided].all()), "int8 greedy token differs where the margin is clear")

    warm = run_static(qparams, cfg, prompts, new_tokens=NEW_TOKENS, chunk=CHUNK)
    log(f"[time] int8 static: prefill {BATCH}x{PROMPT} {warm['prefill_s'] * 1e3:.2f} ms; "
        f"decode {BATCH * (NEW_TOKENS - 1) / warm['decode_s']:.1f} tok/s "
        f"({warm['decode_s'] / (NEW_TOKENS - 1) * 1e3:.2f} ms/step); on {card}")
    caches = tf.init_caches(cfg, BATCH, PROMPT + NEW_TOKENS, torch.float32, dev)
    prefill_step, serve_step = make_prefill_step(cfg, CHUNK), make_serve_step(cfg)
    state = {}

    @torch.inference_mode()
    def run_prefill():
        state["tok"], state["caches"] = prefill_step(qparams, prompts, caches)

    @torch.inference_mode()
    def run_decode(steps=8):
        tok, c = state["tok"][:, None], state["caches"]
        for _ in range(steps):
            tok, c = serve_step(qparams, tok, c)

    for phase, fn in (("int8 prefill 4 chunks", run_prefill), ("int8 decode 8 steps", run_decode)):
        wall, busy, top = device_breakdown(torch, fn)
        log(f"[profile] {phase}: wall {wall * 1e3:.2f} ms (profiled), device kernels "
            f"{busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %")
        for name, us, calls in top:
            log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    return counts[2]


def int8_engine_phase(torch, qparams, cfg, dev, card: str) -> None:
    """The engine trace on int8 weights and int8 KV pools: launch counts
    exact against ``engine.stats()``, prefix hits only at whole pages, the
    audit green on every step and no page leaked, tokens and counters equal
    to the same trace with the GEMMs on their plain version, and the timing
    line."""
    from repro_torch.kernels.decode_attention import paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vta_gemm import vta_gemm
    from repro_torch.models import layers
    from repro_torch.serve.engine import ServingEngine, latency_stats

    reqs = engine_trace(cfg.vocab)
    pg = ENGINE["page_size"]

    def engine():
        return ServingEngine(qparams, cfg, prefix_cache=True, aging_s=None, kv_dtype="int8",
                             num_pages=ENGINE_POOL, prefill_budget=512, **ENGINE)

    def launch_counts():
        return (flash_attention.launches, paged_decode_attention.launches,
                vta_gemm.launches["dequant"])

    reset_counts()
    eng = engine()
    toks, done, engine_s = drive_engine(eng, reqs)
    n_flash, n_paged, n_deq = launch_counts()
    est = eng.stats()
    calls = est["steps"] + est["prefill_chunk_calls"]
    log(f"[int8 engine] stats: {est}")
    log(f"[int8 engine] launches: paged {n_paged} (expect {cfg.num_layers} x {est['steps']} "
        f"decode steps), flash {n_flash} (expect {cfg.num_layers} x "
        f"{est['prefill_chunk_calls']} chunks), vta_gemm dequant {n_deq} (expect {7 * cfg.num_layers} x "
        f"{calls} forward calls)")
    check(n_paged == cfg.num_layers * est["steps"]
          and n_flash == cfg.num_layers * est["prefill_chunk_calls"]
          and n_deq == 7 * cfg.num_layers * calls,
          "the int8 engine's attention and projections all went through the kernels")
    check(eng.blocks[0]["k_pages"].dtype == torch.int8 and eng.prefix.full_pages_only,
          "the engine serves int8 pools with a whole-page prefix tree")
    check(est["prefix_hits"] >= 1 and est["prefix_hit_tokens"] % pg == 0,
          "prefix hits, and only at whole pages")
    check(len(done) == len(reqs) and all(len(r.tokens) == r.max_new for r in done),
          "every int8 request finished with its max_new tokens")
    audit = eng.audit()
    check(eng.allocator.num_free + len(eng.prefix.pages()) == eng.num_pages
          and (eng.block_tables == -1).all(), "int8: every page not held by the tree is free")
    log(f"[int8 engine] audit after run: {audit}; pool {eng.num_pages} pages of "
        f"{eng.pool_bytes / 2 ** 20:.1f} MiB (int8)")
    lat = latency_stats(done)
    del eng
    # the same trace with the GEMMs on their plain version (attention on its
    # kernels): every token and counter equal
    prev = layers.set_gemm_impl("ref")
    try:
        eng = engine()
        ref_toks, _, ref_s = drive_engine(eng, reqs)
        eng.audit()
        ref_stats = eng.stats()
        del eng
    finally:
        layers.set_gemm_impl(prev)
    check(vta_gemm.launches["dequant"] == n_deq, "the plain-GEMM engine run launched no GEMM kernel")
    same = sum(ref_toks[rid] == toks[rid] for rid in toks)
    log(f"[int8 engine] tokens vs the same trace with the GEMMs on their plain version "
        f"({ref_s:.2f} s): {same}/{len(toks)} requests equal, stats equal: "
        f"{_counters(ref_stats) == _counters(est)}")
    check(same == len(toks) and _counters(ref_stats) == _counters(est),
          "int8 engine tokens and counters equal to the plain-GEMM run")
    log(f"[time] int8 engine: {len(reqs)} requests, {lat['tokens']} tokens in {engine_s:.3f} s "
        f"({lat['tokens'] / engine_s:.1f} tok/s) over {est['steps']} decode steps, "
        f"{est['prefill_chunk_calls']} prefill chunks, {est['preemptions']} preemptions; "
        f"TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} ms, p99 {lat['ttft_p99_s'] * 1e3:.1f} ms; "
        f"token latency p50 {lat['token_p50_s'] * 1e3:.1f} ms, p99 "
        f"{lat['token_p99_s'] * 1e3:.1f} ms; on {card}")


def int_mm_operands(torch, a, w):
    """``torch._int_mm``'s operands for a (M, K) x w (K, N): M padded to 32
    rows (it needs M > 16), K to a multiple of 8 with zero columns, w
    column-major (the layout cuBLASLt's int8 GEMM takes)."""
    m, k = a.shape
    kp = -(-k // 8) * 8
    ap = torch.zeros((max(m, 32), kp), dtype=torch.int8, device=a.device)
    ap[:m, :k] = a
    wp = torch.zeros((kp, w.shape[1]), dtype=torch.int8, device=w.device)
    wp[:k] = w
    return ap, wp.t().contiguous().t()


def time_dequant(torch, gen, params, qparams, dev):
    """The dequant kernel at the int8 paths' shapes: each of qwen3's seven
    projections at M 4 (static decode), 8 (engine decode), 512 (engine
    prefill chunk) and 2048 (static prefill chunk), cycling through the 28
    layers' real weights so that the weights stream from device memory as in
    a forward pass.  The kernel runs on the K-major weights
    ``quantize_params`` packs; its slower N-contiguous path is logged once
    per M, on copies of ``NCONTIG_PROJ``'s weights.  Beside the kernel:
    the plain version, ``torch._int_mm`` plus the same epilogue in
    PyTorch, the f32 ``torch.matmul`` of the same projection, and the
    bound (int8 operations at 1,979 TOP/s or bytes at 3.35 TB/s).  Every
    time is device time from CUDA-graph replays.  Returns one row per M
    (one layer's seven projections summed) for the kernels line."""
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref

    layers_n = len(qparams["blocks"])
    rows = {}
    for m in (4, 8, 512, 2048):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, f32_ms=0.0, flops=0, bytes=0)
        for mod, name in PROJ:
            qws = [qparams["blocks"][li][mod][name]["qw"] for li in range(layers_n)]
            fws = [params["blocks"][li][mod][name]["w"] for li in range(layers_n)]
            k, n = qws[0].shape
            check(all(w.stride() == (1, k) for w in qws), "quantize_params packs qw K-major")
            a = int8_operands(torch, gen, dev, m, k)
            xf = torch.randn((m, k), generator=gen, device=dev)
            scale = torch.rand((n,), generator=gen, device=dev) * 1e-4 + 1e-6
            mm = [int_mm_operands(torch, a, w) for w in qws]
            reps = layers_n if m <= 512 else 8
            ms = graph_ms(torch, lambda i: vta_gemm(a, qws[i % layers_n], scale=scale,
                                                    epilogue="dequant"), reps=reps)
            if (mod, name) == NCONTIG_PROJ:
                nws = [w.contiguous() for w in qws]
                ncontig = graph_ms(torch, lambda i: vta_gemm(a, nws[i % layers_n], scale=scale,
                                                             epilogue="dequant"), reps=reps)
                log(f"[time] dequant {name} M {m}: kernel on N-contiguous W {ncontig:.4f} ms "
                    f"against {ms:.4f} ms on the K-major W the model packs")
                del nws
            plain = graph_ms(torch, lambda i: vta_gemm_ref(a, qws[i % layers_n], scale=scale,
                                                           epilogue="dequant"), reps=4)
            lib = graph_ms(torch, lambda i: torch._int_mm(*mm[i % layers_n])[:m].float() * scale,
                           reps=reps)
            f32 = graph_ms(torch, lambda i: torch.matmul(xf, fws[i % layers_n]), reps=reps)
            flops, nbytes = gemm_work(m, k, n, 4, 4 * n)
            bnd, by = bound_ms(flops, nbytes, "int8")
            log(f"[time] dequant {name} M {m} K {k} N {n}: kernel {ms:.4f} ms, "
                f"plain {plain:.4f} ms, _int_mm + epilogue "
                f"{lib:.4f} ms, f32 matmul {f32:.4f} ms, bound {bnd:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("f32_ms", f32), ("flops", flops), ("bytes", nbytes)):
                tot[key] += val
            del mm
        bnd, by = bound_ms(tot["flops"], tot["bytes"], "int8")
        log(f"[time] dequant M {m}, one layer's 7 projections: kernel {tot['ms']:.4f} ms "
            f"(K-major W), plain {tot['plain_ms']:.4f} ms, "
            f"_int_mm + epilogue {tot['library_ms']:.4f} ms, "
            f"f32 matmul {tot['f32_ms']:.4f} ms, bound {bnd:.4f} ms ({by}); x {layers_n} "
            f"layers: kernel {tot['ms'] * layers_n:.3f} ms, bound {bnd * layers_n:.3f} ms, "
            f"{tot['bytes'] * layers_n / (tot['ms'] * layers_n * 1e-3) / 1e12:.3f} TB/s, "
            f"{tot['flops'] / (tot['ms'] * 1e-3) / 1e12:.1f} TOP/s")
        rows[m] = dict(tot, bound_ms=bnd, bound_by=by)
    return rows


def time_vta(torch, operands):
    """The none and requant epilogues at ResNet-18's conv GEMMs, on the
    K-major weights the VTA path packs: kernel, plain version,
    ``torch._int_mm`` (plus the requant epilogue in PyTorch) and bound,
    summed over the four convolutions; the kernel's N-contiguous path
    (a contiguous HWIO weight) logged once, for none over the four."""
    from repro_torch.kernels.vta_gemm import vta_gemm, vta_gemm_ref

    ncontig = 0.0
    for _, patches, wmat, _, _ in operands:
        wn = wmat.contiguous()
        ncontig += graph_ms(torch, lambda _: vta_gemm(patches, wn))
    rows = {}
    for epi in ("none", "requant"):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0, bytes=0)
        for name, patches, wmat, bias, _ in operands:
            m, k = patches.shape
            n = wmat.shape[1]
            kw = (dict(bias=bias, shift=REQUANT_SHIFT, relu=True, epilogue="requant")
                  if epi == "requant" else {})
            ap, wp = int_mm_operands(torch, patches, wmat)

            def library(_):
                acc = torch._int_mm(ap, wp)[:m]
                if epi == "none":
                    return acc
                v = torch.clamp_min((acc + bias) >> REQUANT_SHIFT, 0)
                return torch.clamp(v, -128, 127).to(torch.int8)

            ms = graph_ms(torch, lambda _: vta_gemm(patches, wmat, **kw))
            plain = graph_ms(torch, lambda _: vta_gemm_ref(patches, wmat, **kw), reps=5)
            lib = graph_ms(torch, library)
            flops, nbytes = gemm_work(m, k, n, 4 if epi == "none" else 1,
                                      4 * n if epi == "requant" else 0)
            bnd, by = bound_ms(flops, nbytes, "int8")
            log(f"[time] {epi} {name} (M {m} K {k} N {n}): kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, _int_mm{' + epilogue' if epi == 'requant' else ''} "
                f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}), "
                f"{flops / (ms * 1e-3) / 1e12:.1f} TOP/s")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("flops", flops), ("bytes", nbytes)):
                tot[key] += val
        bnd, by = bound_ms(tot["flops"], tot["bytes"], "int8")
        extra = f" (N-contiguous W: {ncontig:.4f} ms)" if epi == "none" else ""
        log(f"[time] {epi} over the 4 ResNet-18 convolutions, W K-major as the path packs "
            f"it: kernel {tot['ms']:.4f} ms{extra}, plain {tot['plain_ms']:.4f} ms, library "
            f"{tot['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by})")
        rows[epi] = dict(tot, bound_ms=bnd, bound_by=by)
    return rows


# the VTA ALU phase: every op once on each operand pair, the shifts 0, 7, 31
# and 40 (past 31: all sign bits) and immediates at the int32 ends; the row
# of the kernels line times each op at ResNet-18's stem accumulator
ALU_CALLS = ([("add", {}), ("max", {}), ("min", {}), ("add_imm", {"imm": -3}),
              ("add_imm", {"imm": 2 ** 31 - 1}), ("max_imm", {"imm": 11}), ("relu", {})]
             + [("shr", {"shift": sh}) for sh in (0, 7, 31, 40)])
ALU_TIMED = {"add": {}, "max": {}, "min": {}, "add_imm": {"imm": -3}, "max_imm": {"imm": 11},
             "relu": {}, "shr": {"shift": 7}}


def alu_operands(torch, gen, dev, operands):
    """(name, x, y) pairs of the [vta_alu] phase: the int32 accumulators of
    the four ResNet-18 conv GEMMs of the [vta] phase (y: the same
    accumulator upside down, so a binary op combines two real
    accumulators), a ragged (100, 64), an int8 x against an int32 y and
    against an int8 y, and the whole int32 range
    with both ends present (the adds wrap)."""
    def full(*shape):
        return torch.randint(-(2 ** 31), 2 ** 31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    pairs = [(f"{name} M {acc.shape[0]} N {acc.shape[1]}", acc, acc.flip(0))
             for name, *_, acc in operands]
    small = torch.randint(-(2 ** 20), 2 ** 20, (100, 64), generator=gen, device=dev,
                          dtype=torch.int32)
    pairs.append(("ragged M 100 N 64", small, small.flip(1)))
    x8, y8 = (torch.randint(-128, 128, (100, 64), generator=gen, device=dev).to(torch.int8)
              for _ in range(2))
    pairs.append(("int8 x M 100 N 64", x8, small))
    pairs.append(("int8 x, y M 100 N 64", x8, y8))
    x, y = full(64, 64), full(64, 64)
    ends = torch.tensor([2 ** 31 - 1, -(2 ** 31)], dtype=torch.int32, device=dev)
    x[0, :4], y[0, :2], y[0, 2:6] = ends.repeat(2), ends, ends.repeat(2)
    pairs.append(("int32 ends M 64 N 64", x, y))
    return pairs


def alu_phase(torch, gen, dev, operands):
    """The VTA ALU on the VTA path's accumulators: every op of ALU_CALLS on
    every operand pair, with the launch counts set to 0 before and read
    after (exact per op), then each output held bitwise to the plain
    version.  Returns (launches per op, max |err| of the binary and the
    unary ops, the operand pairs)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.vta_alu import _BINARY, vta_alu, vta_alu_ref

    pairs = alu_operands(torch, gen, dev, operands)
    torch.cuda.synchronize()
    reset_counts()
    outs = [ops.alu(x, y if op in _BINARY else None, op=op, **kw)
            for _, x, y in pairs for op, kw in ALU_CALLS]
    torch.cuda.synchronize()
    counts = dict(vta_alu.launches)
    expect = {op: len(pairs) * sum(o == op for o, _ in ALU_CALLS) for op in counts}
    log(f"[vta_alu] launches: {counts} (expect {expect}: {len(pairs)} operand pairs)")
    check(counts == expect, "the ALU calls all went through the kernel, once each")
    got = iter(outs)
    errs = {"binary": 0, "unary": 0}
    for name, x, y in pairs:
        for op, kw in ALU_CALLS:
            out = next(got)
            want = vta_alu_ref(x, y if op in _BINARY else None, op, **kw)
            check(out.dtype == torch.int32 and out.shape == x.shape,
                  f"vta_alu {op} {kw} on {name}: dtype / shape")
            kind = "binary" if op in _BINARY else "unary"
            err = (out.long() - want.long()).abs().max().item()
            errs[kind] = max(errs[kind], err)
            check(torch.equal(out, want),
                  f"vta_alu {op} {kw} on {name}: not bitwise equal to the plain version "
                  f"(max|err| {err})")
        log(f"[vta_alu] {name} ({x.dtype}): {len(ALU_CALLS)} calls (7 ops, shifts 0/7/31/40, "
            f"imm -3 / 2^31-1 / 11) bitwise == plain version")
    return counts, errs, pairs


def time_alu(torch, pairs):
    """Each ALU op at the four accumulators' shapes and on the int8 x:
    kernel, plain version, the one-call PyTorch counterpart and the byte
    bound (each operand read once, the int32 output written once: 12 bytes
    per element binary and 8 unary on int32 operands), device time of
    CUDA-graph replays.  Each is timed on operands cycled past the L2
    (``cold_copies``, each call's output kept), the reading the byte bound
    at the HBM rate applies to; kernel and torch also on one pair of
    operands reused call after call, which the L2 holds, as on the VTA path
    where the GEMM has just written them.  Returns the binary and unary
    rows at the stem accumulator (M 12544, N 64), each the mean over its
    ops of the cycled readings."""
    from repro_torch.kernels.vta_alu import _BINARY, vta_alu, vta_alu_ref

    library = {"add": lambda x, y, kw: torch.add(x, y),
               "max": lambda x, y, kw: torch.maximum(x, y),
               "min": lambda x, y, kw: torch.minimum(x, y),
               "add_imm": lambda x, y, kw: x + kw["imm"],
               "max_imm": lambda x, y, kw: torch.clamp_min(x, kw["imm"]),
               "relu": lambda x, y, kw: torch.relu(x),
               "shr": lambda x, y, kw: x >> kw["shift"]}
    rows = {}
    timed = pairs[:4] + [p for p in pairs if p[1].dtype == torch.int8]
    for pi, (name, x, y) in enumerate(timed):
        for op, kw in ALU_TIMED.items():
            yy = y if op in _BINARY else None
            nbytes = (x.element_size() + 4 + (yy.element_size() if yy is not None else 0)
                      ) * x.numel()
            n = cold_copies(nbytes)
            xs = [x.clone() for _ in range(n)]
            ys = [yy.clone() if yy is not None else None for _ in range(n)]
            reps = max(20, n)
            ms, plain, lib = (
                graph_ms(torch, lambda i, f=f: f(xs[i % n], ys[i % n]), reps=reps, keep=True)
                for f in (lambda a, b: vta_alu(a, b, op=op, **kw),
                          lambda a, b: vta_alu_ref(a, b, op, **kw),
                          lambda a, b: library[op](a, b, kw)))
            del xs, ys
            warm = graph_ms(torch, lambda _: vta_alu(x, yy, op=op, **kw))
            warm_lib = graph_ms(torch, lambda _: library[op](x, yy, kw))
            bnd, by = bound_ms(0, nbytes, "int8")
            where = "past the L2" if n * nbytes >= COLD_BYTES else "(all in the L2)"
            log(f"[time] vta_alu {op} {name}: operands cycled {where} ({n} copies, "
                f"{n * nbytes / 1e6:.1f} MB): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"torch {lib:.4f} ms, bound {bnd:.4f} ms ({by}), "
                f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s; operands in the L2: kernel "
                f"{warm:.4f} ms, torch {warm_lib:.4f} ms")
            if pi == 0:
                kind = "binary" if op in _BINARY else "unary"
                acc = rows.setdefault(kind, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                                 warm_ms=0.0, warm_library_ms=0.0,
                                                 bound_ms=bnd, bound_by=by, ops=0))
                for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                                 ("warm_ms", warm), ("warm_library_ms", warm_lib)):
                    acc[key] += val
                acc["ops"] += 1
    # the kernels' own device durations at the stem accumulator, ours
    # against torch's op, from the profiler (graph replays also count the
    # gaps between launches)
    name0, x, y = timed[0]
    for op, kw in ALU_TIMED.items():
        yy = y if op in _BINARY else None
        for who, fn in (("kernel", lambda: vta_alu(x, yy, op=op, **kw)),
                        ("torch", lambda: library[op](x, yy, kw))):
            fn()
            _, _, prof = device_breakdown(torch, lambda: [fn() for _ in range(20)], top=10 ** 6)
            log(f"[profile] vta_alu {op} {who} at {name0}: " + "; ".join(
                f"{us / calls:.2f} us/call x {calls} {name[:70]}" for name, us, calls in prof))
    for kind, acc in rows.items():
        for key in ("ms", "plain_ms", "library_ms", "warm_ms", "warm_library_ms"):
            acc[key] /= acc["ops"]
        log(f"[time] vta_alu {kind} mean over {acc['ops']} ops at {pairs[0][0]}, operands "
            f"cycled past the L2: kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
            f"torch {acc['library_ms']:.4f} ms, bound {acc['bound_ms']:.4f} ms "
            f"({acc['bound_by']}); in the L2: kernel {acc['warm_ms']:.4f} ms, torch "
            f"{acc['warm_library_ms']:.4f} ms")
    return rows


# the decode kernels' timed shapes.  Dense: the main path's middle decode
# step.  Paged: (label, q / page dtype, int8 pages, B, S, kv_lens, table
# width); the first is the kernels line's row (the dense row's shape at
# shuffled pages of 16), then S 5 verify, bf16 and int8 pages, and the
# engine's 8 slots at lengths 512-2112 in 132-page tables
DECODE_KV = PROMPT + NEW_TOKENS // 2  # 2064
ENGINE_LENS = [512, 740, 968, 1196, 1424, 1652, 1880, 2112]
PAGED_TIMED = [
    ("B 4 kv 2064 f32", "float32", False, BATCH, 1, [DECODE_KV] * BATCH, None),
    ("verify S 5 B 4 kv 2064 f32", "float32", False, BATCH, 5, [DECODE_KV] * BATCH, None),
    ("B 4 kv 2064 bf16", "bfloat16", False, BATCH, 1, [DECODE_KV] * BATCH, None),
    ("B 4 kv 2064 int8 pages", "float32", True, BATCH, 1, [DECODE_KV] * BATCH, None),
    ("B 8 engine lengths 512-2112 f32", "float32", False, 8, 1, ENGINE_LENS, 132),
]
# MLA's absorbed decode at full width (deepseek_v2_236b: 128 heads on one
# latent head, D = r + dr = 576, Dv = r = 512, one pool for keys and values)
MLA_SHAPE = dict(b=2, h=128, hkv=1, d=576, dv=512, kv=DECODE_KV)


# the dense kernel's timed shapes: one full-width layer of each dense
# config at the main path's middle decode step (B 4, T 2080, kv 2064, D 128):
# (label, dtype, Hkv, G); the first is the kernels line's row
DECODE_TIMED = [
    ("qwen3_0p6b G 2 f32", "float32", 8, 2),
    ("qwen3_0p6b G 2 bf16", "bfloat16", 8, 2),
    ("yi_34b G 7 f32", "float32", 8, 7),
    ("qwen2_72b G 8 f32", "float32", 8, 8),
    ("starcoder2_15b G 12 f32", "float32", 4, 12),
]


def time_decode(torch, gen, dev):
    """The dense decode kernel at DECODE_TIMED's shapes and at MLA_SHAPE:
    the device time of CUDA-graph replays (the kernels line's ``ms``)
    beside the eager CUDA-event mean, the plain version and SDPA (on K/V
    with their heads repeated, over twice the L2), each against its bound;
    each shape's output held to the plain version first.  The kernel
    cycles through ``cold_copies`` of its K/V.  MLA reads V as the leading
    512 columns of K's rows and is bound by its operations (SIMT f32); a
    checkout whose kernel refuses it logs the refusal.  Returns the rows by
    label."""
    import torch.nn.functional as F

    dmod = importlib.import_module("repro_torch.kernels.decode_attention")
    decode_attention, decode_attention_ref = dmod.decode_attention, dmod.decode_attention_ref
    b, d, t, kv_len = BATCH, 128, PROMPT + NEW_TOKENS, DECODE_KV
    rows = {}
    for label, dt, hkv, g in DECODE_TIMED:
        dtype, h = getattr(torch, dt), hkv * g
        n = cold_copies(2 * b * t * hkv * d * dtype.itemsize)
        sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for shape in ((b, 1, h, d), (b, t, hkv, d), (b, t, hkv, d)))
                for _ in range(n)]
        q, k, v = sets[0]
        err = (decode_attention(q, k, v, kv_len=kv_len).float()
               - decode_attention_ref(q, k, v, kv_len=kv_len).float()).abs().max().item()
        check(err <= TOL[dt], f"decode {label}: max|err| {err} > {TOL[dt]}")
        qt = q.transpose(1, 2)
        kt = k[:, :kv_len].repeat_interleave(g, dim=2).transpose(1, 2)
        vt = v[:, :kv_len].repeat_interleave(g, dim=2).transpose(1, 2)

        def kernel(i, sets=sets, n=n):
            return decode_attention(*sets[i % n], kv_len=kv_len)

        def sdpa(_, qt=qt, kt=kt, vt=vt):
            return F.scaled_dot_product_attention(qt, kt, vt)

        ms, eager = graph_ms(torch, kernel, reps=50), cuda_ms(torch, kernel, reps=50)
        lib, lib_eager = graph_ms(torch, sdpa, reps=50), cuda_ms(torch, sdpa, reps=50)
        plain = cuda_ms(torch, lambda i: decode_attention_ref(*sets[i % n], kv_len=kv_len),
                        reps=5)
        flops, nbytes = decode_work(b, h, hkv, d, d, kv_len, dtype.itemsize)
        bnd, by = bound_ms(flops, nbytes, "float32")
        plan = ""
        if hasattr(dmod, "decode_plan"):
            pl = dmod.decode_plan(b, h, hkv, t, d, d, dtype.itemsize, False,
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
            plan = (f"; plan span {pl['span']} chunk {pl['chunk']} {pl['ctas']} CTAs "
                    f"x {pl['threads']} threads, {pl['smem']} B")
        log(f"[time] decode {label} B {b} Hkv {hkv} kv_len={kv_len}, {n} copies cycled: "
            f"kernel {ms:.4f} ms (graph replay; eager {eager:.4f}), plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms (graph; eager {lib_eager:.4f}), bound {bnd:.4f} ms ({by}; "
            f"{nbytes / 1e6:.2f} MB), {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{100 * bnd / ms:.1f} % of the bound; max|err| {err:.3e} vs plain{plan}")
        rows[label] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
        del sets, q, k, v, qt, kt, vt

    m = MLA_SHAPE
    h, dm, dv = m["h"], m["d"], m["dv"]
    caches = [torch.randn((m["b"], t, m["hkv"], dm), generator=gen, device=dev)
              for _ in range(cold_copies(m["b"] * t * m["hkv"] * dm * 4))]
    q = torch.randn((m["b"], 1, h, dm), generator=gen, device=dev)
    n = len(caches)
    try:
        got = decode_attention(q, caches[0], caches[0][..., :dv], kv_len=m["kv"])
    except ValueError as e:
        log(f"[time] decode MLA full width: refused ({e})")
        return rows
    err = (got - decode_attention_ref(q, caches[0], caches[0][..., :dv],
                                      kv_len=m["kv"])).abs().max().item()
    check(err <= TOL["float32"], f"decode MLA full width: max|err| {err}")
    ms = graph_ms(torch, lambda i: decode_attention(q, caches[i % n], caches[i % n][..., :dv],
                                                    kv_len=m["kv"]), reps=20)
    flops, nbytes = decode_work(m["b"], h, m["hkv"], dm, dv, m["kv"], 4, shared=True)
    bnd, by = bound_ms(flops, nbytes, "float32")
    log(f"[time] decode MLA full width B {m['b']} H {h} Hkv 1 D {dm} Dv {dv} kv {m['kv']} f32 "
        f"(V the leading columns of K's rows): kernel {ms:.4f} ms (graph replay, {n} caches "
        f"cycled), bound {bnd:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
        f"{100 * bnd / ms:.1f} % of the bound; max|err| {err:.3e} vs plain")
    rows["MLA full width"] = dict(ms=ms, bound_ms=bnd, bound_by=by)
    return rows


def time_paged(torch, gen, dev):
    """The paged kernel at PAGED_TIMED's shapes: graph-replay device time
    (``ms``) beside the eager mean, the plain version, the byte bound, and
    at the first shape SDPA on a dense copy gathered beforehand (no single
    PyTorch call reads a paged pool; the gather is not timed; the copy,
    its heads repeated, is over twice the L2).  The kernel and the plain
    version cycle through ``cold_copies`` of the inputs, pools and tables,
    as a decode step reads each layer's own pool.  Returns the rows by
    label."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_ref)

    h, hkv, d, pg = 16, 8, 128, 16
    rows = {}
    for label, dt, int8, b, sq, kv_lens, width in PAGED_TIMED:
        dtype = getattr(torch, dt)
        sets = [paged_inputs(torch, gen, dev, dtype, b, sq, h, hkv, d, d, pg, kv_lens,
                             int8=int8, max_pp=width)]
        n = cold_copies(sum(x.numel() * x.element_size() for x in sets[0][0][1:3]))
        sets += [paged_inputs(torch, gen, dev, dtype, b, sq, h, hkv, d, d, pg, kv_lens,
                              int8=int8, max_pp=width) for _ in range(n - 1)]
        args, kw = sets[0]

        def kernel(i, sets=sets, n=n):
            return paged_decode_attention(*sets[i % n][0], **sets[i % n][1])

        ms, eager = graph_ms(torch, kernel, reps=50), cuda_ms(torch, kernel, reps=50)
        plain = cuda_ms(torch, lambda i: paged_decode_attention_ref(*sets[i % n][0],
                                                                    **sets[i % n][1]), reps=5)
        esize = dtype.itemsize
        flops, nbytes = paged_work(b, sq, h, hkv, d, d, kv_lens, esize, args[3].shape[1],
                                   kv_esize=1 if int8 else esize, pg=pg)
        bnd, by = bound_ms(flops, nbytes, "float32")
        row = dict(ms=ms, eager_ms=eager, plain_ms=plain, library_ms=None, bound_ms=bnd,
                   bound_by=by)
        lib_note = ""
        if not rows:
            qp, kp, vp, bt, _ = args
            live = bt[:, :-(-kv_lens[0] // pg)].long()
            kdt, vdt = ((x[:, live].permute(1, 0, 2, 3, 4).reshape(b, hkv, -1, d)
                         [:, :, :kv_lens[0]].repeat_interleave(h // hkv, dim=1))
                        for x in (kp, vp))
            qpt = qp.transpose(1, 2)

            def sdpa(_):
                return F.scaled_dot_product_attention(qpt, kdt, vdt)

            row["library_ms"] = graph_ms(torch, sdpa, reps=50)
            lib_note = (f", sdpa on a pre-gathered dense copy {row['library_ms']:.4f} ms "
                        f"(graph; eager {cuda_ms(torch, sdpa, reps=50):.4f})")
        log(f"[time] paged {label} page={pg} shuffled, {n} pools cycled: kernel {ms:.4f} ms "
            f"(graph replay; eager "
            f"{eager:.4f}), plain {plain:.4f} ms{lib_note}, bound {bnd:.4f} ms ({by}; "
            f"{nbytes / 1e6:.2f} MB), {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{100 * bnd / ms:.1f} % of the bound")
        rows[label] = row
    return rows


def paged_mla_phase(torch, gen, dev, tol):
    """MLA's absorbed decode at full width through the paged kernel: 128
    query heads on one latent head, D 576, Dv 512 read from one shared
    pool (keys ``[c_kv | k_rope]``, values its first 512 columns), rows
    in eight tiles of 16.  Held against the plain version, then timed
    against its byte bound, cycling through ``cold_copies`` of the pool.
    Returns max|err|."""
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_ref)

    m = MLA_SHAPE
    b, h, d, dv = m["b"], m["h"], m["d"], m["dv"]
    args, _ = paged_inputs(torch, gen, dev, torch.float32, b, 1, h, m["hkv"], d, d, 16,
                           [m["kv"]] * b)
    q, kp, _, bt, lens = args
    args = (q, kp, kp, bt, lens)  # one pool for keys and values
    got, counts = paged_decode_attention(*args, dv=dv, return_counts=True)
    want, want_map = paged_decode_attention_ref(*args, dv=dv, return_counts=True)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(got.shape == (b, 1, h, dv) and torch.isfinite(got).all(), "paged MLA: shape, finite")
    check(err <= tol, f"paged MLA full width: max|err| {err} > {tol}")
    check(torch.equal(counts, want_map), "paged MLA: map vs the plain version's")
    n = cold_copies(kp.numel() * kp.element_size())
    sets = [args] + [(x[0], x[1], x[1], x[3], x[4]) for x in (
        paged_inputs(torch, gen, dev, torch.float32, b, 1, h, m["hkv"], d, d, 16,
                     [m["kv"]] * b)[0] for _ in range(n - 1))]
    ms = graph_ms(torch, lambda i: paged_decode_attention(*sets[i % n], dv=dv), reps=20)
    flops, nbytes = paged_work(b, 1, h, m["hkv"], d, dv, [m["kv"]] * b, 4, bt.shape[1],
                               shared=True)
    bnd, by = bound_ms(flops, nbytes, "float32")
    log(f"[time] paged MLA full width B {b} H {h} Hkv 1 D {d} W {d} dv {dv} kv {m['kv']} f32 "
        f"(one shared pool): max|err| {err:.3e} (tol {tol}) vs the plain version, map equal; "
        f"kernel {ms:.4f} ms (graph replay, {n} pools cycled), bound {bnd:.4f} ms ({by}; "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return err


# ResNet-18 (the paper's workload, resnet18_vta) at full width: 224 x 224
# images, 1000 classes; the checks run at batch 4, the timings at 1 and 32.
# f32 vs an f64 run of the same forward: the two differ by f32 rounding in
# 20 layers (~1e-6 of the logits); a control run with cuDNN's TF32 on
# (10-bit mantissas) reads how far TF32 would be.  bf16 vs f32: bf16 rounding of every activation
RESNET_BATCH, RESNET_HW, RESNET_CLASSES = 4, 224, 1000
RESNET_TOL, RESNET_BF16_TOL, RESNET_MAC_TOL = 1e-4, 5e-2, 1e-4


def resnet_params(torch, dev, seed: int = 5):
    """Full-width ResNet-18 params from the port's ``init`` (seeded
    generator), every batch norm's scale / bias / mean / var drawn by
    numpy so that no BN is the identity."""
    import numpy as np

    from repro_torch.models import resnet

    params = resnet.init(torch.Generator(device=dev).manual_seed(seed), RESNET_CLASSES,
                         dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)

    def draw(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    for blk in [params["stem"]] + [b for stage in params["stages"] for b in stage]:
        for name, bn in blk.items():
            if "bn" in name:
                c = bn["mean"].shape[0]
                bn.update(scale=draw(rng.uniform(0.5, 1.5, c)),
                          bias=draw(0.1 * rng.standard_normal(c)),
                          mean=draw(0.1 * rng.standard_normal(c)),
                          var=draw(rng.uniform(0.5, 1.5, c)))
    return params


def cast_tree(torch, tree, dtype, key=None):
    """``tree`` in ``dtype``; batch-norm mean / var stay f32 (as
    ``resnet._bn_init`` keeps them; ``_bn`` computes in f64 for an f64
    ``x``, where their f32 values widen exactly)."""
    from repro_torch.convert import keeps_f32

    if isinstance(tree, list):
        return [cast_tree(torch, v, dtype) for v in tree]
    if isinstance(tree, dict):
        return {k: cast_tree(torch, v, dtype, k) for k, v in tree.items()}
    return tree if keeps_f32(key) else tree.to(dtype)


def resnet_phase(torch, dev, card: str) -> int:
    """ResNet-18 at full width through ``resnet.forward``: f32 at batch 4
    against the same forward in f64, bf16 against f32, the int8 head
    (``quantize_params``) with its dequant launches exact and its logits
    bitwise equal to the plain-GEMM run, the MACs of the convolutions and
    the head as the forward runs them against the planner's
    ``resnet18_graph``, then ms per forward, device idle share and top
    kernels at batch 1 and 32.  Returns the dequant launches of one int8
    forward."""
    from repro_torch.core.graph import resnet18_graph
    from repro_torch.kernels.vta_gemm import vta_gemm
    from repro_torch.models import layers, resnet
    from repro_torch.optim.quant import quantize_params

    cudnn = torch.backends.cudnn
    conv_prec = getattr(getattr(cudnn, "conv", None), "fp32_precision", "n/a")
    log(f"[resnet] TF32 flags: cudnn.allow_tf32 {cudnn.allow_tf32} (conv.fp32_precision "
        f"{conv_prec}), cuda.matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; "
        f"resnet._conv turns cuDNN's off around each f32 convolution")
    check(cudnn.allow_tf32, "cuDNN's TF32 flag at its default (on), so that only "
          "resnet._conv keeps the f32 convolutions in f32")
    params = resnet_params(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    images = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), generator=gen, device=dev)

    conv, macs = resnet._conv, []

    def counting_conv(p, x, stride):
        y = conv(p, x, stride)
        kh, kw, cin, _ = p["w"].shape
        macs.append(y[0].numel() * kh * kw * cin)
        return y

    reset_counts()
    resnet._conv = counting_conv
    try:
        with torch.inference_mode():
            f32 = resnet.forward(params, images)
    finally:
        resnet._conv = conv
    torch.cuda.synchronize()
    check(vta_gemm.launches["dequant"] == 0, "the f32 forward launched no GEMM kernel")
    fc = params["fc"]["w"]
    mac_img = sum(macs) + fc.shape[0] * fc.shape[1]
    graph = resnet18_graph(RESNET_HW, RESNET_CLASSES)
    graph_macs = graph.total_macs
    log(f"[resnet] MACs per image as the forward runs them: {len(macs)} convolutions "
        f"{sum(macs)} + fc {fc.shape[0] * fc.shape[1]} = {mac_img} ({mac_img / 1e9:.4f} GMAC); "
        f"resnet18_graph().total_macs {graph_macs:.0f} (the pool and add ALU terms "
        f"{graph_macs - mac_img:.0f} besides)")
    check(len(macs) == 20 and abs(mac_img - graph_macs) <= RESNET_MAC_TOL * graph_macs,
          "the forward's MACs equal the planner graph's within 0.01 %")
    check(f32.shape == (RESNET_BATCH, RESNET_CLASSES) and bool(torch.isfinite(f32).all()),
          "f32 logits finite, of shape (B, 1000)")
    with torch.inference_mode():
        f64 = resnet.forward(cast_tree(torch, params, torch.float64), images.double())
        bf16 = resnet.forward(cast_tree(torch, params, torch.bfloat16), images.bfloat16())
    scale = f64.abs().max().item()
    err = (f32.double() - f64).abs().max().item()
    log(f"[resnet] f32 batch {RESNET_BATCH} vs the same forward in f64: max|err| {err:.3e}, "
        f"{err / scale:.3e} of max|logit| {scale:.3f} (tol {RESNET_TOL})")
    check(err <= RESNET_TOL * scale, f"f32 logits vs f64: {err} > {RESNET_TOL} x {scale}")
    # the control: the same f32 forward with cuDNN's TF32 left on (the
    # default), to show what RESNET_TOL holds the f32 path to
    ieee = resnet._ieee_f32
    resnet._ieee_f32 = lambda x: contextlib.nullcontext()
    try:
        with torch.inference_mode():
            tf32 = resnet.forward(params, images)
    finally:
        resnet._ieee_f32 = ieee
    terr = (tf32.double() - f64).abs().max().item()
    log(f"[resnet] control, f32 with cuDNN TF32 on vs f64: max|err| {terr:.3e}, "
        f"{terr / scale:.3e} of max|logit| "
        f"({'outside' if terr > RESNET_TOL * scale else 'within'} tol {RESNET_TOL})")
    berr = (bf16.float() - f32).abs().max().item()
    fscale = f32.abs().max().item()
    log(f"[resnet] bf16 vs f32: max|err| {berr:.3e}, {berr / fscale:.3e} of max|logit| "
        f"(tol {RESNET_BF16_TOL}); top-1 equal at "
        f"{int((bf16.float().argmax(-1) == f32.argmax(-1)).sum())}/{RESNET_BATCH}")
    check(bool(torch.isfinite(bf16).all()) and berr <= RESNET_BF16_TOL * fscale,
          f"bf16 logits vs f32: {berr} > {RESNET_BF16_TOL} x {fscale}")

    qparams = quantize_params(params)
    check(set(qparams["fc"]) == {"qw", "qscale", "b"} and "w" in qparams["stem"]["conv"],
          "quantize_params packs the fc head only")
    reset_counts()
    with torch.inference_mode():
        q = resnet.forward(qparams, images)
    torch.cuda.synchronize()
    n_deq = vta_gemm.launches["dequant"]
    log(f"[resnet] int8 head: vta_gemm dequant launches {n_deq} (expect 1 per forward)")
    check(n_deq == 1, "the int8 head went through the dequant kernel, once")
    prev = layers.set_gemm_impl("ref")
    try:
        with torch.inference_mode():
            q_plain = resnet.forward(qparams, images)
    finally:
        layers.set_gemm_impl(prev)
    check(vta_gemm.launches["dequant"] == n_deq, "the plain-GEMM run launched no GEMM kernel")
    qerr = (q - f32).abs().max().item()
    log(f"[resnet] int8 head logits vs the plain-GEMM run: max|err| "
        f"{(q - q_plain).abs().max().item():.3e} (bitwise expected); vs f32 {qerr:.3e} "
        f"({qerr / fscale:.3e} of max|logit|)")
    check(torch.equal(q, q_plain), "int8 head logits equal to the plain-GEMM run")

    nparam = graph.total_param_bytes  # conv and fc weights (int8 bytes: one per weight)
    bf16_params = cast_tree(torch, params, torch.bfloat16)
    for batch in (1, 32):
        imgs = torch.randn((batch, RESNET_HW, RESNET_HW, 3), generator=gen, device=dev)
        for mode, p, x, dt, esize in (("f32", params, imgs, "float32", 4),
                                      ("bf16", bf16_params, imgs.bfloat16(), "bfloat16", 2),
                                      ("int8 head", qparams, imgs, "float32", 4)):
            @torch.inference_mode()
            def fwd(_=0, p=p, x=x):
                return resnet.forward(p, x)

            ms = cuda_ms(torch, fwd, reps=10 if batch > 1 else 20)
            flops = 2 * mac_img * batch
            bnd, by = bound_ms(flops, esize * (nparam + x.numel() + batch * RESNET_CLASSES), dt)
            wall, busy, rows = device_breakdown(torch, fwd, top=10 ** 6)
            launches = sum(r[2] for r in rows)
            log(f"[time] resnet {mode} batch {batch}: {ms:.3f} ms/forward, {ms / batch:.4f} "
                f"ms/image, {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; bound {bnd:.4f} ms "
                f"({by}, {flops / 1e9:.2f} GFLOP at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s); "
                f"on {card}")
            log(f"[profile] resnet {mode} batch {batch}: wall {wall * 1e3:.2f} ms (profiled), "
                f"device kernels {busy * 1e3:.2f} ms in {launches} launches, device idle "
                f"{100 * (1 - busy / wall):.1f} %")
            for name, us, calls in rows[:6]:
                log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    return n_deq


def planner_phase() -> None:
    """The port's cluster planner on ResNet-18's graph: the strategy
    ``auto_schedule`` picks for a cluster of 1-12 simulated Zynq-7020
    boards (the paper's testbed), with the simulator's ms per image."""
    from repro_torch.core.cost_model import ZYNQ7020
    from repro_torch.core.graph import resnet18_graph
    from repro_torch.core.scheduler import auto_schedule

    g = resnet18_graph()
    picks = []
    for n in (1, 2, 4, 8, 12):
        choice = auto_schedule(g, n, ZYNQ7020)
        picks.append(f"N={n} {choice.plan.strategy} {choice.result.avg_ms_per_image:.2f}")
    log(f"[planner] ResNet-18 graph ({g.total_macs / 1e9:.4f} GMAC, {len(g)} ops), "
        f"auto_schedule on simulated Zynq-7020 boards (strategy, simulated ms/image): "
        + "; ".join(picks))


# flash at the other configs' full-width layer shapes, f32: a 512-row
# prefill chunk at q_offset 512 over 1024 live keys (mixtral's at q_offset
# 4096 over 4608, its 4096-key window biting), and MLA's prefill (G 1,
# D = dn + dr = 192, Dv 128, scale 192^-0.5)
FLASH_FAMILY = [
    ("yi_34b G 7", dict(h=56, hkv=8, d=128, dv=128), dict(q_offset=512, kv_len=1024)),
    ("qwen2_72b G 8", dict(h=64, hkv=8, d=128, dv=128), dict(q_offset=512, kv_len=1024)),
    ("starcoder2_15b G 12", dict(h=48, hkv=4, d=128, dv=128), dict(q_offset=512, kv_len=1024)),
    ("mixtral_8x22b G 6 window 4096", dict(h=48, hkv=8, d=128, dv=128),
     dict(q_offset=4096, kv_len=4608, window=4096)),
    ("deepseek_v2_236b MLA G 1 D 192 Dv 128", dict(h=128, hkv=128, d=192, dv=128),
     dict(q_offset=512, kv_len=1024, scale=192 ** -0.5)),
]


def flash_family_phase(torch, gen, dev, card: str) -> float:
    """Flash at FLASH_FAMILY's shapes (batch 2): one launch each, within
    TOL of its plain version, then timed beside the plain version, SDPA on
    the same inputs (K/V repeated to H heads, the same mask and scale) and
    its bound.  Returns the largest error."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    b, s = 2, CHUNK
    worst = 0.0
    for name, sh, opts in FLASH_FAMILY:
        h, hkv, d, dv = sh["h"], sh["hkv"], sh["d"], sh["dv"]
        t, q_off, window = opts["kv_len"], opts["q_offset"], opts.get("window", 0)
        q = torch.randn((b, s, h, d), generator=gen, device=dev)
        k = torch.randn((b, t, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, t, hkv, dv), generator=gen, device=dev)
        n0 = flash_attention.launches
        got = flash_attention(q, k, v, **opts)
        want = flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(flash_attention.launches == n0 + 1 and bool(torch.isfinite(got).all()),
              f"flash {name}: one launch, finite")
        check(err <= TOL["float32"], f"flash {name}: max|err| {err} > {TOL['float32']}")
        worst = max(worst, err)
        kv_pos = torch.arange(t, device=dev)[None, :]
        q_pos = q_off + torch.arange(s, device=dev)[:, None]
        mask = (kv_pos <= q_pos) & ((kv_pos > q_pos - window) if window else True)
        qt = q.transpose(1, 2)
        kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        ms = cuda_ms(torch, lambda _: flash_attention(q, k, v, **opts))
        plain = cuda_ms(torch, lambda _: flash_attention_ref(q, k, v, **opts), reps=3)
        lib = cuda_ms(torch, lambda _: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=opts.get("scale")))
        flops, nbytes = flash_work(b, s, h, hkv, d, dv, q_off, t, 4, window=window)
        bnd, by = bound_ms(3 * flops, nbytes, "tf32")
        log(f"[time] flash {name} (B {b}, S {s}, H {h}, Hkv {hkv}, q_offset {q_off}, kv_len "
            f"{t}) f32: max|err| vs plain {err:.3e} (tol {TOL['float32']}); kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}, 3xTF32); "
            f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s; on {card}")
        del q, k, v, qt, kt, vt, got, want
    return worst


# ---------------------------------------------------------------------------
# the MoE family: deepseek_v2_236b and mixtral_8x22b at full width
# ---------------------------------------------------------------------------

# every width is the published config's; the one cut is depth, to 2 layers
MOE_LAYERS = 2
# static path: (batch, prompt, prefill chunk, new tokens).  deepseek's two
# 512-token chunks run flash at MLA's shape (G 1, D 192, Dv 128) and its
# decode the absorbed dense kernel (G 128, D 576, Dv 512); mixtral's
# 4608-token prompt passes its 4096-token window, so its rolling buffer
# wraps (that branch runs no kernel, in the reference either)
MOE_STATIC = {"deepseek_v2_236b": (2, 1024, 512, 16), "mixtral_8x22b": (2, 4608, 512, 16)}
# engine traces: (requests, shortest and longest prompt, shared prefix):
# deepseek's prompts share a 512-token prefix every other request (prefix
# cache on); mixtral's pass the window, so the paged kernel's window bites
MOE_ENGINE = {"deepseek_v2_236b": (8, 512, 1024, 512), "mixtral_8x22b": (4, 4200, 4608, 0)}
MOE_ENGINE_KW = dict(max_slots=4, page_size=16, prefill_chunk=ENGINE["prefill_chunk"])
# a router choice may differ between two runs only where the reference's
# k-th and (k+1)-th probabilities are this close (a near tie the ~1e-6
# attention differences can cross)
ROUTE_TIE = 1e-5


@contextlib.contextmanager
def routing_record(calls: list):
    """Record every MoE router's choice while the block runs: per call, the
    chosen experts (N, k) and the gap between the k-th and (k+1)-th
    probability (N,)."""
    from repro_torch.models import moe

    top_k = moe.top_k

    def recording(probs, k):
        vals, idx = top_k(probs, k + 1)
        calls.append((idx[:, :k].clone(), (vals[:, k - 1] - vals[:, k]).clone()))
        return vals[:, :k], idx[:, :k]

    moe.top_k = recording
    try:
        yield calls
    finally:
        moe.top_k = top_k


def routing_flips(got: list, ref: list):
    """Per router call, the token rows whose chosen experts differ, and the
    reference's gap at each; the two runs must make the same calls."""
    check(len(got) == len(ref) and all(a[0].shape == b[0].shape for a, b in zip(got, ref)),
          "the two runs route the same calls")
    flips = []
    for ci, ((gi, _), (ri, rgap)) in enumerate(zip(got, ref)):
        rows = (gi != ri).any(dim=1).nonzero().flatten()
        flips += [(ci, int(r), rgap[r].item()) for r in rows]
    return flips


def kernel_counts() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vta_gemm import vta_gemm

    return {"flash_attention": flash_attention.launches,
            "decode_attention": decode_attention.launches,
            "paged_decode_attention": paged_decode_attention.launches,
            "vta_gemm_none": vta_gemm.launches["none"],
            "vta_gemm_dequant": vta_gemm.launches["dequant"]}


def moe_gemms(cfg) -> int:
    """VTA GEMM launches (epilogue none) of one int8 forward call: the
    three projections of every routed and shared expert, one launch each."""
    return 3 * (cfg.moe_experts + cfg.moe_shared_experts) * cfg.num_layers


def dequants(cfg, absorbed: bool) -> int:
    """Dequant GEMM launches of one int8 forward call: each quantized
    projection (an absorbed MLA step folds wuk / wuv into einsums on their
    dequantized weights), the router and an untied head."""
    attn = ((3 if absorbed else 5) + bool(cfg.q_lora_rank)) if cfg.uses_mla else 4
    ffn = 1 if cfg.moe_experts else 3
    return cfg.num_layers * (attn + ffn) + (0 if cfg.tie_embeddings else 1)


def moe_static_phase(torch, params, cfg, dev, card: str, int8: bool = False) -> dict:
    """The static path at full width: launches exact, finite logits of the
    right shape; f32 teacher-forced logits within LOGIT_TOL of a run on
    the plain versions with the same routing (a choice that differs must
    sit at a near tie, and its sequence is held by its tokens' margins
    instead), int8 logits bitwise equal to a run with the GEMMs on their
    plain version; then a warm timed run and a profile of the prefill and
    of 8 decode steps.  Returns the launch counts."""
    from repro_torch.launch.serve import run_static
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.models.attention import FLASH_MIN_SEQ
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    batch, prompt, chunk, new = MOE_STATIC[cfg.name]
    tag = f"[moe {cfg.name} {'int8' if int8 else 'f32'} static]"
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device=dev)
    n_chunks, steps, nl = -(-prompt // chunk), new - 1, cfg.num_layers
    # the dense SWA cache is a rolling buffer, whose branch runs no kernel
    rolling = bool(cfg.sliding_window)
    expect = {"flash_attention": 0 if rolling or chunk < FLASH_MIN_SEQ else nl * n_chunks,
              "decode_attention": 0 if rolling else nl * steps,
              "paged_decode_attention": 0,
              "vta_gemm_none": moe_gemms(cfg) * (n_chunks + steps) if int8 else 0,
              "vta_gemm_dequant": (n_chunks * dequants(cfg, False)
                                   + steps * dequants(cfg, True)) if int8 else 0}
    check(layers.attention_impl() == "auto" and layers.gemm_impl() == "auto",
          f"{tag} runs with attention and gemm impl auto")
    routes = []
    reset_counts()
    with routing_record(routes):
        res = run_static(params, cfg, prompts, new_tokens=new, chunk=chunk, return_logits=True)
    counts = kernel_counts()
    log(f"{tag} batch {batch}, prompt {prompt} in {n_chunks} chunks of {chunk}, {new} new "
        f"tokens; launches {counts} (expect {expect}); MoE GEMM launches per forward call "
        f"{moe_gemms(cfg) if int8 else 0}")
    check(counts == expect, f"{tag} every kernel of the path launched as expected")
    tokens = res["tokens"]
    logits = torch.stack(res["logits"], dim=1)
    check(tokens.shape == (batch, new) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab, f"{tag} tokens of shape (B, new) in the vocabulary")
    check(logits.shape == (batch, new, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"{tag} finite logits of shape (B, new, vocab)")

    def teacher_forced(record):
        """(B, new, vocab) logits of the path fed the run's tokens."""
        with torch.inference_mode(), routing_record(record):
            caches = tf.init_caches(cfg, batch, n_chunks * chunk + new, torch.float32, dev)
            _, lg, caches = make_prefill_step(cfg, chunk, return_logits=True)(
                params, prompts, caches)
            out = [lg[:, -1]]
            step = make_serve_step(cfg, return_logits=True)
            for i in range(steps):
                _, lg, caches = step(params, tokens[:, i:i + 1], caches)
                out.append(lg[:, -1])
        return torch.stack(out, dim=1)

    ref_routes = []
    if int8:
        prev = layers.set_gemm_impl("ref")
        try:
            ref = teacher_forced(ref_routes)
        finally:
            layers.set_gemm_impl(prev)
        check(kernel_counts()["vta_gemm_none"] == counts["vta_gemm_none"],
              f"{tag} the plain-GEMM run launched no GEMM kernel")
        err = (logits - ref).abs().max().item()
        log(f"{tag} teacher-forced logits vs the run with the GEMMs on their plain version: "
            f"max|err| {err:.3e} (bitwise expected), routing equal: "
            f"{not routing_flips(routes, ref_routes)}")
        check(torch.equal(logits, ref) and not routing_flips(routes, ref_routes),
              f"{tag} logits and routing equal to the plain-GEMM run")
    else:
        with plain_versions():
            ref = teacher_forced(ref_routes)
        check(kernel_counts() == counts, f"{tag} the reference run launched no kernel")
        flips = routing_flips(routes, ref_routes)
        check(all(gap <= ROUTE_TIE for _, _, gap in flips),
              f"{tag} a router choice differs from the reference's away from a tie: {flips}")
        # a flipped token's row: prefill calls route (B * chunk) tokens, decode calls B
        n_pre = len(routes) - nl * steps
        bad = {(r // chunk if ci < n_pre else r) for ci, r, _ in flips}
        ok = [i for i in range(batch) if i not in bad]
        err = (logits[ok] - ref[ok]).abs().max().item() if ok else 0.0
        log(f"{tag} teacher-forced logits vs the plain-version run: max|err| {err:.3e} "
            f"(tol {LOGIT_TOL}) over rows {ok}; |logits| max {logits.abs().max().item():.3f}; "
            f"router choices equal but {len(flips)} near ties {flips[:4]}")
        check(err <= LOGIT_TOL, f"{tag} logits vs the plain-version run: {err} > {LOGIT_TOL}")
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL
        agree = tokens == ref.argmax(-1)
        check(bool(agree[ok][decided[ok]].all()), f"{tag} greedy token differs at a clear margin")
        # the [tp] phase holds its per-position run to these tokens
        run2 = logits.topk(2, dim=-1).values
        MOE_TOKENS[cfg.name] = (tokens.tolist(), (run2[..., 0] - run2[..., 1]).tolist())

    warm = run_static(params, cfg, prompts, new_tokens=new, chunk=chunk)
    log(f"[time] {tag[1:-1]}: prefill {batch}x{prompt} {warm['prefill_s'] * 1e3:.2f} ms "
        f"({warm['prefill_s'] * 1e3 / n_chunks:.2f} ms per {chunk}-token chunk); decode "
        f"{steps} steps {warm['decode_s'] / steps * 1e3:.2f} ms/step "
        f"({batch * steps / warm['decode_s']:.1f} tok/s); on {card}")
    caches = tf.init_caches(cfg, batch, n_chunks * chunk + 8, torch.float32, dev)
    prefill_step, serve_step = make_prefill_step(cfg, chunk), make_serve_step(cfg)
    state = {}

    @torch.inference_mode()
    def run_prefill():
        state["tok"], state["caches"] = prefill_step(params, prompts, caches)

    @torch.inference_mode()
    def run_decode(n=8):
        tok, c = state["tok"][:, None], state["caches"]
        for _ in range(n):
            tok, c = serve_step(params, tok, c)

    for phase, fn in ((f"prefill {n_chunks} chunks", run_prefill), ("decode 8 steps", run_decode)):
        wall, busy, top = device_breakdown(torch, fn)
        log(f"[profile] {tag[1:-1]} {phase}: wall {wall * 1e3:.2f} ms (profiled), device "
            f"kernels {busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %")
        for name, us, calls in top:
            log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    return counts


def moe_trace(vocab: int, n: int, lo: int, hi: int, shared: int, seed: int = 3):
    """An MoE engine trace: (prompt, max_new, priority, arrival step).
    Prompts of lo-hi tokens, 8-16 new tokens, one arrival every 2 steps;
    with ``shared``, every other prompt starts with one shared prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, shared)
    reqs = []
    for i in range(n):
        share = shared and i % 2
        prompt = rng.integers(0, vocab, int(rng.integers(shared + 64 if share else lo, hi + 1)))
        if share:
            prompt[:shared] = pre
        reqs.append((prompt.astype(np.int32), int(rng.integers(8, 17)), 0, 2 * i))
    return reqs


def moe_engine_phase(torch, params, cfg, dev, card: str, int8: bool = False) -> dict:
    """The paged ``ServingEngine`` at full width (int8: int8 weights on
    int8 pools): launches exact against ``engine.stats()``, the audit green
    on every step, no page leaked, prefix hits where prompts share a
    prefix; tokens equal to a run on the plain versions under the margin
    rule (int8: tokens and counters equal to a run with the GEMMs on their
    plain version); the timing line and a profile of decode-only steps.
    Returns the launch counts."""
    from repro_torch.models import layers
    from repro_torch.models.attention import FLASH_MIN_SEQ
    from repro_torch.serve.engine import ServingEngine, latency_stats
    from repro_torch.serve.kv_cache import pages_for

    n, lo, hi, shared = MOE_ENGINE[cfg.name]
    tag = f"[moe {cfg.name} {'int8' if int8 else 'f32'} engine]"
    reqs = moe_trace(cfg.vocab, n, lo, hi, shared)
    max_len = hi + 17
    kw = dict(MOE_ENGINE_KW, max_len=max_len, aging_s=None, prefix_cache=bool(shared),
              kv_dtype="int8" if int8 else "f32")
    if shared:  # room for retired prefixes in the tree
        kw["num_pages"] = 2 * kw["max_slots"] * pages_for(max_len, kw["page_size"])
    log(f"{tag} trace: {len(reqs)} requests, prompts {[len(r[0]) for r in reqs]}, max_new "
        f"{[r[1] for r in reqs]}, one arrival every 2 steps; {kw}")

    def engine():
        return ServingEngine(params, cfg, **kw)

    reset_counts()
    eng = engine()
    toks, done, secs = drive_engine(eng, reqs)
    counts = kernel_counts()
    est = eng.stats()
    nl, steps, chunks = cfg.num_layers, est["steps"], est["prefill_chunk_calls"]
    flash = not cfg.sliding_window and kw["prefill_chunk"] >= FLASH_MIN_SEQ
    expect = {"flash_attention": nl * chunks if flash else 0,
              "decode_attention": 0, "paged_decode_attention": nl * steps,
              "vta_gemm_none": moe_gemms(cfg) * (chunks + steps) if int8 else 0,
              "vta_gemm_dequant": (chunks * dequants(cfg, False)
                                   + steps * dequants(cfg, True)) if int8 else 0}
    log(f"{tag} stats: {est}")
    log(f"{tag} launches {counts} (expect {expect} from {steps} decode steps and {chunks} "
        f"prefill calls); MoE GEMM launches per decode step {moe_gemms(cfg) if int8 else 0}")
    check(counts == expect, f"{tag} every kernel of the path launched as expected")
    pools = {"kv_pages"} if cfg.uses_mla else {"k_pages", "v_pages"}
    if int8:
        pools |= {k.replace("pages", "scales") for k in pools}
    check(set(eng.blocks[0]) == pools, f"{tag} pools {sorted(eng.blocks[0])}")
    check(len(done) == len(reqs) and all(len(r.tokens) == r.max_new for r in done),
          f"{tag} every request finished with its max_new tokens")
    check(all(0 <= t < cfg.vocab for ts in toks.values() for t in ts), f"{tag} token ids in vocab")
    check(not shared or est["prefix_hits"] >= 1, f"{tag} the trace hits the prefix cache")
    audit = eng.audit()
    held = len(eng.prefix.pages()) if eng.prefix is not None else 0
    check(eng.allocator.num_free + held == eng.num_pages and (eng.block_tables == -1).all(),
          f"{tag} every page not held by the radix tree is free")
    log(f"{tag} audit after run: {audit}, {eng.allocator.num_free} free + {held} held by the "
        f"radix tree = {eng.num_pages} pages")
    lat = latency_stats(done)
    del eng
    if int8:
        prev = layers.set_gemm_impl("ref")
        try:
            eng = engine()
            ref_toks, _, ref_s = drive_engine(eng, reqs)
            ref_stats = eng.stats()
            del eng
        finally:
            layers.set_gemm_impl(prev)
        same = sum(ref_toks[rid] == toks[rid] for rid in toks)
        log(f"{tag} tokens vs the same trace with the GEMMs on their plain version "
            f"({ref_s:.2f} s): {same}/{len(toks)} requests equal, stats equal: "
            f"{_counters(ref_stats) == _counters(est)}")
        check(same == len(toks) and _counters(ref_stats) == _counters(est),
              f"{tag} tokens and counters equal to the plain-GEMM run")
    else:
        with plain_versions():
            eng = engine()
            ref_toks, _, ref_s = drive_engine(eng, reqs)
            del eng
        check(kernel_counts() == counts, f"{tag} the reference run launched no kernel")
        diverged = margin_check(torch, params, cfg, dev, reqs, toks, ref_toks, tag[1:-1],
                                LOGIT_TOL)
        log(f"{tag} tokens vs a run on the plain versions ({ref_s:.2f} s): "
            f"{len(ref_toks) - diverged}/{len(ref_toks)} requests equal, {diverged} diverge "
            f"where the reference's margin <= {LOGIT_TOL}")
    log(f"[time] {tag[1:-1]}: {len(reqs)} requests, {lat['tokens']} tokens in {secs:.3f} s "
        f"({lat['tokens'] / secs:.1f} tok/s) over {steps} decode steps, {chunks} prefill "
        f"calls; TTFT p50 {lat['ttft_p50_s'] * 1e3:.1f} ms, p99 {lat['ttft_p99_s'] * 1e3:.1f} ms; "
        f"token latency p50 {lat['token_p50_s'] * 1e3:.1f} ms, p99 "
        f"{lat['token_p99_s'] * 1e3:.1f} ms; on {card}")

    # a decoding step's time: every slot decoding (1 + 16 steps of 32 tokens)
    eng = ServingEngine(params, cfg, max_len=hi + 40, kv_dtype=kw["kv_dtype"], **MOE_ENGINE_KW)
    for prompt, _, _, _ in reqs[:MOE_ENGINE_KW["max_slots"]]:
        eng.submit(prompt, 32)
    eng.step()  # admits and prefills every slot, then one decode step
    check(all(sl.decoding for sl in eng.slots), f"{tag} the profiled steps decode every slot")

    def engine_steps(k=8):
        for _ in range(k):
            eng.step()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine_steps()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    wall, busy, top = device_breakdown(torch, engine_steps)
    log(f"[time] {tag[1:-1]} decode-only steps at {len(eng.slots)} slots: {step_ms:.2f} ms/step; "
        f"[profile] 8 steps: wall {wall * 1e3:.2f} ms (profiled), device kernels "
        f"{busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %; on {card}")
    for name, us, calls in top:
        log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    del eng
    return counts


def moe_phases(torch, dev, card: str) -> dict:
    """deepseek_v2_236b (f32 static and engine, then int8 weights on int8
    pools) and mixtral_8x22b (f32 static and engine) at full width, depth
    cut to MOE_LAYERS, random weights from the port's ``init`` on a seeded
    generator on the card; each model is freed before the next.  Returns
    {path: launch counts}."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params

    out = {}
    for name in ("deepseek_v2_236b", "mixtral_8x22b"):
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tf.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in leaves(params))
        log(f"[moe] {name} full width, {cfg.num_layers} layers (cut from "
            f"{full.num_layers}): d_model {cfg.d_model}, heads {cfg.num_heads}/{cfg.kv_heads}, "
            f"experts {cfg.moe_experts} top-{cfg.moe_top_k} + {cfg.moe_shared_experts} shared, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params / 1e9:.3f} B f32 params made in "
            f"{time.perf_counter() - t0:.2f} s; device memory "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")
        out[f"{name} f32 static"] = moe_static_phase(torch, params, cfg, dev, card)
        out[f"{name} f32 engine"] = moe_engine_phase(torch, params, cfg, dev, card)
        if cfg.uses_mla:
            qparams = quantize_params(params)
            del params
            torch.cuda.empty_cache()
            out[f"{name} int8 static"] = moe_static_phase(torch, qparams, cfg, dev, card, int8=True)
            out[f"{name} int8 engine"] = moe_engine_phase(torch, qparams, cfg, dev, card, int8=True)
            del qparams
        else:
            del params
        torch.cuda.empty_cache()
        log(f"[moe] {name}: peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
        torch.cuda.reset_peak_memory_stats()
    return out


# ---------------------------------------------------------------------------
# the remaining families: mamba2_2p7b (SSD), zamba2_2p7b (hybrid shared
# attention), seamless_m4t_large_v2 (enc-dec) and internvl2_76b (VLM)
# ---------------------------------------------------------------------------

FAMILY_BATCH, FAMILY_CHUNK, FAMILY_NEW = 2, 512, 16
# arch -> (prompt tokens, encoder frames or patch embeddings, depth: None
# keeps the config's).  internvl2's 80 layers need ~274 GB in f32, more than
# the card holds: 2, as the MoE slice.  mamba2 and zamba2 run the launcher's
# static path; seamless and internvl2 ``serve.step.generate``
# (prompt, frames or patch embeddings, depth): the depth cuts keep the whole
# run under 900 s (mamba2 64 -> 16 layers, zamba2 54 -> 12: two groups of
# six around the shared block, seamless's decoder 24 -> 12 before its 24
# encoder layers; internvl2 80 -> 2, as its f32 weights would not fit)
FAMILIES = {"mamba2_2p7b": (2048, 0, 16), "zamba2_2p7b": (2048, 0, 12),
            "seamless_m4t_large_v2": (1024, 1024, 12), "internvl2_76b": (1536, 256, 2)}
# mamba2's gates: the four-chunk prefill against one 2048-token pass, and
# prefill(2047) + one decode step against prefill(2048), relative to the
# largest |logit|; the SSM and conv states relative to their largest
# element; ssd_chunked in f32 against the f64 recurrence, to max|y|
SSM_LOGIT_TOL, SSM_STATE_TOL, SSD_F64_TOL = 1e-3, 1e-4, 1e-4

# the kernels at the families' new shapes (batch 2, f32), each at the
# path's own buffers: (label, q/k shape, call options, cold): zamba2's
# shared block at its last prompt chunk (G 1, D 80); seamless's encoder
# (bidirectional S = T = 1024) and its cross-attention at prefill (S 512)
# and at every decode step (S 1, K/V cycled past the L2, as each layer
# reads its own); internvl2's first chunk (256 patch embeddings + 512
# tokens, G 8)
FAMILY_FLASH = [
    ("zamba2 G 1 D 80", dict(s=512, t=2064, h=32, hkv=32, d=80),
     dict(q_offset=1536, kv_len=2048), False),
    ("seamless encoder S 1024 T 1024 bidirectional", dict(s=1024, t=1024, h=16, hkv=16, d=64),
     dict(bidirectional=True), False),
    ("seamless cross S 512 T 1024 bidirectional", dict(s=512, t=1024, h=16, hkv=16, d=64),
     dict(bidirectional=True), False),
    ("seamless cross S 1 T 1024 bidirectional", dict(s=1, t=1024, h=16, hkv=16, d=64),
     dict(bidirectional=True), True),
    ("internvl2 G 8 first chunk S 768", dict(s=768, t=1808, h=64, hkv=8, d=128),
     dict(q_offset=0, kv_len=768), False),
]
# dense decode at each path's middle step: (label, shape, kv_len)
FAMILY_DECODE = [
    ("zamba2 G 1 D 80", dict(h=32, hkv=32, d=80, t=2064), 2056),
    ("seamless G 1 D 64", dict(h=16, hkv=16, d=64, t=1040), 1032),
    ("internvl2 G 8 D 128", dict(h=64, hkv=8, d=128, t=1808), 1800),
]


def family_kernel_phase(torch, gen, dev, card: str) -> dict:
    """Flash and dense decode at FAMILY_FLASH's and FAMILY_DECODE's shapes,
    before any of the families' models runs: one launch each, finite,
    within TOL of the plain version; then the kernel's graph-replay time
    beside the eager plain version, SDPA (graph replay; K/V heads repeated
    to H, the same mask) and the bound.  At seamless's S 1 cross-attention
    the dense decode kernel is timed on the same K/V too (one query
    attending every live key is its function), beside its byte bound.
    Returns the largest errors by kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    b = FAMILY_BATCH
    worst = {"flash_attention": 0.0, "decode_attention": 0.0}
    for label, sh, opts, cold in FAMILY_FLASH:
        s, t, h, hkv, d = sh["s"], sh["t"], sh["h"], sh["hkv"], sh["d"]
        kv_len, bidir = opts.get("kv_len", t), opts.get("bidirectional", False)
        n = cold_copies(2 * b * t * hkv * d * 4) if cold else 1
        q = torch.randn((b, s, h, d), generator=gen, device=dev)
        kvs = [(torch.randn((b, t, hkv, d), generator=gen, device=dev),
                torch.randn((b, t, hkv, d), generator=gen, device=dev)) for _ in range(n)]
        k, v = kvs[0]
        n0 = flash_attention.launches
        got = flash_attention(q, k, v, **opts)
        want = flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(flash_attention.launches == n0 + 1 and bool(torch.isfinite(got).all()),
              f"flash {label}: one launch, finite")
        check(err <= TOL["float32"], f"flash {label}: max|err| {err} > {TOL['float32']}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        mask = None
        if not bidir:
            mask = (torch.arange(kv_len, device=dev)[None, :]
                    <= opts["q_offset"] + torch.arange(s, device=dev)[:, None])
        g = h // hkv
        qt = q.transpose(1, 2)
        kt = [k_[:, :kv_len].repeat_interleave(g, dim=2).transpose(1, 2) for k_, _ in kvs]
        vt = [v_[:, :kv_len].repeat_interleave(g, dim=2).transpose(1, 2) for _, v_ in kvs]
        ms = graph_ms(torch, lambda i: flash_attention(q, *kvs[i % n], **opts), reps=20)
        lib = graph_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt[i % n], vt[i % n], attn_mask=mask), reps=20)
        plain = cuda_ms(torch, lambda i: flash_attention_ref(q, *kvs[i % n], **opts), reps=3)
        flops, nbytes = flash_work(b, s, h, hkv, d, d, opts.get("q_offset", 0), kv_len, 4,
                                   bidirectional=bidir)
        bnd, by = bound_ms(3 * flops, nbytes, "tf32")
        extra = ""
        if s == 1:
            dms = graph_ms(torch, lambda i: decode_attention(q, *kvs[i % n], kv_len=kv_len),
                           reps=20)
            derr = (decode_attention(q, k, v, kv_len=kv_len) - want).abs().max().item()
            check(derr <= TOL["float32"], f"decode on {label}'s K/V: max|err| {derr}")
            dbnd, dby = bound_ms(*decode_work(b, h, hkv, d, d, kv_len, 4), "float32")
            extra = (f"; the dense decode kernel on the same K/V {dms:.4f} ms (max|err| vs "
                     f"flash's plain version {derr:.3e}), its bound {dbnd:.4f} ms ({dby})")
        log(f"[time] flash {label} (B {b}, H {h}, Hkv {hkv}, D {d}, kv_len {kv_len}"
            f"{f', {n} K/V copies cycled' if cold else ''}) f32: max|err| vs plain {err:.3e} "
            f"(tol {TOL['float32']}); kernel {ms:.4f} ms (graph replay), plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms (graph replay), bound {bnd:.4f} ms ({by}, 3xTF32; "
            f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB){extra}; on {card}")
        del q, kvs, k, v, kt, vt, qt, got, want

    for label, sh, kv_len in FAMILY_DECODE:
        h, hkv, d, t = sh["h"], sh["hkv"], sh["d"], sh["t"]
        n = cold_copies(2 * b * t * hkv * d * 4)
        q = torch.randn((b, 1, h, d), generator=gen, device=dev)
        kvs = [(torch.randn((b, t, hkv, d), generator=gen, device=dev),
                torch.randn((b, t, hkv, d), generator=gen, device=dev)) for _ in range(n)]
        n0 = decode_attention.launches
        got = decode_attention(q, *kvs[0], kv_len=kv_len)
        want = decode_attention_ref(q, *kvs[0], kv_len=kv_len)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(decode_attention.launches == n0 + 1 and bool(torch.isfinite(got).all()),
              f"decode {label}: one launch, finite")
        check(err <= TOL["float32"], f"decode {label}: max|err| {err} > {TOL['float32']}")
        worst["decode_attention"] = max(worst["decode_attention"], err)
        g = h // hkv
        qt = q.transpose(1, 2)
        kt = [k_[:, :kv_len].repeat_interleave(g, dim=2).transpose(1, 2) for k_, _ in kvs]
        vt = [v_[:, :kv_len].repeat_interleave(g, dim=2).transpose(1, 2) for _, v_ in kvs]
        ms = graph_ms(torch, lambda i: decode_attention(q, *kvs[i % n], kv_len=kv_len), reps=50)
        lib = graph_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt[i % n], vt[i % n]),
                       reps=50)
        plain = cuda_ms(torch, lambda i: decode_attention_ref(q, *kvs[i % n], kv_len=kv_len),
                        reps=5)
        bnd, by = bound_ms(*decode_work(b, h, hkv, d, d, kv_len, 4), "float32")
        log(f"[time] decode {label} (B {b}, H {h}, Hkv {hkv}, T {t}, kv_len {kv_len}, {n} K/V "
            f"copies cycled) f32: max|err| vs plain {err:.3e} (tol {TOL['float32']}); kernel "
            f"{ms:.4f} ms (graph replay), plain {plain:.4f} ms, sdpa {lib:.4f} ms (graph "
            f"replay), bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f} % of the bound; on {card}")
        del q, kvs, kt, vt, qt, got, want
    return worst


def family_expect(cfg, chunks: int, steps: int, int8: bool) -> dict:
    """The launch counts of one family path: flash per attention layer and
    prefill chunk (enc-dec: also each encoder layer once, and the
    cross-attention at every chunk and decode step), dense decode per
    attention layer and step, the dequant GEMM per quantized projection
    (Mamba2's in/out, the shared block's seven, the head) and call."""
    groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    attn_layers = groups or (0 if cfg.ssm_state else cfg.num_layers)
    flash = attn_layers * chunks
    if cfg.is_enc_dec:
        flash += cfg.encoder_layers + cfg.num_layers * (chunks + steps)
    deq = (2 * cfg.num_layers + 7 * groups + 1) * (chunks + steps) if int8 else 0
    return {"flash_attention": flash, "decode_attention": attn_layers * steps,
            "paged_decode_attention": 0, "vta_gemm_none": 0, "vta_gemm_dequant": deq}


def family_inputs(torch, cfg, dev, prompt: int, side: int):
    """Prompts (seed 1) and the frontend stub's input (seed 2): encoder
    frames for an enc-dec config, patch embeddings for a VLM, else None."""
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (FAMILY_BATCH, prompt), generator=gen, device=dev)
    extra = None
    if side:
        gen = torch.Generator(device=dev).manual_seed(2)
        extra = torch.randn((FAMILY_BATCH, side, cfg.d_model), generator=gen, device=dev)
    return prompts, extra


def family_steps(cfg, extra, return_logits: bool = False):
    """(prefill, step) over the path's own entry points: ``prefill(params,
    prompts, caches)`` -> (tok, logits or None, caches, cross K/V or None)
    and ``step(params, tok, caches, kv)``."""
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    kw = {}
    if extra is not None:
        kw = {"frames": extra} if cfg.is_enc_dec else {"embeds": extra}
    pre = make_prefill_step(cfg, FAMILY_CHUNK, return_logits=return_logits)

    def prefill(params, prompts, caches):
        out = pre(params, prompts, caches, **kw)
        kv = out[-1] if cfg.is_enc_dec else None
        out = out[:-1] if cfg.is_enc_dec else out
        return out[0], (out[1] if return_logits else None), out[-1], kv

    return prefill, make_serve_step(cfg, return_logits=return_logits)


def family_caches(torch, cfg, dev, max_len: int):
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf

    return (encdec if cfg.is_enc_dec else tf).init_caches(cfg, FAMILY_BATCH, max_len,
                                                          torch.float32, dev)


def ssm_gates(torch, params, cfg, dev, prompts) -> None:
    """mamba2 at full depth: the four-chunk prefill against one 2048-token
    pass (last logits; every layer's SSM and conv states, each layer's
    block on the one-pass run's own input to it, since through the whole
    stack the GEMMs' rounding at another M grows layer by layer), prefill(2047)
    (three chunks and an exact-size 511-token pass, whose SSD runs at chunk
    1 by the reference's rule) plus one decode step against prefill(2048),
    and one full-width layer's ``ssd_chunked`` (B 2, L 2048, H 80, P 64,
    N 128) against ``ssd_reference`` run in f64 on the card."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import embedding_apply, rmsnorm_apply
    from repro_torch.serve.step import make_prefill_step

    tag = f"[ssm {cfg.name}]"
    s = prompts.shape[1]
    with torch.inference_mode():
        _, lg4, c4 = make_prefill_step(cfg, FAMILY_CHUNK, return_logits=True)(
            params, prompts, tf.init_caches(cfg, FAMILY_BATCH, 0, torch.float32, dev))
        _, lg1, c1 = make_prefill_step(cfg, s, return_logits=True)(
            params, prompts, tf.init_caches(cfg, FAMILY_BATCH, 0, torch.float32, dev))
        scale = lg1.abs().max().item()
        err = (lg4 - lg1).abs().max().item()
        states, per_layer = {}, {}
        for name in ("ssm", "conv"):
            per_layer[name] = [(a[name] - b_[name]).abs().max().item()
                               / b_[name].abs().max().item()
                               for a, b_ in zip(c4["blocks"], c1["blocks"])]
            states[name] = max(per_layer[name])
        log(f"{tag} {s // FAMILY_CHUNK}-chunk prefill vs one {s}-token pass: last logits "
            f"max|err| {err:.3e} ({err / scale:.3e} of max|logit| {scale:.3f}; tol "
            f"{SSM_LOGIT_TOL}); through the whole stack, each layer's state error / its max "
            f"(every 8th layer; the GEMMs' rounding at another M, grown over the layers): "
            + "; ".join(f"{name} " + " ".join(f"{e:.1e}" for e in errs[::8])
                        + f" (worst {states[name]:.3e})" for name, errs in per_layer.items()))
        check(err <= SSM_LOGIT_TOL * scale, f"{tag} chunked prefill logits vs one pass")
        del c4, c1
        # the state carried across chunks, layer by layer: each layer's
        # Mamba2 block over the four chunks against one pass, both on the
        # one-pass run's own input to that layer
        x = embedding_apply(params["embed"], prompts)
        for name in states:
            states[name] = 0.0
        for p in params["blocks"]:
            xin = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
            cache = ssm.mamba2_cache_init(cfg, FAMILY_BATCH, torch.float32, dev)
            h1, one = ssm.mamba2_apply(p["mixer"], cfg, xin, cache)
            for i in range(0, s, FAMILY_CHUNK):
                _, cache = ssm.mamba2_apply(p["mixer"], cfg, xin[:, i:i + FAMILY_CHUNK], cache)
            for name in states:
                states[name] = max(states[name], (cache[name] - one[name]).abs().max().item()
                                   / one[name].abs().max().item())
            x = x + h1
        log(f"{tag} each layer's Mamba2 block over {s // FAMILY_CHUNK} chunks vs one pass on "
            f"the same input: worst state error / its max: ssm {states['ssm']:.3e}, conv "
            f"{states['conv']:.3e} (tol {SSM_STATE_TOL})")
        check(max(states.values()) <= SSM_STATE_TOL, f"{tag} chunked prefill states vs one pass")
        del x, xin, cache, one, h1
        _, _, c = make_prefill_step(cfg, FAMILY_CHUNK, return_logits=True)(
            params, prompts[:, :s - 1], tf.init_caches(cfg, FAMILY_BATCH, 0, torch.float32, dev))
        lgd, c = tf.decode_step(params, cfg, prompts[:, s - 1:], c)
        err = (lgd[:, -1] - lg1[:, -1]).abs().max().item()
        log(f"{tag} prefill({s - 1}: {(s - 1) // FAMILY_CHUNK} chunks + an exact "
            f"{(s - 1) % FAMILY_CHUNK}-token pass at SSD chunk 1) + decode_step vs prefill({s}):"
            f" max|err| {err:.3e} ({err / scale:.3e} of max|logit|; tol {SSM_LOGIT_TOL})")
        check(err <= SSM_LOGIT_TOL * scale, f"{tag} decode consistency")
        del c
        gen = torch.Generator(device=dev).manual_seed(3)
        _, h, n = ssm._mamba2_dims(cfg)
        b, L, p = FAMILY_BATCH, s, cfg.ssm_head_dim
        x = torch.randn((b, L, h, p), generator=gen, device=dev)
        dt = torch.nn.functional.softplus(torch.randn((b, L, h), generator=gen, device=dev))
        a_log = torch.randn((h,), generator=gen, device=dev) * 0.5
        bm = torch.randn((b, L, n), generator=gen, device=dev)
        cm = torch.randn((b, L, n), generator=gen, device=dev)
        y, st = ssm.ssd_chunked(x, dt, a_log, bm, cm, chunk=128)
        y64, st64 = ssm.ssd_reference(x.double(), dt.double(), a_log.double(), bm.double(),
                                      cm.double())
        err = (y.double() - y64).abs().max().item() / y64.abs().max().item()
        serr = (st.double() - st64).abs().max().item() / st64.abs().max().item()
        log(f"{tag} ssd_chunked f32 (B {b}, L {L}, H {h}, P {p}, N {n}, chunk 128) vs the f64 "
            f"recurrence on the card: max|err| / max|y| {err:.3e}, final state {serr:.3e} "
            f"(tol {SSD_F64_TOL})")
        check(err <= SSD_F64_TOL and serr <= SSD_F64_TOL, f"{tag} ssd_chunked vs f64")


def family_phase(torch, params, cfg, dev, card: str, int8: bool = False) -> dict:
    """One family's path at full width: driven once through its entry
    points with every count at 0 (mamba2 / zamba2: the launcher's static
    path; seamless / internvl2: ``serve.step.generate`` with frames or
    patch embeddings), launches exact, finite logits or tokens of the right
    shape; then its gates (mamba2: ``ssm_gates``; int8: teacher-forced
    logits bitwise equal to the run with the GEMMs on their plain version;
    f32: within LOGIT_TOL of the run with every kernel on its plain
    version, greedy tokens equal where the margin is clear), a warm timed
    run and a profile of the prefill and of 8 decode steps.  Returns the
    launch counts."""
    from repro_torch.launch.serve import run_static
    from repro_torch.models import layers
    from repro_torch.serve.step import generate

    prompt, side, _ = FAMILIES[cfg.name]
    tag = f"[{cfg.family} {cfg.name} {'int8' if int8 else 'f32'}]"
    prompts, extra = family_inputs(torch, cfg, dev, prompt, side)
    chunks, steps = -(-prompt // FAMILY_CHUNK), FAMILY_NEW - 1
    static = extra is None
    max_len = (chunks * FAMILY_CHUNK if static else prompt + side) + FAMILY_NEW
    expect = family_expect(cfg, chunks, steps, int8)
    check(layers.attention_impl() == "auto" and layers.gemm_impl() == "auto",
          f"{tag} runs with attention and gemm impl auto")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if static:
        res = run_static(params, cfg, prompts, new_tokens=FAMILY_NEW, chunk=FAMILY_CHUNK,
                         return_logits=True)
        tokens, logits = res["tokens"], torch.stack(res["logits"], dim=1)
    else:
        kw = {"frames": extra} if cfg.is_enc_dec else {"embeds": extra}
        tokens = generate(params, cfg, prompts, FAMILY_NEW, max_len, torch.float32,
                          chunk=FAMILY_CHUNK, **kw)
        logits = None
    torch.cuda.synchronize()
    counts = kernel_counts()
    after = f" after {side} {'frames' if cfg.is_enc_dec else 'patch embeddings'}" if side else ""
    log(f"{tag} batch {FAMILY_BATCH}, prompt {prompt} in {chunks} chunks of {FAMILY_CHUNK}"
        f"{after}, {FAMILY_NEW} new tokens through {'run_static' if static else 'generate'} in "
        f"{time.perf_counter() - t0:.2f} s (first run); launches {counts} (expect {expect})")
    check(counts == expect, f"{tag} every kernel of the path launched as expected")
    check(tokens.shape == (FAMILY_BATCH, FAMILY_NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab, f"{tag} tokens of shape (B, new) in the vocabulary")
    prefill, step = family_steps(cfg, extra, return_logits=True)

    def teacher_forced():
        """(B, new, vocab) logits of the path fed the run's tokens."""
        with torch.inference_mode():
            _, lg, caches, kv = prefill(params, prompts, family_caches(torch, cfg, dev, max_len))
            out = [lg[:, -1]]
            for i in range(steps):
                _, lg, caches = step(params, tokens[:, i:i + 1], caches, kv)
                out.append(lg[:, -1])
        return torch.stack(out, dim=1)

    if logits is None:
        logits = teacher_forced()
    check(logits.shape == (FAMILY_BATCH, FAMILY_NEW, cfg.vocab)
          and bool(torch.isfinite(logits).all()), f"{tag} finite logits of shape (B, new, vocab)")
    check(bool((tokens == logits.argmax(-1)).all()), f"{tag} tokens are the logits' argmax")
    if cfg.ssm_state and not cfg.attn_every:
        ssm_gates(torch, params, cfg, dev, prompts)
    elif int8:
        prev = layers.set_gemm_impl("ref")
        try:
            ref = teacher_forced()
        finally:
            layers.set_gemm_impl(prev)
        err = (logits - ref).abs().max().item()
        log(f"{tag} teacher-forced logits vs the run with the GEMMs on their plain version: "
            f"max|err| {err:.3e} (bitwise expected)")
        check(torch.equal(logits, ref), f"{tag} logits equal to the plain-GEMM run")
    else:
        before = kernel_counts()
        with plain_versions():
            ref = teacher_forced()
        check(kernel_counts() == before, f"{tag} the reference run launched no kernel")
        err = (logits - ref).abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL
        agree = tokens == ref.argmax(-1)
        log(f"{tag} teacher-forced logits vs the run with every kernel on its plain version: "
            f"max|err| {err:.3e} (tol {LOGIT_TOL}), |logits| max {logits.abs().max().item():.3f};"
            f" greedy tokens equal at {int(agree.sum())}/{agree.numel()}, "
            f"{int(decided.sum())} with margin > tol")
        check(err <= LOGIT_TOL, f"{tag} logits vs the plain-version run: {err} > {LOGIT_TOL}")
        check(bool(agree[decided].all()), f"{tag} greedy token differs at a clear margin")
    del logits

    fast_prefill, fast_step = family_steps(cfg, extra)
    state = {}

    @torch.inference_mode()
    def run_prefill():
        caches = family_caches(torch, cfg, dev, max_len)
        state["tok"], _, state["caches"], state["kv"] = fast_prefill(params, prompts, caches)

    @torch.inference_mode()
    def run_decode(n):
        tok, c = state["tok"][:, None], state["caches"]
        for _ in range(n):
            tok, c = fast_step(params, tok, c, state["kv"])

    n_prof = min(8, steps)
    run_prefill()
    run_decode(n_prof)
    times = {}
    for name, fn in (("prefill", run_prefill), ("decode", lambda: run_decode(steps))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    log(f"[time] {tag[1:-1]}: prefill {FAMILY_BATCH}x{prompt} {times['prefill'] * 1e3:.2f} ms "
        f"({times['prefill'] * 1e3 / chunks:.2f} ms per {FAMILY_CHUNK}-token chunk"
        f"{', the encoder included' if cfg.is_enc_dec else ''}); decode {steps} steps "
        f"{times['decode'] / steps * 1e3:.2f} ms/step "
        f"({FAMILY_BATCH * steps / times['decode']:.1f} tok/s); on {card}")
    for phase, fn in ((f"prefill {chunks} chunks", run_prefill),
                      (f"decode {n_prof} steps", lambda: run_decode(n_prof))):
        wall, busy, top = device_breakdown(torch, fn)
        log(f"[profile] {tag[1:-1]} {phase}: wall {wall * 1e3:.2f} ms (profiled), device "
            f"kernels {busy * 1e3:.2f} ms, device idle {100 * (1 - busy / wall):.1f} %")
        for name, us, calls in top:
            log(f"[profile]   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    return counts


def family_phases(torch, dev, card: str) -> dict:
    """The four families at full width, depth cut per ``FAMILIES``, random
    f32 weights from the port's ``init`` on a seeded generator on the card,
    each freed before the next; zamba2 again on ``quantize_params`` weights.
    Returns {path: launch counts}."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params

    out = {}
    for name, (_, _, depth) in FAMILIES.items():
        full = get_config(name)
        cfg = full if depth is None else dataclasses.replace(full, num_layers=depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = (encdec if cfg.is_enc_dec else tf).init(
            cfg, generator=torch.Generator(device=dev).manual_seed(0), dtype=torch.float32,
            device=dev)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in leaves(params))
        cut = f" (cut from {full.num_layers})" if depth is not None else ""
        log(f"[{cfg.family}] {name} full width, {cfg.num_layers} layers{cut}"
            f"{f' + {cfg.encoder_layers} encoder layers' if cfg.is_enc_dec else ''}: d_model "
            f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.kv_heads}, d_ff {cfg.d_ff}, ssm_state "
            f"{cfg.ssm_state}, attn_every {cfg.attn_every}, vocab {cfg.vocab}: "
            f"{n_params / 1e9:.3f} B f32 params made in {time.perf_counter() - t0:.2f} s; "
            f"device memory {torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB")
        out[f"{name} f32"] = family_phase(torch, params, cfg, dev, card)
        if cfg.attn_every:
            qparams = quantize_params(params)
            del params
            torch.cuda.empty_cache()
            out[f"{name} int8"] = family_phase(torch, qparams, cfg, dev, card, int8=True)
            del qparams
        else:
            del params
        torch.cuda.empty_cache()
        log(f"[{cfg.family}] {name}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
    return out


# ---------------------------------------------------------------------------
# fault-tolerant serving ([serve-ft]) and single-device training ([train])
# ---------------------------------------------------------------------------

# the [serve-ft] runs: (label, fault plan, supervisor options, decode_nan
# steps); every step falls while slots decode (one arrival every two steps
# to 30).  A decode_nan is planned at its step for the decoding slot with the
# most tokens left (``arm_decode_nan``), so that its victim cannot retire
# in the poisoned step and hand the page to an admission that overwrites it
SERVE_FT_RUNS = [
    ("decode_nan", None, {}, (20,)),
    ("device_loss", "device_loss:step=25,lose=1", {"devices": [0, 1, 2, 3]}, ()),
    ("pool_corrupt", "pool_corrupt:step=30", {}, ()),
    ("step_hang", "step_hang:step=35,hang_s=60", {}, ()),
    ("degrade", None, {"degrade_after": 2}, (20, 40)),
]
# the events each run must record, exactly (kind: count)
SERVE_FT_EVENTS = {
    "decode_nan": {"quarantine": 1},
    "device_loss": {"rebuild": 1},
    "pool_corrupt": {"rebuild": 1},
    "step_hang": {"watchdog": 1, "rebuild": 1},
    "degrade": {"quarantine": 2, "degrade": 1},
}
SERVE_FT_INT8 = [("int8 decode_nan", None, {}, (20,)),
                 ("int8 device_loss", "device_loss:step=25,lose=1", {"devices": [0, 1, 2, 3]},
                  ())]
# the int8 runs hold the kernels to the plain GEMM within the same runs, so
# they take the first 7 of the 28 layers (depth cut to keep the whole run
# under 900 s; every width and gate kept)
SERVE_FT_INT8_LAYERS = 7
# the [train] phase: qwen3_0p6b full width, f32, remat, SyntheticLM batches
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_SAVE_AT = 4, 2048, 2, 4, 2
# step 1 against the same step on the plain versions: the loss (f32 sums
# over 8192 tokens in another order) and each gradient leaf against its
# max|grad| (the kernel's ~1e-6 attention differences through 28 layers)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
# the restored step 3 against the uninterrupted one
TRAIN_RESUME_TOL = 1e-6
# the [pipeline] phase: the same batch through four pipeline stages on the
# one card; its steps run three forwards a layer (the forward unit, the
# backward unit's re-run and its remat recompute) where the single-device
# step runs two
PIPE_STAGES, PIPE_STEPS = 4, 3
# depth cut 28 -> 16 for run time (the main path's first 16 layers; an even
# planner cut of 4 a stage): every comparison and gate stays
PIPE_LAYERS = 16
# pipelined vs single-device on the same batch, both on the kernels: the
# loss (f32 CE sums in microbatches of 1 vs one batch of 4) and each grad
# leaf against its max (GEMMs at M 2048 vs 8192 sum in other orders)
PIPE_LOSS_TOL, PIPE_GRAD_TOL, PIPE_LOGIT_TOL = 1e-5, 1e-4, 1e-4
# the [train-ft] phase: TrainSupervisor at full width on the one card, B 4 x
# seq 512 (flash runs: FLASH_MIN_SEQ is 512); the fused run's plan is the
# reference's TestSupervisorFused one, the pipeline's its TestSupervisorPipeline
# ones; the re-cut run's final loss within FT_RECUT_RTOL of the fault-free
# run's (the reference's gate: the re-pad is a pure gather, only the f32 sums
# of re-cut stages move)
FT_BATCH, FT_SEQ, FT_FUSED_STEPS, FT_PIPE_STEPS = 4, 512, 8, 12
# depth cut 28 -> 12 for run time (the main path's first 12 layers): the
# plans' events, the four stages and every gate stay
FT_LAYERS = 12
FT_FUSED_PLAN = "nan:step=3;ckpt_crash:step=4"
FT_SLOW_PLAN, FT_KILL_PLAN = "slowdown:step=3,stage=2,factor=3", "kill:step=7,lose=1"
FT_RECUT_RTOL = 5e-2
# keep=2 checkpoints and one torn .tmp of the full-width state (6.7 GiB each)
FT_DISK_BYTES = 3 * 7.2e9
# the [tune] phase: tune_runtime at the main path's shapes (flash's prefill
# call, the engine's decode at 8 slots, its prefill chunks with the full-width
# params; a chunk below 512 rows runs no flash)
TUNE_AUX = dict(heads=16, kv_heads=8, head_dim=128)
TUNE_GRIDS = {
    "flash_prefill": (dict(seq=PROMPT, batch=1, **TUNE_AUX), dict(block_q=64, block_k=64),
                      [dict(block_q=bq, block_k=bk) for bq in (32, 64, 128, 256)
                       for bk in (32, 64, 128)]),
    "paged_decode": (dict(max_len=PROMPT, fill=PROMPT // 2, batch=8, **TUNE_AUX),
                     dict(page_size=16), [dict(page_size=pg) for pg in (8, 16, 32, 64)]),
    "prefill_chunk": (dict(tokens=PROMPT, batch=2), dict(chunk=512),
                      [dict(chunk=c) for c in (256, 512, 1024)]),
}


def drive_supervisor(torch, sup, reqs, deadline_ms=None, on_step=None):
    """``drive_engine`` under a ``ServeSupervisor``: submit each request
    before its arrival step (with ``deadline_ms``), step the supervisor
    until every request is done, cancelled or shed, ``on_step(sup)`` after
    each step; returns (finished requests by rid, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while True:
        while i < len(reqs) and reqs[i][3] <= sup.steps:
            prompt, max_new, priority, _ = reqs[i]
            sup.submit(prompt, max_new, priority=priority, deadline_ms=deadline_ms)
            i += 1
        if i == len(reqs) and not sup.engine.pending and sup.engine.active == 0:
            break
        sup.step()
        if on_step is not None:
            on_step(sup)
    done = sup.run()
    torch.cuda.synchronize()
    return {r.rid: r for r in done}, time.perf_counter() - t0


def arm_decode_nan(steps, planned: list):
    """An ``on_step`` hook that plans a decode_nan at each of ``steps`` (or
    the first step after it with a candidate) for the decoding slot with the
    most tokens left, at least two; ``planned`` collects the specs."""
    from repro_torch.ft.faults import FaultPlan

    todo = sorted(steps)

    def hook(sup):
        if not todo or sup.steps < todo[0]:
            return
        cands = [(sl.req.max_new - len(sl.req.tokens), -sid)
                 for sid, sl in enumerate(sup.engine.slots) if sl.decoding]
        left, sid = max(cands, default=(0, 0))
        if left >= 2:
            todo.pop(0)
            spec = f"decode_nan:step={sup.steps},slot={-sid}"
            sup.plan = FaultPlan.parse(spec)
            planned.append(spec)

    return hook


def leak_check(eng, what: str) -> None:
    """The drained pool: audit green, and once the radix tree lets go,
    every page not quarantined is free."""
    eng.audit()
    eng.prefix.clear()
    check(eng.allocator.num_free == eng.num_pages - eng.allocator.num_quarantined
          and (eng.block_tables == -1).all(), f"{what}: no page leaked")


def serve_ft_phase(torch, params, qparams, cfg, dev, card: str, clean: dict) -> None:
    """``ServeSupervisor`` over the engine trace at full width.  The clean
    supervised run equals the unsupervised ``[engine]`` run (tokens and
    counters, no event); each fault run records exactly its planned events,
    its streams equal the clean run's under the margin rule, and its drained
    pool leaks nothing; a degrade leaves no kernel launch behind it and
    ``restore_dispatchers`` puts ``auto`` back; on int8 weights and pools
    (the first ``SERVE_FT_INT8_LAYERS`` layers), decode_nan and device_loss
    hold every token, counter and event equal to the same supervised run
    with the GEMMs on their plain version."""
    import dataclasses

    from repro_torch.ft.faults import FaultPlan
    from repro_torch.models import layers
    from repro_torch.serve import kv_cache
    from repro_torch.serve.supervisor import ServeSupervisor

    reqs = engine_trace(cfg.vocab)
    engine_kw = dict(prefix_cache=True, aging_s=None, num_pages=ENGINE_POOL,
                     prefill_budget=512, **ENGINE)

    def supervise(plan=None, p=params, kw=engine_kw, c=cfg, **sup_kw):
        fp = FaultPlan.parse(plan, seed=0) if plan else None
        return ServeSupervisor(p, c, engine_kw=kw, fault_plan=fp, **sup_kw)

    def counts():
        return {k: v for k, v in kernel_counts().items() if v}

    def events(sup):
        out = {}
        for ev in sup.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out

    # the clean supervised run: invisible
    sup = supervise()
    done, clean_s = drive_supervisor(torch, sup, reqs)
    st = sup.stats()
    check(sup.events == [] and st["recoveries"] == 0 and st["health_events"] == 0
          and not st["degraded"], f"[serve-ft] clean run: no event ({st['events']}, "
          f"{st['health_events']} health events)")
    same = sum(list(done[rid].tokens) == clean["toks"][rid] for rid in clean["toks"])
    check(same == len(reqs) and _counters(sup.engine.stats()) == _counters(clean["stats"]),
          f"[serve-ft] clean run: tokens ({same}/{len(reqs)}) and counters equal to "
          f"the unsupervised [engine] run")
    n_tok = sum(len(r.tokens) for r in done.values())
    # what the supervisor adds to each step: the pool probe and the audit
    eng = sup.engine
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        kv_cache.find_nonfinite_pages(eng.blocks)
        eng.audit()
    probe_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"[serve-ft] clean supervised run: {st['supervisor_steps']} steps, tokens and "
        f"counters equal to the [engine] run, no event; {n_tok / clean_s:.1f} tok/s "
        f"supervised vs {n_tok / clean['seconds']:.1f} unsupervised ({clean_s:.3f} s vs "
        f"{clean['seconds']:.3f} s); probe + audit {probe_ms:.3f} ms a step "
        f"({len(eng.blocks)} layers x 2 pools of {eng.num_pages} pages); on {card}")
    leak_check(eng, "[serve-ft] clean")
    del sup, eng

    # one run per fault kind; the deadline run after them
    for label, plan, sup_kw, nan_steps in SERVE_FT_RUNS:
        sup = supervise(plan, **sup_kw)
        state, planned = {}, []
        arm = arm_decode_nan(nan_steps, planned)

        def watch(s):
            arm(s)
            # from the degrade on, no kernel may launch
            if s.degraded and "at" not in state:
                check(layers.attention_impl() == "ref" and layers.gemm_impl() == "ref",
                      "[serve-ft] degrade: the dispatch reads ref")
                state["at"] = (s.steps, kernel_counts())

        reset_counts()
        try:
            done, secs = drive_supervisor(torch, sup, reqs, on_step=watch)
        finally:
            sup.restore_dispatchers()
        check(layers.attention_impl() == "auto" and layers.gemm_impl() == "auto",
              f"[serve-ft] {label}: the dispatch reads auto after restore_dispatchers")
        got = events(sup)
        check(got == SERVE_FT_EVENTS[label] and sup.recoveries == (2 if label == "degrade" else 1),
              f"[serve-ft] {label}: events {got} (recoveries {sup.recoveries}), expected "
              f"exactly {SERVE_FT_EVENTS[label]}")
        if label == "step_hang":
            check(next(e for e in sup.events if e.kind == "watchdog").detail["detected"],
                  "[serve-ft] step_hang: the watchdog declared the miss")
        if label == "degrade":
            check("at" in state and kernel_counts() == state["at"][1],
                  f"[serve-ft] degrade: no kernel launched after the degrade at step "
                  f"{state.get('at', (None,))[0]}")
        check(all(not r.cancelled and len(r.tokens) == r.max_new for r in done.values())
              and len(done) == len(reqs), f"[serve-ft] {label}: every request finished")
        diverged = margin_check(torch, params, cfg, dev, reqs,
                                {rid: list(r.tokens) for rid, r in done.items()},
                                clean["toks"], f"serve-ft {label} vs the clean run", LOGIT_TOL)
        leak_check(sup.engine, f"[serve-ft] {label}")
        recov = [(e.kind, round(e.recovery_s * 1e3, 3)) for e in sup.events if e.recovery_s]
        log(f"[serve-ft] {label}: plan {plan or ';'.join(planned)}; events {got}, "
            f"recovery_s {recov} ms, {sup.steps} steps, "
            f"{len(reqs) - diverged}/{len(reqs)} streams equal to the clean run, "
            f"{diverged} diverge where the margin <= {LOGIT_TOL}; pool "
            f"{sup.engine.num_pages} pages, {sup.engine.allocator.num_quarantined} "
            f"quarantined; {secs:.2f} s; launches {counts()}")
        del sup

    # a deadline that expires mid-trace: half the clean run's wall time
    deadline_ms = clean["seconds"] * 1e3 / 2
    sup = supervise()
    done, secs = drive_supervisor(torch, sup, reqs, deadline_ms=deadline_ms)
    got = events(sup)
    cancelled = {rid for rid, r in done.items() if r.cancelled}
    check(set(got) == {"cancel_deadline"} and got["cancel_deadline"] == len(cancelled) >= 1
          and len(cancelled) < len(reqs) and sup.recoveries == 0,
          f"[serve-ft] deadline: events {got}, {len(cancelled)} cancelled")
    check(all(e.detail["expired_since_last_check"] for e in sup.events),
          "[serve-ft] deadline: each cancelled within one step of its deadline")
    finished = {rid: list(r.tokens) for rid, r in done.items() if rid not in cancelled}
    diverged = margin_check(torch, params, cfg, dev, reqs, finished,
                            {rid: clean["toks"][rid] for rid in finished},
                            "serve-ft deadline vs the clean run", LOGIT_TOL)
    for rid in cancelled:
        have, want = list(done[rid].tokens), clean["toks"][rid]
        check(len(have) < len(want), f"[serve-ft] deadline: request {rid} stopped early")
    leak_check(sup.engine, "[serve-ft] deadline")
    late = max(e.detail["late_s"] for e in sup.events)
    log(f"[serve-ft] deadline {deadline_ms:.0f} ms: {len(cancelled)}/{len(reqs)} cancelled "
        f"(latest {late * 1e3:.2f} ms past its deadline), {len(finished) - diverged}/"
        f"{len(finished)} finished streams equal to the clean run; {secs:.2f} s")
    del sup

    # int8 weights on int8 pools: kernels vs the plain GEMM, every token,
    # counter and event equal, on the first SERVE_FT_INT8_LAYERS layers
    kw8 = dict(engine_kw, kv_dtype="int8")
    cfg8 = dataclasses.replace(cfg, num_layers=SERVE_FT_INT8_LAYERS)
    q8 = dict(qparams, blocks=qparams["blocks"][:SERVE_FT_INT8_LAYERS])
    for label, plan, sup_kw, nan_steps in SERVE_FT_INT8:
        runs = []
        for impl in ("auto", "ref"):
            prev = layers.set_gemm_impl(impl)
            try:
                reset_counts()
                sup = supervise(plan, p=q8, kw=kw8, c=cfg8, **sup_kw)
                planned = []
                done, secs = drive_supervisor(torch, sup, reqs,
                                              on_step=arm_decode_nan(nan_steps, planned))
                leak_check(sup.engine, f"[serve-ft] {label} gemm {impl}")
                runs.append(({rid: (list(r.tokens), r.cancelled) for rid, r in done.items()},
                             _counters(sup.engine.stats()), events(sup), sup.recoveries,
                             counts(), secs, planned))
                del sup
            finally:
                layers.set_gemm_impl(prev)
        (toks, st8, ev8, rec8, n8, secs, planned), ref = runs[0], runs[1]
        want = SERVE_FT_EVENTS[label.split()[1]]
        check(ev8 == want and rec8 == 1, f"[serve-ft] {label}: events {ev8}, expected {want}")
        check(n8.get("vta_gemm_dequant", 0) > 0 and "vta_gemm_dequant" not in ref[4],
              f"[serve-ft] {label}: the GEMMs ran on the kernel, then on the plain version")
        same = sum(toks[rid] == ref[0][rid] for rid in toks)
        check(same == len(reqs) and st8 == ref[1] and ev8 == ref[2] and planned == ref[6],
              f"[serve-ft] {label}: tokens ({same}/{len(reqs)}), counters and events equal "
              f"to the plain-GEMM run")
        log(f"[serve-ft] {label} ({SERVE_FT_INT8_LAYERS} of {cfg.num_layers} layers): plan "
            f"{plan or ';'.join(planned)}; events {ev8}; {same}/{len(reqs)} requests, counters and "
            f"events equal to the plain-GEMM run; {secs:.2f} s (plain GEMM {ref[5]:.2f} s); "
            f"launches {n8}")


def train_phase(torch, params, cfg, dev, card: str) -> int:
    """The port's ``make_train_step`` on qwen3_0p6b at full width: B 4,
    seq 2048, grad_accum 2, remat, ``SyntheticLM`` batches, four steps
    through an ``AsyncCheckpointer``.  Step 1 is held to the same step on
    the plain versions; flash launches 2 x layers x grad_accum a step (the
    forward and the remat recompute; the backward is the plain version's);
    the state saved after step 2 restores bitwise into a fresh state and
    step 3 from it gives the uninterrupted loss.  Returns the flash
    launches of the four steps."""
    import math
    import shutil

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.ft.checkpoint import AsyncCheckpointer
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_diff, flash_attention_ref)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_state, make_train_step
    from repro_torch.tree import flatten_with_path, leaves

    import torch.nn.functional as F

    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt, grad_accum=TRAIN_ACCUM, remat=True)
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    def batch(i):
        return {"tokens": torch.from_numpy(data.batch(i)["tokens"]).long().to(dev)}

    expect = 2 * cfg.num_layers * TRAIN_ACCUM
    log(f"[train] {ARCH} full width f32: batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, grad_accum "
        f"{TRAIN_ACCUM}, remat, chunked CE, AdamW {opt}; SyntheticLM seed 0")
    state0 = make_state(params)

    # step 1 on the plain versions, then on the kernels
    reset_counts()
    with plain_versions():
        ref1, mref = step_fn(state0, batch(0))
        torch.cuda.synchronize()
    check(flash_attention.launches == 0, "[train] the plain-version step launched no kernel")
    runs, step_ms, n_flash = [], [], 0
    state = state0
    ckpt_root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt = AsyncCheckpointer(str(ckpt_root), keep=2)
    saved = None
    for i in range(TRAIN_STEPS):
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch(i))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        n = flash_attention.launches
        n_flash += n
        check(n == expect, f"[train] step {i + 1}: flash launches {n}, expected {expect} "
              f"(2 x {cfg.num_layers} layers x {TRAIN_ACCUM} microbatches)")
        check(math.isfinite(loss) and math.isfinite(gnorm), f"[train] step {i + 1}: finite "
              f"loss {loss} and grad norm {gnorm}")
        runs.append((loss, gnorm, float(m["lr"])))
        if i == 0:
            s1 = state
        if i + 1 == TRAIN_SAVE_AT:
            saved = state
            t0 = time.perf_counter()
            ckpt.save(state, i + 1)
            snap_s = time.perf_counter() - t0
        if i + 1 == TRAIN_SAVE_AT + 1:
            s3 = state
        log(f"[train] step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.4f}, lr "
            f"{runs[-1][2]:.3e}, {step_ms[-1]:.1f} ms, flash launches {n}")

    # step 1 against the plain versions: loss, and each gradient leaf through
    # the first moment (mu = (1 - b1) x the clipped gradient)
    lerr = abs(runs[0][0] - float(mref["loss"])) / abs(float(mref["loss"]))
    check(lerr <= TRAIN_LOSS_TOL, f"[train] step 1 loss vs the plain versions: {lerr} > "
          f"{TRAIN_LOSS_TOL}")
    worst, worst_at = -1.0, None
    for (path, a), (_, b) in zip(flatten_with_path(s1["opt"].mu),
                                 flatten_with_path(ref1["opt"].mu)):
        scale = float(b.abs().max())
        err = float((a - b).abs().max()) / max(scale, 1e-30)
        if err > worst:
            worst, worst_at = err, path
        if path[0] == "blocks" and path[-2] in ("wq", "wk", "wv", "q_norm", "k_norm"):
            check(float(a.abs().max()) > 0, f"[train] kernel route: zero gradient at {path}")
    check(worst <= TRAIN_GRAD_TOL, f"[train] step 1 gradient at {worst_at}: {worst} of its "
          f"max > {TRAIN_GRAD_TOL}")
    log(f"[train] step 1 vs the plain versions: loss rel err {lerr:.3e} (tol "
        f"{TRAIN_LOSS_TOL}), worst gradient leaf {worst:.3e} of its max|grad| at "
        f"{'/'.join(map(str, worst_at))} (tol {TRAIN_GRAD_TOL}); every wq/wk/wv/q_norm/"
        f"k_norm gradient non-zero on the kernel route; flash launches {expect} a step "
        f"(forward + remat recompute), none in the backward")
    del ref1, mref, s1

    # the checkpoint: restore into a fresh state, then step 3 again
    ckpt.wait()
    t0 = time.perf_counter()
    restored, at = ckpt.restore_latest(state0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(at == TRAIN_SAVE_AT, f"[train] latest checkpoint at step {at}")
    for (path, a), (_, b) in zip(flatten_with_path(restored), flatten_with_path(saved)):
        check(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b),
              f"[train] restored leaf {path} equals the saved one bitwise")
    flash_attention.launches = 0
    again, m3 = step_fn(restored, batch(TRAIN_SAVE_AT))
    loss3 = float(m3["loss"])
    rel = abs(loss3 - runs[TRAIN_SAVE_AT][0]) / abs(runs[TRAIN_SAVE_AT][0])
    bitwise = loss3 == runs[TRAIN_SAVE_AT][0] and all(
        torch.equal(a, b) for a, b in zip(leaves(again), leaves(s3)))
    check(rel <= TRAIN_RESUME_TOL, f"[train] step {TRAIN_SAVE_AT + 1} from the restored "
          f"state: loss rel err {rel} > {TRAIN_RESUME_TOL}")
    nbytes = sum(x.numel() * x.element_size() for x in leaves(saved))
    log(f"[train] checkpoint after step {TRAIN_SAVE_AT}: {nbytes / 2 ** 30:.2f} GiB, "
        f"snapshot {snap_s:.2f} s, restore {restore_s:.2f} s, every leaf (params, mu, nu, "
        f"step) bitwise equal; step {TRAIN_SAVE_AT + 1} from it: loss {loss3:.6f} vs "
        f"{runs[TRAIN_SAVE_AT][0]:.6f} (rel err {rel:.3e}, tol {TRAIN_RESUME_TOL}); "
        f"{'bitwise' if bitwise else 'NOT bitwise'} equal to the uninterrupted step "
        f"(state and loss)")
    del restored, again, saved, s3
    shutil.rmtree(ckpt_root, ignore_errors=True)

    # where a step's time goes
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, _ = step_fn(state, batch(TRAIN_STEPS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall, busy, top = device_breakdown(torch, lambda: step_fn(state, batch(TRAIN_STEPS + 1)),
                                       top=8)
    log(f"[time] train step (steps 2-{TRAIN_STEPS}): {mean_ms:.1f} ms, "
        f"{tokens / mean_ms * 1e3:.0f} tokens/s; peak allocated {peak / 2 ** 30:.2f} GiB "
        f"({base / 2 ** 30:.2f} GiB live before the step: params, moments, the data); "
        f"profiled step: wall {wall * 1e3:.1f} ms, device kernels {busy * 1e3:.1f} ms, "
        f"device idle {100 * (1 - busy / wall):.1f} %; on {card}")
    for name, us, calls in top:
        log(f"[profile] train   {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")

    # flash at the training shape, and the plain backward it pairs with
    h, hkv, d = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((TRAIN_BATCH, TRAIN_SEQ, h, d), generator=gen, device=dev)
    k = torch.randn((TRAIN_BATCH, TRAIN_SEQ, hkv, d), generator=gen, device=dev)
    v = torch.randn((TRAIN_BATCH, TRAIN_SEQ, hkv, d), generator=gen, device=dev)
    with torch.no_grad():
        ms = cuda_ms(torch, lambda _: flash_attention(q, k, v))
        plain = cuda_ms(torch, lambda _: flash_attention_ref(q, k, v), reps=3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(h // hkv, 2),
                                                  v.repeat_interleave(h // hkv, 2)))
        lib = cuda_ms(torch, lambda _: F.scaled_dot_product_attention(qt, kt, vt,
                                                                      is_causal=True))
    flops, nbytes = flash_work(TRAIN_BATCH, TRAIN_SEQ, h, hkv, d, d, 0, TRAIN_SEQ, 4)
    bnd, by = bound_ms(3 * flops, nbytes, "tf32")
    log(f"[time] flash train shape B {TRAIN_BATCH} S = T = {TRAIN_SEQ} causal G {h // hkv} "
        f"D {d} f32: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}, 3xTF32)")
    mb = TRAIN_BATCH // TRAIN_ACCUM
    leaves_ = [x[:mb].clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_diff(*leaves_)
    g = torch.randn(out.shape, generator=gen, device=dev)
    bwd = cuda_ms(torch, lambda _: torch.autograd.grad(out, leaves_, g, retain_graph=True),
                  reps=3, warmup=1)
    share = bwd * cfg.num_layers * TRAIN_ACCUM / mean_ms
    log(f"[time] flash's plain backward (recompute through flash_attention_ref) per layer "
        f"and microbatch (B {mb}): {bwd:.3f} ms; x {cfg.num_layers} layers x {TRAIN_ACCUM} "
        f"= {bwd * cfg.num_layers * TRAIN_ACCUM:.1f} ms, {100 * share:.1f} % of the step")
    del q, k, v, qt, kt, vt, out, g, leaves_, state, state0
    torch.cuda.empty_cache()
    return n_flash


def pipeline_phase(torch, params, cfg, dev, card: str) -> int:
    """The port's pipeline runtime at qwen3_0p6b's full width, depth cut to
    ``PIPE_LAYERS`` (the main path's first layers), on the one card: four
    stages (``make_mesh_for([dev] * 4, model_axis=4)``), B 4 x
    (2048 + 1) ``SyntheticLM`` tokens (seed 0), the planner's cuts and an
    uneven cut with stage 0 at half speed (so padding rows run at full
    width), m from ``tune_microbatches``.  Gates: the pipelined forward
    against ``transformer.forward`` on both cuts; GPipe and 1F1B
    ``loss_and_grad`` bitwise equal; both against the single-device
    ``value_and_grad`` (loss, every grad leaf after unpadding); attention
    grads non-zero and padding rows' grads zero; schedule counts equal to
    ``pipeline_bubble_counts``; ``unpad(pad(x))`` bitwise with padding
    rows of their own storage; ``PIPE_STEPS`` finite train steps, each
    launching flash 3 x layers x m times.  Readings: the pipelined step
    against the single-device step on the same batch, peak memory, device
    idle, the pipelined forward against ``transformer.forward``.  Returns
    the flash launches of the pipelined train steps."""
    import dataclasses
    import math

    from repro_torch.core.autotune import tune_microbatches
    from repro_torch.core.graph import config_graph
    from repro_torch.core.partition import layer_costs, partition_layers
    from repro_torch.core.placement import pipeline_boundaries
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import pipeline as pl
    from repro_torch.ft.elastic import make_mesh_for
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as st
    from repro_torch.tree import flatten_with_path, leaves as tree_leaves

    check(not torch.backends.cuda.matmul.allow_tf32, "[pipeline] f32 matmuls, TF32 off")
    cfg = dataclasses.replace(cfg, num_layers=PIPE_LAYERS)
    params = dict(params, blocks=params["blocks"][:PIPE_LAYERS])
    mesh = make_mesh_for([dev] * PIPE_STAGES, model_axis=PIPE_STAGES)
    check(mesh.shape == {"data": 1, "model": PIPE_STAGES}
          and mesh.distinct_devices() == [dev], f"[pipeline] mesh {mesh}")
    planner = pipeline_boundaries(cfg, TRAIN_SEQ, PIPE_STAGES)
    costs = layer_costs(config_graph(cfg, TRAIN_SEQ))
    uneven = partition_layers(costs, PIPE_STAGES,
                              stage_weights=[0.5] + [1.0] * (PIPE_STAGES - 1))
    depths = [b - a for a, b in zip(uneven, uneven[1:])]
    per = PIPE_LAYERS // PIPE_STAGES
    check(planner == tuple(range(0, PIPE_LAYERS + 1, per)), f"[pipeline] planner cuts {planner}")
    check(len(set(depths)) > 1, f"[pipeline] the half-speed cut {uneven} is uneven")
    m = tune_microbatches(PIPE_STAGES, TRAIN_BATCH, "1f1b")
    check(m == 4, f"[pipeline] tune_microbatches({PIPE_STAGES}, {TRAIN_BATCH}) = {m}")
    data = SyntheticLM(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    def batch(i):
        return {"tokens": torch.from_numpy(data.batch(i)["tokens"]).long().to(dev)}

    b0 = batch(0)
    log(f"[pipeline] {ARCH} full width f32, {PIPE_STAGES} stages on one card ({mesh}); "
        f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, m {m} (tune_microbatches); cuts: planner "
        f"{planner}, stage 0 at half speed {uneven} (depths {depths}, "
        f"{PIPE_STAGES * max(depths) - cfg.num_layers} padding rows)")

    # pad / unpad: padding rows are clones, unpad(pad(x)) is x
    padded = pl.pad_pipeline_params(params, cfg, uneven)
    ptrs = [x.data_ptr() for x in tree_leaves(padded)]
    back = pl.unpad_pipeline_params(padded, cfg, uneven)
    check(len(set(ptrs)) == len(ptrs), "[pipeline] padding rows have storage of their own")
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params))),
          "[pipeline] unpad(pad(params)) bitwise")

    # the forward pipe on both cuts against transformer.forward
    tokens = b0["tokens"][:, :-1]
    with torch.no_grad():
        want, _ = tf.forward(params, cfg, tokens)
        scale = float(want.abs().max())
        fwd_ms = {}
        for label, cut in (("planner", planner), ("half-speed", uneven)):
            p = pl.pad_pipeline_params(params, cfg, cut)
            fwd = pl.make_pipeline_forward(cfg, mesh, m, cut)
            got = fwd(p, tokens)
            err = float((got - want).abs().max()) / scale
            check(fwd.counts == pl.pipeline_bubble_counts(PIPE_STAGES, m, "forward"),
                  f"[pipeline] forward counts {fwd.counts}")
            check(err <= PIPE_LOGIT_TOL, f"[pipeline] forward {label}: {err} of max|logit|")
            del got
            fwd_ms[label] = cuda_ms(torch, lambda _: fwd(p, tokens), reps=3, warmup=1)
            log(f"[pipeline] forward, {label} cuts: logits within {err:.3e} of max|logit| "
                f"{scale:.3f} of transformer.forward (tol {PIPE_LOGIT_TOL}); counts "
                f"{fwd.counts} == pipeline_bubble_counts")
        del want, p
        plain_ms = cuda_ms(torch, lambda _: tf.forward(params, cfg, tokens), reps=3, warmup=1)
    torch.cuda.empty_cache()

    # loss_and_grad: GPipe == 1F1B bitwise, both against value_and_grad
    outs = {}
    for sched in ("gpipe", "1f1b"):
        lg = pl.make_pipeline_loss_and_grad(cfg, mesh, m, uneven, sched)
        outs[sched] = lg(padded, b0)
        torch.cuda.synchronize()
        want_counts = pl.pipeline_bubble_counts(PIPE_STAGES, m, sched)
        check(lg.counts == want_counts, f"[pipeline] {sched} counts {lg.counts} vs "
              f"{want_counts}")
        log(f"[pipeline] {sched}: loss {float(outs[sched][0][0]):.6f}, counts (rounds, busy, "
            f"idle) {lg.counts} == pipeline_bubble_counts")
    (l1, _), g1 = outs.pop("gpipe")
    (l2, met), g2 = outs.pop("1f1b")
    check(torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in
                                      zip(tree_leaves(g1), tree_leaves(g2))),
          "[pipeline] GPipe and 1F1B loss and grads bitwise equal")
    del g1
    (rl, _), rg = st.value_and_grad(st.make_loss_fn(cfg, remat=True), params, b0)
    lerr = abs(float(l2) - float(rl)) / abs(float(rl))
    check(lerr <= PIPE_LOSS_TOL, f"[pipeline] loss vs value_and_grad: {lerr}")
    unpadded = pl.unpad_pipeline_params(g2, cfg, uneven)
    worst, worst_at = -1.0, None
    for (path, a), (_, w) in zip(flatten_with_path(unpadded), flatten_with_path(rg)):
        err = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if err > worst:
            worst, worst_at = err, path
        if path[0] == "blocks" and path[-2] in ("wq", "wk", "wv", "q_norm", "k_norm"):
            check(float(a.abs().max()) > 0, f"[pipeline] zero gradient at {path}")
    check(worst <= PIPE_GRAD_TOL, f"[pipeline] grad at {worst_at}: {worst} of its max")
    real = {id(x) for x in tree_leaves(unpadded)}
    pads = [x for x in tree_leaves(g2["blocks"]) if id(x) not in real]
    check(pads and all(not x.any() for x in pads), "[pipeline] padding rows' grads zero")
    log(f"[pipeline] GPipe == 1F1B bitwise (loss and {len(tree_leaves(g2))} grad leaves); "
        f"vs single-device value_and_grad: loss {float(l2):.6f} vs {float(rl):.6f} (rel err "
        f"{lerr:.3e}, tol {PIPE_LOSS_TOL}), worst grad leaf {worst:.3e} of its max at "
        f"{'/'.join(map(str, worst_at))} (tol {PIPE_GRAD_TOL}); wq/wk/wv/q_norm/k_norm grads "
        f"non-zero; {len(pads)} padding leaves exactly zero")
    del g2, rg, unpadded, pads, padded
    torch.cuda.empty_cache()

    # the train step: pipelined, then single-device on the same batches
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=PIPE_STEPS)
    step = st.make_pipeline_train_step(cfg, opt, mesh, num_microbatches=m, boundaries=uneven)
    state = st.make_state(pl.pad_pipeline_params(params, cfg, uneven))
    expect = 3 * cfg.num_layers * m
    n_flash, pipe_ms = 0, []
    for i in range(PIPE_STEPS):
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, mt = step(state, batch(i))
        loss, gnorm = float(mt["loss"]), float(mt["grad_norm"])
        torch.cuda.synchronize()
        pipe_ms.append((time.perf_counter() - t0) * 1e3)
        n = flash_attention.launches
        n_flash += n
        check(n == expect, f"[pipeline] step {i + 1}: flash launches {n}, expected {expect} "
              f"(3 x {cfg.num_layers} layers x {m} microbatches)")
        check(math.isfinite(loss) and math.isfinite(gnorm), f"[pipeline] step {i + 1}: "
              f"loss {loss}, grad norm {gnorm}")
        log(f"[pipeline] step {i + 1}: loss {loss:.6f}, grad_norm {gnorm:.4f}, "
            f"{pipe_ms[-1]:.1f} ms, flash launches {n}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state, _ = step(state, batch(PIPE_STEPS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    wall, busy, top = device_breakdown(torch, lambda: step(state, batch(PIPE_STEPS + 1)), top=6)
    del state
    torch.cuda.empty_cache()
    single = st.make_train_step(cfg, opt, remat=True)
    sstate = st.make_state(params)
    single_ms = []
    for i in range(PIPE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sstate, sm = single(sstate, batch(i))
        float(sm["loss"])
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    sbase = torch.cuda.memory_allocated()
    sstate, _ = single(sstate, batch(PIPE_STEPS))
    torch.cuda.synchronize()
    speak = torch.cuda.max_memory_allocated()
    del sstate
    torch.cuda.empty_cache()
    p_ms = sum(pipe_ms[1:]) / len(pipe_ms[1:])
    s_ms = sum(single_ms[1:]) / len(single_ms[1:])
    log(f"[time] pipelined train step ({PIPE_STAGES} stages, m {m}, 1f1b, steps 2-"
        f"{PIPE_STEPS}): {p_ms:.1f} ms vs single-device step {s_ms:.1f} ms on the same batch "
        f"({p_ms / s_ms:.3f}x); peak allocated {peak / 2 ** 30:.2f} GiB ({base / 2 ** 30:.2f} "
        f"before the step) vs {speak / 2 ** 30:.2f} GiB ({sbase / 2 ** 30:.2f}); profiled "
        f"pipelined step: wall {wall * 1e3:.1f} ms, device kernels {busy * 1e3:.1f} ms, "
        f"device idle {100 * (1 - busy / wall):.1f} %; on {card}")
    for name, us, calls in top:
        log(f"[profile] pipeline {us / 1e3:9.3f} ms {calls:5d}x {name[:90]}")
    log(f"[time] pipelined forward (B {TRAIN_BATCH} x {TRAIN_SEQ}, m {m}): planner cuts "
        f"{fwd_ms['planner']:.1f} ms, half-speed cuts {fwd_ms['half-speed']:.1f} ms vs "
        f"transformer.forward {plain_ms:.1f} ms")
    return n_flash


def train_ft_phase(torch, params, cfg, dev, card: str) -> int:
    """``ft.supervisor.TrainSupervisor`` at qwen3_0p6b's full width on the one
    card, depth cut to ``FT_LAYERS`` (the main path's first layers), B 4 x
    seq 512 ``SyntheticLM`` batches (seed 0), f32, from the main path's
    weights (its ``init_fn``), checkpoints in a temporary directory
    under ``build/`` removed afterwards.  (a) fused, 8 steps, a checkpoint
    every 2, ``nan:step=3;ckpt_crash:step=4``: exactly one rollback skipping
    data index 3 with at most 2 steps lost, exactly one ``ckpt_retry`` of a
    ``CheckpointWriteCrash``, no torn ``.tmp`` left and a latest checkpoint
    at step 8.  (b) the 1F1B pipeline on ``[dev] * 4`` (m from
    ``tune_microbatches``), 12 steps, fault-free, then with stage 2 three
    times slower from step 3: at least one re-cut, stage 2's share shrinks,
    the final loss within ``FT_RECUT_RTOL`` of the fault-free run's.  (c) the
    same pipeline with a checkpoint every 2 steps and one device lost at
    step 7: one rescale 4 -> 3 stages, at most 2 steps lost, 4 cut points
    last.  Every loss finite; flash launched exactly what the steps imply
    (2 x layers a fused step, 3 x layers x m a pipelined one, the warm steps
    after each (re)build and the poisoned / replayed steps included).
    Readings: each run's mean step ms, each event's ``recovery_s``, the
    blocking part of each checkpoint save, the device memory live before
    each run and its peak.  Earlier phases' objects in reference cycles
    (engines and their pools) hold device memory until a gc pass, so each
    run starts after one.  Returns the flash launches."""
    import dataclasses
    import gc
    import math
    import shutil
    import tempfile

    from repro_torch.ft import checkpoint as ckpt
    from repro_torch.ft.faults import CheckpointWriteCrash, FaultPlan
    from repro_torch.ft.supervisor import TrainSupervisor
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.step import make_state

    cfg = dataclasses.replace(cfg, num_layers=FT_LAYERS)
    params = dict(params, blocks=params["blocks"][:FT_LAYERS])
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    check(free >= FT_DISK_BYTES, f"[train-ft] {free / 2 ** 30:.1f} GiB free under {build}, "
          f"the checkpoints need {FT_DISK_BYTES / 2 ** 30:.1f}")
    layers_n = cfg.num_layers
    log(f"[train-ft] {ARCH} full width f32, {FT_LAYERS} layers (the main path's first), batch "
        f"{FT_BATCH} x seq {FT_SEQ}, SyntheticLM seed 0; {free / 2 ** 30:.1f} GiB free for "
        f"checkpoints")

    def run(label, steps, plan, *, strategy, devices, ckpt_every=0):
        with tempfile.TemporaryDirectory(dir=build) as root:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            flash_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sup = TrainSupervisor(cfg, steps=steps, seq=FT_SEQ, batch=FT_BATCH,
                                  strategy=strategy, devices=devices,
                                  fault_plan=FaultPlan.parse(plan) if plan else None,
                                  ckpt_dir=root if ckpt_every else None,
                                  ckpt_every=ckpt_every, init_fn=lambda: make_state(params))
            m0 = getattr(sup, "microbatches", 1)
            saves = []
            if sup.ckpt is not None:
                save = sup.ckpt.save

                def timed_save(state, step):
                    t = time.perf_counter()
                    save(state, step)
                    saves.append(time.perf_counter() - t)

                sup.ckpt.save = timed_save
            res = sup.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            latest = ckpt.latest_step(root) if ckpt_every else None
            torn = ckpt.sweep_tmp(root) if ckpt_every else []
        n = flash_attention.launches
        check(all(math.isfinite(x) for x in res.losses) and len(res.losses) == steps,
              f"[train-ft] {label}: {steps} finite losses, got {res.losses}")
        mean_ms = 1e3 * sum(res.step_times) / len(res.step_times)
        log(f"[train-ft] {label} on {card}: {steps} steps in {wall:.2f} s, mean step "
            f"{mean_ms:.1f} ms, final loss {res.final_loss:.6f}, events {len(res.events)}, boundaries history "
            f"{res.boundaries_history}, flash launches {n}; device memory {live / 2 ** 30:.2f} "
            f"GiB live before, peak {peak / 2 ** 30:.2f} GiB")
        for ev in res.events:
            log(f"[train-ft]   [{ev.kind}] at step {ev.step}: lost {ev.steps_lost} steps, "
                f"recovery_s {ev.recovery_s:.4f}  {ev.detail}")
        if saves:
            log(f"[train-ft]   checkpoint saves (blocking: snapshot + the previous write): "
                f"{', '.join(f'{1e3 * x:.0f}' for x in saves)} ms")
        return res, sup, m0, n, latest, torn

    # (a) fused: NaN rollback and checkpoint-crash retry
    res, sup, _, n_a, latest, torn = run("fused", FT_FUSED_STEPS, FT_FUSED_PLAN,
                                         strategy="fused", devices=[dev], ckpt_every=2)
    rbs, retries = res.events_of("rollback"), res.events_of("ckpt_retry")
    check(len(rbs) == 1 and rbs[0].detail["skipped_data_index"] == 3 and rbs[0].steps_lost <= 2,
          f"[train-ft] fused: one rollback skipping data index 3, <= 2 steps lost: {rbs}")
    check(len(retries) == 1 and retries[0].detail["error"].startswith(
        CheckpointWriteCrash.__name__), f"[train-ft] fused: one ckpt_retry of a "
        f"CheckpointWriteCrash: {retries}")
    check(torn == [] and latest == FT_FUSED_STEPS, f"[train-ft] fused: no torn .tmp ({torn}), "
          f"latest checkpoint {latest}")
    expect = 2 * layers_n * (1 + FT_FUSED_STEPS + rbs[0].steps_lost + 1)
    check(n_a == expect, f"[train-ft] fused: flash launches {n_a}, expected {expect} (2 x "
          f"{layers_n} x (warm + {FT_FUSED_STEPS} + {rbs[0].steps_lost} replayed + 1 poisoned))")
    del sup
    torch.cuda.empty_cache()

    # (b) the pipeline: fault-free, then a 3x slow stage 2 re-cut live
    pipe = [dev] * PIPE_STAGES
    base, sup, m, n_b, _, _ = run("pipeline fault-free", FT_PIPE_STEPS, "",
                                  strategy="pipeline", devices=pipe)
    check(base.events == [] and len(base.boundaries_history) == 1,
          f"[train-ft] fault-free pipeline: no event, {base.events}")
    expect = 3 * layers_n * m * (1 + FT_PIPE_STEPS)
    check(n_b == expect, f"[train-ft] fault-free pipeline: flash launches {n_b}, expected "
          f"{expect} (3 x {layers_n} x m {m} x (warm + {FT_PIPE_STEPS}))")
    del sup
    res, sup, m, n_c, _, _ = run("pipeline slowdown", FT_PIPE_STEPS, FT_SLOW_PLAN,
                                 strategy="pipeline", devices=pipe)
    recuts = res.events_of("recut")
    check(recuts and all(e.kind == "recut" for e in res.events),
          f"[train-ft] slowdown: at least one recut and nothing else: {res.events}")
    old, new = recuts[0].detail["old"], recuts[0].detail["new"]
    check(new[3] - new[2] < old[3] - old[2], f"[train-ft] slowdown: stage 2 shrinks, {old} -> "
          f"{new}")
    rel = abs(res.final_loss - base.final_loss) / abs(base.final_loss)
    check(rel <= FT_RECUT_RTOL, f"[train-ft] slowdown: final loss {res.final_loss} vs "
          f"fault-free {base.final_loss}, rel {rel} > {FT_RECUT_RTOL}")
    expect = 3 * layers_n * m * (1 + len(recuts) + FT_PIPE_STEPS)
    check(n_c == expect, f"[train-ft] slowdown: flash launches {n_c}, expected {expect} "
          f"(3 x {layers_n} x m {m} x (warm + {len(recuts)} re-cut warms + {FT_PIPE_STEPS}))")
    log(f"[train-ft] slowdown: stage 2 {old[3] - old[2]} -> {new[3] - new[2]} layers; final "
        f"loss {res.final_loss:.6f} vs fault-free {base.final_loss:.6f}: rel diff {rel:.3e} "
        f"(gate {FT_RECUT_RTOL})")
    del sup
    torch.cuda.empty_cache()

    # (c) the pipeline loses a device: rescale 4 -> 3 stages from the checkpoint
    res, sup, m4, n_d, _, _ = run("pipeline kill", FT_PIPE_STEPS, FT_KILL_PLAN,
                                  strategy="pipeline", devices=pipe, ckpt_every=2)
    evs = res.events_of("rescale")
    check(len(evs) == 1 and len(res.events) == 1 and evs[0].detail["devices"] == "4->3"
          and evs[0].detail["stages"] == 3 and evs[0].steps_lost <= 2,
          f"[train-ft] kill: one rescale 4->3 stages, <= 2 steps lost: {res.events}")
    check(len(res.boundaries_history[-1]) == 4, f"[train-ft] kill: last cuts "
          f"{res.boundaries_history[-1]}")
    ev = evs[0]
    expect = (3 * layers_n * m4 * (1 + ev.step + 1)
              + 3 * layers_n * sup.microbatches * (1 + FT_PIPE_STEPS - ev.detail["restored_step"]))
    check(n_d == expect, f"[train-ft] kill: flash launches {n_d}, expected {expect} (3 x "
          f"{layers_n} x m (warm + steps run) on 4 stages, then on 3 from step "
          f"{ev.detail['restored_step']})")
    del sup
    torch.cuda.empty_cache()
    return n_a + n_b + n_c + n_d


def tune_phase(torch, params, cfg, dev, card: str, untuned: dict) -> dict:
    """``core.autotune.tune_runtime`` on the card at the main path's shapes
    (``TUNE_GRIDS``: flash's prefill call at B 1, S 2048, the paged kernel
    at 8 slots over page sizes 8-64, the prefill chunk 256 / 512 / 1024 with
    the full-width params at 2048 tokens, batch 2), flash blocks the kernel
    refuses for shared memory dropped first.  The table is saved, loaded
    back (its device names this card) and installed; then flash through
    ``flash_attend`` at the tuned blocks equals an explicit call at them and
    is held to its plain version (``TOL``, map == ``flash_tile_counts`` at
    those blocks), the paged kernel at the tuned page size likewise, and the
    ``[engine]`` trace runs with ``page_size`` and ``prefill_chunk`` left
    unset at the same pool bytes: launches exact, audits green, tokens equal
    to the untuned run's under the margin rule, both runs' tok/s printed.
    The table is uninstalled after.  Returns the tuned engine run's flash and
    paged launches."""
    import gc
    import tempfile

    from repro_torch.core.autotune import TuningTable, tune_runtime
    from repro_torch.core.measure import device_signature
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention, paged_decode_attention_ref)
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_ref, flash_tile_counts, flash_tile_map)
    from repro_torch.models import layers
    from repro_torch.models.attention import FLASH_MIN_SEQ
    from repro_torch.serve import kv_cache
    from repro_torch.serve.engine import ServingEngine, latency_stats

    check(layers.tuning_table() is None, "[tune] no table installed before the phase")
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    rep = tune_runtime(params, cfg, kinds=tuple(TUNE_GRIDS), grids=TUNE_GRIDS,
                       verbose=True, device=dev)
    torch.cuda.synchronize()
    log(f"[tune] tune_runtime over {list(TUNE_GRIDS)} in {time.perf_counter() - t0:.2f} s "
        f"({len(rep.entries)} points measured; their launches: flash "
        f"{flash_attention.launches}, paged {paged_decode_attention.launches})")
    for r in rep.results:
        log(f"[tune] {r.kind}: default {r.default_s * 1e3:.4f} ms -> best "
            f"{r.best_s * 1e3:.4f} ms {r.best} ({r.speedup:.3f}x; {r.measured}/{r.candidates} "
            f"measured) on {card}")
    for e in rep.entries:
        log(f"[tune]   {e['kind']} {e['params']}: {e['t_s'] * 1e3:.4f} ms")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = str(Path(d) / "tuning.json")
        rep.table.save(path)
        table = TuningTable.load(path)
    sig = device_signature(dev)
    check(table.device == sig and torch.cuda.get_device_name(dev) in sig
          and table.entries == rep.table.entries, f"[tune] the loaded table names this card: "
          f"{table.device}")
    knobs = table.get("flash_prefill")
    serving = table.get("serving")
    log(f"[tune] table for {table.device}: {table.entries}")

    b, s, h, hkv, d, t = BATCH, CHUNK, 16, 8, 128, PROMPT + NEW_TOKENS
    gen = torch.Generator(device=dev).manual_seed(4321)
    q = torch.randn((b, s, h, d), generator=gen, device=dev)
    k = torch.randn((b, t, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, t, hkv, d), generator=gen, device=dev)
    opts = dict(q_offset=PROMPT - CHUNK, kv_len=PROMPT)
    prev = layers.set_tuning(table)
    try:
        got = layers.flash_attend(q, k, v, **opts)
        want, counts = flash_attention(q, k, v, block_q=knobs["block_q"],
                                       block_k=knobs["block_k"], return_counts=True, **opts)
        plain = flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = (got - plain).abs().max().item()
        check(torch.equal(got, want), "[tune] flash_attend at the tuned blocks equals the "
              "explicit call at them")
        check(err <= TOL["float32"], f"[tune] flash at {knobs}: max|err| {err}")
        tile_map = flash_tile_map(s, t, block_q=knobs["block_q"], block_k=knobs["block_k"],
                                  **opts).to(dev)
        executed, total = flash_tile_counts(s, t, block_q=knobs["block_q"],
                                            block_k=knobs["block_k"], **opts)
        check(torch.equal(counts, tile_map.expand_as(counts)) and int(counts[0, 0].sum())
              == executed and counts[0, 0].numel() == total,
              f"[tune] flash map at {knobs} vs flash_tile_counts")
        log(f"[tune] flash at the tuned blocks {knobs} (q_offset {PROMPT - CHUNK}): "
            f"flash_attend == explicit call, max|err| {err:.3e} vs plain (tol "
            f"{TOL['float32']}), map == flash_tile_counts ({executed}/{total} tiles)")
        pg = serving["page_size"]
        kv_lens = [0, 1, pg - 1, pg, pg + 1, 2064]
        args, kw = paged_inputs(torch, gen, dev, torch.float32, 6, 1, h, hkv, d, d, pg, kv_lens)
        got, pmap = paged_decode_attention(*args, return_counts=True, **kw)
        want, wmap = paged_decode_attention_ref(*args, return_counts=True, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(err <= TOL["float32"] and torch.equal(pmap, wmap) and not got[0].any(),
              f"[tune] paged at the tuned page size {pg}: max|err| {err}, maps")
        log(f"[tune] paged at the tuned page size {pg} kv_lens {kv_lens}: max|err| {err:.3e} "
            f"(tol {TOL['float32']}), map == plain version's")
        del q, k, v, got, want, plain, args

        # the engine trace with its knobs from the table, at the same pool bytes
        reqs = engine_trace(cfg.vocab)
        pool_bytes = ENGINE_POOL * kv_cache.page_bytes(cfg, ENGINE["page_size"], "f32")
        reset_counts()
        eng = ServingEngine(params, cfg, max_slots=ENGINE["max_slots"],
                            max_len=ENGINE["max_len"], pool_bytes=pool_bytes, prefix_cache=True,
                            prefill_budget=512, aging_s=None)
        check((eng.page_size, eng._prefill_chunk) == (serving["page_size"],
                                                      serving["prefill_chunk"]),
              f"[tune] the engine took page {eng.page_size}, chunk {eng._prefill_chunk} from "
              f"the table {serving}")
        toks, done, secs = drive_engine(eng, reqs)
        est = eng.stats()
        n_flash, n_paged = flash_attention.launches, paged_decode_attention.launches
        want_flash = (cfg.num_layers * est["prefill_chunk_calls"]
                      if eng._prefill_chunk >= FLASH_MIN_SEQ else 0)
        check(n_paged == cfg.num_layers * est["steps"] and n_flash == want_flash,
              f"[tune] tuned engine launches: paged {n_paged} (expect {cfg.num_layers} x "
              f"{est['steps']}), flash {n_flash} (expect {want_flash})")
        eng.audit()
        check(eng.allocator.num_free + len(eng.prefix.pages()) == eng.num_pages
              and (eng.block_tables == -1).all(), "[tune] tuned engine: no page leaked")
        check(len(done) == len(reqs) and all(len(r.tokens) == r.max_new for r in done),
              "[tune] tuned engine: every request finished")
        lat = latency_stats(done)
        del eng
    finally:
        layers.set_tuning(prev)
    check(layers.tuning_table() is None, "[tune] the table is uninstalled after the phase")
    diverged = margin_check(torch, params, cfg, dev, reqs, toks, untuned["toks"],
                            "tuned engine vs untuned", LOGIT_TOL)
    n_tok = lat["tokens"]
    ut = sum(len(x) for x in untuned["toks"].values())
    log(f"[tune] tuned engine (page {serving['page_size']}, chunk {serving['prefill_chunk']}, "
        f"{est['steps']} decode steps, {est['prefill_chunk_calls']} chunks, "
        f"{est['preemptions']} preemptions, {est['prefix_hits']} prefix hits): "
        f"{len(toks) - diverged}/{len(toks)} requests equal to the untuned run, {diverged} "
        f"diverge where the reference's margin <= {LOGIT_TOL}; audits green")
    log(f"[time] engine tuned {n_tok / secs:.1f} tok/s ({n_tok} tokens in {secs:.3f} s, TTFT "
        f"p50 {lat['ttft_p50_s'] * 1e3:.1f} ms) vs untuned {ut / untuned['seconds']:.1f} tok/s "
        f"({ut} tokens in {untuned['seconds']:.3f} s, page {ENGINE['page_size']}, chunk "
        f"{ENGINE['prefill_chunk']}) on {card}")
    return {"flash_attention": n_flash, "paged_decode_attention": n_paged}


# multi-card execution over the data axes ([multi]): 2 processes, one per
# data position, at full width; B 2 x 512 (one row a process), f32
MULTI_PROCS, MULTI_SEQ, MULTI_BATCH, MULTI_STEPS, MULTI_NEW = 2, 512, 2, 2, 8
# across processes the gradient sums run in another order (all_reduce)
MULTI_TOL = 1e-5
# the plain one-process step (grad_accum 1: the global batch in one GEMM,
# one mean) sums in yet another order, which AdamW's first update
# g / (|g| + eps) amplifies where gradients are near zero: its params are
# held at this distance, its loss and grad norm at MULTI_TOL
MULTI_PLAIN_TOL = 1e-4
MULTI_TIMEOUT = 600


def _multi_meshes(torch, rows):
    """The (positions, 1) data mesh over each row's first device and the
    (positions, 2) pipeline mesh over the rows' two stage devices."""
    import numpy as np

    from repro_torch.dist.sharding import Mesh

    def mesh(devs, m):
        return Mesh(np.array([torch.device(d) for d in devs], dtype=object).reshape(-1, m),
                    ("data", "model"))

    return mesh([r[0] for r in rows], 1), mesh([d for r in rows for d in r], 2)


def multi_child(rank, nprocs, init_method, job):
    """One data position of the ``[multi]`` phase (a spawned process): the
    port's train steps under scatter_gather, fused and pipeline and the
    static path, each on this process's rows of the global batch; process
    0 then runs the same work in one process (no group) for reference.
    Writes its record as JSON to ``job["out"]/multi_<rank>.json``."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import collective
    from repro_torch.dist.sharding import data_shards, place
    from repro_torch.ft.elastic import state_shardings
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.serve import run_static
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as st
    from repro_torch.tree import flatten_with_path, leaves as tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, rows, seq, batch, steps, new = (job[k] for k in ("cfg", "rows", "seq", "batch",
                                                          "steps", "new"))
    dmesh, pmesh = _multi_meshes(torch, rows)
    group = collective.data_group(dmesh, init_method=init_method, rank=rank,
                                  world_size=nprocs)
    dev = torch.device(rows[rank][0])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # every collective timed on the host clock between device syncs
    coll = {"s": 0.0, "calls": 0}

    def timed(fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                coll["s"] += time.perf_counter() - t0
                coll["calls"] += 1
        return run

    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        setattr(tdist, name, timed(getattr(tdist, name)))

    params = tf.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                     dtype=torch.float32, device=dev)
    data = SyntheticLM(cfg.vocab, seq, batch, seed=0)
    batches = [{"tokens": torch.from_numpy(data.batch(i)["tokens"]).long().to(dev)}
               for i in range(steps)]
    opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    bounds = (0, cfg.num_layers // 2, cfg.num_layers)
    rec = {"rank": rank, "backend": group.backend, "device": str(dev), "runs": {}}

    # one process runs the pipeline's data shards in turn on row 0's stages
    _, one_pmesh = _multi_meshes(torch, [rows[0]] * len(rows))

    def make(strategy, grp, shards):
        if strategy == "pipeline":
            return st.make_pipeline_train_step(cfg, opt, pmesh if grp else one_pmesh,
                                               num_microbatches=1,
                                               boundaries=bounds, schedule="1f1b",
                                               group=grp, shards=shards)
        # one process takes each process's row as a microbatch of its own
        # (the same per-row GEMMs, as the one-process pipeline runs its data
        # shards in turn), so the comparison isolates the cross-process mean
        return st.make_train_step(cfg, opt, grad_accum=1 if grp else nprocs, group=grp,
                                  shards=shards)

    def train(step_fn, state, grp):
        out = []
        for b in batches:
            flash_attention.launches = 0
            coll.update(s=0.0, calls=0)
            sync()
            collective.barrier(grp)
            t0 = time.perf_counter()
            state, met = step_fn(state, b)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            sync()
            out.append(dict(loss=loss, grad_norm=gnorm,
                            ms=(time.perf_counter() - t0) * 1e3,
                            collective_ms=coll["s"] * 1e3, collectives=coll["calls"],
                            flash=flash_attention.launches))
        return state, out

    def param_err(got, ref):
        """(max |difference|, its leaf's path) of two param trees."""
        return max((float((a - b).abs().max()), "/".join(map(str, path)))
                   for (path, a), (_, b) in zip(flatten_with_path(got), flatten_with_path(ref)))

    one = {}
    for strategy in ("scatter_gather", "fused", "pipeline"):
        mesh = pmesh if strategy == "pipeline" else dmesh
        state = st.make_state(params)
        specs = state_shardings(state, mesh, strategy)
        shards = data_shards(specs["params"], mesh)
        mine = place(state, specs, mesh, group)
        # the process's bytes: the stand-in's per-position arithmetic, its
        # row's stage positions summed (the data mesh's 'model' axis is 1)
        placed = sum(t.untyped_storage().nbytes() for t in tree_leaves(mine)
                     if isinstance(t, torch.Tensor))
        expect = tree_bytes(state, specs, dmesh)
        del state
        mine, steps_rec = train(make(strategy, group, shards), mine, group)
        whole = collective.gather_tree(mine["params"], shards, group)
        run = {"placed_bytes": placed, "expect_bytes": expect, "steps": steps_rec}
        del mine
        if rank == 0:
            key = "pipeline" if strategy == "pipeline" else "data"
            if key not in one:
                ref_state, ref_steps = train(make(strategy, None, None),
                                             st.make_state(params), None)
                one[key] = (ref_state["params"], ref_steps)
                del ref_state
                if key == "data":
                    # the step a user runs in one process: grad_accum 1
                    ref_state, ref_steps = train(st.make_train_step(cfg, opt),
                                                 st.make_state(params), None)
                    one["plain"] = (ref_state["params"], ref_steps)
                    del ref_state
            ref_params, run["one_process"] = one[key]
            run["param_err"], run["param_err_leaf"] = param_err(whole, ref_params)
            if key == "data":
                ref_params, run["plain"] = one["plain"]
                run["plain_param_err"], run["plain_param_err_leaf"] = param_err(whole,
                                                                                ref_params)
        del whole
        rec["runs"][strategy] = run
        if cuda:
            torch.cuda.empty_cache()
    one.clear()

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)
    flash_attention.launches = decode_attention.launches = 0
    res = run_static(params, cfg, prompts, new_tokens=new, chunk=seq, mesh=dmesh, group=group)
    serve = {"flash": flash_attention.launches, "decode": decode_attention.launches,
             "prefill_ms": res["prefill_s"] * 1e3, "decode_ms": res["decode_s"] * 1e3,
             "tokens": res["tokens"].tolist()}
    if rank == 0:
        ref = run_static(params, cfg, prompts, new_tokens=new, chunk=seq, return_logits=True)
        top2 = torch.stack(ref["logits"], dim=1).topk(2, dim=-1).values
        serve["one_process_tokens"] = ref["tokens"].tolist()
        serve["one_process_margin"] = (top2[..., 0] - top2[..., 1]).tolist()
        serve["one_process_decode_ms"] = ref["decode_s"] * 1e3
    rec["serve"] = serve
    with open(Path(job["out"]) / f"multi_{rank}.json", "w") as f:
        json.dump(rec, f)
    group.close()


def multi_phase(torch, cfg, dev, card: str) -> dict:
    """Multi-card execution over the data axes at qwen3_0p6b's full width:
    ``MULTI_PROCS`` processes, one per data position (``dist.collective``,
    spawned fresh, a file store under ``build/``), each on its rows of the
    global batch (B 2 x 512, f32): two train steps each under
    scatter_gather and fused on the (2, 1) mesh and pipeline on the (2, 2)
    mesh (2 stages a process, 1F1B, m 1), then the static path (8 new
    tokens).  On one card both processes share it (gloo); with two or more
    cards the phase runs again over distinct cards (NCCL; the pipeline's
    stages on distinct cards where there are four).  Gates: every
    process reads the same loss and grad norm, within ``MULTI_TOL`` of the
    same work in one process, and the gathered params too; each process's
    flash and decode launches equal the analytic counts; each process's
    placed state bytes equal the dry-run stand-in's arithmetic
    (``launch.dryrun.tree_bytes``), fused's below scatter_gather's; the
    gathered tokens equal the one-process run's where its top-2 margin
    clears the tolerance.  The data strategies are also held to the plain
    one-process step (grad_accum 1), params within ``MULTI_PLAIN_TOL``.  A
    failed child, collective or join fails the phase; nothing falls back
    to one process.  Returns the kernels' launches in the
    multi-process runs, summed over processes."""
    import shutil

    from repro_torch.dist import collective

    # each process's row: its pipeline stage devices (the data mesh takes
    # the first); one card shared by both processes, then distinct cards
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    layouts = [("gloo, one card shared", [[str(dev)] * 2] * MULTI_PROCS)]
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n >= 2:
        cards = [f"cuda:{i}" for i in range(n)]
        rows = [cards[0:2], cards[2:4]] if n >= 4 else [[cards[0]] * 2, [cards[1]] * 2]
        layouts.append(("nccl, distinct cards", rows))
    total = {"flash_attention": 0, "decode_attention": 0}
    L = cfg.num_layers
    for label, rows in layouts:
        out = ROOT / "build" / "multi"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        job = dict(cfg=cfg, rows=rows, seq=MULTI_SEQ, batch=MULTI_BATCH, steps=MULTI_STEPS,
                   new=MULTI_NEW, out=str(out))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        collective.spawn(multi_child, MULTI_PROCS, (job,), timeout=MULTI_TIMEOUT,
                         workdir=str(out))
        log(f"[multi] {label}: {MULTI_PROCS} processes, rows {rows}, done in "
            f"{time.perf_counter() - t0:.1f} s (spawn, params, 3 strategies x "
            f"{MULTI_STEPS} steps, the static path, process 0's one-process runs)")
        recs = [json.loads((out / f"multi_{r}.json").read_text()) for r in range(MULTI_PROCS)]
        want_backend = "nccl" if label.startswith("nccl") else "gloo"
        check(all(r["backend"] == want_backend for r in recs),
              f"[multi] {label}: backend {[r['backend'] for r in recs]}")
        for strategy in ("scatter_gather", "fused", "pipeline"):
            runs = [r["runs"][strategy] for r in recs]
            ref = runs[0]["one_process"]
            flash_per = (3 if strategy == "pipeline" else 2) * L
            for i in range(MULTI_STEPS):
                got = [(run["steps"][i]["loss"], run["steps"][i]["grad_norm"]) for run in runs]
                check(len(set(got)) == 1, f"[multi] {label} {strategy} step {i + 1}: "
                      f"processes read {got}")
                loss, gnorm = got[0]
                rl, rg = ref[i]["loss"], ref[i]["grad_norm"]
                check(abs(loss - rl) <= MULTI_TOL * abs(rl)
                      and abs(gnorm - rg) <= MULTI_TOL * abs(rg),
                      f"[multi] {label} {strategy} step {i + 1}: loss {loss} / grad_norm "
                      f"{gnorm} vs one process {rl} / {rg}")
                for r, run in enumerate(runs):
                    check(run["steps"][i]["flash"] == flash_per,
                          f"[multi] {label} {strategy} process {r} step {i + 1}: flash "
                          f"{run['steps'][i]['flash']} launches, expect {flash_per}")
                    total["flash_attention"] += run["steps"][i]["flash"]
                ms = [run["steps"][i]["ms"] for run in runs]
                cms = [run["steps"][i]["collective_ms"] for run in runs]
                calls = runs[0]["steps"][i]["collectives"]
                log(f"[multi] {label} {strategy} step {i + 1}: loss {loss:.6f} (one process "
                    f"{rl:.6f}), grad_norm {gnorm:.6f} ({rg:.6f}); step ms per process "
                    f"{[round(x, 1) for x in ms]} vs one process {ref[i]['ms']:.1f} ms; "
                    f"collectives {calls} calls, {[round(x, 1) for x in cms]} ms; flash "
                    f"{flash_per} a process; on {card}")
            check(runs[0]["param_err"] <= MULTI_TOL,
                  f"[multi] {label} {strategy}: params {runs[0]['param_err']} from one process")
            if "plain" in runs[0]:
                plain = runs[0]["plain"]
                for i in range(MULTI_STEPS):
                    got, want = runs[0]["steps"][i], plain[i]
                    check(all(abs(got[k] - want[k]) <= MULTI_TOL * abs(want[k])
                              for k in ("loss", "grad_norm")),
                          f"[multi] {label} {strategy} step {i + 1}: loss {got['loss']} / "
                          f"grad_norm {got['grad_norm']} vs the plain one-process step "
                          f"{want['loss']} / {want['grad_norm']}")
                check(runs[0]["plain_param_err"] <= MULTI_PLAIN_TOL,
                      f"[multi] {label} {strategy}: params {runs[0]['plain_param_err']} from "
                      f"the plain one-process step")
                log(f"[multi] {label} {strategy}: against the plain one-process step "
                    f"(grad_accum 1, {plain[-1]['ms']:.1f} ms a step): loss "
                    f"{plain[-1]['loss']:.6f}, grad_norm {plain[-1]['grad_norm']:.6f} at step "
                    f"{MULTI_STEPS}; params within {runs[0]['plain_param_err']:.3e} (tol "
                    f"{MULTI_PLAIN_TOL}; worst leaf {runs[0]['plain_param_err_leaf']})")
            for r, run in enumerate(runs):
                check(run["placed_bytes"] == run["expect_bytes"],
                      f"[multi] {label} {strategy} process {r}: placed {run['placed_bytes']} B "
                      f"vs the stand-in's {run['expect_bytes']} B")
            log(f"[multi] {label} {strategy}: params after {MULTI_STEPS} steps within "
                f"{runs[0]['param_err']:.3e} of one process (tol {MULTI_TOL}; worst leaf "
                f"{runs[0]['param_err_leaf']}); placed state "
                f"{[run['placed_bytes'] for run in runs]} B a process == the stand-in's "
                f"arithmetic")
        check(recs[0]["runs"]["fused"]["placed_bytes"]
              < recs[0]["runs"]["scatter_gather"]["placed_bytes"],
              f"[multi] {label}: fused holds less than scatter_gather")
        serves = [r["serve"] for r in recs]
        for r, sv in enumerate(serves):
            # the prompt is one 512-token chunk: one flash call a layer
            check(sv["flash"] == L and sv["decode"] == L * (MULTI_NEW - 1),
                  f"[multi] {label} static process {r}: flash {sv['flash']}, decode "
                  f"{sv['decode']} launches")
            total["flash_attention"] += sv["flash"]
            total["decode_attention"] += sv["decode"]
        toks, one = serves[0]["tokens"], serves[0]["one_process_tokens"]
        margin = serves[0]["one_process_margin"]
        check(all(sv["tokens"] == toks for sv in serves), f"[multi] {label}: gathered tokens "
              "differ between processes")
        equal = 0
        for row, (a, b) in enumerate(zip(toks, one)):
            first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
            equal += len(a) if first is None else first
            if first is not None:
                log(f"[multi] {label} static row {row}: first token differing from one process "
                    f"at {first}, one-process top-2 margin {margin[row][first]:.3e}")
                check(margin[row][first] < MULTI_TOL,
                      f"[multi] {label} static row {row}: token differs at a clear margin")
        log(f"[multi] {label} static path: {MULTI_BATCH} rows x {MULTI_NEW} tokens gathered, "
            f"{equal}/{MULTI_BATCH * MULTI_NEW} equal to one process; decode "
            f"{serves[0]['decode_ms']:.1f} ms on process 0 vs "
            f"{serves[0]['one_process_decode_ms']:.1f} ms in one process; flash "
            f"{serves[0]['flash']}, decode {serves[0]['decode']} launches a process")
    return total


# ---------------------------------------------------------------------------
# tensor and expert parallelism over the 'model' axis ([tp]): one process
# per mesh position
# ---------------------------------------------------------------------------

# qwen3_0p6b at full width, f32, global B 2 x 512, two AdamW steps under
# ai_core_assignment on (1, 2) and fused on (2, 2), then the static path on
# (1, 2) (8 new tokens)
TP_SEQ, TP_BATCH, TP_STEPS, TP_NEW = 512, 2, 2, 8
# TP sums each split product across the ranks (all_reduce) where one process
# sums it in one GEMM: losses and grad norms within this of one process
TP_TOL = 1e-5
# AdamW's first updates g / (|g| + eps) amplify those summation orders where
# a gradient is near zero: params held at this distance, as [multi]'s plain
# one-process step
TP_PARAM_TOL = 1e-4
TP_TIMEOUT = 600
# deepseek_v2_236b static under ai_core_assignment on (1, 2) at the [moe]
# phase's depth and shapes (MOE_STATIC); mixtral_8x22b training across 2
# processes (EP: 4 experts a process) at depth 1 (2.9e9 params).  In f32 its
# params, grads and two moments are 46.4 GB over the two processes, and
# AdamW builds the new params and moments beside the old ones and the
# clipped grads: 92.8 GB at the update, past the card's 80 GB (an f32 run
# ran out of memory there).  bf16 params and moments halve that (~52 GB);
# the comparison with one process is then held at a bf16 tolerance
TP_MIXTRAL_LAYERS, TP_MIXTRAL_DTYPE = 1, "bfloat16"
# one process's bf16 GEMM rounds its f32 sum once where the split product's
# halves round apart before the all_reduce
TP_BF16_TOL = 1e-2
# the one-process [moe] run's f32 static tokens and top-2 margins, per config
MOE_TOKENS: dict = {}


def _tp_mesh(torch, devs, shape):
    import numpy as np

    from repro_torch.dist.sharding import Mesh

    return Mesh(np.array([torch.device(d) for d in devs], dtype=object).reshape(shape),
                ("data", "model"))


def tp_child(rank, nprocs, init_method, job):
    """One mesh position of the ``[tp]`` phase (a spawned process): the
    job's train steps or static path tensor and expert parallel over its
    model group; process 0 then runs the same work in one process where the
    job asks.  Writes its record as JSON to ``job["out"]/tp_<rank>.json``."""
    import torch
    import torch.distributed as tdist

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import collective
    from repro_torch.dist.sharding import data_shards, model_shards, param_specs, place
    from repro_torch.ft.elastic import state_shardings
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.serve import run_static
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as st
    from repro_torch.tree import flatten_with_path, leaves as tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    kind, cfg, strategy, shape, devs = (job[k] for k in ("kind", "cfg", "strategy", "shape",
                                                         "devs"))
    mesh = _tp_mesh(torch, devs, shape)
    data, model = collective.mesh_groups(mesh, init_method=init_method, rank=rank,
                                         world_size=nprocs)
    dev = torch.device(devs[rank])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0

    def free():
        if cuda:
            torch.cuda.empty_cache()

    coll = {"s": 0.0, "calls": 0}

    def timed(fn):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                coll["s"] += time.perf_counter() - t0
                coll["calls"] += 1
        return run

    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        setattr(tdist, name, timed(getattr(tdist, name)))

    dtype = getattr(torch, job.get("dtype", "float32"))

    def make_params():
        return tf.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                       dtype=dtype, device=dev)

    def placed_in_turn(make, specs_of):
        """Each process in turn makes the whole tree on the card, keeps its
        slices and frees the rest, so that one whole tree is live at a time."""
        mine = expect = None
        for r in range(nprocs):
            if r == rank:
                whole = make()
                specs = specs_of(whole)
                expect = tree_bytes(whole, specs, mesh)
                mine = place(whole, specs, mesh, data, model)
                del whole
                free()
            collective.barrier(model, data)
        return mine, specs, expect

    rec = {"rank": rank, "backend": model.backend, "device": str(dev), "layers": cfg.num_layers}
    if kind == "train":
        opt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=job["steps"],
                          moments_dtype=job.get("dtype", "float32"))
        gen = SyntheticLM(cfg.vocab, job["seq"], job["batch"], seed=0)
        batches = [{"tokens": torch.from_numpy(gen.batch(i)["tokens"]).long().to(dev)}
                   for i in range(job["steps"])]
        state, specs, expect = placed_in_turn(
            lambda: st.make_state(make_params(), dtype),
            lambda s: state_shardings(s, mesh, strategy))
        rec["placed_bytes"] = sum(t.untyped_storage().nbytes() for t in tree_leaves(state)
                                  if isinstance(t, torch.Tensor))
        rec["expect_bytes"] = expect
        shards = data_shards(specs["params"], mesh) if data is not None else None
        mshards = model_shards(specs["params"], mesh)
        step = st.make_train_step(cfg, opt, group=data, shards=shards, model=model,
                                  model_shards=mshards)
        steps = []
        for b in batches:
            flash_attention.launches = 0
            coll.update(s=0.0, calls=0)
            sync()
            collective.barrier(model, data)
            t0 = time.perf_counter()
            state, met = step(state, b)
            loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            sync()
            steps.append(dict(loss=loss, grad_norm=gnorm, ms=(time.perf_counter() - t0) * 1e3,
                              collective_ms=coll["s"] * 1e3, collectives=coll["calls"],
                              flash=flash_attention.launches))
        rec["steps"] = steps
        rec["peak_gib"] = peak_gib()
        if job.get("compare"):
            whole = collective.gather_tree(collective.gather_tree(state["params"], shards, data),
                                           mshards, model)
            del state
            free()
            if rank == 0:
                # the same rows in one process: each data position's rows as
                # a microbatch of their own, as the processes compute them
                ref = st.make_state(make_params(), dtype)
                one = st.make_train_step(cfg, opt, grad_accum=shape[0])
                rsteps = []
                for b in batches:
                    flash_attention.launches = 0
                    sync()
                    t0 = time.perf_counter()
                    ref, met = one(ref, b)
                    rsteps.append(dict(loss=float(met["loss"]),
                                       grad_norm=float(met["grad_norm"]),
                                       ms=(time.perf_counter() - t0) * 1e3))
                rec["one_process"] = rsteps
                rec["param_err"], rec["param_err_leaf"] = max(
                    (float((a - b).abs().max()), "/".join(map(str, p)))
                    for (p, a), (_, b) in zip(flatten_with_path(whole),
                                              flatten_with_path(ref["params"])))
                del ref
            del whole
        else:
            del state
        free()
        collective.barrier(model, data)
    if kind in ("train", "serve") and job.get("serve"):
        params, _, _ = placed_in_turn(make_params,
                                      lambda p: param_specs(p, mesh, strategy))
        batch, prompt, chunk, new = job["serve"]
        gen = torch.Generator(device=dev).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device=dev)
        flash_attention.launches = decode_attention.launches = 0
        res = run_static(params, cfg, prompts, new_tokens=new, chunk=chunk, mesh=mesh,
                         group=data, model=model)
        serve = {"flash": flash_attention.launches, "decode": decode_attention.launches,
                 "prefill_ms": res["prefill_s"] * 1e3, "decode_ms": res["decode_s"] * 1e3,
                 "tokens": res["tokens"].tolist(),
                 "kv_heads": tf.cache_kv_heads(params, cfg),
                 "peak_gib": peak_gib()}
        del params
        free()
        collective.barrier(model, data)
        if rank == 0 and job.get("compare"):
            whole = make_params()
            ref = run_static(whole, cfg, prompts, new_tokens=new, chunk=chunk,
                             return_logits=True)
            top2 = torch.stack(ref["logits"], dim=1).topk(2, dim=-1).values
            serve["one_process_tokens"] = ref["tokens"].tolist()
            serve["one_process_margin"] = (top2[..., 0] - top2[..., 1]).tolist()
            serve["one_process_decode_ms"] = ref["decode_s"] * 1e3
            del whole, ref
        rec["serve"] = serve
    with open(Path(job["out"]) / f"tp_{rank}.json", "w") as f:
        json.dump(rec, f)
    collective.close(data, model)


def tp_spawn(torch, label: str, job: dict) -> list:
    """Run ``job`` on every mesh position (``collective.spawn``, a file store
    under ``build/tp``); returns the processes' records."""
    import math
    import shutil

    from repro_torch.dist import collective

    out = ROOT / "build" / "tp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    n = math.prod(job["shape"])
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    collective.spawn(tp_child, n, (dict(job, out=str(out)),), timeout=TP_TIMEOUT,
                     workdir=str(out))
    log(f"[tp] {label}: {n} processes on {job['devs']} done in "
        f"{time.perf_counter() - t0:.1f} s")
    return [json.loads((out / f"tp_{r}.json").read_text()) for r in range(n)]


def tp_check_train(label: str, recs: list, flash_per: int, card: str, *, params=True,
                   tol: float = TP_TOL) -> int:
    """The [multi] gates on a TP train job, losses and grad norms within
    ``tol``; returns its flash launches."""
    ref = recs[0].get("one_process")
    total = 0
    for i in range(len(recs[0]["steps"])):
        got = [(r["steps"][i]["loss"], r["steps"][i]["grad_norm"]) for r in recs]
        check(len(set(got)) == 1, f"[tp] {label} step {i + 1}: processes read {got}")
        loss, gnorm = got[0]
        rl, rg = ref[i]["loss"], ref[i]["grad_norm"]
        check(abs(loss - rl) <= tol * abs(rl) and abs(gnorm - rg) <= tol * abs(rg),
              f"[tp] {label} step {i + 1}: loss {loss} / grad_norm {gnorm} vs one process "
              f"{rl} / {rg}")
        for r, run in enumerate(recs):
            check(run["steps"][i]["flash"] == flash_per,
                  f"[tp] {label} process {r} step {i + 1}: flash {run['steps'][i]['flash']} "
                  f"launches, expect {flash_per}")
            total += run["steps"][i]["flash"]
        ms = [run["steps"][i]["ms"] for run in recs]
        cms = [run["steps"][i]["collective_ms"] for run in recs]
        log(f"[tp] {label} step {i + 1}: loss {loss:.6f} (one process {rl:.6f}), grad_norm "
            f"{gnorm:.6f} ({rg:.6f}); step ms per process {[round(x, 1) for x in ms]} vs one "
            f"process {ref[i]['ms']:.1f} ms; collectives {recs[0]['steps'][i]['collectives']} "
            f"calls, {[round(x, 1) for x in cms]} ms; flash {flash_per} a process; on {card}")
    if params:
        check(recs[0]["param_err"] <= TP_PARAM_TOL,
              f"[tp] {label}: params {recs[0]['param_err']} from one process")
        log(f"[tp] {label}: params after {len(ref)} steps within {recs[0]['param_err']:.3e} of "
            f"one process (tol {TP_PARAM_TOL}; worst leaf {recs[0]['param_err_leaf']})")
    for r, run in enumerate(recs):
        check(run["placed_bytes"] == run["expect_bytes"],
              f"[tp] {label} process {r}: placed {run['placed_bytes']} B vs the stand-in's "
              f"{run['expect_bytes']} B")
    log(f"[tp] {label}: placed state {[run['placed_bytes'] for run in recs]} B a process == "
        f"the stand-in's arithmetic; peak device memory a process "
        f"{[round(run['peak_gib'], 2) for run in recs]} GiB")
    return total


def tp_check_tokens(label: str, toks, one, margin, tol: float) -> int:
    """Tokens equal to one process's but at a near tie; returns the count
    equal."""
    equal = 0
    for row, (a, b) in enumerate(zip(toks, one)):
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        equal += len(a) if first is None else first
        if first is not None:
            log(f"[tp] {label} row {row}: first token differing from one process at {first}, "
                f"one-process top-2 margin {margin[row][first]:.3e}")
            check(margin[row][first] < tol, f"[tp] {label} row {row}: token differs at a "
                  f"clear margin")
    return equal


def tp_kernel_parity(torch, gen, dev) -> dict:
    """Flash and dense decode at the [tp] phase's local head counts against
    their plain versions: qwen3 at model 2 (8 query / 4 KV heads, training
    rows B 2 and B 1 at S 512, decode B 2 at kv_len 519), mixtral's 24 / 4
    (G 6), MLA at 64 heads (prefill D 192, Dv 128; absorbed decode D 576,
    Dv 512).  Returns the worst f32 error per kernel."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for name, (b, h, hkv, d, dv) in {"qwen3 model 2 B 2": (2, 8, 4, 128, 128),
                                     "qwen3 model 2 B 1": (1, 8, 4, 128, 128),
                                     "mixtral model 2": (2, 24, 4, 128, 128),
                                     "deepseek MLA model 2": (2, 64, 64, 192, 128)}.items():
        q, k, v = randn(b, TP_SEQ, h, d), randn(b, TP_SEQ, hkv, d), randn(b, TP_SEQ, hkv, dv)
        got = flash_attention(q, k, v)
        want = flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.isfinite(got).all() and err <= TOL["float32"],
              f"[tp] flash {name}: max|err| {err}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
        log(f"[tp] flash {name} (S {TP_SEQ}, {h}/{hkv} heads, D {d}, Dv {dv}): max|err| "
            f"{err:.3e} (tol {TOL['float32']})")
    t = TP_SEQ + TP_NEW
    for name, (b, h, hkv, d, dv, shared) in {
            "qwen3 model 2": (TP_BATCH, 8, 4, 128, 128, False),
            "deepseek MLA absorbed model 2": (2, 64, 1, 576, 512, True)}.items():
        q, k = randn(b, 1, h, d), randn(b, t, hkv, d)
        v = k[..., :dv] if shared else randn(b, t, hkv, dv)
        got = decode_attention(q, k, v, kv_len=t - 1)
        want = decode_attention_ref(q, k, v, kv_len=t - 1)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.isfinite(got).all() and err <= TOL["float32"],
              f"[tp] decode {name}: max|err| {err}")
        errs["decode_attention"] = max(errs["decode_attention"], err)
        log(f"[tp] decode {name} ({h}/{hkv} heads, D {d}, Dv {dv}, kv_len {t - 1}): max|err| "
            f"{err:.3e} (tol {TOL['float32']})")
    return errs


def tp_phase(torch, dev, card: str, configs=None) -> dict:
    """Tensor and expert parallelism, one process per mesh position
    (``dist.collective.mesh_groups``, spawned fresh, a file store under
    ``build/``; on one card the processes share it over gloo, which gates
    arithmetic and layouts; with enough cards the qwen3 jobs run again over
    distinct cards, NCCL).  qwen3_0p6b at full width, f32, global B 2 x 512:
    two AdamW steps under ai_core_assignment on (1, 2) and fused on (2, 2),
    each process's loss and grad norm within ``TP_TOL`` of the same rows in
    one process, params within ``TP_PARAM_TOL``, flash launches a process
    exact (at 8 query / 4 KV heads), placed state bytes equal to the dry-run
    stand-in's; the static path on (1, 2), 8 new tokens, equal to one
    process's under the margin rule, dense decode launches exact at the
    local heads.  deepseek_v2_236b's static path at the [moe] phase's depth
    and shapes under ai_core_assignment on (1, 2), half the experts a
    process, tokens equal to the one-process [moe] run's under the margin
    rule.  mixtral_8x22b training across 2 processes (EP, depth
    ``TP_MIXTRAL_LAYERS``, bf16 params and moments), loss and grad norm
    within ``TP_BF16_TOL`` of one process (the parent's run, after the
    children free the card).  A failed
    child, collective or join fails the phase; nothing falls back.
    ``configs`` (arch -> config) replaces the full-width configs (a CPU
    rehearsal).  Returns the launches per kernel, summed over processes,
    and the worst parity error per kernel."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as st

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    configs = configs or {}

    def config(name, layers=None):
        cfg = configs.get(name) or get_config(name)
        return dataclasses.replace(cfg, num_layers=layers) if layers else cfg

    gen = torch.Generator(device=dev).manual_seed(4321)
    errs = tp_kernel_parity(torch, gen, dev)
    total = {"flash_attention": 0, "decode_attention": 0}
    qwen = config(ARCH)
    L = qwen.num_layers
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    cards = [f"cuda:{i}" for i in range(n)]
    for shape, strategy in (((1, 2), "ai_core_assignment"), ((2, 2), "fused")):
        size = shape[0] * shape[1]
        layouts = [("gloo, one card shared", [str(dev)] * size)]
        if n >= size:
            layouts.append(("nccl, distinct cards", cards[:size]))
        for where, devs in layouts:
            label = f"qwen3 {strategy} {shape} ({where})"
            serve = (TP_BATCH, TP_SEQ, TP_SEQ, TP_NEW) if shape == (1, 2) else None
            recs = tp_spawn(torch, label, dict(
                kind="train", cfg=qwen, strategy=strategy, shape=shape, devs=devs,
                seq=TP_SEQ, batch=TP_BATCH, steps=TP_STEPS, serve=serve, compare=True))
            want = "nccl" if where.startswith("nccl") else "gloo"
            check(all(r["backend"] == want for r in recs),
                  f"[tp] {label}: backend {[r['backend'] for r in recs]}")
            # each process computes its rows' forward and the remat recompute
            total["flash_attention"] += tp_check_train(label, recs, 2 * L, card)
            if serve:
                sv = [r["serve"] for r in recs]
                for r, s in enumerate(sv):
                    check(s["flash"] == L and s["decode"] == L * (TP_NEW - 1)
                          and s["kv_heads"] == qwen.kv_heads // shape[1],
                          f"[tp] {label} static process {r}: flash {s['flash']}, decode "
                          f"{s['decode']} launches, {s['kv_heads']} KV heads")
                    total["flash_attention"] += s["flash"]
                    total["decode_attention"] += s["decode"]
                check(all(s["tokens"] == sv[0]["tokens"] for s in sv),
                      f"[tp] {label}: tokens differ between processes")
                equal = tp_check_tokens(label + " static", sv[0]["tokens"],
                                        sv[0]["one_process_tokens"],
                                        sv[0]["one_process_margin"], TP_TOL)
                log(f"[tp] {label} static path: {TP_BATCH} rows x {TP_NEW} tokens, "
                    f"{equal}/{TP_BATCH * TP_NEW} equal to one process; decode "
                    f"{sv[0]['decode_ms']:.1f} ms on process 0 vs "
                    f"{sv[0]['one_process_decode_ms']:.1f} ms in one process; flash "
                    f"{sv[0]['flash']}, decode {sv[0]['decode']} launches a process at "
                    f"{qwen.num_heads // shape[1]} query / {sv[0]['kv_heads']} KV heads")

    # deepseek: half the experts (and heads, vocabulary) a process
    name = "deepseek_v2_236b"
    batch, prompt, chunk, new = MOE_STATIC[name]
    check(name in MOE_TOKENS, "[tp] the [moe] phase recorded deepseek's one-process tokens")
    recs = tp_spawn(torch, f"{name} static ai_core_assignment (1, 2)", dict(
        kind="serve", cfg=config(name, MOE_LAYERS), strategy="ai_core_assignment",
        shape=(1, 2), devs=[str(dev)] * 2, serve=(batch, prompt, chunk, new)))
    sv = [r["serve"] for r in recs]
    nl = recs[0]["layers"]
    for r, s in enumerate(sv):
        check(s["flash"] == nl * (-(-prompt // chunk)) and s["decode"] == nl * (new - 1),
              f"[tp] {name} static process {r}: flash {s['flash']}, decode {s['decode']}")
        total["flash_attention"] += s["flash"]
        total["decode_attention"] += s["decode"]
    check(all(s["tokens"] == sv[0]["tokens"] for s in sv), f"[tp] {name}: tokens differ "
          "between processes")
    one, margin = MOE_TOKENS[name]
    equal = tp_check_tokens(f"{name} static", sv[0]["tokens"], one, margin, LOGIT_TOL)
    log(f"[tp] {name} static (1, 2): {equal}/{batch * new} tokens equal to the one-process "
        f"[moe] run's; prefill {sv[0]['prefill_ms']:.1f} ms, decode {sv[0]['decode_ms']:.1f} "
        f"ms on process 0; peak device memory a process {[round(s['peak_gib'], 2) for s in sv]}"
        f" GiB; on {card}")

    # mixtral: EP training across 2 processes, then the same in one process
    name = "mixtral_8x22b"
    cfg = config(name, TP_MIXTRAL_LAYERS)
    recs = tp_spawn(torch, f"{name} train ai_core_assignment (1, 2) {TP_MIXTRAL_DTYPE}", dict(
        kind="train", cfg=cfg, strategy="ai_core_assignment", dtype=TP_MIXTRAL_DTYPE,
        shape=(1, 2), devs=[str(dev)] * 2, seq=TP_SEQ, batch=TP_BATCH, steps=TP_STEPS))
    dtype = getattr(torch, TP_MIXTRAL_DTYPE)
    state = st.make_state(tf.init(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                                  dtype=dtype, device=dev), dtype)
    step = st.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=TP_STEPS,
                                               moments_dtype=TP_MIXTRAL_DTYPE))
    data = SyntheticLM(cfg.vocab, TP_SEQ, TP_BATCH, seed=0)
    ref = []
    for i in range(TP_STEPS):
        b = {"tokens": torch.from_numpy(data.batch(i)["tokens"]).long().to(dev)}
        t0 = time.perf_counter()
        state, met = step(state, b)
        ref.append(dict(loss=float(met["loss"]), grad_norm=float(met["grad_norm"]),
                        ms=(time.perf_counter() - t0) * 1e3))
    log(f"[tp] {name} one process ({cfg.num_layers} layer): step ms "
        f"{[round(r['ms'], 1) for r in ref]}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    del state, step
    torch.cuda.empty_cache()
    recs[0]["one_process"] = ref
    total["flash_attention"] += tp_check_train(
        f"{name} ai_core_assignment (1, 2) {TP_MIXTRAL_DTYPE}", recs, 2 * cfg.num_layers, card,
        params=False, tol=TP_BF16_TOL)
    return {"launches": total, "errs": errs}


def leaves(tree):
    """The tensors of a param tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree



def build_kernels(names=None) -> None:
    """Build the kernels (all of them by default), one nvcc each, all at
    once, and log the build time and ptxas' register and spill report."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all(*(() if names is None else (names,)))
    log(f"[build] {len(reports)} kernels with nvcc in {time.perf_counter() - t0:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def timings_main(torch, dev) -> int:
    """``--timings``: build the decode, paged and ALU kernels and time them
    as the full run does (``time_decode``, ``time_paged``, ``time_alu`` on
    random int32 accumulators of the four ResNet-18 conv GEMMs' shapes),
    nothing else.  Run from two checkouts in one call, it compares their
    kernels on one card."""
    build_kernels(("decode_attention", "paged_decode_attention", "vta_alu"))
    gen = torch.Generator(device=dev).manual_seed(1234)
    time_decode(torch, gen, dev)
    time_paged(torch, gen, dev)
    accs = [(name, torch.randint(-(2 ** 20), 2 ** 20, (hw_o * hw_o, cout), generator=gen,
                                 device=dev, dtype=torch.int32))
            for name, hw, _, cout, _, stride in RESNET for hw_o in (hw // stride,)]
    time_alu(torch, alu_operands(torch, gen, dev, accs))
    return 0


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repository's sources are missing (no "
              f"{ROOT / 'src' / 'repro_torch'}); run it from a checkout", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_ref, decode_partition_counts,
        decode_partition_map, paged_decode_attention, paged_decode_attention_ref,
        paged_partition_counts)
    from repro_torch.kernels.flash_attention import (
        attention_f64, flash_attention, flash_attention_ref, flash_tile_counts, flash_tile_map)
    from repro_torch.launch.serve import run_static
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.optim.quant import quantize_params
    from repro_torch.serve.step import make_prefill_step, make_serve_step

    # f32 matmuls in full f32 (PyTorch's default, stated); cuDNN's TF32 flag
    # stays at its default (on): resnet._conv turns it off around its f32
    # convolutions, and the [resnet] phase's f64 check would catch a miss
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
        f"nvidia-smi: {smi}; devices {torch.cuda.device_count()}")
    if sys.argv[1:] == ["--timings"]:
        return timings_main(torch, dev)
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]} (only --timings)")

    # ---- build -----------------------------------------------------------
    lap = Laps()
    build_kernels()
    lap("build")

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

    # f32 accuracy: kernel and plain version against exact f64 attention at
    # the main path's four chunk offsets and the window case
    q = randn(b, s, h, d)
    k = randn(b, t, hkv, d)
    v = randn(b, t, hkv, d)
    f64_cases = [dict(q_offset=i * CHUNK, kv_len=(i + 1) * CHUNK) for i in range(PROMPT // CHUNK)]
    f64_cases.append(dict(q_offset=1536, kv_len=2048, window=256))
    for opts in f64_cases:
        exact = attention_f64(q, k, v, **opts)
        got = flash_attention(q, k, v, **opts)
        want = flash_attention_ref(q, k, v, **opts)
        torch.cuda.synchronize()
        err = (got.double() - exact).abs().max().item()
        perr = (want.double() - exact).abs().max().item()
        log(f"[f64] flash {opts} float32: kernel vs exact f64 attention max|err| {err:.3e} "
            f"(gate {F64_TOL}), plain version {perr:.3e}")
        check(err <= F64_TOL, f"flash {opts}: {err} from f64 attention > {F64_TOL}")
    del q, k, v, exact, got, want

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

    # MLA's absorbed decode at full width (128 heads on one latent head, D 576,
    # v a view of the leading 512 columns of k, as the absorbed cache is)
    m = MLA_SHAPE
    q = randn(m["b"], 1, m["h"], m["d"])
    k = randn(m["b"], t, m["hkv"], m["d"])
    v = k[..., :m["dv"]]
    n0 = decode_attention.launches
    got, counts = decode_attention(q, k, v, kv_len=m["kv"], return_counts=True)
    want = decode_attention_ref(q, k, v, kv_len=m["kv"])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(decode_attention.launches == n0 + 1, "decode MLA: one launch")
    check(got.shape == (m["b"], 1, m["h"], m["dv"]) and torch.isfinite(got).all(),
          "decode MLA: shape, finite")
    check(err <= TOL["float32"], f"decode MLA full width: max|err| {err}")
    pmap = decode_partition_map(t, m["kv"]).to(dev)
    executed, total = decode_partition_counts(t, m["kv"])
    check(torch.equal(counts, pmap.expand_as(counts)) and int(counts[0, 0].sum()) == executed
          and counts[0, 0].numel() == total, "decode MLA: map vs decode_partition_counts")
    errs["decode_attention"] = max(errs["decode_attention"], err)
    log(f"[parity] decode MLA full width B {m['b']} H {m['h']} D {m['d']} Dv {m['dv']} "
        f"kv_len={m['kv']} float32: max|err| {err:.3e} (tol {TOL['float32']}), one launch, "
        f"map == decode_partition_counts ({executed}/{total} partitions)")
    del q, k, v, got, want

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

    # the VTA GEMM, all three epilogues
    errs.update({f"vta_gemm_{epi}": err for epi, err in vta_parity(torch, gen, dev).items()})
    lap("kernel parity")

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
    lap("static path")

    # ---- the paged engine: the second main path ------------------------------
    engine_run = engine_phases(torch, params, cfg, dev, f"{kind} ({smi})")
    n_paged = engine_run["n_paged"]
    lap("engine")

    # ---- fault-tolerant serving and training on the same weights ---------------
    qparams = quantize_params(params)
    serve_ft_phase(torch, params, qparams, cfg, dev, f"{kind} ({smi})", engine_run)
    lap("serve-ft")
    n_train_flash = train_phase(torch, params, cfg, dev, f"{kind} ({smi})")
    lap("train")
    n_train_flash += pipeline_phase(torch, params, cfg, dev, f"{kind} ({smi})")
    lap("pipeline")
    n_train_flash += train_ft_phase(torch, params, cfg, dev, f"{kind} ({smi})")
    lap("train-ft")
    tuned = tune_phase(torch, params, cfg, dev, f"{kind} ({smi})", engine_run)
    n_train_flash += tuned["flash_attention"]
    n_paged += tuned["paged_decode_attention"]
    lap("tune")
    multi = multi_phase(torch, cfg, dev, f"{kind} ({smi})")
    n_train_flash += multi["flash_attention"]
    n_multi_decode = multi["decode_attention"]
    lap("multi")
    check(layers.attention_impl() == "auto" and layers.gemm_impl() == "auto"
          and layers.tuning_table() is None,
          "the dispatch reads auto, untuned, after the serving-fault, training and tuning phases")

    # ---- the VTA path and int8 serving: the third ------------------------------
    n_none, n_req, vta_operands = vta_phase(torch, gen, dev)
    n_deq = int8_static_phase(torch, params, qparams, cfg, prompts, dev, f"{kind} ({smi})")
    int8_engine_phase(torch, qparams, cfg, dev, f"{kind} ({smi})")
    lap("vta and int8")

    # ---- the VTA ALU, ResNet-18 and the planner: the fourth --------------------
    alu_counts, alu_errs, alu_pairs = alu_phase(torch, gen, dev, vta_operands)
    resnet_phase(torch, dev, f"{kind} ({smi})")
    planner_phase()
    lap("alu, resnet and planner")

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
        ms = cuda_ms(torch, lambda _: flash_attention(q, k, v, q_offset=q_off, kv_len=kv_len))
        plain = cuda_ms(torch, lambda _: flash_attention_ref(q, k, v, q_offset=q_off,
                                                           kv_len=kv_len), reps=5)
        lib = cuda_ms(torch, lambda _: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=mask))
        flops, nbytes = flash_work(b, s, h, hkv, d, d, q_off, kv_len, 4)
        bnd, by = bound_ms(3 * flops, nbytes, "tf32")
        simt, _ = bound_ms(flops, nbytes, "float32")
        log(f"[time] flash q_offset={q_off} kv_len={kv_len}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}, 3xTF32 at "
            f"495 TFLOP/s; SIMT f32 bound {simt:.4f} ms; {flops / 1e9:.2f} GFLOP, "
            f"{nbytes / 1e6:.2f} MB)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bnd), ("flops", flops), ("bytes", nbytes)):
            acc[key] += val / len(offsets)
    bnd, by = bound_ms(3 * acc["flops"], acc["bytes"], "tf32")
    simt, _ = bound_ms(acc["flops"], acc["bytes"], "float32")
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:196", launches=n_flash + n_train_flash,
        max_abs_err=errs["flash_attention"], ms=acc["ms"], plain_ms=acc["plain_ms"],
        bound_ms=bnd, bound_by=by, library_ms=acc["library_ms"])
    log(f"[time] flash mean over the main path's 4 chunk offsets: kernel "
        f"{acc['ms']:.4f} ms, sdpa {acc['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by}, "
        f"3xTF32; SIMT f32 bound {simt:.4f} ms), "
        f"{acc['flops'] / (acc['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
    # bf16 at the same shapes: one bf16 tensor-core pass, beside SDPA in bf16
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    bacc = {key: 0.0 for key in ("ms", "library_ms", "flops", "bytes")}
    for q_off in offsets:
        kv_len = q_off + s
        mask = (torch.arange(kv_len, device=dev)[None, :]
                <= q_off + torch.arange(s, device=dev)[:, None])
        qt = qb.transpose(1, 2)
        kt = kb[:, :kv_len].repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        vt = vb[:, :kv_len].repeat_interleave(h // hkv, dim=2).transpose(1, 2)
        ms = cuda_ms(torch, lambda _: flash_attention(qb, kb, vb, q_offset=q_off, kv_len=kv_len))
        lib = cuda_ms(torch, lambda _: F.scaled_dot_product_attention(qt, kt, vt,
                                                                    attn_mask=mask))
        flops, nbytes = flash_work(b, s, h, hkv, d, d, q_off, kv_len, 2)
        for key, val in (("ms", ms), ("library_ms", lib), ("flops", flops), ("bytes", nbytes)):
            bacc[key] += val / len(offsets)
    bbnd, bby = bound_ms(bacc["flops"], bacc["bytes"], "bfloat16")
    log(f"[time] flash bf16 mean over the main path's 4 chunk offsets: kernel "
        f"{bacc['ms']:.4f} ms, sdpa bf16 {bacc['library_ms']:.4f} ms, bound {bbnd:.4f} ms "
        f"({bby}, 989 TFLOP/s), {bacc['flops'] / (bacc['ms'] * 1e-3) / 1e12:.2f} TFLOP/s")
    del qb, kb, vb
    # the other configs' layer shapes: the dense family's G 7 / 8 / 12,
    # mixtral's windowed G 6 and MLA's prefill (G 1, D 192, Dv 128)
    errs["flash_attention"] = max(errs["flash_attention"],
                                  flash_family_phase(torch, gen, dev, f"{kind} ({smi})"))

    row = time_decode(torch, gen, dev)[DECODE_TIMED[0][0]]
    rows["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:215",
        launches=n_decode + n_multi_decode,
        max_abs_err=errs["decode_attention"], **row)
    row = time_paged(torch, gen, dev)[PAGED_TIMED[0][0]]
    del row["eager_ms"]
    rows["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:402", launches=n_paged,
        max_abs_err=errs["paged_decode_attention"], **row)
    paged_mla_phase(torch, gen, dev, TOL["float32"])

    deq = time_dequant(torch, gen, params, qparams, dev)
    vta = time_vta(torch, vta_operands)
    for epi, line, launches, row in (("none", 178, n_none, vta["none"]),
                                     ("requant", 189, n_req, vta["requant"]),
                                     ("dequant", 206, n_deq, deq[4])):
        rows[f"vta_gemm_{epi}"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/vta_gemm.cu",
            replaces=f"src/repro/kernels/vta_gemm.py:{line}", launches=launches,
            max_abs_err=errs[f"vta_gemm_{epi}"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"])
    alu = time_alu(torch, alu_pairs)
    for kind_, line, ops_ in (("binary", 68, ("add", "max", "min")),
                              ("unary", 77, ("add_imm", "max_imm", "relu", "shr"))):
        row = alu[kind_]
        rows[f"vta_alu_{kind_}"] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/vta_alu.cu",
            replaces=f"src/repro/kernels/vta_alu.py:{line}",
            launches=sum(alu_counts[o] for o in ops_), max_abs_err=float(alu_errs[kind_]),
            ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"])
    check(len(rows) == 8, "eight kernels in the record")
    lap("kernel timings")

    # ---- the MoE family: deepseek_v2_236b and mixtral_8x22b, the fifth ---------
    del params, qparams, prompts, res, warm
    torch.cuda.empty_cache()
    moe = moe_phases(torch, dev, f"{kind} ({smi})")
    for path, counts in moe.items():
        log(f"[moe] launches on {path}: {counts}")
    lap("moe")

    # ---- tensor and expert parallelism: one process per mesh position ---------
    tp = tp_phase(torch, dev, f"{kind} ({smi})")
    for name, n in tp["launches"].items():
        log(f"[tp] {name} launches over every process: {n}")
        rows[name]["launches"] += n
    for name, err in tp["errs"].items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    lap("tp")

    # ---- the remaining families: mamba2, zamba2, seamless, internvl2 ----------
    # the kernels at the families' new shapes first, then the models
    for name, err in family_kernel_phase(torch, gen, dev, f"{kind} ({smi})").items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    families = family_phases(torch, dev, f"{kind} ({smi})")
    for path, counts in families.items():
        log(f"[family] launches on {path}: {counts}")
        for name in ("flash_attention", "decode_attention", "vta_gemm_dequant"):
            rows[name]["launches"] += counts[name]
    lap("families")

    print(json.dumps({"kernels": [dict(name=n, **r) for n, r in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
