"""Micro-benchmark harness for the port's runtime hot paths (the port of
``repro.core.measure``).

Each ``measure_*`` function times one hot path through the dispatcher
the model code calls — flash prefill across ``(seq, block_q, block_k)``,
dense split-KV decode across ``(fill, block_k)``,
``paged_decode_attend`` across ``(fill, page_size)``, the int8 VTA GEMM
across block presets, and the engine's prefill-chunk buckets — with
warmup calls discarded and a median of fenced calls, and returns profile
entries

    {"kind": <cost kind>, "params": {...}, "t_s": <median seconds>}

that :meth:`repro_torch.core.cost_model.RuntimeCostModel.fit` consumes
and ``core.autotune.tune_runtime`` searches over.  ``collect_profile``
wraps entries with the provenance the fit is keyed by (device signature
+ config hash): a profile measured under one device or dispatch must
never parameterize another.

Inputs come from a seeded ``torch.Generator`` on ``device`` (the card by
default; the CPU only when a caller asks, where the kernels' plain
versions run).  The port's dense decode kernel and its GEMM pick their
own tiles, so ``measure_decode``'s ``block_k`` and ``measure_gemm``'s
blocks are recorded but change nothing the card runs.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import time

import torch

#: profile schema — bump on incompatible entry changes
PROFILE_SCHEMA = 1

#: default shapes shared by the measurement grids and ``choose_pattern``
#: (aux params must match between profile and prediction)
DEFAULT_AUX = dict(batch=1, heads=4, kv_heads=2, head_dim=64)


def device_signature(device="cuda") -> str:
    """Identity the profile/tuning table is keyed by: torch's device type,
    the card's name (``cpu`` on the CPU) and the active attention/GEMM
    dispatch.  The JAX package names its backends cpu / gpu / tpu, so no
    table it tuned on an accelerator carries a ``cuda/...`` signature."""
    from repro_torch.models import layers

    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return (f"{dev.type}/{name}/"
            f"attn={layers.attention_impl()},gemm={layers.gemm_impl()}")


def config_hash(cfg) -> str:
    """Stable short hash of a model config (profiles carry it so serving
    entries only parameterize the config they timed)."""
    if dataclasses.is_dataclass(cfg):
        src = json.dumps(
            {k: repr(v) for k, v in dataclasses.asdict(cfg).items()},
            sort_keys=True)
    else:
        src = repr(cfg)
    return hashlib.md5(src.encode()).hexdigest()[:12]


def _fence(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn, *args, warmup: int = 2, reps: int = 5, device="cuda") -> float:
    """Median-of-``reps`` wall seconds for ``fn(*args)``, after
    ``warmup`` discarded calls (first launches, allocator and cache
    effects), every call fenced with a synchronize of ``device`` so
    asynchronous launches can't lie."""
    for _ in range(max(warmup, 1)):
        fn(*args)
        _fence(device)
    ts = []
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn(*args)
        _fence(device)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _entry(kind: str, params: dict, t_s: float) -> dict:
    return {"kind": kind, "params": dict(params), "t_s": float(t_s)}


def _aux(overrides: dict) -> dict:
    out = dict(DEFAULT_AUX)
    out.update({k: v for k, v in overrides.items() if v is not None})
    return out


def _randn(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# per-hot-path measurement grids
# ---------------------------------------------------------------------------


def measure_flash_prefill(*, seqs=(256,), blocks=((64, 64), (128, 128)),
                          batch=None, heads=None, kv_heads=None,
                          head_dim=None, warmup=2, reps=5,
                          device="cuda") -> list[dict]:
    """Time ``layers.flash_attend`` (causal, f32) across a (seq, block_q,
    block_k) grid."""
    from repro_torch.models import layers

    aux = _aux(dict(batch=batch, heads=heads, kv_heads=kv_heads,
                    head_dim=head_dim))
    b, h, hkv, d = (aux["batch"], aux["heads"], aux["kv_heads"],
                    aux["head_dim"])
    out = []
    for s in seqs:
        gen = torch.Generator(device=device).manual_seed(s)
        q = _randn(gen, (b, s, h, d), device)
        k = _randn(gen, (b, s, hkv, d), device)
        v = _randn(gen, (b, s, hkv, d), device)
        for bq, bk in blocks:
            fn = functools.partial(layers.flash_attend, block_q=bq, block_k=bk)
            t = time_fn(fn, q, k, v, warmup=warmup, reps=reps, device=device)
            out.append(_entry("flash_prefill",
                              dict(seq=s, block_q=bq, block_k=bk, **aux), t))
    return out


def measure_decode(*, buf=1024, fills=(256, 1024), block_ks=(256, 512, 1024),
                   batch=None, heads=None, kv_heads=None, head_dim=None,
                   warmup=2, reps=5, device="cuda") -> list[dict]:
    """Time ``layers.decode_attend`` (dense split-KV over a padded
    T=``buf`` cache) across (fill, block_k)."""
    from repro_torch.models import layers

    aux = _aux(dict(batch=batch, heads=heads, kv_heads=kv_heads,
                    head_dim=head_dim))
    b, h, hkv, d = (aux["batch"], aux["heads"], aux["kv_heads"],
                    aux["head_dim"])
    gen = torch.Generator(device=device).manual_seed(1)
    q = _randn(gen, (b, 1, h, d), device)
    k = _randn(gen, (b, buf, hkv, d), device)
    v = _randn(gen, (b, buf, hkv, d), device)
    out = []
    for fill in fills:
        for bk in block_ks:
            fn = functools.partial(layers.decode_attend, kv_len=fill)
            t = time_fn(fn, q, k, v, warmup=warmup, reps=reps, device=device)
            out.append(_entry("decode",
                              dict(buf=buf, fill=fill, block_k=bk, **aux), t))
    return out


def measure_paged_decode(*, max_len=512, fills=(64, 256), page_sizes=(8, 16),
                         batch=None, heads=None, kv_heads=None,
                         head_dim=None, warmup=2, reps=5,
                         device="cuda") -> list[dict]:
    """Time ``layers.paged_decode_attend`` across (fill, page_size) with
    a fully-backed pool (slot s owns pages [s*max_pp, (s+1)*max_pp))."""
    from repro_torch.models import layers

    aux = _aux(dict(batch=batch, heads=heads, kv_heads=kv_heads,
                    head_dim=head_dim))
    b, h, hkv, d = (aux["batch"], aux["heads"], aux["kv_heads"],
                    aux["head_dim"])
    gen = torch.Generator(device=device).manual_seed(2)
    q = _randn(gen, (b, 1, h, d), device)
    out = []
    for pg in page_sizes:
        max_pp = -(-max_len // pg)
        kp = _randn(gen, (hkv, b * max_pp, pg, d), device)
        vp = _randn(gen, (hkv, b * max_pp, pg, d), device)
        bt = torch.arange(b * max_pp, dtype=torch.int32, device=device).reshape(b, max_pp)
        for fill in fills:
            lens = torch.full((b,), min(fill, max_len), dtype=torch.int32, device=device)
            t = time_fn(layers.paged_decode_attend, q, kp, vp, bt, lens,
                        warmup=warmup, reps=reps, device=device)
            out.append(_entry(
                "paged_decode",
                dict(fill=min(fill, max_len), page_size=pg, max_pp=max_pp,
                     max_len=max_len, **aux), t))
    return out


def measure_gemm(*, m=256, n=256, k=256, block_sets=None,
                 warmup=2, reps=5, device="cuda") -> list[dict]:
    """Time the int8 VTA GEMM (``kernels.ops.matmul_int8``: the kernel on
    the card, its plain version on the CPU) across block presets."""
    from repro_torch.kernels.ops import BLOCK_PRESETS, matmul_int8

    if block_sets is None:
        block_sets = list(BLOCK_PRESETS.values())
    gen = torch.Generator(device=device).manual_seed(3)
    a = torch.randint(-128, 127, (m, k), generator=gen, dtype=torch.int8, device=device)
    w = torch.randint(-128, 127, (k, n), generator=gen, dtype=torch.int8, device=device)
    out = []
    for blocks in block_sets:
        blocks = dict(blocks)
        fn = functools.partial(matmul_int8, **blocks)
        t = time_fn(fn, a, w, warmup=warmup, reps=reps, device=device)
        out.append(_entry("gemm_int8", dict(m=m, n=n, k=k, **blocks), t))
    return out


def measure_prefill_chunk(params, cfg, *, prompt=64, chunks=(16, 32, 64),
                          batch=2, dtype=torch.float32, warmup=1,
                          reps=3) -> list[dict]:
    """Time the engine's chunked prefill (``serve.step.make_prefill_step``)
    across chunk buckets for one model config, on the params' device.
    The dense cache holds the right-padded last chunk, so it has at least
    ``ceil(prompt / chunk) * chunk`` rows."""
    from repro_torch.models import transformer as tf
    from repro_torch.serve.step import make_prefill_step

    device = params["embed"]["table"].device
    gen = torch.Generator(device=device).manual_seed(4)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device=device)
    out = []
    for c in chunks:
        step = make_prefill_step(cfg, chunk=c)
        max_len = max(2 * prompt, -(-prompt // c) * c)

        @torch.inference_mode()
        def run(params, prompts, step=step, max_len=max_len):
            caches = tf.init_caches(cfg, batch, max_len, dtype, device)
            tok, caches = step(params, prompts, caches)
            return tok

        t = time_fn(run, params, prompts, warmup=warmup, reps=reps, device=device)
        out.append(_entry(
            "prefill_chunk",
            dict(tokens=prompt, chunk=c, batch=batch,
                 cfg=config_hash(cfg)), t))
    return out


# ---------------------------------------------------------------------------
# generic single-point measurement (the tuner's confirm step)
# ---------------------------------------------------------------------------


def measure_point(kind: str, params: dict, *, model_params=None, cfg=None,
                  warmup=2, reps=3, device="cuda") -> dict:
    """Measure ONE (kind, params) point — how ``tune_runtime`` confirms
    the cost model's predicted winners before deploying them.
    ``prefill_chunk`` runs on ``model_params``' device."""
    p = dict(params)
    aux = {k: p.get(k) for k in DEFAULT_AUX}
    if kind == "flash_prefill":
        return measure_flash_prefill(
            seqs=(p["seq"],), blocks=((p["block_q"], p["block_k"]),),
            warmup=warmup, reps=reps, device=device, **aux)[0]
    if kind == "decode":
        return measure_decode(
            buf=p["buf"], fills=(p["fill"],), block_ks=(p["block_k"],),
            warmup=warmup, reps=reps, device=device, **aux)[0]
    if kind == "paged_decode":
        return measure_paged_decode(
            max_len=p.get("max_len", 512), fills=(p["fill"],),
            page_sizes=(p["page_size"],), warmup=warmup, reps=reps,
            device=device, **aux)[0]
    if kind == "gemm_int8":
        blocks = {k: p[k] for k in ("block_m", "block_n", "block_k")}
        return measure_gemm(m=p["m"], n=p["n"], k=p["k"], block_sets=[blocks],
                            warmup=warmup, reps=reps, device=device)[0]
    if kind == "prefill_chunk":
        if model_params is None or cfg is None:
            raise ValueError("prefill_chunk needs model_params and cfg")
        return measure_prefill_chunk(
            model_params, cfg, prompt=p["tokens"], chunks=(p["chunk"],),
            batch=p.get("batch", 2), warmup=warmup, reps=reps)[0]
    raise ValueError(f"unknown measure kind {kind!r}")


# ---------------------------------------------------------------------------
# profile assembly
# ---------------------------------------------------------------------------


def collect_profile(entries, *, cfg=None, extra=None, device="cuda") -> dict:
    """Wrap measured entries with the provenance the fit is keyed by."""
    dev = torch.device(device)
    prof = {
        "schema": PROFILE_SCHEMA,
        "device": device_signature(dev),
        "backend": dev.type,
        "device_kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else dev.type),
        "torch_version": torch.__version__,
        "entries": list(entries),
    }
    if cfg is not None:
        prof["config_hash"] = config_hash(cfg)
    if extra:
        prof.update(extra)
    return prof


def save_profile(profile: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(profile, f, indent=1)


def load_profile(path: str) -> dict:
    with open(path) as f:
        prof = json.load(f)
    if prof.get("schema") != PROFILE_SCHEMA:
        raise ValueError(f"stale profile schema {prof.get('schema')!r} "
                         f"(current {PROFILE_SCHEMA}); re-measure")
    return prof
