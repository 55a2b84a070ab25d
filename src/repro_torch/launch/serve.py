"""Serving launcher (PyTorch port of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3_0p6b --prompt 2048
    python -m repro_torch.launch.serve --engine paged --prefix-cache
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --batch 4

``--engine static`` (default) runs one fixed batch through chunked
prefill and greedy decode and prints the prefill time and decode tok/s.
``--engine paged`` runs the continuous-batching ``ServingEngine`` over
the paged KV cache on a mixed-length trace of ``2 * batch`` requests and
prints the reference's engine summary (tok/s, token latency and TTFT
percentiles, pool, admission, scheduler, prefix-cache and speculative
lines); an SSM or hybrid config (mamba2_2p7b, zamba2_2p7b) has no paged
cache and the engine refuses it, as the reference's does.  An enc-dec or
frontend config (seamless_m4t_large_v2, internvl2_76b) exits with the
reference's message: its entry point is ``serve.step.generate`` with
``frames=`` or ``embeds=``.  It runs on the CUDA card by default;
``--device cpu`` runs the same path on the CPU with the kernels' plain
versions.  Weights and prompts are random, made from fixed seeds.
``--kv-dtype int8`` serves the paged engine from int8 pools; the static
path ignores it, as the reference's does.  ``--supervise`` (implied by
``--fault-plan`` and ``--deadline-ms``) runs the paged engine under the
fault-tolerant ``serve.supervisor.ServeSupervisor`` and prints the
reference's supervisor summary (steps, recoveries, every event with its
recovery time, a degrade to the plain versions, cancelled requests).
The params are placed per ``dist.sharding.param_specs`` under
``--strategy`` (any of the four) on ``ft.elastic.make_mesh_for``'s mesh
over the devices of ``--device``, and the static path's caches per
``cache_specs``.  Across cards the static path runs one process per data
position under ``torchrun --nproc-per-node <positions>``: each process
serves its rows of the same global prompts (FSDP slices gathered whole
once at load), the tokens are gathered, and process 0 prints the
reference's lines, its decode tok/s over the global rows timed after a
barrier.  Run alone on a mesh with several data positions over distinct
cards it exits naming the torchrun commands.  Under ``ai_core_assignment``
/ ``fused`` it also runs one process per mesh position (``torchrun
--nproc-per-node <mesh size>``): each holds its 'model' slices and the
ranks of a model group serve their data position's rows tensor and
expert parallel (``dist.tensor``), the tokens gathered over the data
group; any other world exits naming both commands.  ``--engine paged``,
``--supervise``, ``--fault-plan`` and ``--deadline-ms`` run in one
process only (the paged engine serves from one device, as the
reference's does).  Int8 weights come from
``optim.quant.quantize_params``
(the reference launcher has no flag for them either).  ``--autotune``
tunes flash's blocks (and, under ``--engine paged``, the paged kernel's
page size, which the engine's ``serving`` entry takes) with
``core.autotune.tune_runtime`` on the device before serving, saving the
table to ``--tuning-file`` when one is given; ``--tuning-file`` alone
installs a saved table (``launch.tuning``).  An explicit ``--page-size``
wins over the table, as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.dist import tensor as tp
from repro_torch.dist.collective import (
    barrier,
    close,
    gather_rows,
    gather_tree,
    process_index,
    requested_world,
)
from repro_torch.dist.sharding import (
    MULTI_CARD_ITEM,
    SHARDING_STRATEGIES,
    cache_specs,
    data_shards,
    param_specs,
    place,
)
from repro_torch.launch.mesh import join_groups, launch_mesh
from repro_torch.launch.tuning import tuning_from
from repro_torch.models import transformer as tf
from repro_torch.serve.step import make_prefill_step, make_serve_step
from repro_torch.tree import leaves


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_static(params, cfg, prompts, *, new_tokens: int, chunk: int,
               return_logits: bool = False, mesh=None, group=None, model=None):
    """Prefill ``prompts`` (B, S) in chunks of ``chunk``, then decode
    ``new_tokens - 1`` greedy steps.  The caches follow the params: made
    on the prompts' device, and with a ``mesh`` over whose devices the
    params are spread, placed on it per ``cache_specs``; params whole on
    one device (scatter_gather's replicas, computed once on a row's first
    device) keep their caches beside them.  Returns a dict with ``tokens``
    (B, new_tokens), ``prefill_s``, ``decode_s`` (host clock around work
    that ends in a device sync) and, with ``return_logits``, ``logits``:
    the prefill head then every decode step's, each (B, V).  The caches
    take the params' dtype and hold the right-padded final chunk.

    With a ``group`` (one process per data position) the process serves
    its contiguous block of ``B / count`` rows of the global ``prompts``
    (the data axes split the batch), its caches on its row of ``mesh``;
    the tokens and logits are gathered from every process, and each
    timing ends after a barrier, so process 0's covers every row.

    With a ``model`` group as well (one process per mesh position; the
    params this position's 'model' slices on its device) the steps run
    tensor and expert parallel under ``dist.tensor.parallel``: every rank
    of a model group reads the same gathered logits and takes the same
    greedy token, its caches holding its share of the KV heads."""
    if group is not None:
        from repro_torch.dist.sharding import local_mesh

        b = prompts.shape[0]
        if b % group.size:
            raise ValueError(f"batch {b} does not split over {group.size} processes")
        r = b // group.size
        prompts = prompts[group.rank * r:(group.rank + 1) * r]
        if mesh is not None and model is None:
            mesh = local_mesh(mesh, group)
    device = prompts.device
    b, s = prompts.shape
    max_len = -(-s // chunk) * chunk + new_tokens
    with tp.parallel(model=model):
        tf.check_supported(cfg)
    caches = tf.init_caches(cfg, b, max_len, params["embed"]["table"].dtype, device,
                            kv_heads=tf.cache_kv_heads(params, cfg))
    homes = {t.device for t in leaves(params) if isinstance(t, torch.Tensor)}
    if mesh is not None and model is None and len(homes) > 1:
        caches = place(caches, cache_specs(caches, mesh), mesh)
    prefill = make_prefill_step(cfg, chunk, return_logits=return_logits)
    decode = make_serve_step(cfg, return_logits=return_logits)
    logits = []

    def fence():
        _sync(device)
        barrier(model, group)

    fence()
    with tp.parallel(model=model):
        t0 = time.perf_counter()
        res = prefill(params, prompts, caches)
        tok, caches = res[0][:, None], res[-1]
        if return_logits:
            logits.append(res[1][:, -1])
        fence()
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(new_tokens - 1):
            res = decode(params, out[-1], caches)
            out.append(res[0])
            caches = res[-1]
            if return_logits:
                logits.append(res[1][:, -1])
        fence()
        decode_s = time.perf_counter() - t0
    result = {"tokens": gather_rows(torch.cat(out, dim=1), group), "prefill_s": prefill_s,
              "decode_s": decode_s}
    if return_logits:
        result["logits"] = [gather_rows(x, group) for x in logits]
    return result


def run_paged_engine(params, cfg, args, device):
    """The reference's ``_run_paged_engine``: a ``ServingEngine`` sized
    from the launcher's options (under a ``ServeSupervisor`` with
    ``--supervise``, ``--fault-plan`` or ``--deadline-ms``) serves a
    mixed-length trace of ``2 * batch`` requests (generation lengths
    spread 1/4x..1x so slots churn; with the prefix cache on, every other
    request shares the first half of its prompt), then the engine summary
    is printed.  Returns ``{"done": [Request], "engine": ServingEngine,
    "seconds": float, "supervisor": ServeSupervisor or None}``."""
    from repro_torch.models.layers import tuned
    from repro_torch.serve.engine import ServingEngine, latency_stats

    # explicit flag > tuning table (--autotune / --tuning-file) > default
    page_size = args.page_size or int(tuned("serving").get("page_size", 16))
    max_len = args.prompt + args.new_tokens
    draft_params = draft_cfg = None
    if args.draft:
        draft_cfg = get_config(args.draft)
        if args.smoke:
            draft_cfg = draft_cfg.scaled_down()
        draft_cfg = dataclasses.replace(draft_cfg, vocab=cfg.vocab)
        gen = torch.Generator(device=device).manual_seed(2)
        draft_params = tf.init(draft_cfg, generator=gen, dtype=torch.float32,
                               device=device)
    # with the prefix cache on, a zero-slack pool evicts every retired
    # prefix before its sharer arrives — double it so pages can linger
    pages = -(-max_len // page_size) * args.batch
    engine_kw = dict(
        max_slots=args.batch, max_len=max_len,
        page_size=page_size, kv_dtype=args.kv_dtype,
        num_pages=2 * pages if args.prefix_cache else pages,
        prefill_chunk=max(16, args.prompt // 4),
        prefix_cache=args.prefix_cache,
        draft_params=draft_params, draft_cfg=draft_cfg, spec_k=args.spec_k,
        prefill_budget=args.prefill_budget, slo_ms=args.slo_ms)
    sup = None
    if args.supervise or args.fault_plan or args.deadline_ms:
        from repro_torch.ft.faults import FaultPlan
        from repro_torch.serve.supervisor import ServeSupervisor

        plan = (FaultPlan.parse(args.fault_plan, seed=args.fault_seed)
                if args.fault_plan else None)
        sup = ServeSupervisor(params, cfg, engine_kw=engine_kw, fault_plan=plan,
                              verbose=True)
        eng = sup.engine
    else:
        eng = ServingEngine(params, cfg, **engine_kw)
    priorities = ([int(p) for p in args.priority.split(",")]
                  if args.priority else [0])
    gen = torch.Generator().manual_seed(1)
    shared = torch.randint(0, cfg.vocab, (args.prompt // 2,), generator=gen)
    for i in range(2 * args.batch):
        prompt = torch.randint(0, cfg.vocab, (args.prompt,), generator=gen)
        if args.prefix_cache and i % 2:
            prompt = torch.cat([shared, prompt[args.prompt // 2:]])
        new = max(1, args.new_tokens // (1 + i % 4))
        if sup is not None:
            sup.submit(prompt.numpy(), new, priority=priorities[i % len(priorities)],
                       deadline_ms=args.deadline_ms)
        else:
            eng.submit(prompt.numpy(), new, priority=priorities[i % len(priorities)])
    t0 = time.monotonic()
    if sup is not None:
        try:
            done = sup.run()
        finally:
            sup.restore_dispatchers()
        eng = sup.engine  # recoveries may have rebuilt it
    else:
        done = eng.run()
    _sync(device)
    dt = time.monotonic() - t0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    result = {"done": done, "engine": eng, "seconds": dt, "supervisor": sup}
    if sup is not None:
        kinds = {}
        for ev in sup.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        print(f"supervisor: {sup.steps} supervised steps, "
              f"{sup.recoveries} recoveries ({sup.rebuilds} rebuilds), "
              f"events {kinds or '{}'}"
              + (", DEGRADED to the plain versions" if sup.degraded else ""))
        for ev in sup.events:
            print(f"  step {ev.step}: {ev.kind} {ev.detail} "
                  f"({ev.recovery_s * 1e3:.1f} ms)")
    finished = [r for r in done if not r.cancelled]
    if len(finished) < len(done):
        print(f"  {len(done) - len(finished)} requests cancelled "
              "(deadline/shed)")
    if not finished:
        print("paged engine: no requests finished")
        return result
    done = finished
    stats = latency_stats(done)
    print(f"paged engine: {len(done)} requests, {stats['tokens']} tokens "
          f"in {dt*1e3:.0f} ms over {eng.steps} decode steps "
          f"({stats['tokens']/dt:.0f} tok/s) on {name}")
    print(f"  token latency p50 {stats['token_p50_s']*1e3:.1f} ms, "
          f"p99 {stats['token_p99_s']*1e3:.1f} ms; "
          f"ttft p50 {stats['ttft_p50_s']*1e3:.1f} ms, "
          f"p99 {stats['ttft_p99_s']*1e3:.1f} ms; "
          f"queue wait p99 {stats['queue_p99_s']*1e3:.1f} ms; "
          f"pool {eng.num_pages} pages x {eng.page_size} slots "
          f"({eng.kv_dtype}, {eng.pool_bytes/2**10:.0f} KiB)")
    es = eng.stats()
    print(f"  admitted {es['admitted']}, rejected {es['rejected']}; "
          f"prefilled {es['prefilled_tokens']}/{es['prompt_tokens']} "
          "prompt tokens")
    if eng.prefill_budget is not None:
        print(f"  scheduler: budget {es['prefill_budget']} tok/step over "
              f"{es['prefill_chunk_calls']} chunk calls; "
              f"{es['preemptions']} preemptions "
              f"({es['preempt_pages_saved']} pages saved to prefix)")
    if eng.slo_s is not None:
        print(f"  slo {es['slo_ms']:.1f} ms: deferred "
              f"{es['slo_deferred_steps']} admissions, throttled "
              f"{es['slo_throttled_steps']} steps "
              f"(chunk {es.get('chunk_cost_ms', 0):.2f} ms, decode "
              f"{es.get('decode_cost_ms', 0):.2f} ms EWMA)")
    if args.prefix_cache:
        print(f"  prefix cache: {es['prefix_hits']}/{es['prefix_lookups']} "
              f"hits, {es['prefix_hit_tokens']} tokens served from shared "
              f"pages, {es['prefix_evicted_pages']} evicted, "
              f"{es['prefix_nodes']} resident nodes")
    if eng.spec_k:
        print(f"  speculative k={es['spec_k']}: "
              f"{es['accepted_per_spec_step']:.2f} tokens/slot-step "
              f"over {es['spec_steps']} verify steps")
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
    ap.add_argument("--strategy", default="fused", choices=list(SHARDING_STRATEGIES))
    ap.add_argument("--engine", choices=["static", "paged"], default="static")
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--tuning-file", default=None,
                    help="TuningTable JSON to install (tuned flash blocks, page "
                         "size); with --autotune, where to save the search result")
    ap.add_argument("--autotune", action="store_true",
                    help="run the measured knob search (core.autotune."
                         "tune_runtime) on the device before serving")
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

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.scaled_down()
    if cfg.is_enc_dec or cfg.frontend:
        # the reference's message; their entry point is
        # repro_torch.serve.step.generate(frames= / embeds=)
        raise SystemExit("use examples/serve_batched.py variants for "
                         "frontend/enc-dec archs")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {args.device}")
    # f32 matmuls in full f32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False

    tf.check_supported(cfg)
    world = requested_world()
    if (args.supervise or args.fault_plan or args.deadline_ms) and world and world[1] > 1:
        raise SystemExit(f"--supervise / --fault-plan / --deadline-ms run in one process; "
                         f"across {world[1]} processes they are {MULTI_CARD_ITEM}")
    kinds = ("flash_prefill", "paged_decode") if args.engine == "paged" else ("flash_prefill",)
    with tuning_from(args.autotune, args.tuning_file, cfg=cfg, kinds=kinds, device=device):
        return run(cfg, args, device)


def run(cfg, args, device):
    """Serve per the options (module docstring): the paged engine's result
    (``run_paged_engine``) or the static path's (``run_static``)."""
    world = requested_world()
    if args.engine == "paged" and world and world[1] > 1:
        raise SystemExit(f"--engine paged serves from one device, as the reference's does: "
                         f"run it in one process, not {world[1]}")
    mesh = launch_mesh(device, world[1] if world else 1)
    if args.engine == "static":
        group, model = join_groups(mesh, args.strategy, "repro_torch.launch.serve")
    else:
        group = model = None
    lead = process_index(group) == 0 and process_index(model) == 0
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    # random weights from seed 0 and prompts from seed 1, as the reference
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init(cfg, generator=gen, dtype=torch.float32, device=device)
    specs = param_specs(params, mesh, args.strategy)
    params = place(params, specs, mesh, group, model)
    # the FSDP slices gathered once at load: serving computes on whole weights
    params = gather_tree(params, data_shards(specs, mesh), group)
    if lead:
        print(f"mesh {mesh.shape}  arch {cfg.name}  strategy {args.strategy}")
    if args.engine == "paged":
        return run_paged_engine(params, cfg, args, device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                            generator=gen, device=device)
    res = run_static(params, cfg, prompts, new_tokens=args.new_tokens,
                     chunk=max(16, args.prompt // 4), mesh=mesh, group=group, model=model)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    steps = args.new_tokens - 1
    rate = args.batch * steps / res["decode_s"] if steps else 0.0
    if lead:
        print(f"prefill {args.batch}x{args.prompt} in {res['prefill_s'] * 1e3:.1f} ms "
              f"on {name}")
        print(f"decode {steps} steps: {rate:.1f} tok/s on {name}")
    close(group, model)
    return res


if __name__ == "__main__":
    main()
