"""The dry-run stand-in's one mesh position on ``meta``
(``repro_torch.launch.dryrun.run_position``) against real processes, and
the kernel wrappers' ``meta`` routes.

* Real gloo processes on the CPU (``collective.spawn``), qwen3_0p6b
  ``scaled_down()`` in float32, global batch 4 x 16 tokens: one AdamW train
  step under ai_core_assignment on (1, 2), fused on (2, 1) and fused on
  (2, 2), and one decode step under ai_core_assignment on (1, 2) against
  caches filled to 7 of 24 positions.  Each process places its slices and
  builds its step as the launchers do and measures the step with
  ``launch.counters.Counters``.  The stand-in's ``route="plain"`` record
  for rank 0 (the same global trees on ``meta``, in a fake world of the
  mesh's size) equals rank 0's exactly in ``flops``, ``bytes_accessed``,
  ``collective_bytes`` by kind, ``output_bytes`` and the peak of live
  bytes; its ``arg_bytes`` equals ``tree_bytes`` of the specs.
* The pipeline, one process a stage: one AdamW train step of 2
  microbatches under 1F1B on (1, 2) and GPipe on (2, 2).  Every rank's
  stand-in record (rank r of its own fake world) equals that process's in
  the same keys, its ``collective-permute`` (the activations and
  gradients it receives) included, and its placed state its specs'
  ``arg_bytes``.
* Each wrapper's ``meta`` route (flash, dense decode, paged decode, the
  VTA GEMM's three epilogues, the ALU) returns the shapes and dtypes of its
  plain version at the families' shapes, counts no launch and reports its
  analytic work (``flash_work`` / ``decode_work`` / ``paged_work`` /
  ``gemm_work`` / ``alu_work``); on the CPU the model's dispatch sends
  ``meta`` to the wrappers unless ``meta_route("plain")`` is active.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.dist import collective  # noqa: E402
from repro_torch.dist import tensor as tp  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    Mesh,
    cache_specs,
    data_shards,
    data_specs,
    model_shards,
    param_specs,
    place,
    stage_slice,
)
from repro_torch.ft.elastic import state_shardings  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.counters import KINDS, Counters  # noqa: E402
from repro_torch.launch.mesh import per_position  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serve.step import make_serve_step  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_state,
    make_pipeline_train_step,
    make_train_step,
)

# the kernels' modules (the package exports functions of the same names)
fa, da, gemm, alu = (importlib.import_module(f"repro_torch.kernels.{m}") for m in (
    "flash_attention", "decode_attention", "vta_gemm", "vta_alu"))
CPU, META = torch.device("cpu"), torch.device("meta")
B, S, MAX_LEN, FILLED = 4, 16, 24, 7
#: (kind, strategy, mesh shape)
CASES = [("train", "ai_core_assignment", (1, 2)), ("train", "fused", (2, 1)),
         ("train", "fused", (2, 2)), ("decode", "ai_core_assignment", (1, 2))]
#: the pipeline's cells, one process a stage: (mesh shape, schedule), 2
#: microbatches
PIPE_CASES = [((1, 2), "1f1b"), ((2, 2), "gpipe")]
PIPE_M = 2
SPAWN_TIMEOUT = 120
COMPARED = ("flops", "bytes_accessed", "collective_bytes", "output_bytes", "peak_bytes")


def _cfg():
    return get_config("qwen3_0p6b").scaled_down()


def _mesh(shape, device):
    n = shape[0] * shape[1]
    return Mesh(np.array([device] * n, dtype=object).reshape(shape), ("data", "model"))


def _inputs(kind, strategy, mesh, device):
    """The case's GLOBAL argument trees and specs on ``device`` (random
    values from fixed seeds; on ``meta`` only their shapes)."""
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + 1 if kind == "train" else 1))).to(device)
    if kind == "train":
        state = init_state(cfg, generator=gen, dtype=torch.float32, device=device)
        batch = {"tokens": tokens}
        return (state, batch), (state_shardings(state, mesh, strategy),
                                data_specs(batch, mesh))
    params = tf.init(cfg, generator=gen, dtype=torch.float32, device=device)
    caches = tf.init_caches(cfg, B, MAX_LEN, torch.float32, device)
    for c in caches["blocks"]:
        c["len"] = FILLED
    return (params, tokens, caches), (param_specs(params, mesh, strategy),
                                      data_specs(tokens, mesh), cache_specs(caches, mesh))


def _pipe_cell(shape, schedule, device):
    """A pipeline cell's mesh and ``dryrun.Cell`` on ``device``."""
    mesh = _mesh(shape, device)
    args, specs = _inputs("train", "pipeline", mesh, device)
    return mesh, dryrun.Cell("train", args, specs, grad_accum=PIPE_M, schedule=schedule)


def _child(rank, nprocs, init_method, out, cases):
    """One process of a mesh: each case's step on its slices, measured."""
    torch.set_num_threads(1)
    recs = []
    for case in cases:
        kind, strategy, shape = case[:3]
        mesh = _mesh(shape, CPU)
        if per_position(mesh, strategy):
            data, model = collective.mesh_groups(mesh, init_method=init_method, rank=rank,
                                                 world_size=nprocs)
        else:
            data = collective.data_group(mesh, init_method=init_method, rank=rank,
                                         world_size=nprocs)
            model = None
        (args, specs) = _inputs(kind, strategy, mesh, CPU)
        cfg = _cfg()
        if strategy == "pipeline":
            # the launchers' stage process: its stage's layers and data slices
            state, batch = args
            local = stage_slice(specs[0], specs[0], model)
            shards = data_shards(local, mesh)["params"] if data is not None else None
            step = make_pipeline_train_step(cfg, AdamWConfig(), mesh, num_microbatches=PIPE_M,
                                            schedule=case[3], group=data, shards=shards,
                                            model=model)
            placed = (place(state, specs[0], mesh, data, model), batch)
            with Counters(args=placed) as c:
                out_tree = step(*placed)
        elif kind == "train":
            state, batch = args
            shards = data_shards(specs[0], mesh) if data is not None else None
            mshards = model_shards(specs[0], mesh) if model is not None else None
            step = make_train_step(cfg, AdamWConfig(), group=data,
                                   shards=shards and shards["params"], model=model,
                                   model_shards=mshards and mshards["params"])
            placed = (place(state, specs[0], mesh, data, model), batch)
            with Counters(args=placed) as c:
                out_tree = step(*placed)
        else:
            placed = tuple(place(t, s, mesh, data, model) for t, s in zip(args, specs))
            serve = make_serve_step(cfg)
            with torch.inference_mode(), tp.parallel(model=model), \
                    Counters(args=placed) as c:
                out_tree = serve(*placed)
        recs.append(c.record(out_tree))
        collective.close(data, model)
        init_method = init_method + "_next"
    with open(f"{out}/rank_{rank}.json", "w") as f:
        json.dump(recs, f)


def _pipe(case):
    """A pipeline case as ``_child`` takes it."""
    return ("train", "pipeline") + case


@pytest.fixture(scope="module")
def processes(tmp_path_factory):
    """Every rank's records per case, from one spawn per process count."""
    out = tmp_path_factory.mktemp("dryrun_position")
    recs = {}
    for n in (2, 4):
        cases = [c for c in CASES + [_pipe(p) for p in PIPE_CASES]
                 if c[2][0] * c[2][1] == n]
        d = out / str(n)
        d.mkdir()
        collective.spawn(_child, n, (str(d), cases), timeout=SPAWN_TIMEOUT, workdir=str(d))
        ranks = [json.loads((d / f"rank_{r}.json").read_text()) for r in range(n)]
        recs.update(zip(cases, zip(*ranks)))
    return recs


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}")
def test_stand_in_equals_real_process(processes, case):
    kind, strategy, shape = case
    mesh = _mesh(shape, META)
    args, specs = _inputs(kind, strategy, mesh, META)
    cell = dryrun.Cell(kind, args, specs)
    got = dryrun.run_position(_cfg(), cell, mesh, strategy, route="plain")
    want = processes[case][0]
    print(f"{case}: stand-in {json.dumps({k: got[k] for k in COMPARED})}")
    for key in COMPARED:
        assert got[key] == want[key], (key, got[key], want[key])
    assert set(got["collective_bytes"]) >= set(KINDS) | {"total"}
    assert got["arg_bytes"] == sum(dryrun.tree_bytes(a, s, mesh) for a, s in zip(args, specs))
    assert got["position"] == ("mesh" if shape[1] > 1 else "data")
    if kind == "train" and shape[0] > 1:
        # fused gathers the FSDP slices and scatters the grads over 'data'
        assert got["collective_bytes"]["all-gather"] > 0
        assert got["collective_bytes"]["reduce-scatter"] > 0
    assert got["kernel_calls"] == {}


@pytest.mark.parametrize("case,rank", [(c, r) for c in PIPE_CASES
                                       for r in range(c[0][0] * c[0][1])],
                         ids=lambda x: f"{x[0][0]}x{x[0][1]}-{x[1]}" if isinstance(x, tuple)
                         else f"rank{x}")
def test_stage_stand_in_equals_real_process(processes, case, rank):
    """One process a pipeline stage: rank ``rank``'s stand-in record (its
    own fake world) equals that real process's, its permutes included."""
    shape, schedule = case
    mesh, cell = _pipe_cell(shape, schedule, META)
    got = dryrun.run_position(_cfg(), cell, mesh, "pipeline", route="plain", rank=rank)
    want = processes[_pipe(case)][rank]
    print(f"{case} rank {rank}: stand-in {json.dumps({k: got[k] for k in COMPARED})}")
    for key in COMPARED:
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["position"] == "mesh" and got["rank"] == rank
    assert got["arg_bytes"] == sum(dryrun.tree_bytes(a, s, mesh)
                                   for a, s in zip(cell.args, cell.specs))
    # a stage receives one activation (stage > 0) and one gradient (stage
    # < last) a microbatch, (mb rows, S, D) f32 each
    cfg = _cfg()
    k, last = rank % shape[1], shape[1] - 1
    rows = B // PIPE_M // shape[0]
    one = rows * S * cfg.d_model * 4
    assert got["collective_bytes"]["collective-permute"] == PIPE_M * one * ((k > 0) + (k < last))
    assert got["kernel_calls"] == {}


def test_fake_world_refuses_an_existing_group(tmp_path):
    """A process with a default group cannot host the stand-in's world."""
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                                         rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no default group"):
            collective.fake_world(4)
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the wrappers' meta routes
# ---------------------------------------------------------------------------

#: flash at the families' attention shapes: (B, S, H, Hkv, D, Dv, q_offset,
#: T, window, bidirectional, dtype)
FLASH = [(1, 64, 16, 8, 128, 128, 0, 64, 0, False, torch.float32),      # dense GQA
         (1, 48, 14, 2, 64, 64, 16, 80, 0, False, torch.bfloat16),      # 7 heads a group
         (2, 32, 12, 2, 128, 128, 0, 32, 16, False, torch.float32),     # a window
         (1, 32, 16, 16, 192, 128, 0, 32, 0, False, torch.float32),     # MLA's D / Dv
         (1, 8, 8, 8, 64, 64, 0, 40, 0, True, torch.float32)]           # cross-attention
#: dense decode: (B, H, Hkv, D, Dv, T, kv_len, window, shared)
DECODE = [(4, 16, 8, 128, 128, 64, 33, 0, False), (2, 12, 2, 128, 128, 48, 48, 16, False),
          (2, 16, 1, 576, 512, 32, 20, 0, True)]
#: paged decode: (B, S, H, Hkv, D, pages, page, table width, dtype of pages)
PAGED = [(3, 1, 16, 8, 128, 9, 16, 3, torch.float32), (2, 5, 16, 8, 128, 9, 16, 4, torch.int8)]


@pytest.fixture
def work():
    """The kernels' work reports of the test, in order."""
    calls = []
    _build.WORK_LISTENERS.append(lambda *a: calls.append(a))
    yield calls
    _build.WORK_LISTENERS.pop()


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device == META


@pytest.mark.parametrize("shape", FLASH, ids=lambda s: f"S{s[1]}H{s[2]}G{s[2] // s[3]}")
def test_flash_meta_route(work, shape):
    b, s, h, hkv, d, dv, q0, t, window, bi, dtype = shape
    q = torch.empty((b, s, h, d), dtype=dtype, device=META)
    k = torch.empty((b, t, hkv, d), dtype=dtype, device=META)
    v = torch.empty((b, t, hkv, dv), dtype=dtype, device=META)
    kw = dict(q_offset=q0, window=window, bidirectional=bi)
    launches = fa.flash_attention.launches
    _same(fa.flash_attention(q, k, v, **kw), fa.flash_attention_ref(q, k, v, **kw))
    assert fa.flash_attention.launches == launches
    size = torch.empty((), dtype=dtype).element_size()
    assert work == [("flash_attention",
                     *fa.flash_work(b, s, h, hkv, d, dv, q0, t, size, window, bi))]
    # the differentiable route's forward is the wrapper too
    qg = q.requires_grad_()
    with torch.enable_grad():
        out = fa.flash_attention_diff(qg, k, v, **kw)
    assert out.shape == (b, s, h, dv) and len(work) == 2


def test_flash_work_closed_form():
    """The closed form equals the per-query sum it replaces."""
    def loop(s, q0, kv, w, bi):
        lo = (lambda p: max(0, p - w + 1)) if w else (lambda p: 0)
        if bi:
            return s * kv, kv
        pairs = sum(min(q0 + i + 1, kv) - lo(q0 + i) for i in range(s))
        return pairs, kv - lo(q0)

    for s, q0, kv, w, bi in [(17, 5, 20, 4, False), (64, 0, 64, 0, False), (3, 100, 64, 33, False),
                             (64, 40, 200, 300, False), (5, 0, 9, 0, True), (1, 63, 64, 1, False)]:
        pairs, keys = loop(s, q0, kv, w, bi)
        want = (2 * 4 * pairs * 2 * 16, 4 * (2 * s * 4 * 8 + 2 * keys * 2 * 16 + 2 * s * 4 * 8))
        assert fa.flash_work(2, s, 4, 2, 8, 8, q0, kv, 4, w, bi) == want


@pytest.mark.parametrize("shape", DECODE, ids=lambda s: f"H{s[1]}Hkv{s[2]}D{s[3]}")
def test_decode_meta_route(work, shape):
    b, h, hkv, d, dv, t, kv_len, window, shared = shape
    q = torch.empty((b, 1, h, d), device=META)
    k = torch.empty((b, t, hkv, d), device=META)
    v = k[..., :dv] if shared else torch.empty((b, t, hkv, dv), device=META)
    launches = da.decode_attention.launches
    _same(da.decode_attention(q, k, v, kv_len=kv_len, window=window),
          da.decode_attention_ref(q, k, v, kv_len=kv_len, window=window))
    assert da.decode_attention.launches == launches
    assert work == [("decode_attention",
                     *da.decode_work(b, h, hkv, d, dv, kv_len, 4, shared, window))]


@pytest.mark.parametrize("shape", PAGED, ids=lambda s: f"S{s[1]}-{s[8]}")
def test_paged_meta_route(work, shape):
    b, s, h, hkv, d, pages, pg, width, kv_dtype = shape
    q = torch.empty((b, s, h, d), device=META)
    kp = torch.empty((hkv, pages, pg, d), dtype=kv_dtype, device=META)
    vp = torch.empty((hkv, pages, pg, d), dtype=kv_dtype, device=META)
    bt = torch.empty((b, width), dtype=torch.int32, device=META)
    lens = torch.empty((b,), dtype=torch.int32, device=META)
    scales = {}
    if kv_dtype == torch.int8:
        scales = dict(k_scales=torch.empty((hkv, pages), device=META),
                      v_scales=torch.empty((hkv, pages), device=META))
    launches = da.paged_decode_attention.launches
    got = da.paged_decode_attention(q, kp, vp, bt, lens, **scales)
    assert da.paged_decode_attention.launches == launches
    assert got.shape == (b, s, h, d) and got.dtype == q.dtype and got.device == META
    esize = torch.empty((), dtype=kv_dtype).element_size()
    assert work == [("paged_decode_attention",
                     *da.paged_work(b, s, h, hkv, d, d, [width * pg] * b, 4, width, esize,
                                    pg=pg))]


@pytest.mark.parametrize("epilogue", ["none", "requant", "dequant"])
def test_gemm_meta_route(work, epilogue):
    m, k, n = 40, 96, 72
    a = torch.empty((m, k), dtype=torch.int8, device=META)
    w = torch.empty((n, k), dtype=torch.int8, device=META).T  # K-major, as the model packs
    kw = {"none": {}, "requant": dict(bias=torch.empty((n,), dtype=torch.int32, device=META)),
          "dequant": dict(scale=torch.empty((n,), device=META),
                          bias=torch.empty((n,), device=META))}[epilogue]
    launches = dict(gemm.vta_gemm.launches)
    got = gemm.vta_gemm(a, w, epilogue=epilogue, **kw)
    _same(got, gemm.vta_gemm_ref(a, w, kw.get("bias"), kw.get("scale"), epilogue=epilogue))
    assert gemm.vta_gemm.launches == launches
    out_bytes = got.element_size()
    assert work == [(f"vta_gemm_{epilogue}", *gemm.gemm_work(m, k, n, out_bytes, 4 * n * len(kw)))]


@pytest.mark.parametrize("op", ["add", "max", "relu", "shr"])
def test_alu_meta_route(work, op):
    x = torch.empty((33, 20), dtype=torch.int32, device=META)
    y = torch.empty((33, 20), dtype=torch.int8, device=META)
    yy = y if op in alu._BINARY else None
    launches = dict(alu.vta_alu.launches)
    _same(alu.vta_alu(x, yy, op=op, shift=3), alu.vta_alu_ref(x, yy, op, shift=3))
    assert alu.vta_alu.launches == launches
    assert work == [(f"vta_alu_{op}", *alu.alu_work(660, 4, 1 if yy is not None else 0))]


def test_meta_dispatch_routes(work):
    """The model's dispatch: ``meta`` reaches the wrappers by default and
    the plain versions under ``meta_route("plain")``; a wrapper refuses on
    ``meta`` what it refuses on the card."""
    q = torch.empty((1, 1, 8, 64), device=META)
    k = torch.empty((1, 32, 4, 64), device=META)
    layers.decode_attend(q, k, k, kv_len=9)
    assert [c[0] for c in work] == ["decode_attention"]
    with layers.meta_route("plain"):
        layers.decode_attend(q, k, k, kv_len=9)
    assert len(work) == 1
    with pytest.raises(ValueError, match="route"):
        with layers.meta_route("cuda"):
            pass
    big = torch.empty((1, 8, 2, 64), device=META)
    with pytest.raises(ValueError, match="Dv <= 128"):
        fa.flash_attention(big, big, torch.empty((1, 8, 2, 256), device=META))


def test_counters_on_the_cpu():
    """The counters' algebra on a small CPU program: a matmul's flops, the
    bytes of non-view ops, live bytes and the outputs."""
    x = torch.ones((8, 16))
    w = torch.ones((16, 4))
    with Counters(args=(x, w)) as c:
        y = (x @ w).relu()
        z = y.T  # a view: no bytes, no storage
    rec = c.record((y, z))
    assert rec["flops"] == 2 * 8 * 16 * 4
    assert rec["bytes_accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4) + 4 * (2 * 8 * 4)
    assert rec["output_bytes"] == 4 * 8 * 4
    assert rec["held_bytes"] == 4 * (8 * 16 + 16 * 4)
    # the matmul's result died when relu returned (refcount), so the peak
    # holds the arguments and two (8, 4) results at once at most
    assert rec["peak_bytes"] == rec["held_bytes"] + 2 * 4 * 8 * 4
    assert rec["collective_bytes"]["total"] == 0
