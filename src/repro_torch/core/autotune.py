"""VTA configuration autotuning (the AutoTVM analogue) and the runtime's
knob tables: the planner half of ``repro.core.autotune``.

The paper hand-explored two reconfigurations (§IV: 350 MHz; BLOCK=32 +
big buffers @200 MHz).  ``tune()`` searches the whole Table-I knob
space against the analytic cost model — block size, buffer sizes, and
the clock/timing trade (bigger blocks close timing at lower clocks,
modeled as clock ~ base / (block/16)^timing_penalty) — reproducing the
paper's finding that BLOCK=32 with doubled buffers wins despite the
clock drop.

``tune_microbatches()`` picks the pipeline runtime's microbatch count
from the bubble oracle.  :class:`TuningTable` is the versioned knob
table (the reference's JSON format, so each package loads the other's
files), and ``choose_pattern()`` the InTAR-style execution-pattern
selector on a fitted :class:`repro_torch.core.cost_model.RuntimeCostModel`.

``tune_runtime()`` is the measured twin: ``core.measure`` times a seed
grid of each hot path's knob space, a ``RuntimeCostModel`` is fitted to
the measurements, the fit ranks the remaining candidates, the top
predictions are measured to confirm, and the measured-best knobs land in
a :class:`TuningTable` that ``models.layers.set_tuning`` installs for
``flash_attend`` and the serving engine.  It searches only the knobs the
port's kernels honour (flash's blocks, the engine's page size and
prefill chunk): the dense decode kernel and the GEMM pick their own
tiles, so ``decode`` and ``gemm_int8`` are refused.

The planner half is the port's copy of the reference module's: pure
Python, same names, same numbers; ``tune_runtime`` imports torch (through
``core.measure``) when called.
"""

from __future__ import annotations

import dataclasses
import itertools
import json

from repro_torch.core.cost_model import (
    BoardModel,
    RuntimeCostModel,
    VTAConfig,
    board_with_vta,
)
from repro_torch.core.graph import Graph
from repro_torch.core.partition import pipeline_bubble_counts
from repro_torch.core.simulator import graph_service_time

# Zynq-7000-class timing model: achievable clock shrinks as the GEMM
# array and buffers grow (routing congestion); exponents calibrated to
# the paper's two published points (300->200 MHz when block 16->32 and
# buffers x2 on UltraScale+).
TIMING_PENALTY_BLOCK = 0.585  # 200/300 = (32/16)^-0.585


def achievable_clock(base_hz: float, block: int, buf_scale: float) -> float:
    return base_hz * (block / 16) ** (-TIMING_PENALTY_BLOCK) * (
        buf_scale ** -0.05
    )


def candidate_configs(base: VTAConfig):
    for block, buf_scale in itertools.product((8, 16, 32, 64), (0.5, 1.0, 2.0, 4.0)):
        clock = achievable_clock(base.clock_hz, block, buf_scale)
        yield VTAConfig(
            clock_hz=clock,
            block=block,
            uop_buffer_bytes=base.uop_buffer_bytes * buf_scale,
            input_buffer_bytes=base.input_buffer_bytes * buf_scale,
            weight_buffer_bytes=base.weight_buffer_bytes * buf_scale,
            acc_buffer_bytes=base.acc_buffer_bytes * buf_scale,
        )


@dataclasses.dataclass
class TuneResult:
    best: VTAConfig
    best_ms: float
    baseline_ms: float
    table: list  # (config, ms)

    @property
    def speedup(self) -> float:
        return self.baseline_ms / self.best_ms


def tune_microbatches(
    stages: int,
    global_batch: int,
    schedule: str = "1f1b",
    bubble_target: float = 0.15,
    max_microbatches: int | None = None,
) -> int:
    """Pick ``num_microbatches`` for the pipeline runtime.

    More microbatches shrink the pipeline bubble (idle fraction ~
    (stages-1)/(m+stages-1)) but also shrink the per-microbatch batch,
    hurting arithmetic intensity.  The bubble fraction decays
    monotonically toward zero, so "as close to optimal as possible"
    degenerates to one-sample microbatches; instead we take the
    *smallest* divisor of the global batch (the runtime's divisibility
    requirement) whose idle fraction is already at or below
    ``bubble_target``.  When no candidate reaches the target (small
    batches), fall back to the smallest divisor that at least fills the
    pipe (``m >= stages``) — chasing the least bubble there would
    monotonically pick the max divisor, i.e. 1-sample microbatches.
    """
    cap = min(global_batch, max_microbatches or global_batch)
    cands = [m for m in range(1, cap + 1) if global_batch % m == 0]

    def bubble(m: int) -> float:
        rounds, busy, idle = pipeline_bubble_counts(stages, m, schedule)
        return idle / max(busy + idle, 1)

    for m in cands:  # ascending: smallest m that meets the target
        if bubble(m) <= bubble_target:
            return m
    return next((m for m in cands if m >= stages), cands[-1])


def tune(graph: Graph, board: BoardModel) -> TuneResult:
    baseline = graph_service_time(board, graph) * 1e3
    rows = []
    for cand in candidate_configs(board.vta):
        ms = graph_service_time(board_with_vta(board, cand), graph) * 1e3
        rows.append((cand, ms))
    rows.sort(key=lambda r: r[1])
    return TuneResult(best=rows[0][0], best_ms=rows[0][1],
                      baseline_ms=baseline, table=rows)


# ---------------------------------------------------------------------------
# runtime knob tables
# ---------------------------------------------------------------------------

#: persisted-table format — stale tables are rejected, not misread
TUNING_VERSION = 1


@dataclasses.dataclass
class TuningTable:
    """Best-known knobs per cost kind for one device signature.

    ``entries[kind]`` is a flat knob dict (e.g. ``{"block_q": 256,
    "block_k": 256}`` for ``flash_prefill``; ``{"page_size": 32,
    "prefill_chunk": 32}`` for ``serving``); ``meta`` carries the
    provenance the tuning ran under (config hash, measured times).
    ``device`` is the measuring device's signature — "any" trusts the
    table everywhere.  A table tuned for the JAX package's device says
    nothing about this port's card.
    """

    device: str = "any"
    entries: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = TUNING_VERSION

    def put(self, kind: str, **knobs) -> None:
        self.entries.setdefault(kind, {}).update(knobs)

    def get(self, kind: str) -> dict:
        return dict(self.entries.get(kind, {}))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"version": self.version, "device": self.device,
                       "entries": self.entries, "meta": self.meta}, f,
                      indent=1)

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            obj = json.load(f)
        if obj.get("version") != TUNING_VERSION:
            raise ValueError(
                f"stale tuning table {path!r}: version {obj.get('version')!r}"
                f" != {TUNING_VERSION} — re-run tune_runtime")
        return cls(device=obj.get("device", "any"),
                   entries=obj.get("entries", {}),
                   meta=obj.get("meta", {}),
                   version=obj["version"])


#: knob candidates per kind: (base point, default knobs, candidate knobs).
#: The default knobs mirror the dispatchers' untuned behavior: the port's
#: flash kernel's own 64 / 64 (the reference's is 128 / 128), decode
#: DEFAULT_BLOCK_K = 512, GEMM "table1" preset, engine page_size=16 /
#: prefill_chunk=64.
def default_grid(kind: str) -> tuple[dict, dict, list[dict]]:
    if kind == "flash_prefill":
        return (dict(seq=256), dict(block_q=64, block_k=64),
                [dict(block_q=bq, block_k=bk) for bq, bk in
                 ((32, 32), (64, 64), (128, 128), (256, 256),
                  (64, 256), (256, 64), (128, 256), (256, 128))])
    if kind == "decode":
        return (dict(buf=1024, fill=512), dict(block_k=512),
                [dict(block_k=bk) for bk in (128, 256, 512, 1024)])
    if kind == "gemm_int8":
        return (dict(m=256, n=256, k=256),
                dict(block_m=128, block_n=128, block_k=128),
                [dict(block_m=bm, block_n=bn, block_k=bk) for bm, bn, bk in
                 ((64, 128, 128), (128, 128, 128), (128, 256, 256),
                  (256, 256, 256), (256, 128, 128))])
    if kind == "paged_decode":
        return (dict(max_len=512, fill=256), dict(page_size=16),
                [dict(page_size=pg) for pg in (8, 16, 32, 64)])
    if kind == "prefill_chunk":
        return (dict(tokens=64, batch=2), dict(chunk=64),
                [dict(chunk=c) for c in (16, 32, 64)])
    raise ValueError(f"no default grid for kind {kind!r}")


@dataclasses.dataclass
class KindResult:
    kind: str
    default_s: float
    best_s: float
    best: dict       # winning knobs
    measured: int    # points actually timed
    candidates: int  # points in the search space

    @property
    def speedup(self) -> float:
        return self.default_s / max(self.best_s, 1e-12)


@dataclasses.dataclass
class TuneReport:
    table: TuningTable
    model: RuntimeCostModel
    entries: list            # every measured profile entry
    results: list            # per-kind KindResult

    def result(self, kind: str) -> KindResult:
        return next(r for r in self.results if r.kind == kind)


#: kinds whose knobs the port's kernels ignore: the dense decode kernel
#: splits its keys by ``decode_plan`` and the GEMM keeps its own tiles
UNTUNABLE = {
    "decode": "the dense decode kernel picks its spans itself (decode_plan); "
              "block_k changes nothing",
    "gemm_int8": "the VTA GEMM keeps its own tiles; BLOCK_PRESETS change nothing",
}


def _fits(kind: str, base: dict, knobs: dict) -> bool:
    """Whether the kernel takes ``knobs`` at ``base``: a flash candidate
    must pass the wrapper's shared-memory check (f32, as measured)."""
    if kind != "flash_prefill":
        return True
    import torch

    from repro_torch.core.measure import DEFAULT_AUX
    from repro_torch.kernels.flash_attention import flash_blocks_fit

    p = dict(DEFAULT_AUX, **base, **knobs)
    s = p["seq"]
    return flash_blocks_fit(torch.float32, p["heads"] // p["kv_heads"],
                            min(p["block_q"], s), min(p["block_k"], s), p["head_dim"])


def tune_runtime(model_params=None, cfg=None, *,
                 kinds=("flash_prefill", "paged_decode"),
                 grids: dict | None = None,
                 confirm_top: int = 2,
                 warmup: int = 2, reps: int = 3,
                 save_path: str | None = None,
                 verbose: bool = False,
                 device="cuda") -> TuneReport:
    """Cost-model-pruned, measurement-confirmed knob search on ``device``.

    Per kind: (0) drop the candidates the kernel would refuse (flash
    blocks past its shared memory); (1) time a seed subset of the
    candidate grid (always including the dispatcher defaults) via
    ``core.measure``; (2) fit a :class:`RuntimeCostModel` to everything
    measured so far; (3) rank the unmeasured candidates by predicted time
    and measure only the ``confirm_top`` best predictions; (4) deploy the
    measured-best knobs into the returned :class:`TuningTable` (saved to
    ``save_path`` when given; ``--tuning-file`` loads it back).
    ``prefill_chunk`` tuning needs ``model_params``/``cfg`` and runs on
    the params' device; ``grids`` overrides ``default_grid`` per kind with
    ``(base, default_knobs, candidates)`` triples.  ``decode`` and
    ``gemm_int8`` raise ``ValueError``: the port's kernels ignore their
    knobs.
    """
    from repro_torch.core import measure

    for kind in kinds:
        if kind in UNTUNABLE:
            raise ValueError(f"tune_runtime: {kind!r} is not tuned in the port: "
                             f"{UNTUNABLE[kind]}")
    table = TuningTable(device=measure.device_signature(device))
    if cfg is not None:
        table.meta["config_hash"] = measure.config_hash(cfg)
    all_entries: list = []
    results: list[KindResult] = []

    for kind in kinds:
        base, default, cands = (grids or {}).get(kind) or default_grid(kind)
        if kind == "prefill_chunk" and (model_params is None or cfg is None):
            raise ValueError("tune_runtime: prefill_chunk needs "
                             "model_params and cfg")
        kept = [c for c in cands if _fits(kind, base, c)]
        dropped = len(cands) - len(kept)
        cands = kept

        def meas(knobs):
            e = measure.measure_point(
                kind, dict(base, **knobs), model_params=model_params,
                cfg=cfg, warmup=warmup, reps=reps, device=device)
            all_entries.append(e)
            return e

        timed: dict[tuple, dict] = {}

        def key(knobs):
            return tuple(sorted(knobs.items()))

        # (1) seed: defaults + every other candidate
        seeds = [default] + cands[::2]
        for knobs in seeds:
            if key(knobs) not in timed:
                timed[key(knobs)] = meas(knobs)
        # (2) fit on the seed measurements
        model = RuntimeCostModel.fit(list(timed.values()),
                                     device=table.device)
        # (3) rank the rest by prediction; confirm only the top few
        rest = [c for c in cands if key(c) not in timed]
        rest.sort(key=lambda c: model.predict(kind, **dict(base, **c)))
        for knobs in rest[:confirm_top]:
            timed[key(knobs)] = meas(knobs)
        # (4) measured-best wins
        best_key = min(timed, key=lambda k: timed[k]["t_s"])
        best = dict(best_key)
        default_s = timed[key(default)]["t_s"]
        best_s = timed[best_key]["t_s"]
        table.put(kind, **best)
        # serving-level knobs double into the engine's "serving" entry
        if kind == "paged_decode":
            table.put("serving", page_size=best["page_size"])
        if kind == "prefill_chunk":
            table.put("serving", prefill_chunk=best["chunk"])
        table.meta.setdefault("measured", {})[kind] = {
            "default_s": default_s, "best_s": best_s}
        results.append(KindResult(kind, default_s, best_s, best,
                                  measured=len(timed),
                                  candidates=len(cands) + 1))
        if verbose:
            print(f"tune_runtime[{kind}]: default {default_s*1e6:.0f}us -> "
                  f"best {best_s*1e6:.0f}us {best} "
                  f"({len(timed)}/{len(cands) + 1} measured"
                  + (f", {dropped} refused by the kernel" if dropped else "") + ")")

    final = RuntimeCostModel.fit(all_entries, device=table.device)
    if save_path:
        table.save(save_path)
    return TuneReport(table=table, model=final, entries=all_entries,
                      results=results)


# ---------------------------------------------------------------------------
# execution-pattern selection (InTAR-style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PatternChoice:
    cache_layout: str    # "paged" | "dense"
    execution: str       # "pipelined" | "sequential"
    predicted: dict      # step-time / intermediate-size predictions
    reasons: list


def choose_pattern(model: RuntimeCostModel, *, batch: int, max_len: int,
                   fill: int | None = None, page_size: int = 16,
                   block_k: int | None = None,
                   kv_bytes_budget: float | None = None,
                   kv_bytes_per_token: float | None = None,
                   stages: int = 1, microbatches: int = 1,
                   schedule: str = "1f1b",
                   heads: int = 4, kv_heads: int = 2,
                   head_dim: int = 64) -> PatternChoice:
    """Pick the serving execution pattern from fitted predictions.

    The InTAR insight: the right dataflow follows from *intermediate
    sizes* — here the KV residency.  Dense-vs-paged cache layout is
    decided by the fitted per-step decode predictions at the expected
    fill (dense attends a padded ``max_len`` buffer, paged only its
    live pages), with a hard override when the dense buffers don't fit
    ``kv_bytes_budget``.  Pipelined-vs-sequential execution follows
    the analytic bubble accounting (``pipeline_bubble_counts``): a
    pipeline wins exactly when its stage-rounds beat the sequential
    ``stages * microbatches``.  ``heads``/``kv_heads``/``head_dim``
    must match the profile the model was fitted on.
    """
    fill = fill if fill is not None else max(max_len // 2, 1)
    aux = dict(batch=batch, heads=heads, kv_heads=kv_heads,
               head_dim=head_dim)
    dense_t = model.predict("decode", buf=max_len, fill=fill,
                            block_k=block_k or max_len, **aux)
    max_pp = -(-max_len // page_size)
    paged_t = model.predict("paged_decode", fill=fill, page_size=page_size,
                            max_pp=max_pp, max_len=max_len, **aux)
    bpt = (kv_bytes_per_token if kv_bytes_per_token is not None
           else 2 * kv_heads * head_dim * 4)  # K+V rows, f32
    dense_bytes = batch * max_len * bpt
    live_pages = -(-fill // page_size)
    paged_bytes = batch * live_pages * page_size * bpt
    reasons = []
    forced = kv_bytes_budget is not None and dense_bytes > kv_bytes_budget
    if forced:
        layout = "paged"
        reasons.append(
            f"dense KV residency {dense_bytes:.0f}B exceeds budget "
            f"{kv_bytes_budget:.0f}B")
    else:
        layout = "paged" if paged_t < dense_t else "dense"
        reasons.append(
            f"predicted step: dense {dense_t*1e6:.1f}us vs paged "
            f"{paged_t*1e6:.1f}us at fill={fill}")
    if stages <= 1:
        execution, rounds = "sequential", stages * microbatches
        reasons.append("single stage: nothing to pipeline")
    else:
        rounds, busy, idle = pipeline_bubble_counts(
            stages, microbatches, schedule)
        execution = ("pipelined" if rounds < stages * microbatches
                     else "sequential")
        reasons.append(
            f"pipeline rounds {rounds} vs sequential "
            f"{stages * microbatches} ({schedule}, m={microbatches})")
    return PatternChoice(
        cache_layout=layout, execution=execution,
        predicted={"dense_step_s": dense_t, "paged_step_s": paged_t,
                   "dense_kv_bytes": float(dense_bytes),
                   "paged_live_kv_bytes": float(paged_bytes),
                   "pipeline_rounds": int(rounds)},
        reasons=reasons)
