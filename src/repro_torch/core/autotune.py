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
The measured search (``tune_runtime``) needs the port's measurement
harness and is not here yet.

The port's copy of the reference module's planner half: pure Python,
same names, same numbers; no torch.
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
#: The default knobs mirror the reference dispatchers' untuned behavior
#: (flash DEFAULT_BLOCK_Q/K = 128, decode DEFAULT_BLOCK_K = 512, GEMM
#: "table1" preset, engine page_size=16 / prefill_chunk=64).
def default_grid(kind: str) -> tuple[dict, dict, list[dict]]:
    if kind == "flash_prefill":
        return (dict(seq=256), dict(block_q=128, block_k=128),
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
