"""SLO-aware continuous-batching serving engine over the paged KV cache
(PyTorch port of ``repro.serve.engine``).

The static loop (launch/serve.py --engine static) admits one batch,
decodes until the LONGEST request finishes, and only then admits the
next — short requests ride along as dead slots, so token throughput
collapses to ``mean(len) / max(len)`` of the batch.  This engine keeps a
fixed grid of **decode slots** and schedules at REQUEST granularity,
the way the paper schedules heterogeneous models onto one cluster.

Slot state machine::

    FREE --admit--> PREFILLING --last chunk--> DECODING --done--> FREE
                        |  ^                       |
                        |  '----- re-admit --------'
                        '------- preempt ----------'   (request re-queues)

* a request is **admitted** the moment a slot is free AND the page
  allocator can cover its worst case (prompt + max_new tokens);
* admitted requests **prefill chunk-by-chunk** against a per-slot
  batch-1 dense cache (the ragged-prefill path, so arbitrary prompt
  lengths run at one chunk shape).  With ``prefill_budget=None`` the
  whole prefill runs inside admission (the stall discipline: every
  decoding slot stalls for the full prompt).  With a budget, each
  ``step()`` spends at most ``prefill_budget`` prompt tokens advancing
  PREFILLING slots round-robin and then runs the batched decode — a
  long prompt never blocks decode for more than one budget's worth of
  work, which is what bounds p99 token latency;
* the prefilled rows scatter into the request's pages
  (``kv_cache.write_prompt_pages``) only when the LAST chunk lands, so
  a mid-prefill slot looks exactly like an empty one to the decode
  kernel (block-table row -1, len 0);
* every engine step runs ONE batched paged decode over the DECODING
  slots — per-sequence block tables and lens mean mixed fill levels
  batch together, masked slots produce zeros;
* finished sequences **retire** at the end of the step that completed
  them: pages go back to the free list and the slot is immediately
  re-admittable.

**Priorities and preemption.**  ``submit(..., priority=)`` tags a
request; admission orders the queue by *effective* priority
``priority + wait / aging_s`` (aging: a starved low-priority request
eventually outranks fresh high-priority arrivals), FIFO within a tie.
Under slot or pool pressure a strictly-lower-priority running sequence
is **preempted**: its computed KV rows are released INTO the radix
prefix cache (the tree keeps one reference, so the work survives as an
evictable-but-resident prefix), its pages return to the pool, and the
request re-queues with its generated tokens attached — re-admission
looks the sequence up in the tree and prefills only the suffix
generated since (one token, when nothing was evicted meanwhile).
Without a prefix cache preemption still works; the KV is simply
recomputed at re-admission.  Either way the greedy tokens are the
request's own deterministic function of its token sequence, so a
preempted request finishes with exactly the tokens of an unpreempted
run.

**p99-targeted admission** (``slo_ms``, needs ``prefill_budget``): the
engine EWMA-measures the per-chunk prefill cost and the batched decode
step cost.  An in-flight decoder's per-token latency is one step time
= (prefill tokens spent that step)/chunk x chunk_cost + decode_cost,
so each step's prefill allowance shrinks to
``chunk * floor((slo - decode_cost) / chunk_cost)`` tokens — the most
prefill that still lands the step under the SLO — and admission DEFERS
entirely while even one chunk would blow it (allowance zero).  A
patience guard (``slo_patience_s``) forces one chunk per step once the
oldest waiting request has aged past it, so an over-tight SLO degrades
to slow prefill instead of starvation.

The engine is the host-side half of the contract: it owns block tables,
lens and the free list (request-rate work); the device half is the
paged ``serve_step``, which updates the pools in place.  Per decode step
the engine uploads the tokens, block tables and lens once (pinned host
memory, asynchronous copies) and reads the step's tokens back once; the
only other sync is the SLO probe, one prefill step in eight.

The port runs the dense and MoE families, GQA and MLA caches, on float
or int8 pools (an int8 prefix tree shares whole pages only, so
``row_lo`` is page-aligned and no partial int8 page is ever COW-forked).
An SWA config prefills each prompt in one exact-shape pass into a
rolling buffer (which cannot absorb pad rows or pause mid-prompt), so it
refuses ``prefill_budget`` and ``prefix_cache`` as the reference does.  Step
functions are plain closures built per engine: PyTorch runs eagerly,
so the reference's cross-engine jit cache has
nothing to keep.  Knobs left unset take the reference's untuned
defaults, ``page_size=16`` and ``prefill_chunk=64`` (the tuning table
is ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.serve import kv_cache
from repro_torch.serve.step import (
    make_prefill_step,
    make_serve_step,
    make_verify_step,
)

# the ONE clock behind every engine timestamp (queue wait, TTFT, SLO
# EWMAs, aging, deadlines): monotonic, so an NTP step / DST jump can
# never produce a negative queue wait or a bogus SLO deferral the way
# wall-clock time.time() could.  Module-level indirection so tests (and
# a serving supervisor's hang recovery) can install a fake clock.
_now = time.monotonic


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new: int
    priority: int = 0
    t_submit: float = 0.0
    t_admit: float | None = None  # FIRST admission (queue-wait metric)
    t_first: float | None = None
    t_done: float | None = None
    preemptions: int = 0
    cancelled: bool = False  # deadline/shed: ended without finishing
    tokens: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new

    @property
    def seq(self) -> np.ndarray:
        """Full known token sequence: prompt + generated so far — what a
        re-admission after preemption must (re)prefill or resume."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pages: list = dataclasses.field(default_factory=list)
    length: int = 0  # tokens in cache (prompt + generated-so-far - 1)
    quarantined: bool = False  # poisoned lane: admission skips it
    # -- PREFILLING state (dense is the in-flight batch-1 prefill cache)
    seq: np.ndarray | None = None  # admission-time token sequence
    dense: dict | None = None
    pf_pos: int = 0    # rows of ``seq`` already in the dense cache
    n_prefix: int = 0  # rows served from shared prefix pages

    @property
    def prefilling(self) -> bool:
        return self.dense is not None

    @property
    def decoding(self) -> bool:
        return self.req is not None and self.dense is None


class ServingEngine:
    """Paged continuous-batching engine for decoder-LM configs.

    ``max_slots`` is the decode batch width; ``num_pages`` the shared
    pool size (defaults to fully backing every slot at ``max_len`` —
    pass something smaller to exercise admission control).

    ``kv_dtype`` selects the pool precision ("f32"/"bf16"/"int8"); the
    admission-relevant pool size can be given in BYTES via
    ``pool_bytes`` instead of pages — the engine divides by
    ``kv_cache.page_bytes(cfg, page_size, kv_dtype)``, so the same byte
    budget admits ~4x the concurrent sequences at int8 vs f32 (~2x vs
    bf16).  Prefill still runs in ``dtype``; pages quantize at scatter
    time.

    ``prefill_budget`` (tokens per step) turns on decode-interleaved
    chunked prefill: pending prefills advance at most that many prompt
    tokens per ``step()`` (round-robin, always at least one chunk when
    any budget remains) instead of running to completion inside
    admission — see the module docstring for the latency math.  Needs
    the dynamic prefill path.  ``slo_ms`` adds p99-targeted
    admission on top (needs ``prefill_budget``): per-step allowance
    throttling from measured chunk/decode costs, with
    ``slo_patience_s`` (default ``50 * slo``) bounding how long an
    over-tight SLO may defer anyone.  ``aging_s`` is the queue-aging
    constant (seconds of waiting worth one priority class; ``None``
    disables aging — pure priority order, low priority can starve).

    ``prefix_cache=True`` turns on prefix sharing: admitted prompts are
    indexed in a radix tree over page-granular token chunks, and a new
    request whose prompt shares a cached prefix pins those pages
    (refcount++), seeds a dense cache from them, and prefills ONLY the
    unseen suffix — a partially-filled shared tail page is COW-forked
    before the sequence writes into it.  Retirement (and preemption)
    re-inserts prompt + generated tokens and releases the slot's
    references; under pool pressure admission evicts unpinned LRU tree
    pages.  Note: prompts index at prefill COMPLETION (only then are
    the rows physically in the pages), so with a ``prefill_budget`` two
    same-wave admissions cannot share each other's in-flight prefix;
    without a budget the admission loop completes each prefill before
    the next lookup and same-wave sharing works as before.

    ``draft_params``/``draft_cfg`` + ``spec_k`` turn on speculative
    decoding: the draft (same vocab, its own fully-backed paged cache
    in lockstep with the target's lengths) proposes ``spec_k`` tokens
    per slot per step, the target verifies all of them in ONE
    multi-token paged step, and the longest matching prefix plus the
    target's own next token is emitted — greedy output is exactly the
    non-speculative sequence, rejected rows need no physical rollback
    (they sit at/after the advanced length, masked and later
    overwritten).  PREFILLING slots sit out of speculative rounds the
    same way they sit out of plain decode.
    """

    def __init__(self, params, cfg, *, max_slots: int = 4,
                 max_len: int = 512, page_size: int | None = None,
                 num_pages: int | None = None,
                 prefill_chunk: int | None = None,
                 dtype=torch.float32, eos_id: int | None = None,
                 kv_dtype: str | None = None,
                 pool_bytes: int | None = None,
                 prefix_cache: bool = False,
                 draft_params=None, draft_cfg=None, spec_k: int = 4,
                 prefill_budget: int | None = None,
                 slo_ms: float | None = None,
                 slo_patience_s: float | None = None,
                 aging_s: float | None = 5.0):
        if not kv_cache.supports_paged(cfg):
            raise NotImplementedError(
                f"ServingEngine: {cfg.name} ({cfg.family}) has recurrent/"
                "enc-dec caches — use the static loop")
        tf.check_supported(cfg)
        # the reference's untuned defaults (its tuning table is ROADMAP.md
        # queue 1, item 13)
        if page_size is None:
            page_size = 16
        if prefill_chunk is None:
            prefill_chunk = 64

        self.params, self.cfg = params, cfg
        self.max_slots, self.max_len = max_slots, max_len
        self.page_size, self.eos_id = page_size, eos_id
        self.device = params["embed"]["table"].device
        self.kv_dtype = kv_dtype or (
            "bf16" if dtype == torch.bfloat16 else "f32")
        self.max_pp = kv_cache.pages_for(max_len, page_size)
        if pool_bytes is not None:
            if num_pages is not None:
                raise ValueError("pass num_pages OR pool_bytes, not both")
            num_pages = kv_cache.pool_pages_for_bytes(
                cfg, pool_bytes, page_size, self.kv_dtype)
        caches = tf.init_caches(cfg, max_slots, max_len, dtype, self.device,
                                cache_layout="paged", page_size=page_size,
                                num_pages=num_pages, kv_dtype=self.kv_dtype)
        self.blocks = caches["blocks"]
        self.num_pages = kv_cache.pool_num_pages(next(iter(self.blocks[0].values())))
        self.pool_bytes = self.num_pages * kv_cache.page_bytes(
            cfg, page_size, self.kv_dtype)
        self.allocator = kv_cache.PageAllocator(self.num_pages)
        self.block_tables = np.full((max_slots, self.max_pp), -1, np.int32)
        self.slots = [_Slot() for _ in range(max_slots)]
        self._dtype = dtype
        self._queue: list[Request] = []
        self._done: list[Request] = []
        self._next_rid = 0
        self._prefill_chunk = prefill_chunk
        # SWA rolling buffers can't absorb pad rows -> exact-shape path
        self._dyn_prefill = not cfg.sliding_window
        self._prefill = make_prefill_step(cfg, chunk=prefill_chunk)
        self._decode = make_serve_step(cfg)
        self._verify = make_verify_step(cfg)
        # -- SLO-aware scheduling knobs
        if prefill_budget is not None:
            if prefill_budget < 1:
                raise ValueError(
                    f"prefill_budget must be >= 1 token, got {prefill_budget}")
            if not self._dyn_prefill:
                raise NotImplementedError(
                    "prefill_budget needs the dynamic (resumable) prefill "
                    "path — an SWA rolling buffer cannot pause mid-prompt")
        if slo_ms is not None and prefill_budget is None:
            raise ValueError(
                "slo_ms targets per-step prefill interference — it needs "
                "prefill_budget (bounded per-step prefill) to act on")
        self.prefill_budget = prefill_budget
        self.slo_s = slo_ms / 1e3 if slo_ms is not None else None
        self.slo_patience_s = (
            slo_patience_s if slo_patience_s is not None
            else (50.0 * self.slo_s if self.slo_s else None))
        self.aging_s = aging_s
        self._chunk_ewma: float | None = None   # s per prefill chunk call
        self._decode_ewma: float | None = None  # s per batched decode step
        self._chunk_probe = 0  # steps since the last synced chunk sample
        if prefix_cache and not self._dyn_prefill:
            raise NotImplementedError(
                "prefix cache needs the dynamic (resumable) prefill path — "
                "an SWA rolling buffer cannot seed a mid-sequence resume")
        self.prefix = (
            kv_cache.RadixPrefixCache(self.allocator, page_size,
                                      full_pages_only=self.kv_dtype == "int8")
            if prefix_cache else None)
        # speculative decoding: a small same-vocab draft proposes spec_k
        # tokens; the target verifies all of them in one multi-token step
        self.spec_k = int(spec_k) if draft_params is not None else 0
        self.draft_params, self.draft_cfg = draft_params, draft_cfg
        if draft_params is not None:
            if draft_cfg is None or draft_cfg.vocab != cfg.vocab:
                raise ValueError(
                    "speculative decoding needs a draft_cfg sharing the "
                    "target's vocab")
            if (not kv_cache.supports_paged(draft_cfg)
                    or draft_cfg.sliding_window):
                raise NotImplementedError(
                    "draft must be a plain (non-SWA) paged-attention config")
            dkv = "bf16" if dtype == torch.bfloat16 else "f32"
            dc = tf.init_caches(draft_cfg, max_slots, max_len, dtype, self.device,
                                cache_layout="paged", page_size=page_size,
                                num_pages=max_slots * self.max_pp,
                                kv_dtype=dkv)
            self.draft_blocks = dc["blocks"]
            # the draft pool fully backs every slot, so block tables are
            # STATIC: slot s owns pages [s*max_pp, (s+1)*max_pp) and its
            # lengths simply mirror the target's — no allocator needed
            self._draft_bt = np.arange(
                max_slots * self.max_pp, dtype=np.int32
            ).reshape(max_slots, self.max_pp)
            self._draft_prefill = make_prefill_step(draft_cfg, chunk=prefill_chunk)
            self._draft_decode = make_serve_step(draft_cfg)
        self.steps = 0
        self._admitted = self._rejected = self._cancelled = 0
        self._prompt_tokens = self._prefilled_tokens = 0
        self._spec_steps = self._spec_slot_steps = self._spec_emitted = 0
        self._preempted = 0
        self._preempt_pages_saved = 0
        self._prefill_chunk_calls = 0
        self._deferred_steps = 0
        self._throttled_steps = 0

    # -- host to device ----------------------------------------------------

    def _upload(self, arr, dtype=torch.int32) -> torch.Tensor:
        """A copy of host array ``arr`` on the engine's device; on the card
        through pinned memory, asynchronously (no stream sync)."""
        t = torch.tensor(np.asarray(arr), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new: int, priority: int = 0) -> Request:
        prompt = np.asarray(prompt, np.int32)
        # malformed input is a caller bug, not a capacity rejection:
        # raise before touching counters or the queue
        if prompt.ndim != 1:
            raise ValueError(
                f"prompt must be a 1-D token sequence, got shape "
                f"{prompt.shape}")
        if prompt.size == 0:
            raise ValueError("prompt must be non-empty (an empty prompt "
                             "has no token to condition decode on)")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        need = kv_cache.pages_for(len(prompt) + max_new, self.page_size)
        # gate on the POOL too: with an undersubscribed pool a request
        # that can never be admitted would block the FIFO queue forever
        if (need > min(self.max_pp, self.num_pages)
                or len(prompt) >= self.max_len):
            self._rejected += 1
            raise ValueError(
                f"prompt+max_new ({len(prompt)}+{max_new}) exceeds "
                f"max_len {self.max_len} / pool of {self.num_pages} "
                f"pages x {self.page_size}")
        req = Request(self._next_rid, prompt, max_new, priority=priority,
                      t_submit=_now())
        self._next_rid += 1
        self._queue.append(req)
        return req

    def requeue(self, req: Request) -> Request:
        """Adopt an EXISTING request (tokens attached) into this
        engine's queue — the cross-engine half of recovery: a
        supervisor rebuilding pools after a fault moves the old
        engine's in-flight requests here, and admission resumes each
        through the preemption path (prefill prompt + generated-so-far,
        continue decoding), so the greedy continuation is bitwise the
        unfaulted run's.  The rid is preserved; ``_next_rid`` advances
        past it so fresh submissions never collide."""
        if req.cancelled or req.done:
            raise ValueError(f"request {req.rid} already "
                             f"{'cancelled' if req.cancelled else 'done'}")
        need = kv_cache.pages_for(len(req.prompt) + req.max_new,
                                  self.page_size)
        usable = self.num_pages - self.allocator.num_quarantined
        if need > min(self.max_pp, usable):
            self._rejected += 1
            raise ValueError(
                f"request {req.rid} needs {need} pages, pool has "
                f"{usable} usable of {self.num_pages}")
        self._next_rid = max(self._next_rid, req.rid + 1)
        self._queue.append(req)
        return req

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(s.req is not None for s in self.slots)

    # -- scheduling ---------------------------------------------------------

    def _pages_for_request(self, req: Request) -> int:
        # +spec_k: a verify step writes up to spec_k rows past the last
        # accepted position; the extra headroom keeps those speculative
        # writes on owned pages (past-capacity writes drop in-kernel,
        # which only costs re-derivation after a truncation).  A
        # re-admitted request needs the same worst case: generated
        # tokens moved from max_new into the resume prompt, the total
        # row count is unchanged.
        want = len(req.prompt) + req.max_new + self.spec_k
        return min(kv_cache.pages_for(want, self.page_size), self.max_pp)

    def _eff_priority(self, req: Request, now: float) -> float:
        """Aging: one ``aging_s`` of queue wait is worth one priority
        class, so a starved request eventually outranks anything."""
        if self.aging_s is None:
            return float(req.priority)
        return req.priority + (now - req.t_submit) / self.aging_s

    def _bucket(self, n: int) -> int:
        c = self._prefill_chunk
        return max(c, -(-n // c) * c)

    # -- SLO throttle -------------------------------------------------------

    def _note_cost(self, attr: str, value: float) -> None:
        old = getattr(self, attr)
        setattr(self, attr, value if old is None else 0.7 * old + 0.3 * value)

    def _oldest_wait(self, now: float) -> float:
        """Longest anyone (queued or mid-prefill) has been waiting."""
        ts = [r.t_submit for r in self._queue]
        ts += [s.req.t_submit for s in self.slots if s.prefilling]
        return now - min(ts) if ts else 0.0

    def _prefill_allowance(self, now: float) -> int | None:
        """Prompt tokens this step may spend on prefill.  ``None`` means
        unlimited (no budget configured: admission-stall discipline).
        With an SLO, the allowance shrinks to what fits the step under
        the target next to the measured decode cost; the patience guard
        floors it at one chunk once someone has waited too long."""
        if self.prefill_budget is None:
            return None
        b = self.prefill_budget
        if (self.slo_s is not None
                and any(s.decoding for s in self.slots)
                and self._chunk_ewma and self._decode_ewma):
            room = self.slo_s - self._decode_ewma
            chunks = max(0, int(room / self._chunk_ewma))
            allowed = chunks * self._prefill_chunk
            if allowed < b:
                self._throttled_steps += 1
            b = min(b, allowed)
            if b == 0 and (self.slo_patience_s is None
                           or self._oldest_wait(now) > self.slo_patience_s):
                b = self._prefill_chunk  # starvation floor: one chunk
        return b

    # -- admission ----------------------------------------------------------

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s.req is None and not s.quarantined:
                return i
        return None

    def _pick_victim(self, req: Request, now: float) -> int | None:
        """Preemption victim: a running request of STRICTLY lower raw
        priority — least priority first, least generated progress as
        the tiebreak (minimum lost/preserved work).  The victim must
        ALSO rank below the incoming request's EFFECTIVE priority:
        aging protects a long-waiting runner from being re-preempted by
        every fresh high-priority arrival (without the guard a steady
        high-priority stream would evict an aged request each time it
        re-admits — starvation by preemption, the failure the aging
        test pins down)."""
        eff = self._eff_priority(req, now)
        cands = [(s.req.priority, len(s.req.tokens), i)
                 for i, s in enumerate(self.slots)
                 if s.req is not None and not s.req.done
                 and s.req.priority < req.priority
                 and self._eff_priority(s.req, now) < eff]
        return min(cands)[2] if cands else None

    def _preempt(self, slot_id: int) -> None:
        """Evict a running sequence: KV pages release into the prefix
        cache (when present — the computed rows survive as a resident,
        evictable prefix and re-admission prefills only the suffix),
        the request re-queues with its tokens attached.  A PREFILLING
        victim just drops its partial dense work — nothing has been
        scattered to pages yet, so there is nothing to preserve."""
        slot = self.slots[slot_id]
        req = slot.req
        if self.prefix is not None:
            if not slot.prefilling and slot.length > 0:
                full = np.concatenate(
                    [req.prompt, np.asarray(req.tokens, np.int32)])
                self._preempt_pages_saved += self.prefix.insert(
                    full[:slot.length], slot.pages)
            self.allocator.release(slot.pages)
        else:
            self.allocator.free(slot.pages)
        self.block_tables[slot_id, :] = -1
        req.preemptions += 1
        self._preempted += 1
        self._queue.append(req)
        slot.req, slot.pages, slot.length = None, [], 0
        slot.seq, slot.dense, slot.pf_pos, slot.n_prefix = None, None, 0, 0

    def _admit(self, allowance: int | None) -> int:
        """Priority admission: fill slots while the head of the
        effective-priority order fits — preempting strictly-lower
        priority runners under slot/pool pressure, never skipping past
        an unadmittable head (within a class that keeps FIFO's
        no-starvation guarantee; across classes aging provides it).
        Returns first tokens emitted (unbudgeted mode prefills each
        admission to completion right here, so a later same-wave lookup
        sees the earlier admission's prefix)."""
        produced = 0
        while self._queue:
            now = _now()
            self._queue.sort(
                key=lambda r: (-self._eff_priority(r, now), r.rid))
            req = self._queue[0]
            # p99-targeted deferral: even one chunk of prefill would
            # push the in-flight decoders past the SLO this step
            if (self.slo_s is not None and allowance == 0
                    and any(s.decoding for s in self.slots)):
                self._deferred_steps += 1
                break
            slot_id = self._free_slot()
            if slot_id is None:
                victim = self._pick_victim(req, now)
                if victim is None:
                    break
                self._preempt(victim)
                slot_id = victim
            need = self._pages_for_request(req)
            seq = req.seq
            m, shared = 0, []
            if self.prefix is not None:
                # cap the hit at n-1: at least one suffix token must run
                # through prefill to produce the first output logits
                # (an int8 tree additionally rounds the hit down to a
                # page boundary — see RadixPrefixCache.full_pages_only)
                m, shared = self.prefix.lookup(seq[:-1])
            fork = m % self.page_size != 0
            fresh_n = need - len(shared) + (1 if fork else 0)
            while not self.allocator.can_alloc(fresh_n):
                if self.prefix is not None:
                    self.prefix.evict(fresh_n - self.allocator.num_free)
                    if self.allocator.can_alloc(fresh_n):
                        break
                victim = self._pick_victim(req, now)
                if victim is None:
                    break
                self._preempt(victim)
            if not self.allocator.can_alloc(fresh_n):
                if self.prefix is not None:
                    self.allocator.release(shared)
                break  # keep head-of-queue blocking: no skipping
            fresh = self.allocator.alloc(fresh_n)
            if fork:
                # the shared tail page is partially filled: this slot
                # will write into it, so copy-on-write it into a fresh
                # page and drop our reference to the shared original
                kv_cache.fork_page(self.blocks, shared[-1], fresh[0])
                self.allocator.release([shared[-1]])
                pages = shared[:-1] + fresh
            else:
                pages = shared + fresh
            self._queue.remove(req)
            self._assign(slot_id, req, pages, m, now)
            if self.prefill_budget is None:
                # admission-stall discipline: run this prefill to
                # completion before looking at the next request (the
                # completion-time prefix insert is then visible to the
                # rest of the wave, preserving same-wave sharing)
                slot = self.slots[slot_id]
                t0, chunks = _now(), 0
                while slot.prefilling:
                    self._advance_slot(slot_id, slot)
                    chunks += 1
                produced += 1
                self._note_cost("_chunk_ewma",
                                (_now() - t0) / chunks)
        return produced

    def _assign(self, slot_id: int, req: Request, pages: list, m: int,
                now: float) -> None:
        """Move a request into a slot in PREFILLING state: allocate its
        per-slot dense cache (seeded from shared prefix pages on a hit)
        — no model work happens here, and the slot's block-table row
        stays -1 until the finished prefill scatters into the pages."""
        slot = self.slots[slot_id]
        seq = req.seq
        if req.t_admit is None:
            req.t_admit = now
        slot.req, slot.pages, slot.length = req, pages, 0
        slot.seq, slot.pf_pos, slot.n_prefix = seq, m, m
        if not self._dyn_prefill:  # SWA: monolithic exact-shape prefill
            slot.dense = tf.init_caches(self.cfg, 1, self._bucket(len(seq)),
                                        self._dtype, self.device)
            return
        ns = len(seq) - m
        # the dense cache must hold prefix + suffix, bucketed on the
        # chunk grid as the reference does
        c_pad = max(self._bucket(ns), self._bucket(m + self._bucket(ns)))
        dense = tf.init_caches(self.cfg, 1, c_pad, self._dtype, self.device)
        if m:
            # gather the cached prefix rows into the dense cache and
            # set len=m: prefill resumes at position m, attending
            # over the seeded rows without recomputing them
            row = np.full((self.max_pp,), -1, np.int32)
            row[:len(pages)] = pages
            kv_cache.seed_prefix_dense(dense, self.blocks, self._upload(row), m)
        slot.dense = dense

    # -- chunked prefill ----------------------------------------------------

    def _advance_slot(self, slot_id: int, slot: _Slot) -> int:
        """Run ONE prefill chunk for a PREFILLING slot (the dynamic-
        length contract: a fixed (1, chunk) right-padded piece with the
        real token count).  Returns prompt tokens consumed; the slot
        transitions to DECODING when the last chunk lands."""
        seq, n = slot.seq, len(slot.seq)
        if not self._dyn_prefill:  # SWA: single exact pass
            tok, slot.dense = self._prefill(self.params,
                                            self._upload(seq[None], torch.int64),
                                            slot.dense)
            slot.pf_pos, k = n, n
        else:
            k = min(self._prefill_chunk, n - slot.pf_pos)
            piece = np.zeros((1, self._prefill_chunk), np.int64)
            piece[0, :k] = seq[slot.pf_pos:slot.pf_pos + k]
            tok, slot.dense = self._prefill(self.params,
                                            self._upload(piece, torch.int64),
                                            slot.dense, n_tokens=k)
            slot.pf_pos += k
        self._prefill_chunk_calls += 1
        if slot.pf_pos >= n:
            self._finish_prefill(slot_id, slot, tok)
        return k

    def _finish_prefill(self, slot_id: int, slot: _Slot, tok) -> None:
        """Last chunk landed: scatter the dense rows into the slot's
        pages, publish the block-table row, emit the first token, and
        flip the slot to DECODING."""
        req, seq, m, pages = slot.req, slot.seq, slot.n_prefix, slot.pages
        n = len(seq)
        self.block_tables[slot_id, :] = -1
        self.block_tables[slot_id, :len(pages)] = pages
        # an SWA prefill's rolling buffer holds positions n - t .. n - 1
        # (the ordered snapshot): tell the copy where its row 0 sits
        row0 = 0 if self._dyn_prefill else n - slot.dense["blocks"][0]["k"].shape[1]
        # row_lo=m: rows < m came from shared pages this slot may only
        # READ — scatter back just what this prefill computed
        kv_cache.write_prompt_pages(self.blocks, slot.dense["blocks"],
                                    self._upload(self.block_tables[slot_id]),
                                    n, row0_pos=row0, row_lo=m)
        slot.dense = None
        if self.spec_k:
            # draft prefill: FULL sequence (the draft shares no pages,
            # so no prefix shortcut), into the slot's static draft pages
            dpad = self._bucket(n)
            dprompt = np.zeros((1, dpad), np.int64)
            dprompt[0, :n] = seq
            ddense = tf.init_caches(self.draft_cfg, 1, dpad, self._dtype,
                                    self.device)
            _, ddense = self._draft_prefill(self.draft_params,
                                            self._upload(dprompt, torch.int64),
                                            ddense, n_tokens=n)
            kv_cache.write_prompt_pages(self.draft_blocks, ddense["blocks"],
                                        self._upload(self._draft_bt[slot_id]), n)
        self._admitted += 1
        self._prompt_tokens += n
        self._prefilled_tokens += n - m
        if self.prefix is not None:
            # index the sequence now that its rows are physically in
            # the pages (an in-flight prefill must never be served)
            self.prefix.insert(seq, pages)
        now = _now()
        if req.t_first is None:
            req.t_first = now
        req.tokens.append(int(tok[0]))
        req.token_times.append(now)
        slot.length = n
        if self.eos_id is not None and req.tokens[-1] == self.eos_id:
            req.max_new = len(req.tokens)  # eos at prefill: done already

    def _advance_prefills(self, allowance: int | None) -> int:
        """Spend this step's prefill allowance advancing PREFILLING
        slots round-robin, one chunk at a time (a slot admitted earlier
        never monopolizes the budget).  Unlimited allowance drains them
        all.  Returns first tokens emitted by finished prefills."""
        spent, chunks, produced = 0, 0, 0
        t0 = _now()
        while True:
            live = [(i, s) for i, s in enumerate(self.slots)
                    if s.prefilling]
            if not live or (allowance is not None and spent >= allowance):
                break
            for slot_id, slot in live:
                if allowance is not None and spent >= allowance:
                    break
                spent += self._advance_slot(slot_id, slot)
                chunks += 1
                if not slot.prefilling:
                    produced += 1
        if chunks:
            # sample the chunk cost periodically rather than every step:
            # an accurate sample needs a device sync,
            # and paying that round-trip on EVERY interleaved step costs
            # real throughput — the EWMA only feeds the SLO throttle, so
            # a 1-in-8 probe keeps it current at ~1/8th the sync cost
            self._chunk_probe += 1
            if self._chunk_ewma is None or self._chunk_probe % 8 == 0:
                # every chunk of this step was issued on the device's
                # one stream: waiting for it waits for them all
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._note_cost("_chunk_ewma",
                                (_now() - t0) / chunks)
        return produced

    # -- retirement ---------------------------------------------------------

    def _retire(self, slot_id, slot) -> None:
        req = slot.req
        req.t_done = _now()
        if self.prefix is not None:
            # index prompt + generated tokens: rows [0, length) are
            # valid, and row j holds the KV of sequence token j — the
            # LAST generated token never ran through the model, so it
            # has no row and stays out of the index
            full = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
            self.prefix.insert(full[:slot.length], slot.pages)
            self.allocator.release(slot.pages)
        else:
            self.allocator.free(slot.pages)
        self.block_tables[slot_id, :] = -1
        self._done.append(req)
        slot.req, slot.pages, slot.length = None, [], 0
        slot.seq, slot.dense, slot.pf_pos, slot.n_prefix = None, None, 0, 0

    # -- fault tolerance (the hooks a serving supervisor drives) ------------

    def cancel(self, req: Request) -> bool:
        """End a request wherever it is — queued (dequeued), PREFILLING
        (partial dense work dropped), or DECODING (pages released) —
        keeping its tokens so far.  Retirement minus the radix insert:
        a deadline-dead sequence's KV is not worth indexing.  Returns
        False if the request is unknown here (already retired,
        cancelled, or living in a different engine)."""
        if req in self._queue:
            self._queue.remove(req)
        else:
            for sid, slot in enumerate(self.slots):
                if slot.req is req:
                    if self.prefix is not None:
                        self.allocator.release(slot.pages)
                    else:
                        self.allocator.free(slot.pages)
                    self.block_tables[sid, :] = -1
                    slot.req, slot.pages, slot.length = None, [], 0
                    slot.seq, slot.dense = None, None
                    slot.pf_pos, slot.n_prefix = 0, 0
                    break
            else:
                return False
        req.cancelled = True
        req.t_done = _now()
        self._cancelled += 1
        self._done.append(req)
        return True

    def quarantine_slot(self, slot_id: int) -> None:
        """Permanently retire a decode lane whose state is suspect (its
        pages held poisoned KV).  The caller tears the occupant down
        first (:meth:`cancel` or a supervisor salvage); admission skips
        quarantined lanes from here on."""
        slot = self.slots[slot_id]
        if slot.req is not None:
            raise ValueError(
                f"slot {slot_id} still holds request {slot.req.rid} — "
                "tear it down before quarantining the lane")
        slot.quarantined = True

    def page_owners(self) -> dict:
        """Claimed page ownership for :meth:`kv_cache.PageAllocator.
        audit`: every live slot claims its block-table pages, the radix
        tree claims one reference per node."""
        owners = {}
        for sid, slot in enumerate(self.slots):
            if slot.req is not None:
                owners[f"slot{sid}"] = list(slot.pages)
        if self.prefix is not None:
            owners["radix"] = self.prefix.pages()
        return owners

    def audit(self) -> dict:
        """Zero-leak proof for the whole engine: the allocator's
        internal invariants AND cross-checked ownership claims (slots +
        radix tree), plus block-table/slot agreement — a DECODING
        slot's published table row must list exactly its pages, and
        non-decoding rows must be unmapped.  Raises
        :class:`kv_cache.PoolAuditError`; returns the pool summary."""
        report = self.allocator.audit(self.page_owners())
        for sid, slot in enumerate(self.slots):
            row = [int(p) for p in self.block_tables[sid] if p >= 0]
            want = list(slot.pages) if slot.decoding else []
            if row != want:
                raise kv_cache.PoolAuditError(
                    f"slot {sid} block table {row} != owned pages {want}")
        return report

    def take_done(self) -> list[Request]:
        """Drain finished (and cancelled) requests — what a supervisor
        collects across engine rebuilds; :meth:`run` uses it too."""
        done, self._done = self._done, []
        return done

    # -- the engine step ----------------------------------------------------

    @torch.no_grad()
    def step(self, debug_audit: bool = False) -> int:
        """Admit what fits, spend the prefill allowance, run one batched
        decode over the DECODING slots, retire what finished.  Returns
        tokens generated (decode + prefill first tokens).
        ``debug_audit`` runs the zero-leak :meth:`audit` after the step
        — every page accounted for on every step, at host-side cost."""
        produced = self._step_inner()
        if debug_audit:
            self.audit()
        return produced

    def _step_inner(self) -> int:
        # retire-before-admit: a request whose LAST token came from the
        # previous step (or from prefill, max_new == 1) frees its pages
        # for this step's admissions
        for sid, slot in enumerate(self.slots):
            if slot.decoding and slot.req.done:
                self._retire(sid, slot)
        now = _now()
        allowance = self._prefill_allowance(now)
        produced = self._admit(allowance)
        produced += self._advance_prefills(allowance)
        # max_new == 1 requests finish at prefill: retire before the
        # decode so they don't produce an extra token
        for sid, slot in enumerate(self.slots):
            if slot.decoding and slot.req.done:
                self._retire(sid, slot)
        if not any(s.decoding for s in self.slots):
            return produced
        if self.spec_k:
            produced += self._spec_step()
            self.steps += 1
            return produced

        t_dec = _now()
        last = np.zeros((self.max_slots, 1), np.int64)
        for sid, slot in enumerate(self.slots):
            if slot.decoding:
                last[sid, 0] = slot.req.tokens[-1]
        caches = {
            "blocks": self.blocks,
            "block_tables": self._upload(self.block_tables),
            "lens": self._upload(
                [s.length if s.decoding else 0 for s in self.slots]),
        }
        tok, caches = self._decode(self.params, self._upload(last, torch.int64),
                                   caches)
        self.blocks = caches["blocks"]
        self.steps += 1
        tok = tok.cpu().numpy()  # blocks: the step streams its tokens
        self._note_cost("_decode_ewma", _now() - t_dec)
        now = _now()
        for sid, slot in enumerate(self.slots):
            if not slot.decoding:
                continue
            req = slot.req
            slot.length += 1
            t = int(tok[sid, 0])
            req.tokens.append(t)
            req.token_times.append(now)
            produced += 1
            if self.eos_id is not None and t == self.eos_id:
                req.max_new = len(req.tokens)  # truncate: eos ends it
        return produced

    def _spec_step(self) -> int:
        """One speculative round over the DECODING slots: draft proposes
        ``spec_k`` tokens, the target verifies all of them in one
        multi-token paged step, the longest matching prefix plus the
        target's own continuation is emitted.

        Correctness: ``greedy[:, j]`` is the target's greedy token
        after the true sequence extended by proposals ``1..j``; the
        accept scan stops at the first mismatch, so every emitted token
        equals what non-speculative greedy decode would have produced
        (induction over columns).  Rejected rows sit at/after the
        advanced length — masked by every later attend and overwritten
        by later writes — so no physical rollback is needed.
        PREFILLING slots ride along masked (len 0, block-table -1, no
        emission) exactly like empty ones.
        """
        k = self.spec_k
        t_dec = _now()
        last = np.zeros((self.max_slots, 1), np.int64)
        for sid, slot in enumerate(self.slots):
            if slot.decoding:
                last[sid, 0] = slot.req.tokens[-1]
        lens = np.array([s.length if s.decoding else 0 for s in self.slots],
                        np.int32)
        # draft chain: k+1 sequential single-token steps — outputs
        # 0..k-1 are the proposals, the extra step writes the LAST
        # proposal's KV row so the draft cache stays in lockstep with
        # the target after a full acceptance
        dcaches = {
            "blocks": self.draft_blocks,
            "block_tables": self._upload(self._draft_bt),
            "lens": self._upload(lens),
        }
        tok, chain = self._upload(last, torch.int64), []
        for _ in range(k + 1):
            tok, dcaches = self._draft_decode(self.draft_params, tok,
                                              dcaches)
            chain.append(tok)
        self.draft_blocks = dcaches["blocks"]
        props = torch.cat(chain[:k], dim=1).cpu().numpy()  # (B, k)
        caches = {
            "blocks": self.blocks,
            "block_tables": self._upload(self.block_tables),
            "lens": self._upload(lens),
        }
        verify_in = np.concatenate([last, props], axis=1)  # (B, k+1)
        greedy, caches = self._verify(self.params,
                                      self._upload(verify_in, torch.int64), caches)
        self.blocks = caches["blocks"]
        greedy = greedy.cpu().numpy()
        self._note_cost("_decode_ewma", _now() - t_dec)
        now = _now()
        produced = 0
        self._spec_steps += 1
        for sid, slot in enumerate(self.slots):
            if not slot.decoding:
                continue
            req = slot.req
            self._spec_slot_steps += 1
            a = 0
            while a < k and props[sid, a] == greedy[sid, a]:
                a += 1
            appended = 0
            for j in range(a + 1):
                if req.done:
                    break
                t = int(greedy[sid, j])
                req.tokens.append(t)
                req.token_times.append(now)
                appended += 1
                if self.eos_id is not None and t == self.eos_id:
                    req.max_new = len(req.tokens)  # truncate: eos ends it
                    break
            # advance by what was actually APPENDED (eos / max_new can
            # truncate below a+1) — keeps length == n + len(tokens) - 1,
            # the invariant every later step and retire-insert relies on
            slot.length += appended
            produced += appended
            self._spec_emitted += appended
        return produced

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive steps until every submitted request has retired."""
        for _ in range(max_steps):
            if not self._queue and self.active == 0:
                break
            self.step()
        # a trailing retire pass: the final step's completions
        for sid, slot in enumerate(self.slots):
            if slot.decoding and slot.req.done:
                self._retire(sid, slot)
        if self._queue or self.active:
            raise RuntimeError(
                f"engine stalled: {len(self._queue)} queued, "
                f"{self.active} active after {max_steps} steps")
        return self.take_done()

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Counters for the run so far: admission, scheduling (budget /
        preemption / SLO deferral), prefix-cache hit rates (prefill
        tokens served from shared pages vs computed), pool sharing, and
        speculative acceptance."""
        s = {
            "steps": self.steps,
            "admitted": self._admitted,
            "rejected": self._rejected,
            "prompt_tokens": self._prompt_tokens,
            "prefilled_tokens": self._prefilled_tokens,
            "prefill_chunk_calls": self._prefill_chunk_calls,
            "pages_free": self.allocator.num_free,
            "pages_shared": self.allocator.num_shared,
            "preemptions": self._preempted,
            "preempt_pages_saved": self._preempt_pages_saved,
            "cancelled": self._cancelled,
        }
        if self.allocator.num_quarantined or any(
                s.quarantined for s in self.slots):
            s.update(
                pages_quarantined=self.allocator.num_quarantined,
                slots_quarantined=sum(
                    1 for sl in self.slots if sl.quarantined))
        if self.prefill_budget is not None:
            s["prefill_budget"] = self.prefill_budget
        if self.slo_s is not None:
            s.update(slo_ms=self.slo_s * 1e3,
                     slo_deferred_steps=self._deferred_steps,
                     slo_throttled_steps=self._throttled_steps)
        if self._chunk_ewma is not None:
            s["chunk_cost_ms"] = self._chunk_ewma * 1e3
        if self._decode_ewma is not None:
            s["decode_cost_ms"] = self._decode_ewma * 1e3
        if self.prefix is not None:
            s.update(
                prefix_lookups=self.prefix.lookups,
                prefix_hits=self.prefix.hits,
                prefix_hit_tokens=self.prefix.hit_tokens,
                prefix_evicted_pages=self.prefix.evicted_pages,
                prefix_nodes=self.prefix.num_nodes,
            )
        if self.spec_k:
            s.update(
                spec_k=self.spec_k,
                spec_steps=self._spec_steps,
                spec_slot_steps=self._spec_slot_steps,
                spec_emitted=self._spec_emitted,
                accepted_per_spec_step=(
                    self._spec_emitted / max(self._spec_slot_steps, 1)),
            )
        return s


def latency_stats(requests) -> dict:
    """p50/p99 per-token latency + request latency over a finished
    trace (seconds).  ``token_*`` percentiles measure from SUBMISSION
    (a request's first gap is its TTFT, so queue wait shows up in the
    tail); ``itl_*`` are the INTER-token gaps only — the streaming
    experience of an already-started request, the number an SLO on
    "time between tokens" targets and the one admission-time prefill
    stalls inflate.  Queue wait is submit -> first admission, TTFT is
    submit -> first token.  All timestamps come from the engine's
    monotonic ``_now`` clock, so every difference here is non-negative
    by construction — wall-clock steps cannot fabricate latency."""
    gaps, itl, req_lat, ttft, qwait = [], [], [], [], []
    for r in requests:
        ts = [r.t_submit] + r.token_times
        gaps += [b - a for a, b in zip(ts, ts[1:])]
        itl += [b - a for a, b in zip(r.token_times, r.token_times[1:])]
        req_lat.append(r.t_done - r.t_submit)
        ttft.append(r.t_first - r.t_submit)
        qwait.append(r.t_admit - r.t_submit)
    gaps.sort()
    itl.sort()
    ttft.sort()
    qwait.sort()
    if not itl:  # every request emitted a single token
        itl = [0.0]

    def pct(xs, p):
        return xs[min(len(xs) - 1, int(p * len(xs)))]

    return {
        "tokens": sum(len(r.tokens) for r in requests),
        "token_p50_s": pct(gaps, 0.50),
        "token_p99_s": pct(gaps, 0.99),
        "itl_p50_s": pct(itl, 0.50),
        "itl_p99_s": pct(itl, 0.99),
        "ttft_p50_s": pct(ttft, 0.50),
        "ttft_p99_s": pct(ttft, 0.99),
        "queue_p50_s": pct(qwait, 0.50),
        "queue_p99_s": pct(qwait, 0.99),
        "request_mean_s": sum(req_lat) / len(req_lat),
    }


def phase_breakdown(requests) -> dict:
    """Where the p99-latency request spent its life: queue wait
    (submit -> admit), prefill (admit -> first token) and decode
    (first -> last token) as fractions of its total latency, plus the
    fleet-wide mean shares — the row serving_bench archives so the
    trajectory shows WHICH phase the tail lives in."""
    lat = sorted(requests, key=lambda r: r.t_done - r.t_submit)
    r99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]

    def shares(r):
        total = max(r.t_done - r.t_submit, 1e-12)
        return ((r.t_admit - r.t_submit) / total,
                (r.t_first - r.t_admit) / total,
                (r.t_done - r.t_first) / total)

    q99, p99, d99 = shares(r99)
    mean = [sum(xs) / len(lat) for xs in zip(*(shares(r) for r in lat))]
    return {
        "p99_queue": q99, "p99_prefill": p99, "p99_decode": d99,
        "mean_queue": mean[0], "mean_prefill": mean[1],
        "mean_decode": mean[2],
    }
