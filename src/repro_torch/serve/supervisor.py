"""Fault-tolerant serving: a supervisor wrapping :class:`ServingEngine`
(PyTorch port of ``repro.serve.supervisor``).

The training tier's detect -> replan -> resume loop is the reference's
``ft/supervisor.TrainSupervisor``; this module is the serving
counterpart the paper's reconfigurable cluster needs just as much — an
inference board wedges or poisons its KV pool mid-decode, and the
engine must shed the damage without corrupting the sequences that were
never touched.  The supervisor owns the engine the way the train
supervisor owns the train step:

* every ``step()`` runs one engine step and reports a **heartbeat**
  (:class:`repro_torch.ft.health.HeartbeatMonitor`): wall-clock step time,
  the device enumeration, a NaN probe over the KV pools, and any
  exception the step raised.  Faults from the
  :class:`repro_torch.ft.faults.FaultPlan` poison what the beat *observes*
  (a shrunken enumeration, NaN rows in a victim's pages, a page doubled
  onto the free list) — detection is the monitor and the
  :meth:`ServingEngine.audit` cross-check noticing, the same code path
  a real deployment would run;
* **deadlines**: ``submit(..., deadline_ms=)`` arms a per-request
  timer; enforcement runs every supervisor step (hangs included), so an
  expired request is cancelled within one step of its deadline and its
  pages provably return to the pool (the audit runs right after);
* **recovery** is built on the bitwise-resume property the preemption
  path proved: a greedy continuation is a pure
  function of the token sequence, so truncating a victim to its last
  known-clean token and re-admitting it through
  :meth:`ServingEngine.requeue` resumes bit-for-bit.  ``decode_nan``
  recovers IN PLACE — poisoned pages are purged from the radix index
  (:meth:`RadixPrefixCache.drop_pages`), their clean page-prefix is
  salvaged back INTO the index, the pages and the victim's decode lane
  are quarantined, and only the victims requeue; ``device_loss`` /
  ``step_hang`` / ``pool_corrupt`` rebuild the engine (pools sized to
  the surviving device fraction) and migrate every in-flight request
  across;
* **graceful degradation**: requests that can no longer fit the
  shrunken pool are shed lowest-priority-first, and after
  ``degrade_after`` faults implicating the compiled kernels
  (``decode_nan``, ``step_hang``) the attention/GEMM dispatchers flip
  to the plain PyTorch versions (``set_attention_impl("ref")``,
  ``set_gemm_impl("ref")``), trading speed for a known-good numeric
  path.  The flip is visible: a ``degrade`` event, ``stats()["degraded"]``,
  and :meth:`restore_dispatchers` puts the previous settings back.

Every action lands in ``self.events`` as a typed :class:`ServeEvent`
with its measured ``recovery_s``.

Where the port differs from the reference on purpose:

* an error of the device (``torch.AcceleratorError``) or of a kernel's
  launch (``kernels._build.KernelLaunchError``) raised by the engine's
  step propagates: recovery is for faults of the serving state, and a
  rebuild around a failing kernel would hide it.  Every other exception
  of the step is caught and recovered from as in the reference;
* the pool probe catches nothing (the port donates no buffer, so no
  probe can meet a deleted one);
* ``decode_nan`` writes its NaN rows into the pools in place, into every
  floating leaf of every layer's pool (an int8 pool's f32 scales), at the
  page on axis 1, which is where ``kv_cache.find_nonfinite_pages`` looks;
* the default device list is the CUDA devices torch sees (one CPU device
  for an engine on the CPU): on one card a ``device_loss`` ends in "all
  devices lost", as the reference does on one device.

The engine keeps its block tables in a host numpy array and uploads a
fresh copy of it every step (``ServingEngine._upload`` copies the array
into a new tensor before the asynchronous transfer), so the rows the
supervisor rewrites (``block_tables[sid, :] = -1``) are never read by an
upload in flight.
"""

from __future__ import annotations

import copy
import dataclasses
from collections import Counter

import torch

from repro_torch.ft.health import HeartbeatMonitor
from repro_torch.kernels._build import KernelLaunchError
from repro_torch.models import layers
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import kv_cache
from repro_torch.serve.engine import Request, ServingEngine

__all__ = ["SERVE_EVENT_KINDS", "ServeEvent", "ServeSupervisor"]

SERVE_EVENT_KINDS = ("cancel_deadline", "quarantine", "rebuild", "shed",
                     "degrade", "watchdog")

# errors of the card or of a kernel's launch: never recovered from
_DEVICE_ERRORS = (torch.AcceleratorError, KernelLaunchError)


def _default_devices(params) -> list:
    """The devices a supervisor starts with: every CUDA device torch sees
    for params on the card, the one CPU device for params on the CPU."""
    dev = params["embed"]["table"].device
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


@dataclasses.dataclass(frozen=True)
class ServeEvent:
    """One supervisor action: what happened, at which supervisor step,
    and how long the recovery took (0 for bookkeeping-only events)."""

    kind: str
    step: int
    detail: dict = dataclasses.field(default_factory=dict)
    recovery_s: float = 0.0

    def __post_init__(self):
        if self.kind not in SERVE_EVENT_KINDS:
            raise ValueError(f"unknown serve event kind {self.kind!r} "
                             f"(one of {SERVE_EVENT_KINDS})")


class ServeSupervisor:
    """Heartbeat-driven fault tolerance around one :class:`ServingEngine`.

    ``engine_kw`` is passed through to every engine build (the
    supervisor rebuilds after destructive faults, scaling ``num_pages``
    / ``pool_bytes`` by the surviving device fraction — a lost board
    takes its HBM slice with it).  ``fault_plan`` poisons observations;
    ``None`` runs clean.  ``nan_probe_every`` / ``audit_every`` set the
    probe cadence in steps (1 = every step: the zero-leak discipline
    the bench gates on).  ``degrade_after`` kernel-implicating faults
    flip the dispatchers to the plain versions (``None`` disables);
    ``max_recoveries`` bounds how many faults the supervisor absorbs
    before declaring the deployment unrecoverable.
    """

    def __init__(self, params, cfg, *, engine_kw=None, fault_plan=None,
                 devices=None, health: HeartbeatMonitor | None = None,
                 nan_probe_every: int = 1, audit_every: int = 1,
                 degrade_after: int | None = 2, max_recoveries: int = 8,
                 verbose: bool = False):
        self.params, self.cfg = params, cfg
        self.engine_kw = dict(engine_kw or {})
        self.plan = fault_plan
        self.devices = list(devices if devices is not None
                            else _default_devices(params))
        self._total_devices = len(self.devices)
        self.health = health or HeartbeatMonitor()
        self.nan_probe_every = max(1, nan_probe_every)
        self.audit_every = max(1, audit_every)
        self.degrade_after = degrade_after
        self.max_recoveries = max_recoveries
        self.verbose = verbose
        self.events: list[ServeEvent] = []
        self.done: list[Request] = []
        self.steps = 0
        self.recoveries = 0
        self.rebuilds = 0
        self.degraded = False
        self._prev_impls = None
        self._fault_counts: Counter = Counter()
        self._pending: list = []  # injections waiting for a viable target
        self._deadline: dict[int, float] = {}  # rid -> absolute deadline
        self._by_rid: dict[int, Request] = {}
        self._orig_max_new: dict[int, int] = {}
        # rid -> generated-token count at the last CLEAN probe: the
        # truncation bound recovery rolls a poisoned victim back to
        self._clean_tokens: dict[int, int] = {}
        self._last_enforce = engine_mod._now()
        self.engine: ServingEngine | None = None
        self._build_engine()

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[serve-ft] {msg}")

    # -- engine lifecycle ---------------------------------------------------

    def _build_engine(self) -> None:
        """(Re)build the engine on the CURRENT device set: the KV pool
        shrinks by the surviving fraction — a dead board's HBM is gone,
        and pretending otherwise would admit sequences the real cluster
        could not back."""
        kw = dict(self.engine_kw)
        frac = len(self.devices) / max(self._total_devices, 1)
        if frac < 1.0:
            if kw.get("pool_bytes") is not None:
                kw["pool_bytes"] = max(1, int(kw["pool_bytes"] * frac))
            else:
                base = kw.get("num_pages")
                if base is None:
                    base = kw.get("max_slots", 4) * kv_cache.pages_for(
                        kw.get("max_len", 512), kw.get("page_size", 16))
                kw["num_pages"] = max(1, int(base * frac))
        self.engine = ServingEngine(self.params, self.cfg, **kw)
        # old intervals described the old engine; the fresh enumeration
        # must not read as a second loss
        self.health.reset()
        self.health.expect_devices(0, len(self.devices))

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new: int, priority: int = 0,
               deadline_ms: float | None = None) -> Request:
        """Submit through the CURRENT engine; ``deadline_ms`` arms a
        per-request timer (from now, monotonic) — expiry cancels the
        request wherever it is, within one supervisor step."""
        req = self.engine.submit(prompt, max_new, priority=priority)
        self._by_rid[req.rid] = req
        # eos can clobber req.max_new; a rollback past a GARBAGE eos
        # must restore the original budget
        self._orig_max_new[req.rid] = req.max_new
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise ValueError(
                    f"deadline_ms must be > 0, got {deadline_ms}")
            self._deadline[req.rid] = engine_mod._now() + deadline_ms / 1e3
        return req

    # -- fault injection (plan -> observable damage) ------------------------

    def _inject(self, t: int) -> None:
        """Turn due plan events into OBSERVABLE damage: NaN rows in a
        victim's pages, a live page doubled onto the free list.  An
        event with no viable target yet (no decoding slot, no live
        page) stays pending and retries next step."""
        for kind in ("decode_nan", "pool_corrupt"):
            while True:
                ev = self.plan.take(kind, t)
                if ev is None:
                    break
                self._pending.append(ev)
        still = []
        for ev in self._pending:
            done = (self._inject_poison(ev) if ev.kind == "decode_nan"
                    else self._inject_corrupt(ev))
            if not done:
                still.append(ev)
        self._pending = still

    def _inject_poison(self, ev) -> bool:
        eng = self.engine
        sid = None
        if 0 <= ev.slot < len(eng.slots) and eng.slots[ev.slot].decoding:
            sid = ev.slot
        else:
            sid = next((i for i, s in enumerate(eng.slots) if s.decoding),
                       None)
        if sid is None:
            return False
        # the victim's tail page: always privately owned (at least one
        # suffix row was written by this slot — shared tails are
        # COW-forked at admission), so the poison maps to one sequence
        page = eng.slots[sid].pages[-1]
        for pool in eng.blocks:
            for leaf in pool.values():
                if leaf.is_floating_point():
                    leaf[:, page] = float("nan")
        self._log(f"step {ev.step}: poisoned page {page} (slot {sid})")
        return True

    def _inject_corrupt(self, ev) -> bool:
        eng = self.engine
        live = sorted(eng.allocator._refs)
        if ev.page >= 0:
            page = ev.page
        elif live:
            page = self.plan.choose(live)
        else:
            return False
        # the double-ownership bug class: a page a slot still owns
        # reappears on the free list, waiting to be handed to the next
        # admission — only the audit cross-check can see it in time
        eng.allocator._free.append(page)
        self._log(f"step {ev.step}: doubled page {page} onto free list")
        return True

    # -- clean-state bookkeeping --------------------------------------------

    def _snapshot_clean(self) -> None:
        """After a step whose probes all passed, every live request's
        generated tokens are known-good: record the counts as the
        rollback bound for the next fault."""
        clean = {}
        for slot in self.engine.slots:
            if slot.req is not None:
                clean[slot.req.rid] = len(slot.req.tokens)
        for req in self.engine._queue:
            clean[req.rid] = len(req.tokens)
        self._clean_tokens = clean

    def _truncate(self, req: Request) -> None:
        """Roll a suspect request back to its last clean token count —
        the bitwise-resume contract needs every kept token to be one
        the fault-free run would also have emitted."""
        n = self._clean_tokens.get(req.rid, 0)
        if len(req.tokens) > n:
            del req.tokens[n:]
            del req.token_times[n:]
        orig = self._orig_max_new.get(req.rid)
        if (orig is not None and req.max_new != orig
                and req.max_new > len(req.tokens)):
            req.max_new = orig  # eos fired on a GARBAGE token: undo it

    # -- the supervised step ------------------------------------------------

    def step(self) -> int:
        """One supervised engine step: inject due faults, run the step,
        beat the heartbeat, probe pools, dispatch recovery, enforce
        deadlines.  Returns tokens the engine produced."""
        t = self.steps
        eng = self.engine
        # drain completions first so everything in eng._done afterwards
        # finished DURING this step (recovery must re-examine those)
        self.done += eng.take_done()
        if self.plan is not None:
            hang = self.plan.take("step_hang", t)
            if hang is not None:
                self._handle_hang(hang, t)
                self._enforce_deadlines(t)
                self.steps += 1
                return 0
            self._inject(t)
            visible = self.plan.devices_visible(self.devices, t)
        else:
            visible = self.devices
        # pre-step ownership snapshot: a victim that RETIRES during the
        # poisoned step vacates its slot, and only this map still ties
        # its request to the pages the probe flags
        pre_owners = {s.req.rid: list(s.pages)
                      for s in eng.slots if s.req is not None}
        t0 = engine_mod._now()
        err, produced = None, 0
        try:
            produced = eng.step()
        except _DEVICE_ERRORS:
            raise
        except Exception as e:  # poisoned metadata can throw anywhere
            err = f"{type(e).__name__}: {e}"
        step_s = engine_mod._now() - t0
        health_events = self.health.beat(
            0, t, now=engine_mod._now(), step_s=step_s,
            devices=len(visible), error=err)
        bad = [] if err else self._nan_probe(t)
        audit_err = None
        if err is None and not bad and t % self.audit_every == 0:
            try:
                eng.audit()
            except kv_cache.PoolAuditError as e:
                audit_err = str(e)
        lost = sum(e.detail["lost"] for e in health_events
                   if e.kind == "device_loss")
        if lost:
            self._recover_rebuild(t, kind="device_loss",
                                  reason=f"enumeration shrank by {lost}",
                                  lost=lost, bad=bad, pre_owners=pre_owners)
        elif bad:
            self._recover_poison(t, bad, pre_owners)
        elif err is not None or audit_err is not None:
            self._recover_rebuild(t, kind="pool_corrupt",
                                  reason=err or audit_err,
                                  truncate_all=True, pre_owners=pre_owners)
        else:
            self._snapshot_clean()
        self._enforce_deadlines(t)
        self.steps += 1
        return produced

    def _nan_probe(self, t: int) -> list[int]:
        if t % self.nan_probe_every != 0:
            return []
        bad = kv_cache.find_nonfinite_pages(self.engine.blocks)
        # a quarantined page keeps its NaN rows (out of circulation, not
        # scrubbed) — re-flagging it every step would loop recovery
        quarantined = self.engine.allocator._quarantined
        return [p for p in bad if p not in quarantined]

    # -- deadlines ----------------------------------------------------------

    def _enforce_deadlines(self, t: int) -> None:
        """Cancel every expired request.  Runs on EVERY supervisor step
        (hangs and recoveries included), so a deadline is enforced
        within one step of expiry — ``expired_since_last_check`` in the
        event detail records exactly that."""
        now = engine_mod._now()
        for rid, dl in sorted(self._deadline.items()):
            req = self._by_rid[rid]
            if req.done or req.cancelled:
                del self._deadline[rid]
                continue
            if now < dl:
                continue
            if not self.engine.cancel(req):
                # not in this engine (mid-recovery edge): end it here
                req.cancelled = True
                req.t_done = now
                self.done.append(req)
            self.events.append(ServeEvent(
                "cancel_deadline", t,
                {"rid": rid, "late_s": now - dl,
                 "expired_since_last_check": dl >= self._last_enforce}))
            self._log(f"step {t}: deadline-cancelled rid {rid} "
                      f"({(now - dl) * 1e3:.1f} ms past)")
            del self._deadline[rid]
        self._last_enforce = now

    # -- recovery -----------------------------------------------------------

    def _bump(self, kind: str) -> None:
        self.recoveries += 1
        self._fault_counts[kind] += 1
        if self.recoveries > self.max_recoveries:
            raise RuntimeError(
                f"unrecoverable: {self.recoveries} faults exceeds "
                f"max_recoveries={self.max_recoveries}")

    def _handle_hang(self, ev, t: int) -> None:
        """A wedged step never beats; the watchdog poll at the virtual
        post-hang clock declares the miss, and recovery rebuilds — the
        wedged step's work is simply gone."""
        now_virtual = engine_mod._now() + ev.hang_s
        misses = self.health.poll(now=now_virtual)
        detected = any(m.kind == "miss" for m in misses)
        self.events.append(ServeEvent(
            "watchdog", t,
            {"hang_s": ev.hang_s, "detected": detected,
             "missing": self.health.missing}))
        self._log(f"step {t}: watchdog fired (hang {ev.hang_s:g}s, "
                  f"miss detected={detected})")
        self._recover_rebuild(
            t, kind="step_hang",
            reason=f"engine step wedged {ev.hang_s:g}s")

    def _suspect(self, rid: int, pages, bad: set, truncate_all: bool,
                 pre_owners: dict) -> bool:
        if truncate_all:
            return True
        if not bad:
            return False
        return bool(bad & set(pages)) or bool(
            bad & set(pre_owners.get(rid, ())))

    def _collect_salvage(self, *, bad=(), truncate_all: bool = False,
                         pre_owners: dict | None = None) -> list[Request]:
        """Gather every in-flight request off the current engine for
        re-admission into its successor, truncating suspects to their
        last clean token.  Requests that FINISHED during the faulted
        step are re-examined: a suspect's final tokens are rolled back
        and it resumes; a clean one stays done."""
        eng = self.engine
        badset = set(bad)
        pre = pre_owners or {}
        salvaged = []
        for slot in eng.slots:
            if slot.req is None:
                continue
            req = slot.req
            if self._suspect(req.rid, slot.pages, badset, truncate_all, pre):
                self._truncate(req)
            (self.done if req.done else salvaged).append(req)
        salvaged += list(eng._queue)  # queued tokens live host-side: clean
        for req in eng.take_done():  # finished during the faulted step
            if req.cancelled:
                self.done.append(req)
                continue
            if self._suspect(req.rid, (), badset, truncate_all, pre):
                self._truncate(req)
            (self.done if req.done else salvaged).append(req)
        return salvaged

    def _readmit(self, salvaged, t: int) -> None:
        """Requeue salvaged requests highest-priority-first; shed what
        the (possibly shrunken) pool can never back again."""
        shed = []
        now = engine_mod._now()
        for req in sorted(salvaged, key=lambda r: (-r.priority, r.rid)):
            try:
                self.engine.requeue(req)
            except ValueError:
                req.cancelled = True
                req.t_done = now
                self.done.append(req)
                self._deadline.pop(req.rid, None)
                shed.append(req.rid)
        if shed:
            self.events.append(ServeEvent(
                "shed", t, {"rids": shed,
                            "reason": "pool cannot back request"}))
            self._log(f"step {t}: shed rids {shed}")

    def _shed_unfit(self, t: int) -> None:
        """After quarantine shrank the usable pool, queued requests it
        can never back would block the FIFO head forever — shed them
        (lowest priority first) instead of stalling everyone."""
        eng = self.engine
        usable = min(eng.max_pp,
                     eng.num_pages - eng.allocator.num_quarantined)
        unfit = [r for r in eng._queue
                 if kv_cache.pages_for(len(r.prompt) + r.max_new,
                                       eng.page_size) > usable]
        if not unfit:
            return
        now = engine_mod._now()
        shed = []
        for req in sorted(unfit, key=lambda r: (r.priority, r.rid)):
            eng._queue.remove(req)
            req.cancelled = True
            req.t_done = now
            self.done.append(req)
            self._deadline.pop(req.rid, None)
            shed.append(req.rid)
        self.events.append(ServeEvent(
            "shed", t, {"rids": shed,
                        "reason": "quarantine shrank the pool"}))
        self._log(f"step {t}: shed rids {shed} (pool shrank)")

    def _recover_poison(self, t: int, bad, pre_owners: dict) -> None:
        """In-place ``decode_nan`` recovery: purge poisoned pages from
        the radix index, salvage each victim's clean page-prefix back
        into it, quarantine the pages and the victim's lane, roll the
        victim back to its last clean token and requeue it.  Healthy
        slots keep decoding untouched."""
        self._bump("decode_nan")
        t0 = engine_mod._now()
        eng = self.engine
        badset = set(int(p) for p in bad)
        dropped = (eng.prefix.drop_pages(badset)
                   if eng.prefix is not None else 0)
        victims = [(sid, s) for sid, s in enumerate(eng.slots)
                   if s.req is not None and badset & set(s.pages)]
        rids, salvaged_pages = [], 0
        for sid, slot in victims:
            req = slot.req
            self._truncate(req)
            if eng.prefix is not None and slot.decoding and slot.length:
                # rows in pages BEFORE the first poisoned one are valid
                # KV for the clean token prefix: keep them indexed so
                # the victim's re-prefill is a prefix hit, not a redo
                k = 0
                for p in slot.pages:
                    if p in badset:
                        break
                    k += 1
                rows = min(k * eng.page_size, slot.length,
                           len(req.prompt) + len(req.tokens))
                if rows > 0:
                    salvaged_pages += eng.prefix.insert(
                        req.seq[:rows],
                        slot.pages[:kv_cache.pages_for(rows,
                                                       eng.page_size)])
            if eng.prefix is not None:
                eng.allocator.release(slot.pages)
            else:
                eng.allocator.free(slot.pages)
            eng.block_tables[sid, :] = -1
            slot.req, slot.pages, slot.length = None, [], 0
            slot.seq, slot.dense, slot.pf_pos, slot.n_prefix = (
                None, None, 0, 0)
            eng.quarantine_slot(sid)
            rids.append(req.rid)
            if req.done:  # a legit eos inside the clean prefix
                req.t_done = engine_mod._now()
                self.done.append(req)
            else:
                try:
                    eng.requeue(req)
                except ValueError:
                    req.cancelled = True
                    req.t_done = engine_mod._now()
                    self.done.append(req)
        # a victim that retired DURING the poisoned step: identified
        # through the pre-step ownership snapshot
        for req in eng.take_done():
            if not req.cancelled and badset & set(pre_owners.get(req.rid,
                                                                 ())):
                self._truncate(req)
                if not req.done:
                    rids.append(req.rid)
                    try:
                        eng.requeue(req)
                        continue
                    except ValueError:
                        req.cancelled = True
                        req.t_done = engine_mod._now()
            self.done.append(req)
        quarantined = eng.allocator.quarantine(badset)
        eng.audit()  # the zero-leak proof, immediately
        self.events.append(ServeEvent(
            "quarantine", t,
            {"pages": sorted(badset), "slots": [sid for sid, _ in victims],
             "rids": rids, "radix_dropped": dropped,
             "salvaged_pages": salvaged_pages,
             "newly_quarantined": quarantined},
            recovery_s=engine_mod._now() - t0))
        self._log(f"step {t}: quarantined pages {sorted(badset)}, "
                  f"rolled back rids {rids}")
        self._shed_unfit(t)
        if all(s.quarantined for s in eng.slots):
            # no decode lane left: the engine itself is the casualty
            self._recover_rebuild(t, kind="decode_nan",
                                  reason="every decode lane quarantined",
                                  count=False)
        self._maybe_degrade(t)

    def _recover_rebuild(self, t: int, *, kind: str, reason: str,
                         lost: int = 0, bad=(), truncate_all: bool = False,
                         pre_owners: dict | None = None,
                         count: bool = True) -> None:
        """Destructive-fault recovery: salvage every in-flight request,
        rebuild pools/engine on the (possibly shrunken) device set,
        re-admit the salvage, audit.  Re-admitted requests resume
        through the preemption path — bitwise the unfaulted
        continuation."""
        if count:
            self._bump(kind)
        t0 = engine_mod._now()
        if lost:
            if lost >= len(self.devices):
                raise RuntimeError(
                    f"step {t}: all {len(self.devices)} devices lost")
            self.devices = self.devices[:len(self.devices) - lost]
        salvaged = self._collect_salvage(bad=bad, truncate_all=truncate_all,
                                         pre_owners=pre_owners)
        self._build_engine()
        self._readmit(salvaged, t)
        self.engine.audit()
        self.rebuilds += 1
        self.events.append(ServeEvent(
            "rebuild", t,
            {"kind": kind, "reason": reason, "devices": len(self.devices),
             "pages": self.engine.num_pages, "salvaged": len(salvaged)},
            recovery_s=engine_mod._now() - t0))
        self._log(f"step {t}: rebuilt after {kind} ({reason}) on "
                  f"{len(self.devices)} devices, {self.engine.num_pages} "
                  f"pages, {len(salvaged)} requests migrated")
        if count:
            self._maybe_degrade(t)

    def _maybe_degrade(self, t: int) -> None:
        """After ``degrade_after`` faults implicating the kernel paths,
        flip attention/GEMM dispatch to the plain versions and rebuild.
        ``cfg`` is shallow-copied as in the reference (the port keeps no
        cache keyed on it)."""
        if self.degraded or self.degrade_after is None:
            return
        implicating = (self._fault_counts["decode_nan"]
                       + self._fault_counts["step_hang"])
        if implicating < self.degrade_after:
            return
        t0 = engine_mod._now()
        self._prev_impls = (layers.set_attention_impl("ref"),
                            layers.set_gemm_impl("ref"))
        self.degraded = True
        self.cfg = copy.copy(self.cfg)
        salvaged = self._collect_salvage()
        self._build_engine()
        self._readmit(salvaged, t)
        self.engine.audit()
        self.events.append(ServeEvent(
            "degrade", t,
            {"faults": implicating, "attention": "ref", "gemm": "ref"},
            recovery_s=engine_mod._now() - t0))
        self._log(f"step {t}: degraded to the plain versions after "
                  f"{implicating} kernel-implicating faults")

    def restore_dispatchers(self) -> None:
        """Undo a degrade's global dispatcher flips (tests and benches
        must not leak the plain versions into later runs)."""
        if self._prev_impls is not None:
            layers.set_attention_impl(self._prev_impls[0])
            layers.set_gemm_impl(self._prev_impls[1])
            self._prev_impls = None

    # -- driving ------------------------------------------------------------

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive supervised steps until every request has finished,
        been cancelled, or been shed.  Returns all terminal requests in
        rid order."""
        for _ in range(max_steps):
            if self.engine.pending == 0 and self.engine.active == 0:
                break
            self.step()
        self.done += self.engine.take_done()
        if self.engine.pending or self.engine.active:
            raise RuntimeError(
                f"supervised engine stalled: {self.engine.pending} queued, "
                f"{self.engine.active} active after {max_steps} steps")
        return sorted(self.done, key=lambda r: r.rid)

    def stats(self) -> dict:
        s = dict(self.engine.stats())
        counts = Counter(e.kind for e in self.events)
        s.update(
            supervisor_steps=self.steps,
            recoveries=self.recoveries,
            rebuilds=self.rebuilds,
            degraded=self.degraded,
            devices=len(self.devices),
            health_events=self.health.total_events,
            events={k: counts[k] for k in SERVE_EVENT_KINDS if counts[k]},
        )
        return s
