"""Fault-tolerant elastic training supervisor (PyTorch port of
``repro.ft.supervisor``).

The port has every *piece* of the paper's reconfigurability story —
straggler detection (``ft.straggler``), rate-weighted stage re-cutting
(``core.scheduler.recut_boundaries``), cheap uneven cuts at runtime
(``dist.pipeline.pad_pipeline_params``), elastic mesh reformation +
placed restore (``ft.elastic``), and async atomic checkpoints
(``ft.checkpoint``).  :class:`TrainSupervisor` closes the loop:

    step -> per-stage heartbeats -> HeartbeatMonitor -> HealthEvents
         -> "slow"?         re-cut boundaries with the rate-weighted
            DP, re-pad the LIVE state (pure gathers, no checkpoint
            round-trip), rebuild the step, continue — zero steps lost
         -> "device_loss"?  reform the mesh from the survivors, restore
            the latest checkpoint placed onto the new topology,
            recompute the batch schedule from the restored step,
            resume — at most ``ckpt_every`` steps lost
         -> "nan"?          roll back to the last checkpoint and SKIP
            the poisoned batch on replay
         -> checkpoint write died?  the atomic-rename design means
            nothing on disk is corrupt: sweep the torn .tmp and retry

Detection is observation-driven: after each step the supervisor emits one
heartbeat per pipeline stage into a :class:`repro_torch.ft.health.HeartbeatMonitor`
— carrying the stage's service time, the step's device enumeration and a
loss-finiteness flag — and reacts to the typed ``HealthEvent``s that come
back.  The fault plan poisons what the beats REPORT
(``FaultPlan.devices_visible`` shrinks the enumeration, ``nan_at``
poisons the loss); ``ckpt_crash`` arms a write-path hook, detected by the
save exception and recorded as a ``ckpt_retry`` event.

Checkpoints are written in the CANONICAL (unpadded) layer layout, so a
restore can target any later boundary vector or stage count.  Per-stage
service times are modelled as the measured lockstep step time apportioned
by the planner's per-stage cost shares, with injected slowdowns both
recorded into the monitor and *slept*, so recovery metrics are real
wall-clock quantities.  The clock is read through this module's ``time``
binding (``perf_counter``, ``monotonic``, ``sleep``), so a test can drive
it with a fake clock.

Data replay is exact: batches are a pure function of (seed, data index),
the supervisor tracks skipped indices, so a run recovered from step N
consumes exactly the batches the fault-free run would.

Where the port differs: the fresh state comes from ``init_fn`` (default:
``train.step.init_state`` with a ``torch.Generator`` seeded with
``seed`` on the first device), not from a PRNG key — a test passes the
reference's params through ``repro_torch.convert`` there.  The restore
template is a ``meta`` copy of the first state's structure, so it holds
no second state.  The
default devices are the CUDA devices torch sees; a device may be listed
several times (one card playing four pipeline stages), and stages on
distinct devices are refused by ``make_pipeline_train_step`` (ROADMAP.md
item 16).  There is no jit: one discarded step after each (re)build keeps
first-launch time out of the monitor's samples, as the reference's
warm-up does for compilation.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist.sharding import Mesh, place, stage_devices
from repro_torch.ft import checkpoint as ckpt_mod
from repro_torch.ft.elastic import make_mesh_for, rescale, state_shardings
from repro_torch.ft.faults import one_shot_write_fault
from repro_torch.ft.health import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.launch.mesh import cuda_devices
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    init_state,
    make_pipeline_train_step,
    make_train_step,
    pad_pipeline_state,
    repad_pipeline_state,
    unpad_pipeline_state,
)
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class RecoveryEvent:
    """One supervisor reaction, with its real cost."""

    kind: str  # "recut" | "rescale" | "rollback" | "ckpt_retry"
    step: int  # opt step at which the reaction happened
    steps_lost: int = 0  # opt steps re-run because of the fault
    recovery_s: float = 0.0  # wall-clock from detection to resumed
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SupervisorResult:
    losses: list  # per-step loss of the final (recovered) trajectory
    step_times: list  # effective per-step seconds (faults included)
    events: list  # RecoveryEvents in order
    boundaries_history: list  # pipeline cut vectors over the run
    final_loss: float = float("nan")

    def events_of(self, kind: str) -> list:
        return [e for e in self.events if e.kind == kind]


class TrainSupervisor:
    """Closed-loop fault-tolerant trainer (see module docstring).

    ``strategy='pipeline'`` (the full story: per-stage monitoring and
    straggler-driven live re-cuts on a ``(1, stages)`` mesh, one stage
    per listed device) or any SPMD strategy (``fused``/...), where the
    checkpointed recovery paths still apply but re-cutting does not.

    ``init_fn()`` returns a fresh canonical (unpadded) train state; it is
    called at start and again by a rollback that finds no checkpoint.
    """

    def __init__(self, cfg, opt_cfg: AdamWConfig | None = None, *,
                 steps: int, seq: int = 32, batch: int = 8,
                 strategy: str = "pipeline", schedule: str = "1f1b",
                 microbatches: int = 0, grad_accum: int = 1,
                 ckpt_dir: str | None = None, ckpt_every: int = 0,
                 keep: int = 2, fault_plan=None, devices=None, data=None,
                 monitor: StragglerMonitor | None = None,
                 recut_cooldown: int | None = None,
                 dtype=torch.float32, seed: int = 0,
                 max_inject_sleep_s: float = 1.0, max_rollbacks: int = 8,
                 verbose: bool = False, init_fn=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg or AdamWConfig(lr=1e-3, warmup_steps=5,
                                              total_steps=steps)
        self.steps = steps
        self.seq, self.batch = seq, batch
        self.strategy, self.schedule = strategy, schedule
        self._mb_arg, self.grad_accum = microbatches, grad_accum
        self.plan = fault_plan
        self.devices = list(devices if devices is not None else cuda_devices())
        if not self.devices:
            raise ValueError("no devices to train on")
        self.data = data or SyntheticLM(cfg.vocab, seq, batch, seed=seed)
        self.monitor = monitor or StragglerMonitor(window=8, threshold=1.3,
                                                   min_samples=4)
        # detection runs through heartbeats: each stage beats once per
        # step and the monitor's typed events drive the handlers below
        self.health = HeartbeatMonitor(straggler=self.monitor)
        self.recut_cooldown = (recut_cooldown if recut_cooldown is not None
                               else self.monitor.min_samples)
        self.dtype, self.seed = dtype, seed
        self.max_inject_sleep_s = max_inject_sleep_s
        self.max_rollbacks = max_rollbacks
        self.verbose = verbose
        self._init_fn = init_fn  # None: _fresh_state (no bound method: no cycle)

        self.ckpt = (ckpt_mod.AsyncCheckpointer(ckpt_dir, keep=keep)
                     if ckpt_dir else None)
        self.ckpt_every = ckpt_every
        fresh = (self._init_fn or self._fresh_state)()
        # canonical (unpadded) state template for topology-free restore:
        # meta tensors, structure only
        self._like = tree_map(lambda x: x.to("meta"), fresh)
        self.events: list[RecoveryEvent] = []
        self.boundaries = None
        self.boundaries_history: list = []
        self.skipped: set[int] = set()  # poisoned data indices
        self._losses: dict[int, float] = {}
        self._times: dict[int, float] = {}
        self._recut_ready = 0
        self._unit_costs = None
        self._setup(canonical=fresh)

    # -- build / rebuild ----------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[supervisor] {msg}", flush=True)

    def _fresh_state(self):
        dev = self.devices[0]
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        return init_state(self.cfg, generator=gen, dtype=self.dtype, device=dev)

    def _mesh_for(self, devices) -> Mesh:
        if self.strategy == "pipeline":
            return Mesh(np.asarray(devices, dtype=object).reshape(1, len(devices)),
                        ("data", "model"))
        return make_mesh_for(devices)

    def _batch(self, data_index: int) -> dict:
        return {k: torch.from_numpy(v).long().to(self.device)
                for k, v in self.data.batch(data_index).items()}

    def _setup(self, canonical=None, padded=None) -> None:
        """(Re)build mesh, step function, specs and state for the CURRENT
        device set + boundaries.  ``canonical`` installs a restored
        unpadded state; ``padded`` installs an already-padded live state
        (the re-cut path); neither -> fresh init."""
        cfg = self.cfg
        if self.strategy == "pipeline":
            from repro_torch.core.autotune import tune_microbatches
            from repro_torch.core.graph import config_graph
            from repro_torch.core.partition import layer_costs, stage_costs
            from repro_torch.core.placement import pipeline_boundaries
            from repro_torch.dist.pipeline import pipeline_units

            self.stages = len(self.devices)
            units = pipeline_units(cfg)
            if self.stages > units:
                raise ValueError(
                    f"{self.stages} devices > {units} cut units; shrink the "
                    "device set or deepen the model")
            if self.boundaries is None:
                self.boundaries = pipeline_boundaries(cfg, self.seq,
                                                      self.stages)
            self.microbatches = self._mb_arg or tune_microbatches(
                self.stages, self.batch, self.schedule)
            if self.batch % self.microbatches:
                raise ValueError(f"batch {self.batch} % microbatches "
                                 f"{self.microbatches} != 0")
            self.mesh = self._mesh_for(self.devices)
            self.step_fn = make_pipeline_train_step(
                cfg, self.opt_cfg, self.mesh,
                num_microbatches=self.microbatches,
                boundaries=self.boundaries, schedule=self.schedule,
            )
            if padded is None:
                if canonical is None:
                    canonical = (self._init_fn or self._fresh_state)()
                padded = pad_pipeline_state(canonical, cfg, self.boundaries)
            state = padded
            if self._unit_costs is None:
                self._unit_costs = layer_costs(config_graph(cfg, self.seq))
            if len(self._unit_costs) == self.boundaries[-1]:
                costs = stage_costs(self._unit_costs, self.boundaries)
            else:  # hybrid cut units (groups): shares by unit count
                b = self.boundaries
                costs = [float(b[k + 1] - b[k]) for k in range(self.stages)]
            total = sum(costs) or 1.0
            self._stage_shares = tuple(c / total for c in costs)
            self.boundaries_history.append(tuple(self.boundaries))
            self.device = stage_devices(self.mesh)[0]
        else:
            self.stages = 1
            self.mesh = self._mesh_for(self.devices)
            self.step_fn = make_train_step(cfg, self.opt_cfg,
                                           grad_accum=self.grad_accum)
            state = canonical if canonical is not None else (self._init_fn or self._fresh_state)()
            self._stage_shares = (1.0,)
            self.device = self.mesh.distinct_devices()[0]

        self.specs = state_shardings(state, self.mesh, self.strategy)
        self.state = place(state, self.specs, self.mesh)
        # one discarded step: first launches and the GEMM heuristics' first
        # calls must not reach the monitor as a (spurious) straggler; the
        # step returns new tensors, so self.state is untouched
        _, warm = self.step_fn(self.state, self._batch(0))
        float(warm["loss"])
        self._reset_health()

    def _reset_health(self) -> None:
        """Post-reconfiguration amnesia: stale intervals/timings must not
        describe the new plan, and the shrunken device enumeration must
        not read as a SECOND loss on the next beat."""
        self.health.reset()
        self.health.expect_devices(0, len(self.devices))

    def _install_state(self, canonical) -> None:
        """Pad (if pipelined) + place a canonical state without rebuilding
        the step function (topology unchanged)."""
        if self.strategy == "pipeline":
            canonical = pad_pipeline_state(canonical, self.cfg,
                                           self.boundaries)
        self.state = place(canonical, self.specs, self.mesh)

    # -- checkpointing ------------------------------------------------------

    def _canonical_state(self):
        if self.strategy == "pipeline":
            return unpad_pipeline_state(self.state, self.cfg,
                                        self.boundaries)
        return self.state

    def _save(self, step: int) -> None:
        if self.ckpt is None:
            return
        st = self._canonical_state()
        try:
            self.ckpt.save(st, step)
        except Exception as e:
            # a previous background write died; atomic rename means the
            # on-disk latest is still intact — sweep the torn .tmp,
            # record it, and retry this save
            swept = ckpt_mod.sweep_tmp(self.ckpt.root)
            self.events.append(RecoveryEvent(
                "ckpt_retry", step,
                detail={"error": repr(e), "swept": swept}))
            self._log(f"checkpoint write failed ({e!r}); swept {swept}, "
                      "retrying")
            self.ckpt.save(st, step)

    def _load_latest(self):
        """(canonical_state, step) from the newest complete checkpoint,
        placed for the current device set, or None.  A pending failed
        write surfaces here and is recorded — it cannot have produced a
        corrupt checkpoint."""
        if self.ckpt is None:
            return None
        try:
            self.ckpt.wait()
        except Exception as e:
            ckpt_mod.sweep_tmp(self.ckpt.root)
            self._log(f"pending checkpoint write had failed: {e!r}")
        step = ckpt_mod.latest_step(self.ckpt.root)
        if step is None:
            return None
        state = rescale(os.path.join(self.ckpt.root, f"step_{step}"), self._like,
                        self._mesh_for(self.devices), self.strategy)
        return state, step

    # -- fault handling -----------------------------------------------------

    def _handle_kill(self, lost: int, t: int) -> int:
        """Device loss (a ``device_loss`` HealthEvent): reform the mesh
        from the survivors, restore the latest checkpoint placed onto
        it, resume from its step."""
        t0 = time.perf_counter()
        if len(self.devices) - lost < 1:
            raise RuntimeError("device loss removed the last device")
        before = len(self.devices)
        self.devices = self.devices[: before - lost]
        # the dead topology's state and step go before the restore lands
        self.state = None
        loaded = self._load_latest()
        canonical, rstep = loaded if loaded else (None, 0)
        self.boundaries = None  # re-cut for the shrunken stage count
        self._setup(canonical=canonical)
        self.events.append(RecoveryEvent(
            "rescale", t, steps_lost=t - rstep,
            recovery_s=time.perf_counter() - t0,
            detail={"devices": f"{before}->{len(self.devices)}",
                    "restored_step": rstep, "stages": self.stages,
                    "boundaries": tuple(self.boundaries or ())}))
        self._log(f"device loss at step {t}: {before}->{len(self.devices)} "
                  f"devices, resumed from step {rstep}")
        return rstep

    def _handle_rollback(self, t: int, data_index: int) -> int:
        """Non-finite loss: back to the last checkpoint, skip the batch."""
        t0 = time.perf_counter()
        self.skipped.add(data_index)
        self.state = None  # replaced by the checkpoint or a fresh init
        loaded = self._load_latest()
        if loaded:
            canonical, rstep = loaded
            self._install_state(canonical)
        else:  # no checkpoint yet: restart from initialization
            rstep = 0
            self._setup()
        self._reset_health()
        self.events.append(RecoveryEvent(
            "rollback", t, steps_lost=t - rstep,
            recovery_s=time.perf_counter() - t0,
            detail={"skipped_data_index": data_index,
                    "restored_step": rstep}))
        self._log(f"non-finite loss at step {t}: rolled back to {rstep}, "
                  f"skipping batch {data_index}")
        return rstep

    def _maybe_recut(self, t: int, stragglers: list, rates: dict) -> None:
        """Persistent straggler (a ``slow`` HealthEvent) -> rate-weighted
        DP re-cut of the LIVE pipeline (no rollback: the re-pad is a
        pure gather).  ``stragglers``/``rates`` come from the event's
        detail — the monitor's verdict over the beats it has seen."""
        if self.strategy != "pipeline" or self.stages < 2:
            return
        if t < self._recut_ready:
            return
        from repro_torch.core.scheduler import recut_boundaries

        t0 = time.perf_counter()
        new = tuple(recut_boundaries(self.cfg, self.seq, self.stages,
                                     rates))
        old = tuple(self.boundaries)
        if new == old:
            # plan already compensates the observed rates (or the rates
            # are still averaging in pre-fault history): check again
            # next step rather than thrash
            self._recut_ready = t + 1
            return
        live = repad_pipeline_state(self.state, self.cfg, old, new)
        self.state = None
        self.boundaries = new
        self._setup(padded=live)
        self._recut_ready = t + self.recut_cooldown
        self.events.append(RecoveryEvent(
            "recut", t, steps_lost=0,
            recovery_s=time.perf_counter() - t0,
            detail={"stragglers": stragglers,
                    "rates": {n: round(r, 3) for n, r in rates.items()},
                    "old": old, "new": new}))
        self._log(f"straggler(s) {stragglers} at step {t}: re-cut "
                  f"{old} -> {new}")

    def _observe(self, t: int, t_compute: float, loss: float) -> list:
        """Emit one heartbeat per pipeline stage for step ``t`` and
        return the monitor's HealthEvents.  The fault plan poisons the
        observations here — slowdown factors scale the reported service
        time, pending kills shrink the reported device enumeration, a
        poisoned batch shows up as a non-finite loss flag — and the
        monitor, not the plan, decides what they mean.

        Per-unit-work service time: a slow BOARD is slow regardless of
        how many layers it holds, so the beat carries t * factor —
        cut-imbalance never masquerades as a straggler."""
        now = time.monotonic()
        factors = self.plan.slowdowns_at(t) if self.plan else {}
        visible = (self.plan.devices_visible(self.devices, t)
                   if self.plan else self.devices)
        bad = not math.isfinite(loss)
        events = []
        for s in range(self.stages):
            events += self.health.beat(
                s, t, now=now,
                step_s=t_compute * factors.get(s, 1.0),
                # stage 0 is the coordinator's view of the cluster; the
                # loss is a collective output, so one stage flags it
                devices=len(visible) if s == 0 else None,
                nan=bad if s == 0 else False)
        return events

    def _inject_sleep(self, t: int, t_compute: float) -> float:
        """Sleep the wall-clock surcharge an active slowdown would cost
        the lockstep pipe, so recovery metrics stay real wall-clock
        quantities.  Returns the effective step seconds."""
        factors = self.plan.slowdowns_at(t) if self.plan else {}
        if not factors:
            return t_compute
        shares = self._stage_shares
        base = max(shares) * self.stages * t_compute
        slow = max(
            shares[s] * self.stages * t_compute * factors.get(s, 1.0)
            for s in range(self.stages)
        )
        extra = min(max(0.0, slow - base), self.max_inject_sleep_s)
        if extra > 0:
            time.sleep(extra)
        return t_compute + extra

    # -- the loop -----------------------------------------------------------

    def _data_index(self, t: int) -> int:
        d = t
        for s in sorted(self.skipped):
            if s <= d:
                d += 1
        return d

    def run(self) -> SupervisorResult:
        t = int(self.state["step"])
        if self.ckpt is not None and ckpt_mod.latest_step(self.ckpt.root) is None:
            self._save(t)  # step-0 anchor so the first rollback has a target
        rollbacks = 0
        while t < self.steps:
            if self.plan is not None and self.ckpt is not None:
                # write-path injection (detection is the save exception
                # itself, recorded as a ckpt_retry event in _save)
                cev = self.plan.take_ckpt_crash(t)
                if cev is not None:
                    n_leaves = len(leaves(self._like))
                    one_shot_write_fault(self.plan.crash_leaf_index(n_leaves))
                    self._log(f"armed checkpoint-write crash at step {t}")

            d_idx = self._data_index(t)
            batch = self._batch(d_idx)
            t0 = time.perf_counter()
            new_state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])  # waits for the step's result
            t_compute = time.perf_counter() - t0
            if self.plan is not None and self.plan.nan_at(d_idx):
                loss = float("nan")  # injected numerically-poisoned batch

            # observation, then reaction: the step's heartbeats report
            # what happened and the monitor's events say what it means
            events = self._observe(t, t_compute, loss)
            lost = sum(e.detail["lost"] for e in events
                       if e.kind == "device_loss")
            if lost:
                # the step's output ran on the pre-loss topology —
                # discard it and restore from the checkpoint
                del new_state, metrics
                t = self._handle_kill(lost, t)
                continue
            if any(e.kind == "nan" for e in events):
                rollbacks += 1
                if rollbacks > self.max_rollbacks:
                    raise RuntimeError(
                        f"{rollbacks} rollbacks: loss is persistently "
                        "non-finite, refusing to loop forever")
                del new_state, metrics
                t = self._handle_rollback(t, d_idx)
                continue

            self.state = new_state
            t_eff = self._inject_sleep(t, t_compute)
            self._losses[t] = loss
            self._times[t] = t_eff
            t += 1
            slow = [e for e in events if e.kind == "slow"]
            if slow:
                # the step's LAST slow event carries the freshest rates
                # (every stage's sample for this step is in by then)
                self._maybe_recut(t - 1, slow[-1].detail["stragglers"],
                                  slow[-1].detail["rates"])
            if (self.ckpt is not None and self.ckpt_every
                    and t % self.ckpt_every == 0):
                self._save(t)

        if self.ckpt is not None:
            try:
                self.ckpt.wait()
            except Exception as e:
                ckpt_mod.sweep_tmp(self.ckpt.root)
                self.events.append(RecoveryEvent(
                    "ckpt_retry", t, detail={"error": repr(e)}))
        losses = [self._losses[i] for i in range(self.steps)]
        times = [self._times[i] for i in range(self.steps)]
        return SupervisorResult(
            losses=losses, step_times=times, events=self.events,
            boundaries_history=self.boundaries_history,
            final_loss=losses[-1] if losses else float("nan"),
        )
