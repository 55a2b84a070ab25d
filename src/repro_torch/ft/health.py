"""Heartbeat-driven health detection shared by training and serving.

The port's copy of ``repro.ft.health`` (pure Python).  Hosts (pipeline
stages in training, the engine's step loop in serving) emit per-step liveness
**beats** carrying wall-clock step timings, a device enumeration, and
NaN/exception flags, and :class:`HeartbeatMonitor` turns them into typed
:class:`HealthEvent`s.  The fault plan still exists, but it now poisons
the *observations* (what a beat reports) instead of the supervisor's
control flow, so detection runs the same code path a real deployment
would.

Event kinds:

``miss``         a host went silent: no beat for longer than
                 ``miss_factor`` x its own EWMA inter-beat interval.
                 Emitted once per outage from :meth:`HeartbeatMonitor.
                 poll` (the watchdog tick); re-armed by the host's next
                 beat, which emits ``recovered``.
``recovered``    a previously-missing host beat again.
``device_loss``  a beat's device enumeration shrank vs the host's last
                 (or seeded) enumeration — detail carries how many
                 boards vanished.
``nan``          the beat flagged non-finite compute output (a poisoned
                 loss, a poisoned KV pool probe).
``error``        the beat carried an exception from the monitored step.
``slow``         the wrapped :class:`repro_torch.ft.straggler.StragglerMonitor`
                 flags persistent stragglers among the beating hosts;
                 detail carries the relative-rate map the re-cut DP
                 consumes.  Emitted on every beat while the condition
                 persists (consumers own the cooldown — the monitor is
                 a detector, not a policy).

Miss detection is deliberately *relative*: a fixed timeout would need
per-deployment tuning (a 0.6 B model steps in milliseconds, a 70 B in
seconds), while ``miss_factor`` x the learned interval adapts per host
and survives re-jits because beats during compilation stretch the EWMA
before the watchdog arms (``min_beats``).
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.ft.straggler import Ewma, StragglerMonitor

__all__ = ["HEALTH_KINDS", "HealthEvent", "HeartbeatMonitor"]

HEALTH_KINDS = ("miss", "recovered", "device_loss", "nan", "error", "slow")


@dataclasses.dataclass(frozen=True)
class HealthEvent:
    kind: str
    host: int
    step: int  # the host's own step counter at its last beat
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in HEALTH_KINDS:
            raise ValueError(f"unknown health event kind {self.kind!r} "
                             f"(one of {HEALTH_KINDS})")


class HeartbeatMonitor:
    """Per-host liveness tracker: beats in, :class:`HealthEvent`s out.

    ``beat()`` is the host-side report (returns the events the beat
    itself implies: nan/error/device_loss/slow/recovered); ``poll()``
    is the supervisor-side watchdog tick (returns ``miss`` events for
    hosts that have gone silent).  Both take an explicit ``now`` so
    tests and hang-recovery can drive virtual time; the default is
    ``time.monotonic`` — wall-clock (``time.time``) would let an NTP
    step masquerade as an outage.
    """

    def __init__(self, *, miss_factor: float = 4.0, alpha: float = 0.3,
                 min_beats: int = 3,
                 straggler: StragglerMonitor | None = None):
        if miss_factor <= 1.0:
            raise ValueError(
                f"miss_factor must be > 1 (a host is only missing once "
                f"it is LATE), got {miss_factor}")
        self.miss_factor = miss_factor
        self.alpha = alpha
        self.min_beats = max(1, min_beats)
        self.straggler = straggler or StragglerMonitor()
        self._interval: dict[int, Ewma] = {}  # host -> inter-beat EWMA
        self._last: dict[int, tuple[float, int]] = {}  # host -> (t, step)
        self._missing: set[int] = set()
        self._devices: dict[int, int] = {}  # host -> last enumeration size
        self.total_events = 0

    # -- host side ----------------------------------------------------------

    def expect_devices(self, host: int, devices: int) -> None:
        """Seed the device-enumeration baseline so a loss BEFORE the
        host's second beat is still a shrink, not a first sighting."""
        self._devices[host] = int(devices)

    def beat(self, host: int, step: int, *, now: float | None = None,
             step_s: float | None = None, devices: int | None = None,
             nan: bool = False, error: str | None = None
             ) -> list[HealthEvent]:
        """One liveness report from ``host`` at its step ``step``."""
        if now is None:
            now = time.monotonic()
        events: list[HealthEvent] = []
        if host in self._missing:
            self._missing.discard(host)
            events.append(HealthEvent("recovered", host, step))
        prev = self._last.get(host)
        if prev is not None:
            ewma = self._interval.setdefault(host, Ewma(alpha=self.alpha))
            ewma.update(max(now - prev[0], 0.0))
        self._last[host] = (now, step)
        if step_s is not None:
            self.straggler.record(host, step_s)
        if nan:
            events.append(HealthEvent("nan", host, step))
        if error is not None:
            events.append(HealthEvent("error", host, step,
                                      {"error": error}))
        if devices is not None:
            old = self._devices.get(host)
            if old is not None and devices < old:
                events.append(HealthEvent(
                    "device_loss", host, step,
                    {"lost": old - devices, "before": old,
                     "after": devices}))
            self._devices[host] = devices
        if step_s is not None:
            rep = self.straggler.report()
            if rep.stragglers:
                events.append(HealthEvent(
                    "slow", host, step,
                    {"stragglers": rep.stragglers, "rates": rep.rates}))
        self.total_events += len(events)
        return events

    # -- supervisor side ----------------------------------------------------

    def poll(self, now: float | None = None) -> list[HealthEvent]:
        """Watchdog tick: flag hosts whose silence exceeds
        ``miss_factor`` x their learned inter-beat interval.  One
        ``miss`` per outage — a flagged host stays flagged (no event
        spam) until its next beat re-arms it with ``recovered``."""
        if now is None:
            now = time.monotonic()
        events: list[HealthEvent] = []
        for host, (t_last, step) in self._last.items():
            if host in self._missing:
                continue
            ewma = self._interval.get(host)
            if ewma is None or ewma.count < self.min_beats:
                continue  # not enough history to call anyone late
            deadline = self.miss_factor * ewma.value
            overdue = now - t_last
            if overdue > deadline:
                self._missing.add(host)
                events.append(HealthEvent(
                    "miss", host, step,
                    {"overdue_s": overdue, "deadline_s": deadline}))
        self.total_events += len(events)
        return events

    @property
    def missing(self) -> list[int]:
        return sorted(self._missing)

    def reset(self) -> None:
        """Forget all history — call after a reconfiguration: old
        intervals describe the old topology, and the new device
        enumeration must not read as a (second) loss."""
        self._interval.clear()
        self._last.clear()
        self._missing.clear()
        self._devices.clear()
        self.straggler.reset()
