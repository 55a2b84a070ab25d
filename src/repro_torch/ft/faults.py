"""Deterministic fault injection for the fault-tolerant training loop.

PyTorch port of ``repro.ft.faults`` (pure Python): the same eight kinds,
the same strict grammar and the same seeded choices; ``one_shot_write_fault``
hooks the port's ``ft.checkpoint``.

A :class:`FaultPlan` is a seeded list of :class:`FaultEvent`s that a
supervisor consults every step (the reference's training supervisor for
the first four kinds, not ported yet), so a recovery run is exactly
reproducible — the point of the harness is to
*prove* the detect -> replan -> reshard -> resume loop, and a proof you
can't replay is not a proof.  Four fault kinds cover the taxonomy the
paper's reconfigurable cluster must survive:

``slowdown``    a pipeline stage runs ``factor``x slower starting at
                ``step`` (optionally for ``duration`` steps).  The
                supervisor scales the slow stage's recorded service
                time AND sleeps the extra wall-clock the lockstep pipe
                would lose, so both the StragglerMonitor input and the
                measured step time are faithful to a slow board.
``kill``        at ``step``, ``lose`` devices vanish from the visible
                device set before the step runs — the supervisor must
                reform the mesh from the survivors and restore the
                latest checkpoint re-sharded onto it.
``ckpt_crash``  the next async checkpoint write at/after ``step`` dies
                partway through its leaf files (via the
                ``ft.checkpoint.set_write_fault`` hook), leaving a torn
                ``.tmp`` dir — atomic rename means the previous
                checkpoint must survive intact.
``nan``         the batch at data index ``step`` is poisoned: its loss
                comes out non-finite.  The supervisor must roll back to
                the last checkpoint and skip that batch on replay.

``kill`` and ``ckpt_crash`` are one-shot (consumed when they fire);
``slowdown`` is a state over a step interval; ``nan`` is a property of
a *data index* (so the replay after rollback sees it again unless the
batch is skipped — which is exactly what the supervisor must do).

Four **serving** fault kinds extend the taxonomy to the inference tier
(consumed by :class:`repro_torch.serve.supervisor.ServeSupervisor`; all
one-shot, ``step`` counts supervisor steps):

``decode_nan``   a decode step poisons one slot's KV pages with
                 non-finite rows (``slot=-1``: first active slot) — the
                 supervisor's pool probe must find the poison, purge it
                 from the radix index, quarantine pages+slot, and
                 resume the victim from its last clean token.
``step_hang``    the engine step wedges for ``hang_s`` seconds — the
                 heartbeat watchdog must declare the miss and rebuild.
``device_loss``  ``lose`` boards vanish from the enumeration the
                 heartbeat reports — pools rebuild on the survivors.
``pool_corrupt`` the allocator's free list gains a page a live slot
                 still owns (``page=-1``: seeded choice of a live
                 page) — double-ownership that only
                 ``PageAllocator.audit()`` can see before it serves one
                 sequence's KV to another.
"""

from __future__ import annotations

import dataclasses
import random

from repro_torch.ft import checkpoint as _ckpt

__all__ = [
    "CheckpointWriteCrash",
    "FaultEvent",
    "FaultPlan",
    "one_shot_write_fault",
]


class CheckpointWriteCrash(RuntimeError):
    """Injected mid-write crash (stands in for the process dying)."""


def one_shot_write_fault(after_leaves: int = 1):
    """Install a ``ft.checkpoint`` write fault that raises
    :class:`CheckpointWriteCrash` after ``after_leaves`` leaf files have
    been written, then uninstalls itself (the next write succeeds, like
    a restarted saver would)."""

    def hook(i, name):
        if i + 1 >= after_leaves:
            _ckpt.set_write_fault(None)
            raise CheckpointWriteCrash(
                f"injected crash after leaf {i} ({name!r})"
            )

    _ckpt.set_write_fault(hook)
    return hook


_KINDS = ("slowdown", "kill", "ckpt_crash", "nan",
          "decode_nan", "step_hang", "device_loss", "pool_corrupt")

#: fields each kind accepts in the ``--fault-plan`` grammar — a field on
#: the wrong kind is a typo'd plan, and a typo'd fault plan silently
#: testing nothing is worse than a crash
_FIELDS = {
    "slowdown": ("step", "stage", "factor", "duration"),
    "kill": ("step", "lose"),
    "ckpt_crash": ("step",),
    "nan": ("step",),
    "decode_nan": ("step", "slot"),
    "step_hang": ("step", "hang_s"),
    "device_loss": ("step", "lose"),
    "pool_corrupt": ("step", "page"),
}
_FLOAT_FIELDS = ("factor", "hang_s")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    step: int  # first step active (data index for ``nan``)
    stage: int = 0  # slowdown: which pipeline stage / node
    factor: float = 1.0  # slowdown: service-time multiplier
    duration: int | None = None  # slowdown: steps active (None = forever)
    lose: int = 1  # kill / device_loss: devices removed
    slot: int = -1  # decode_nan: victim slot (-1 = first active)
    hang_s: float = 30.0  # step_hang: wedge duration (virtual seconds)
    page: int = -1  # pool_corrupt: victim page (-1 = seeded live choice)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.kind == "slowdown" and self.factor < 1.0:
            raise ValueError(f"slowdown factor must be >= 1, got "
                             f"{self.factor}")
        if self.kind in ("kill", "device_loss") and self.lose < 1:
            raise ValueError(f"{self.kind} must lose >= 1 devices, "
                             f"got {self.lose}")
        if self.kind == "step_hang" and self.hang_s <= 0:
            raise ValueError(f"step_hang hang_s must be > 0, "
                             f"got {self.hang_s}")

    def spec(self) -> str:
        parts = [f"step={self.step}"]
        if self.kind == "slowdown":
            parts += [f"stage={self.stage}", f"factor={self.factor:g}"]
            if self.duration is not None:
                parts.append(f"duration={self.duration}")
        if self.kind in ("kill", "device_loss"):
            parts.append(f"lose={self.lose}")
        if self.kind == "decode_nan" and self.slot != -1:
            parts.append(f"slot={self.slot}")
        if self.kind == "step_hang" and self.hang_s != 30.0:
            parts.append(f"hang_s={self.hang_s:g}")
        if self.kind == "pool_corrupt" and self.page != -1:
            parts.append(f"page={self.page}")
        return f"{self.kind}:" + ",".join(parts)


class FaultPlan:
    """Seeded schedule of fault events queried by the supervisor."""

    def __init__(self, events=(), seed: int = 0):
        self.events = tuple(events)
        self.seed = seed
        self._rng = random.Random(seed)
        self._fired: set[int] = set()  # indices of consumed one-shots

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``--fault-plan`` CLI syntax: ``;``-separated events,
        each ``kind:key=val,key=val`` — e.g.
        ``slowdown:step=6,stage=2,factor=3;kill:step=20,lose=1;nan:step=9``
        or ``device_loss:step=8,lose=1;decode_nan:step=14``.

        Parsing is strict so a typo'd plan fails loudly instead of
        silently injecting nothing: unknown kinds, fields a kind does
        not accept, non-numeric values and missing ``step`` all raise
        ``ValueError`` naming the offending piece.  ``parse`` and
        :meth:`spec` round-trip exactly.
        """
        events = []
        for item in spec.split(";"):
            item = item.strip()
            if not item:
                continue
            kind, _, rest = item.partition(":")
            kind = kind.strip()
            if kind not in _KINDS:
                raise ValueError(f"unknown fault kind {kind!r} in {item!r} "
                                 f"(one of {_KINDS})")
            allowed = _FIELDS[kind]
            kw: dict = {}
            for pair in filter(None, (p.strip() for p in rest.split(","))):
                k, eq, v = pair.partition("=")
                if not eq or k not in allowed:
                    raise ValueError(
                        f"bad fault field {pair!r} in {item!r} "
                        f"({kind} accepts {allowed})")
                try:
                    kw[k] = float(v) if k in _FLOAT_FIELDS else int(v)
                except ValueError:
                    raise ValueError(
                        f"non-numeric value in fault field {pair!r} "
                        f"of {item!r}") from None
            if "step" not in kw:
                raise ValueError(f"fault {item!r} is missing step=")
            events.append(FaultEvent(kind=kind, **kw))
        return cls(events, seed=seed)

    def spec(self) -> str:
        return ";".join(ev.spec() for ev in self.events)

    # -- queries (called by the supervisor) ---------------------------------

    def slowdowns_at(self, step: int) -> dict[int, float]:
        """Active per-stage slowdown factors at ``step`` (empty = clean).
        Overlapping slowdowns on one stage compound multiplicatively."""
        out: dict[int, float] = {}
        for ev in self.events:
            if ev.kind != "slowdown" or step < ev.step:
                continue
            if ev.duration is not None and step >= ev.step + ev.duration:
                continue
            out[ev.stage] = out.get(ev.stage, 1.0) * ev.factor
        return out

    def nan_at(self, data_index: int) -> bool:
        """Is the batch at ``data_index`` poisoned?  NOT one-shot: the
        same batch replayed after a rollback is just as poisoned, which
        is why the supervisor must skip it."""
        return any(
            ev.kind == "nan" and ev.step == data_index for ev in self.events
        )

    def take_kill(self, step: int) -> FaultEvent | None:
        """Consume a pending device-loss event due at/before ``step``."""
        return self.take("kill", step)

    def take_ckpt_crash(self, step: int) -> FaultEvent | None:
        """Consume a pending checkpoint-crash event due at/before
        ``step``; the caller installs :func:`one_shot_write_fault` so the
        NEXT checkpoint write dies partway (at a seeded leaf index, see
        :meth:`crash_leaf_index`)."""
        return self.take("ckpt_crash", step)

    def take(self, kind: str, step: int) -> FaultEvent | None:
        """Consume one pending one-shot event of ``kind`` due at/before
        ``step`` — the generic injector query the serving supervisor
        uses for its fault kinds."""
        for i, ev in enumerate(self.events):
            if i not in self._fired and ev.kind == kind and ev.step <= step:
                self._fired.add(i)
                return ev
        return None

    def devices_visible(self, devices, step: int,
                        kinds=("kill", "device_loss")) -> list:
        """The device enumeration a heartbeat at ``step`` would report:
        every pending kill/device_loss due by now drops its ``lose``
        trailing devices (consumed — a dead board stays dead).  This is
        the observation-side injection that replaced the supervisors'
        direct ``take_kill`` dispatch: the plan shrinks what the beat
        *sees*, and detection is the monitor comparing enumerations."""
        out = list(devices)
        for kind in kinds:
            while True:
                ev = self.take(kind, step)
                if ev is None:
                    break
                out = out[:max(0, len(out) - ev.lose)]
        return out

    def choose(self, options):
        """Seeded choice among ``options`` (e.g. which live page a
        ``pool_corrupt`` event doubles onto the free list) —
        deterministic per plan, varies with the seed."""
        if not options:
            raise ValueError("cannot choose from no options")
        return self._rng.choice(list(options))

    def crash_leaf_index(self, num_leaves: int) -> int:
        """Seeded choice of how many leaf files a ckpt_crash lets land
        before dying — deterministic per plan, varies with the seed so
        repeated runs probe different torn-write shapes."""
        return self._rng.randrange(1, max(num_leaves, 2))

    def reset(self) -> None:
        """Re-arm all one-shot events (fresh run of the same plan)."""
        self._fired.clear()
        self._rng = random.Random(self.seed)
