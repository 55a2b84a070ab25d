"""A serving cell: the program's ``ServingEngine`` driven as a closed loop.

Set-up makes the weights from the seed, builds the engine with every knob
given explicitly (and no tuning table installed), prefills the mix's
documents into the prefix cache, starts every client and runs
``warm_steps`` engine steps of the cell's own traffic, so that every shape
the window uses has run.  The window then steps the engine for
``seconds``; each client sends its next request as soon as the last one
has its final token.  A traced run puts ``torch.profiler`` over the last
``trace_seconds`` of the window and reduces its events in memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from bench.harness import model, trace
from bench.harness.traffic import Item, Traffic


def pages_for(n: int, page: int) -> int:
    return -(-n // page)


@dataclasses.dataclass
class Served:
    """One request as the benchmark sent it: ``n`` prompt tokens, of which
    its document shares the first ``m``, and the engine's request.
    ``t_sent`` is when its client sent it and ``times`` when each of its
    tokens reached the client: the end of the engine step that produced
    it, on the benchmark's clock (the engine stamps a first token before
    the device has computed it)."""
    item: Item
    req: object
    client: int
    n: int
    m: int
    t_sent: float
    times: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.times) >= self.item.max_new


def engine_knobs(c: dict, mix: dict, traffic: Traffic) -> dict:
    """Every knob of the engine, from the configuration and the mix.  The
    pool takes the configuration's ``engine.pool_gib`` of the card, as a
    deployment gives its K/V pool the memory that weights and work leave;
    where documents, running requests and finished sequences outgrow it,
    admission waits and the prefix cache evicts its least recently used
    pages."""
    e = c["engine"]
    page = int(e["page_size"])
    return dict(max_slots=int(mix["max_slots"]),
                max_len=pages_for(traffic.max_prompt + traffic.max_answer, page) * page,
                page_size=page, pool_bytes=int(float(e["pool_gib"]) * 2 ** 30),
                prefill_chunk=int(e["prefill_chunk"]), kv_dtype=e["kv_dtype"],
                prefix_cache=bool(e["prefix_cache"]), aging_s=float(e["aging_s"]),
                prefill_budget=None, slo_ms=None, dtype=model.DTYPES[c["dtype"]])


class ClosedLoop:
    def __init__(self, engine, traffic: Traffic, clients: int):
        self.engine, self.traffic, self.clients = engine, traffic, clients
        self.records: list[Served] = []
        self.live: dict[int, Served] = {}
        self.sent = 0
        self.spans = False  # host spans for the profiler, in a traced sub-window

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def submit(self, client: int) -> None:
        item = self.traffic.item(self.sent)
        self.sent += 1
        prompt = self.traffic.prompt(item)
        t_sent = time.monotonic()
        with self._span("bench.submit"):
            req = self.engine.submit(prompt, item.max_new)
        rec = Served(item, req, client, len(prompt), self.traffic.shared_len(item), t_sent)
        self.records.append(rec)
        self.live[client] = rec

    def start(self) -> None:
        for client in range(self.clients):
            self.submit(client)

    def step(self) -> None:
        with self._span("bench.step"):
            self.engine.step()
        now = time.monotonic()
        for client, rec in list(self.live.items()):
            rec.times += [now] * (len(rec.req.tokens) - len(rec.times))
            if rec.done:
                self.submit(client)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    stats0: dict
    stats1: dict
    trace: object = None  # trace.Summary of the traced sub-window


class Cell:
    """Set-up of one cell: weights, engine, documents, clients, warm-up and,
    for a traced run, the profiler's first start."""

    def __init__(self, c: dict, mix: dict, seed: int, device, weights_buffer=None,
                 traced: bool = False):
        from repro_torch.models.layers import set_tuning
        from repro_torch.serve.engine import ServingEngine

        self.c, self.mix, self.seed, self.device = c, mix, seed, device
        self.phases = {}
        mark = time.monotonic()

        def phase(name):
            nonlocal mark
            sync(device)
            t = time.monotonic()
            self.phases[name] = t - mark
            mark = t

        self.ref = model.reference(c)
        self.layout = self.ref.layout(c)
        self.cfg = model.port_config(c)
        self.weights, self.buffer = model.make_weights(c, self.layout, seed, device,
                                                       weights_buffer)
        phase("weights")
        self.traffic = Traffic(mix, c["vocab_size"], seed)
        self.knobs = engine_knobs(c, mix, self.traffic)
        set_tuning(None)  # the knobs above, not a measured table, decide
        self.engine = ServingEngine(self.weights, self.cfg, **self.knobs)
        phase("traffic_and_engine")
        with torch.no_grad():
            for doc in self.traffic.docs:
                self.engine.submit(doc, 1)
            self.engine.run()
        phase("documents")
        self.loop = ClosedLoop(self.engine, self.traffic, int(mix["clients"]))
        self.loop.start()
        for _ in range(int(mix["warm_steps"])):
            self.loop.step()
        phase("warm_steps")
        if traced:
            trace.warm(device)
            phase("profiler")

    def measure(self, seconds: float, traced: bool) -> Window:
        """Step the engine for ``seconds``; with ``traced``, profile the last
        ``trace_seconds`` of them."""
        loop, now = self.loop, time.monotonic
        trace_s = float(self.mix["trace_seconds"]) if traced else 0.0
        t0 = now()
        stats0 = self.engine.stats()
        while now() - t0 < seconds - trace_s:
            loop.step()
        summary = None
        if traced:
            summary = trace.profile_steps(loop, self.device, trace_s, now)
        sync(self.device)
        t1 = now()
        return Window(t0, t1, stats0, self.engine.stats(), summary)

    def release_engine(self) -> None:
        """Free the program's state (pools, caches), keeping the weights and
        the finished requests' tokens."""
        self.loop.engine = None
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def finished_in(records, t0: float, t1: float) -> list:
    return [r for r in records if r.done and t0 <= r.times[-1] <= t1]


def sample(records, seed: int, served_tokens: int, max_requests: int) -> list:
    """The finished requests to check: the one with the most served tokens
    (ties: the longest prompt), then others drawn from ``seed`` until the
    sample serves ``served_tokens`` tokens or holds ``max_requests``."""
    if not records:
        return []
    first = max(records, key=lambda r: (len(r.times), r.n, -r.item.index))
    rest = [r for r in records if r is not first]
    order = np.random.default_rng([seed % 2 ** 64, 11]).permutation(len(rest))
    out, total = [first], len(first.req.tokens)
    for i in order:
        if total >= served_tokens or len(out) >= max_requests:
            break
        out.append(rest[i])
        total += len(rest[i].req.tokens)
    return out


def logit_gaps(ref, c: dict, weights, rec: Served, device, control: bool = False):
    """For each token served to ``rec``, at its position: how far the
    judged token's logit lies below the float32 reference's best.  The
    judged tokens are the served ones; with ``control``, those that the
    reference computed at TF32 puts first at the same positions (the
    control in the program's place)."""
    from bench.reference._plain import precision

    served = list(rec.req.tokens)
    seq = np.concatenate([np.asarray(rec.req.prompt, np.int64),
                          np.asarray(served[:-1], np.int64)])
    toks = torch.from_numpy(seq).to(device)
    with precision("f32"):
        logits = ref.score(weights, c, toks, rec.n - 1)
    if control:
        with precision("tf32"):
            pick = ref.score(weights, c, toks, rec.n - 1).argmax(dim=-1)
    else:
        pick = torch.tensor(served, device=device)
    g = logits.max(dim=-1).values - logits.gather(1, pick[:, None])[:, 0]
    return torch.where(torch.isfinite(g), g, torch.full_like(g, float("inf"))).cpu().numpy()
