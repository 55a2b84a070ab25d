"""The port's fault-tolerant serving against the JAX reference, class by
class as ``tests/test_serve_ft.py``: the heartbeat monitor, the fault-plan
grammar, the pool audit and quarantine, the radix drop and the NaN probe,
the engine's fault surface, the monotonic clock and every
``ServeSupervisor`` case.  Each scenario runs in both packages on the same
numpy inputs and, for the engines, under one fake ``_now`` clock installed
in both: events, tokens, ``stats()`` and error messages must be equal
(the degrade event names the port's plain versions, ``"ref"``, where the
reference names ``"jnp"``).  Where NaN rows sit in the pools (``decode_nan``,
degrade) the reference runs its Pallas attention kernels in interpret
mode, as on its own device: its jnp paged reference gathers every page of
a block table, the unwritten tail page included, and 0 x NaN then spreads
the poison into the next K/V row; the Pallas kernel, and the port's paged
kernel and plain version that follow it, never read a dead page.  Then the port's own run is held to the
reference test's properties (bitwise resume against a fault-free run,
zero leaks).  Last, the port's deliberate differences: a device or kernel
launch error from the engine's step propagates, and a supervisor on the
CPU starts with one device.

Model: ``qwen3_0p6b.scaled_down(num_layers=2, d_model=64, vocab=256)`` in
f32, the reference's params carried over by ``convert.params_from_numpy``.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.ft import faults as jfaults  # noqa: E402
from repro.ft import health as jhealth  # noqa: E402
from repro.ft import straggler as jstrag  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro.serve import supervisor as jsup  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.ft import faults as tfaults  # noqa: E402
from repro_torch.ft import health as thealth  # noqa: E402
from repro_torch.ft import straggler as tstrag  # noqa: E402
from repro_torch.kernels._build import KernelLaunchError  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
from repro_torch.serve import supervisor as tsup  # noqa: E402

ENGINE_KW = dict(max_slots=2, max_len=128, page_size=8, prefill_chunk=8,
                 prefix_cache=True)
HEALTH = {"ref": (jhealth, jstrag), "port": (thealth, tstrag)}


@pytest.fixture(scope="module")
def model():
    small = dict(num_layers=2, d_model=64, vocab=256)
    cfg = get_config("qwen3_0p6b").scaled_down(**small)
    tcfg = t_get_config("qwen3_0p6b").scaled_down(**small)
    jp = jtf.init(jax.random.PRNGKey(0), cfg, jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return {"ref": (jp, cfg), "port": (tp, tcfg)}


MODS = {"ref": (jeng, jkv, jsup, jfaults), "port": (teng, tkv, tsup, tfaults)}


@contextlib.contextmanager
def _fake_clock(mod, start=0.0):
    """Install a clock ticking 1 ms per read as ``mod._now``."""
    ticks = [start]

    def clock():
        ticks[0] += 1e-3
        return ticks[0]

    prev, mod._now = mod._now, clock
    try:
        yield
    finally:
        mod._now = prev


def _reqs(vocab, seed, spec):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (n,)).astype(np.int32), m) for n, m in spec]


def _leak_check(eng):
    """Post-drain zero-leak proof: audit, drop the radix tree's pins,
    then every non-quarantined page must be back on the free list."""
    eng.audit()
    if eng.prefix is not None:
        eng.prefix.clear()
    assert eng.allocator.num_free == eng.num_pages - eng.allocator.num_quarantined


def _event(ev):
    detail = dict(ev.detail)
    if ev.kind == "degrade":  # the port's plain versions are "ref"
        detail = {k: ("ref" if v == "jnp" else v) for k, v in detail.items()}
    return ev.kind, ev.step, detail, ev.recovery_s


@contextlib.contextmanager
def _reference_kernels():
    """The reference's attention on its Pallas kernels (interpret mode).
    Its engine keeps jitted steps keyed on ``id(cfg)``, so a run under it
    takes a copy of the config (the reference's degrade does the same)."""
    prev = jlayers.set_attention_impl("pallas")
    try:
        yield
    finally:
        jlayers.set_attention_impl(prev)


def _supervise(model, side, reqs, engine_kw=ENGINE_KW, plan=None, seed=0,
               deadlines=None, ref_kernels=False, **kw):
    """One supervised run in package ``side`` under the fake clock (the
    reference on its Pallas kernels with ``ref_kernels``): returns
    (supervisor, {rid: (tokens, cancelled, done)}, stats, events)."""
    eng_mod, _, sup_mod, faults_mod = MODS[side]
    params, cfg = model[side]
    kernels = contextlib.nullcontext()
    if ref_kernels and side == "ref":
        kernels, cfg = _reference_kernels(), copy.copy(cfg)
    with _fake_clock(eng_mod), kernels:
        fp = faults_mod.FaultPlan.parse(plan, seed=seed) if plan else None
        sup = sup_mod.ServeSupervisor(params, cfg, engine_kw=engine_kw, fault_plan=fp,
                                      **kw)
        try:
            for i, (p, m) in enumerate(reqs):
                sup.submit(p, m, deadline_ms=(deadlines or {}).get(i))
            done = sup.run()
        finally:
            sup.restore_dispatchers()
        out = {r.rid: (list(r.tokens), r.cancelled, r.done) for r in done}
        return sup, out, sup.stats(), [_event(e) for e in sup.events]


def _both(model, reqs, **kw):
    """The same supervised run in both packages; everything observable
    must be equal.  Returns the port's (supervisor, done)."""
    runs = {side: _supervise(model, side, reqs, **kw) for side in ("ref", "port")}
    (_, jdone, jst, jev), (tsup_, tdone, tst, tev) = runs["ref"], runs["port"]
    assert tdone == jdone
    assert tst == jst
    assert tev == jev
    return tsup_, tdone


def _baseline(model, reqs, kw=ENGINE_KW):
    params, cfg = model["port"]
    eng = teng.ServingEngine(params, cfg, **kw)
    for p, m in reqs:
        eng.submit(p, m)
    return {r.rid: list(r.tokens) for r in eng.run()}


# ---------------------------------------------------------------------------
# heartbeat monitor
# ---------------------------------------------------------------------------


def _obs(events):
    return [(e.kind, e.host, e.step, e.detail) for e in events]


def _miss_once_then_recover(hm_mod, _):
    hm = hm_mod.HeartbeatMonitor(miss_factor=4.0, min_beats=3)
    out, t = [], 100.0
    for s in range(5):
        out.append(_obs(hm.beat(0, s, now=t)))
        t += 1.0
    last = t - 1.0
    for dt in (3.9, 4.1, 400.0):
        out.append(_obs(hm.poll(now=last + dt)))
    out.append(hm.missing)
    out.append(_obs(hm.beat(0, 9, now=last + 500.0)))
    return out + [hm.missing, hm.total_events]


def _min_beats_gate(hm_mod, _):
    hm = hm_mod.HeartbeatMonitor(miss_factor=2.0, min_beats=3)
    hm.beat(0, 0, now=1.0)
    hm.beat(0, 1, now=2.0)
    return [_obs(hm.poll(now=1e6))]


def _device_loss(hm_mod, _):
    hm = hm_mod.HeartbeatMonitor()
    hm.expect_devices(0, 4)
    return [_obs(hm.beat(0, s, now=float(s), devices=n))
            for s, n in enumerate((3, 3, 4, 2))] + [_obs(hm.beat(7, 0, now=4.0, devices=2))]


def _nan_and_error(hm_mod, _):
    hm = hm_mod.HeartbeatMonitor()
    return [_obs(hm.beat(0, 3, now=0.0, nan=True, error="RuntimeError: boom")),
            hm.total_events]


def _slow(hm_mod, strag_mod):
    hm = hm_mod.HeartbeatMonitor(
        straggler=strag_mod.StragglerMonitor(window=8, threshold=1.3, min_samples=2))
    t, out = 0.0, []
    for s in range(3):
        t += 1.0
        out.append(_obs(hm.beat(0, s, now=t, step_s=0.01)))
        t += 1.0
        out.append(_obs(hm.beat(1, s, now=t, step_s=0.05)))
    return out


def _reset(hm_mod, _):
    hm = hm_mod.HeartbeatMonitor(min_beats=1)
    for s in range(4):
        hm.beat(0, s, now=float(s), devices=4)
    out = [_obs(hm.poll(now=100.0))]
    hm.reset()
    return out + [hm.missing, _obs(hm.poll(now=1e6)), _obs(hm.beat(0, 0, now=0.0, devices=2))]


HEALTH_SCENARIOS = {"miss_once_then_recover": _miss_once_then_recover,
                    "min_beats_gate": _min_beats_gate, "device_loss": _device_loss,
                    "nan_and_error": _nan_and_error, "slow": _slow, "reset": _reset}


class TestHeartbeatMonitor:
    @pytest.mark.parametrize("name", list(HEALTH_SCENARIOS))
    def test_scenario_matches_reference(self, name):
        port = HEALTH_SCENARIOS[name](*HEALTH["port"])
        assert port == HEALTH_SCENARIOS[name](*HEALTH["ref"])
        if name == "miss_once_then_recover":
            assert port[6][0][0] == "miss" and port[5] == [] and port[7] == []
            assert port[8] == [0] and port[9][0][0] == "recovered" and port[10] == []
        if name == "device_loss":
            assert port[0] == [("device_loss", 0, 0, {"lost": 1, "before": 4, "after": 3})]
            assert port[4] == []  # an unseeded host's first enumeration
        if name == "slow":
            assert port[-1][0][0] == "slow" and port[-1][0][3]["stragglers"] == [1]

    def test_guards_match_reference(self):
        for hm_mod, _ in HEALTH.values():
            with pytest.raises(ValueError, match="miss_factor"):
                hm_mod.HeartbeatMonitor(miss_factor=1.0)
            with pytest.raises(ValueError, match="unknown health event"):
                hm_mod.HealthEvent("melted", 0, 0)

    def test_ewma_and_straggler_report_match_reference(self):
        rng = np.random.default_rng(0)
        xs = rng.random(20).tolist()
        outs = []
        for _, strag in HEALTH.values():
            e = strag.Ewma(alpha=0.3)
            mon = strag.StragglerMonitor(window=8, threshold=1.3, min_samples=4)
            for i, x in enumerate(xs):
                e.update(x)
                mon.record(i % 4, x * (3.0 if i % 4 == 2 else 1.0))
            rep = mon.report()
            outs.append((e.value, e.count, rep.rates, rep.stragglers))
        assert outs[0] == outs[1] and outs[1][3] == [2]


# ---------------------------------------------------------------------------
# fault-plan grammar
# ---------------------------------------------------------------------------

SPEC = ("device_loss:step=8,lose=1;decode_nan:step=18;step_hang:step=4,hang_s=2.5;"
        "pool_corrupt:step=9,page=3;decode_nan:step=30,slot=1;"
        "slowdown:step=6,stage=2,factor=3,duration=4;kill:step=20,lose=2;nan:step=9;"
        "ckpt_crash:step=3")
BAD_SPECS = ["decode_naan:step=1", "decode_nan:step=1,lose=2", "step_hang:step=1,hang_s=soon",
             "pool_corrupt:page=3", "step_hang:step=1,hang_s=0", "device_loss:step=1,lose=0",
             "slowdown:step=1,factor=0.5", "kill:step=-1"]


class TestFaultPlanGrammar:
    def test_every_kind_round_trips_as_the_reference(self):
        plan = tfaults.FaultPlan.parse(SPEC, seed=7)
        assert plan.spec() == SPEC == jfaults.FaultPlan.parse(SPEC, seed=7).spec()
        assert tfaults.FaultPlan.parse(plan.spec(), seed=7).events == plan.events

    @pytest.mark.parametrize("bad", BAD_SPECS)
    def test_parse_rejects_typos_with_the_reference_message(self, bad):
        msgs = []
        for mod in (jfaults, tfaults):
            with pytest.raises(ValueError) as exc:
                mod.FaultPlan.parse(bad)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]

    def test_round_trip_property(self):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings
        from hypothesis import strategies as st

        step = st.integers(0, 500)
        event = st.one_of(
            st.builds(dict, kind=st.just("nan"), step=step),
            st.builds(dict, kind=st.just("kill"), step=step, lose=st.integers(1, 8)),
            st.builds(dict, kind=st.just("device_loss"), step=step, lose=st.integers(1, 8)),
            st.builds(dict, kind=st.just("decode_nan"), step=step, slot=st.integers(-1, 7)),
            st.builds(dict, kind=st.just("step_hang"), step=step,
                      hang_s=st.floats(0.5, 120.0).map(lambda x: round(x, 3))),
            st.builds(dict, kind=st.just("pool_corrupt"), step=step,
                      page=st.integers(-1, 63)),
            st.builds(dict, kind=st.just("slowdown"), step=step, stage=st.integers(0, 7),
                      factor=st.floats(1.0, 16.0).map(lambda x: round(x, 3)),
                      duration=st.one_of(st.none(), st.integers(1, 50))),
        )

        @given(st.lists(event, max_size=6))
        @settings(max_examples=60, deadline=None)
        def round_trips(evs):
            plan = tfaults.FaultPlan([tfaults.FaultEvent(**e) for e in evs], seed=3)
            ref = jfaults.FaultPlan([jfaults.FaultEvent(**e) for e in evs], seed=3)
            assert plan.spec() == ref.spec()
            assert tfaults.FaultPlan.parse(plan.spec(), seed=3).events == plan.events

        round_trips()

    def test_queries_match_reference(self):
        """take (one-shot, due-gated), reset, devices_visible (consumed,
        dead stays dead), the slowdown and nan queries, and the seeded
        choose / crash_leaf_index draws."""
        spec = ("decode_nan:step=5;decode_nan:step=9;device_loss:step=2,lose=1;"
                "kill:step=4,lose=2;slowdown:step=1,stage=1,factor=2,duration=3;"
                "slowdown:step=2,stage=1,factor=3;nan:step=6")
        outs = []
        for mod in (jfaults, tfaults):
            plan = mod.FaultPlan.parse(spec, seed=11)
            out = [getattr(plan.take("decode_nan", s), "step", None) for s in (4, 7, 7, 9)]
            plan.reset()
            out.append(plan.take("decode_nan", 5).step)
            out += [len(plan.devices_visible(list(range(8)), s)) for s in (1, 2, 3, 4)]
            out += [plan.slowdowns_at(s) for s in range(6)]
            out += [plan.nan_at(s) for s in (5, 6, 6)]
            out += [plan.choose(list(range(100))) for _ in range(5)]
            out += [plan.crash_leaf_index(30) for _ in range(3)]
            with pytest.raises(ValueError, match="no options"):
                plan.choose([])
            outs.append(out)
        assert outs[0] == outs[1]
        assert outs[1][:5] == [None, 5, None, 9, 5] and outs[1][5:9] == [8, 7, 8, 6]


# ---------------------------------------------------------------------------
# allocator audit + quarantine, radix drop, the NaN probe
# ---------------------------------------------------------------------------


def _audit_msg(fn):
    try:
        return fn()
    except Exception as e:  # both packages' PoolAuditError / ValueError
        return type(e).__name__, str(e)


def _audit_scenarios(kv):
    out = []
    a = kv.PageAllocator(8)
    pages = a.alloc(3)
    a.ref(pages[:1])
    out.append(_audit_msg(lambda: a.audit({"a": pages, "b": pages[:1]})))
    a = kv.PageAllocator(8)
    pages = a.alloc(2)
    a._free.append(pages[0])  # the pool_corrupt injection
    out.append(_audit_msg(a.audit))
    a = kv.PageAllocator(4)
    a._free.append(a._free[0])
    out.append(_audit_msg(a.audit))
    a = kv.PageAllocator(4)
    a._free.remove(2)
    out.append(_audit_msg(a.audit))
    a = kv.PageAllocator(8)
    pages = a.alloc(2)
    out.append(_audit_msg(lambda: a.audit({"slot0": pages, "slot1": [pages[0]]})))
    a.ref(pages[1:])
    out.append(_audit_msg(lambda: a.audit({"slot0": pages})))
    a = kv.PageAllocator(8)
    pages = a.alloc(3)
    out += [a.quarantine([pages[0], 7]), a.quarantine([pages[0]]), a.num_quarantined,
            a.refcount(pages[0]), _audit_msg(lambda: a.audit({"a": pages[1:]}))]
    a._free.append(7)
    out.append(_audit_msg(a.audit))
    out.append(_audit_msg(lambda: a.quarantine([99])))
    return out


class TestPoolAudit:
    def test_audit_and_quarantine_match_reference(self):
        port = _audit_scenarios(tkv)
        assert port == _audit_scenarios(jkv)
        assert port[0] == {"free": 5, "live": 3, "shared": 1, "quarantined": 0}
        for i, what in ((1, "both free and live"), (2, "duplicates"), (3, "vanished"),
                        (4, "double ownership"), (5, "leaked reference"),
                        (11, "still circulating"), (12, "out of range")):
            assert what in port[i][1], (i, port[i])
        assert port[6:10] == [2, 0, 2, 0] and port[10]["quarantined"] == 2


class TestRadixDropAndProbe:
    def test_drop_pages_matches_reference(self):
        outs = []
        for kv in (jkv, tkv):
            a = kv.PageAllocator(8)
            cache = kv.RadixPrefixCache(a, page_size=4)
            pages = a.alloc(3)
            out = [cache.insert(list(range(12)), pages)]
            a.release(pages)
            a.audit({"radix": cache.pages()})
            out += [cache.drop_pages({pages[1]}), cache.pages(), a.num_free,
                    a.audit({"radix": cache.pages()})]
            outs.append(out)
        assert outs[0] == outs[1] == [3, 2, [0], 7,
                                      {"free": 7, "live": 1, "shared": 0, "quarantined": 0}]

    def test_find_nonfinite_pages_matches_reference(self):
        """Same NaN / inf positions; the port's pools carry one more page
        on axis 1, the sink, which the probe never reads (poisoned here)."""
        z = np.zeros((2, 5, 4, 3), np.float32)
        k0, v1 = z.copy(), z.copy()
        k0[0, 2, 1, 0] = np.nan
        v1[1, 4] = np.inf
        ref = jkv.find_nonfinite_pages([{"k": jnp.asarray(k0), "v": jnp.asarray(z)},
                                        {"k": jnp.asarray(z), "v": jnp.asarray(v1)}])

        def port(x):
            sink = np.full((x.shape[0], 1) + x.shape[2:], np.nan, np.float32)
            return torch.from_numpy(np.concatenate([x, sink], axis=1))

        got = tkv.find_nonfinite_pages([{"k": port(k0), "v": port(z)},
                                        {"k": port(z), "v": port(v1)}])
        assert got == ref == [2, 4]
        codes = np.zeros((2, 5, 4), np.int8)
        scale = np.zeros((1, 5, 4), np.float32)
        scale[0, 3, 0] = np.nan
        ref = jkv.find_nonfinite_pages([{"codes": jnp.asarray(codes),
                                         "scale": jnp.asarray(scale)}])
        got = tkv.find_nonfinite_pages([{"codes": torch.zeros((2, 6, 4), dtype=torch.int8),
                                         "scale": port(scale[..., None])[..., 0]}])
        assert got == ref == [3]


# ---------------------------------------------------------------------------
# engine fault surface and the monotonic clock
# ---------------------------------------------------------------------------


def _engine_surface(model, side):
    eng_mod = MODS[side][0]
    params, cfg = model[side]
    rng = np.random.default_rng(0)
    out = []
    with _fake_clock(eng_mod):
        eng = eng_mod.ServingEngine(params, cfg, max_slots=1, max_len=128, page_size=8,
                                    prefill_chunk=8)
        free0 = eng.allocator.num_free
        a = eng.submit(rng.integers(0, cfg.vocab, (9,), dtype=np.int32), 6)
        b = eng.submit(rng.integers(0, cfg.vocab, (7,), dtype=np.int32), 6)
        eng.step()
        out += [eng.cancel(b), b.cancelled, b.t_done]
        eng.step()
        out += [eng.cancel(a), a.cancelled, eng.allocator.num_free == free0,
                bool((eng.block_tables == -1).all()), eng.audit(), eng.cancel(a),
                sorted(r.rid for r in eng.take_done()), list(a.tokens), eng.stats()]
        # requeue guards
        eng = eng_mod.ServingEngine(params, cfg, **ENGINE_KW)
        done = eng.submit(rng.integers(0, cfg.vocab, (6,), dtype=np.int32), 2)
        eng.run()
        out.append(_audit_msg(lambda: eng.requeue(done)))
        gone = eng.submit(rng.integers(0, cfg.vocab, (6,), dtype=np.int32), 2)
        eng.cancel(gone)
        out.append(_audit_msg(lambda: eng.requeue(gone)))
        big = eng.submit(rng.integers(0, cfg.vocab, (40,), dtype=np.int32), 40)
        small = eng_mod.ServingEngine(params, cfg, max_slots=1, max_len=128, page_size=8,
                                      num_pages=4, prefill_chunk=8)
        out.append(_audit_msg(lambda: small.requeue(big)))
        # quarantine_slot retires the lane
        eng = eng_mod.ServingEngine(params, cfg, **ENGINE_KW)
        r = eng.submit(rng.integers(0, cfg.vocab, (9,), dtype=np.int32), 6)
        eng.step()
        sid = next(i for i, s in enumerate(eng.slots) if s.req is r)
        out.append(_audit_msg(lambda: eng.quarantine_slot(sid)))
        eng.cancel(r)
        eng.quarantine_slot(sid)
        p = rng.integers(0, cfg.vocab, (7,), dtype=np.int32)
        r2, r3 = eng.submit(p, 3), eng.submit(p[:5], 3)
        fin = {q.rid: list(q.tokens) for q in eng.run() if not q.cancelled}
        out += [eng.slots[sid].quarantined, fin, r2.rid in fin and r3.rid in fin,
                eng.audit(), eng.stats()]
        # debug_audit catches live corruption
        eng = eng_mod.ServingEngine(params, cfg, **ENGINE_KW)
        eng.submit(rng.integers(0, cfg.vocab, (9,), dtype=np.int32), 8)
        eng.step(debug_audit=True)
        eng.allocator._free.append(next(iter(eng.allocator._refs)))
        out.append(_audit_msg(lambda: eng.step(debug_audit=True)))
    return out


class TestEngineFaultSurface:
    def test_fault_surface_matches_reference(self, model):
        port = _engine_surface(model, "port")
        assert port == _engine_surface(model, "ref")
        assert port[:3] == [True, True, port[2]] and port[2] is not None
        assert port[3:7] == [True, True, True, True] and port[8] is False
        assert "already done" in port[12][1] and "already cancelled" in port[13][1]
        assert "pages" in port[14][1] and "tear it down" in port[15][1]
        assert port[16] is True and port[18] is True
        assert port[-1][0] == "PoolAuditError"


class TestMonotonicClock:
    def test_every_timestamp_comes_from_the_module_clock(self, model):
        """A clock far above any real ``time.monotonic()`` reading: every
        stamp must come from it, never decrease, and give the reference's
        latency statistics."""
        t0 = 1e9
        stats = []
        for side in ("ref", "port"):
            eng_mod = MODS[side][0]
            params, cfg = model[side]
            rng = np.random.default_rng(4)
            with _fake_clock(eng_mod, start=t0):
                eng = eng_mod.ServingEngine(params, cfg, **ENGINE_KW)
                for n, m in [(9, 5), (13, 4)]:
                    eng.submit(rng.integers(0, cfg.vocab, (n,), dtype=np.int32), m)
                done = eng.run()
            for r in done:
                stamps = [r.t_submit, r.t_admit, r.t_first, *r.token_times, r.t_done]
                assert all(s >= t0 for s in stamps), "a timestamp bypassed _now"
                assert all(b >= a for a, b in zip(stamps, stamps[1:]))
            stats.append(eng_mod.latency_stats(done))
        assert stats[0] == stats[1]
        assert all(v >= 0.0 for v in stats[1].values() if isinstance(v, (int, float)))


# ---------------------------------------------------------------------------
# the serving supervisor
# ---------------------------------------------------------------------------


class TestServeSupervisor:
    def test_clean_run_is_invisible(self, model):
        reqs = _reqs(256, 5, [(9, 5)])
        sup, done = _both(model, reqs)
        params, cfg = model["port"]
        eng = teng.ServingEngine(params, cfg, **ENGINE_KW)
        eng.submit(*reqs[0])
        assert done[0][0] == eng.run()[0].tokens
        st = sup.stats()
        assert sup.events == [] and st["recoveries"] == 0
        assert st["health_events"] == 0 and not sup.degraded
        _leak_check(sup.engine)

    def test_submit_guards_and_event_kinds(self, model):
        params, cfg = model["port"]
        sup = tsup.ServeSupervisor(params, cfg, engine_kw=ENGINE_KW)
        with pytest.raises(ValueError, match="deadline_ms"):
            sup.submit(_reqs(256, 5, [(9, 5)])[0][0], 5, deadline_ms=0)
        with pytest.raises(ValueError, match="unknown serve event"):
            tsup.ServeEvent("oops", 0)
        assert tsup.SERVE_EVENT_KINDS == jsup.SERVE_EVENT_KINDS

    @pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
    def test_decode_nan_quarantines_and_resumes_bitwise(self, model, kv_dtype):
        """NaN rows written into the victim's tail page (the scales of an
        int8 pool) are found by the probe, purged from the radix index,
        quarantined with the victim's lane, and the victim resumes from
        its last clean token: every stream bitwise the fault-free run's."""
        kw = dict(ENGINE_KW, kv_dtype=kv_dtype)
        reqs = _reqs(256, 6, [(9, 12), (13, 10), (8, 8)])
        sup, done = _both(model, reqs, engine_kw=kw, plan="decode_nan:step=3",
                          ref_kernels=True)
        base = _baseline(model, reqs, kw)
        assert sorted(done) == [0, 1, 2] and not any(c for _, c, _ in done.values())
        assert all(done[rid][0] == base[rid] for rid in base)
        assert sup.stats()["events"] == {"quarantine": 1}
        assert sup.recoveries == 1 and not sup.degraded
        ev = sup.events[0]
        assert ev.detail["newly_quarantined"] >= 1 and ev.detail["rids"]
        assert any(s.quarantined for s in sup.engine.slots)
        # the poisoned page keeps its NaN rows in every floating leaf
        page = ev.detail["pages"][0]
        for pool in sup.engine.blocks:
            for leaf in pool.values():
                if leaf.is_floating_point():
                    assert torch.isnan(leaf[:, page]).all()
        _leak_check(sup.engine)

    def test_device_loss_rebuilds_on_survivors_bitwise(self, model):
        reqs = _reqs(256, 7, [(9, 10), (13, 8), (8, 6)])
        sup, done = _both(model, reqs, plan="device_loss:step=2,lose=1",
                          devices=[0, 1, 2, 3])
        base = _baseline(model, reqs)
        assert all(done[rid][0] == base[rid] and not done[rid][1] for rid in base)
        st = sup.stats()
        assert st["devices"] == 3 and st["events"] == {"rebuild": 1}
        assert sup.engine.num_pages == 24  # the lost board took its HBM slice
        assert sup.events[0].detail["kind"] == "device_loss"
        assert sup.events[0].detail["salvaged"] >= 1 and st["health_events"] >= 1
        _leak_check(sup.engine)

    def test_pool_corrupt_is_caught_by_the_audit(self, model):
        kw = dict(ENGINE_KW, prefix_cache=False)
        reqs = _reqs(256, 8, [(9, 10), (13, 8)])
        sup, done = _both(model, reqs, engine_kw=kw, plan="pool_corrupt:step=2", seed=1)
        base = _baseline(model, reqs, kw)
        assert all(done[rid][0] == base[rid] and not done[rid][1] for rid in base)
        ev = next(e for e in sup.events if e.kind == "rebuild")
        assert ev.detail["kind"] == "pool_corrupt"
        _leak_check(sup.engine)

    def test_step_hang_trips_the_watchdog(self, model):
        reqs = _reqs(256, 9, [(9, 20), (13, 18)])
        sup, done = _both(model, reqs, plan="step_hang:step=6,hang_s=60")
        base = _baseline(model, reqs)
        assert all(done[rid][0] == base[rid] and not done[rid][1] for rid in base)
        wd = [e for e in sup.events if e.kind == "watchdog"]
        assert len(wd) == 1 and wd[0].detail["detected"]
        assert next(e for e in sup.events if e.kind == "rebuild").detail["kind"] == "step_hang"
        _leak_check(sup.engine)

    def test_deadline_cancels_within_one_step(self, model):
        reqs = _reqs(256, 10, [(9, 110), (13, 6)])
        sup, done = _both(model, reqs, deadlines={0: 1.0})
        assert done[0][1] and not done[1][1] and done[1][2]
        cd = [e for e in sup.events if e.kind == "cancel_deadline"]
        assert len(cd) == 1 and cd[0].detail["rid"] == 0
        assert cd[0].detail["expired_since_last_check"] and cd[0].detail["late_s"] >= 0.0
        assert done[1][0] == _baseline(model, reqs[1:])[0]
        _leak_check(sup.engine)

    def test_shed_when_the_shrunken_pool_cannot_back_a_request(self, model):
        reqs = _reqs(256, 11, [(8, 4), (40, 40)])  # the big one needs 10 of 8 pages
        sup, done = _both(model, reqs, engine_kw=dict(ENGINE_KW, num_pages=16),
                          plan="device_loss:step=0,lose=2", devices=[0, 1, 2, 3])
        assert done[1][1] and not done[0][1]
        shed = [e for e in sup.events if e.kind == "shed"]
        assert shed and 1 in shed[0].detail["rids"] and sup.engine.num_pages == 8
        assert done[0][0] == _baseline(model, reqs[:1])[0]
        _leak_check(sup.engine)

    def test_degrade_flips_dispatch_and_restores(self, model):
        attn0, gemm0 = tlayers.attention_impl(), tlayers.gemm_impl()
        reqs = _reqs(256, 12, [(9, 10), (13, 8)])
        runs = {}
        for side in ("ref", "port"):
            sup_mod = MODS[side][2]
            params, cfg = model[side]
            kernels = contextlib.nullcontext()
            if side == "ref":
                kernels, cfg = _reference_kernels(), copy.copy(cfg)
            with _fake_clock(MODS[side][0]), kernels:
                sup = sup_mod.ServeSupervisor(
                    params, cfg, engine_kw=ENGINE_KW, degrade_after=1,
                    fault_plan=MODS[side][3].FaultPlan.parse("decode_nan:step=3"))
                try:
                    for p, m in reqs:
                        sup.submit(p, m)
                    done = sup.run()
                    live = (jlayers.attention_impl(), jlayers.gemm_impl()) if side == "ref" \
                        else (tlayers.attention_impl(), tlayers.gemm_impl())
                    runs[side] = ({r.rid: (list(r.tokens), r.cancelled) for r in done},
                                  sup.stats(), [_event(e) for e in sup.events], live)
                    _leak_check(sup.engine)
                finally:
                    sup.restore_dispatchers()
        assert runs["port"][:3] == runs["ref"][:3]
        done, st, events, live = runs["port"]
        assert st["degraded"] and live == ("ref", "ref")
        deg = next(e for e in events if e[0] == "degrade")
        assert deg[2] == {"faults": 1, "attention": "ref", "gemm": "ref"}
        assert len(done) == len(reqs) and not any(c for _, c in done.values())
        assert (tlayers.attention_impl(), tlayers.gemm_impl()) == (attn0, gemm0)


class TestPortDifferences:
    @pytest.mark.parametrize("error", [
        torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
        KernelLaunchError("flash_attention: CUDA error 700 at launch (illegal address)"),
    ], ids=["accelerator_error", "kernel_launch_error"])
    def test_device_errors_propagate(self, model, monkeypatch, error):
        """An error of the card or of a kernel's launch is never turned
        into a pool_corrupt rebuild: it leaves the supervisor's step."""
        params, cfg = model["port"]
        sup = tsup.ServeSupervisor(params, cfg, engine_kw=ENGINE_KW)
        sup.submit(*_reqs(256, 5, [(9, 5)])[0])

        def fail(debug_audit=False):
            raise error

        monkeypatch.setattr(sup.engine, "step", fail)
        with pytest.raises(type(error), match="CUDA error"):
            sup.step()
        assert sup.events == [] and sup.recoveries == 0

    def test_other_step_errors_are_recovered_as_the_reference(self, model, monkeypatch):
        params, cfg = model["port"]
        reqs = _reqs(256, 8, [(9, 6), (13, 4)])
        sup = tsup.ServeSupervisor(params, cfg, engine_kw=ENGINE_KW)
        for p, m in reqs:
            sup.submit(p, m)
        sup.step()
        real = sup.engine.step

        def once(debug_audit=False):
            monkeypatch.setattr(sup.engine, "step", real)
            raise RuntimeError("poisoned metadata")

        monkeypatch.setattr(sup.engine, "step", once)
        done = {r.rid: list(r.tokens) for r in sup.run()}
        rb = [e for e in sup.events if e.kind == "rebuild"]
        assert len(rb) == 1 and rb[0].detail["kind"] == "pool_corrupt"
        assert rb[0].detail["reason"] == "RuntimeError: poisoned metadata"
        assert done == _baseline(model, reqs)
        _leak_check(sup.engine)

    def test_cpu_supervisor_has_one_device(self, model):
        """Params on the CPU: one device, so a device_loss ends the
        deployment, as the reference's does on one device."""
        params, cfg = model["port"]
        sup = tsup.ServeSupervisor(params, cfg, engine_kw=ENGINE_KW,
                                   fault_plan=tfaults.FaultPlan.parse("device_loss:step=1"))
        assert sup.devices == [torch.device("cpu")]
        sup.submit(*_reqs(256, 5, [(9, 5)])[0])
        with pytest.raises(RuntimeError, match="all 1 devices lost"):
            sup.run()

    def test_write_fault_hooks_the_port_checkpoint(self):
        from repro_torch.ft import checkpoint as tckpt

        hook = tfaults.one_shot_write_fault(2)
        assert tckpt._write_fault is hook
        hook(0, "a")  # the first leaf lands
        with pytest.raises(tfaults.CheckpointWriteCrash, match="after leaf 1"):
            hook(1, "b")
        assert tckpt._write_fault is None


def test_fault_event_fields_match_reference():
    assert [f.name for f in dataclasses.fields(tfaults.FaultEvent)] == \
        [f.name for f in dataclasses.fields(jfaults.FaultEvent)]
    assert tfaults._FIELDS == jfaults._FIELDS and tfaults._KINDS == jfaults._KINDS
