"""The port's ``ft.supervisor.TrainSupervisor`` and ``ft.elastic``'s
``state_shardings`` / ``rescale`` against the JAX reference's.

* Both supervisors run under one fake clock (``FakeClock`` below, set as
  each supervisor module's ``time``: every ``perf_counter`` /
  ``monotonic`` read advances it by 10 ms, ``sleep`` by its argument), so
  the step times the heartbeats carry, and with them every straggler
  verdict, are the same numbers in both packages.  Both start from the
  reference's params (``transformer.init(PRNGKey(0))``), carried over by
  ``convert`` through the port's ``init_fn`` seam.
* Fused, in process: the reference's ``TestSupervisorFused`` run (NaN at
  data index 3, a checkpoint write crash at step 4): the events equal in
  kind, step, steps lost and the error's type (the port's tree has more
  leaves, so the torn write stops at another leaf), the losses within
  1e-5 relative, the skipped set and the latest checkpoint equal; the
  persistent-NaN refusal after the same events.
* Pipeline: one subprocess runs the reference's clean, slowdown and kill
  runs of ``TestSupervisorPipeline`` on 4 fake CPU devices (its own
  ``jax.sharding.Mesh``, Auto axes); the port runs them on ``[cpu] * 4``.
  Events (re-cut boundaries, rates, ``4->3`` with the restored step) and
  ``boundaries_history`` equal, losses within 1e-5 relative.
* ``state_shardings`` equals the reference's specs on a 1 x 1 mesh for the
  four strategies; ``rescale`` restores a checkpoint the reference wrote
  (a state in the port's per-layer layout) bitwise, onto a fused and a
  four-stage mesh.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.ft import elastic as jelastic  # noqa: E402
from repro.ft import faults as jfaults  # noqa: E402
from repro.ft import supervisor as jsup  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.ft import checkpoint as tckpt  # noqa: E402
from repro_torch.ft import elastic as telastic  # noqa: E402
from repro_torch.ft import faults as tfaults  # noqa: E402
from repro_torch.ft import supervisor as tsup  # noqa: E402
from repro_torch.train.step import init_state, make_state  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
FUSED = dict(num_layers=2, d_model=64, vocab=256)
PIPE = dict(num_layers=8, d_model=64, vocab=256)

# one fake clock class for both packages (and the reference's subprocess)
CLOCK = r"""
class FakeClock:
    def __init__(self, dt=0.01):
        self.t, self.dt = 0.0, dt

    def perf_counter(self):
        self.t += self.dt
        return self.t

    monotonic = perf_counter

    def sleep(self, s):
        self.t += s
"""
exec(CLOCK)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread, so parallel workers do not
    oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _init_fn(small):
    """The port's ``init_fn``: the reference's params from PRNGKey(0)."""
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0),
                                               jget_config("qwen3_0p6b").scaled_down(**small),
                                               jnp.float32))
    cfg = get_config("qwen3_0p6b").scaled_down(**small)
    return cfg, lambda: make_state(convert.params_from_numpy(params, cfg, "cpu"))


def _event(e) -> dict:
    """An event as JSON-able fields: the error (a repr) by its type only."""
    detail = dict(e.detail)
    if "error" in detail:
        detail["error"] = detail["error"].split("(")[0]
    detail.pop("swept", None)
    return json.loads(json.dumps({"kind": e.kind, "step": e.step,
                                  "steps_lost": e.steps_lost, "detail": detail}))


def _close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert math.isfinite(a) and abs(a - b) <= LOSS_RTOL * abs(b), (got, want)


# ---------------------------------------------------------------------------
# fused: NaN rollback, checkpoint-crash retry, persistent NaN
# ---------------------------------------------------------------------------


def _fused_pair(monkeypatch, tmp_path, spec, **kw):
    """(reference supervisor, port supervisor) on the fused strategy."""
    cfg, init_fn = _init_fn(FUSED)
    jcfg = jget_config("qwen3_0p6b").scaled_down(**FUSED)
    common = dict(steps=kw.pop("steps", 8), seq=16, batch=4, strategy="fused", ckpt_every=2,
                  **kw)
    monkeypatch.setattr(jsup, "time", FakeClock())
    ref = jsup.TrainSupervisor(jcfg, fault_plan=spec(jfaults), ckpt_dir=str(tmp_path / "j"),
                               **common)
    monkeypatch.setattr(tsup, "time", FakeClock())
    port = tsup.TrainSupervisor(cfg, fault_plan=spec(tfaults), ckpt_dir=str(tmp_path / "t"),
                                devices=[CPU], init_fn=init_fn, **common)
    return ref, port


def test_fused_nan_rollback_and_ckpt_retry_match_reference(monkeypatch, tmp_path):
    ref, port = _fused_pair(monkeypatch, tmp_path,
                            lambda m: m.FaultPlan.parse("nan:step=3;ckpt_crash:step=4"))
    want, got = ref.run(), port.run()
    assert [_event(e) for e in got.events] == [_event(e) for e in want.events]
    kinds = [e.kind for e in got.events]
    assert kinds == ["rollback", "ckpt_retry"]
    assert got.events[1].detail["error"].startswith("CheckpointWriteCrash(")
    assert got.events[0].detail == {"skipped_data_index": 3, "restored_step": 2}
    _close(got.losses, want.losses)
    assert port.skipped == ref.skipped == {3}
    for sup, root in ((ref, tmp_path / "j"), (port, tmp_path / "t")):
        assert tckpt.sweep_tmp(str(root)) == []
        assert tckpt.latest_step(str(root)) == 8
    assert got.boundaries_history == want.boundaries_history == []


def test_persistent_nan_refused_like_reference(monkeypatch, tmp_path):
    ref, port = _fused_pair(
        monkeypatch, tmp_path,
        lambda m: m.FaultPlan([m.FaultEvent("nan", step=s) for s in range(20)]),
        steps=4, max_rollbacks=3)
    for sup in (ref, port):
        with pytest.raises(RuntimeError, match="rollback"):
            sup.run()
    assert [_event(e) for e in port.events] == [_event(e) for e in ref.events]
    assert [e.kind for e in port.events] == ["rollback"] * 3


def test_supervisor_template_is_meta_and_restore_lands_on_device(tmp_path):
    """The restore template allocates nothing; a restored state lands on
    the supervisor's device in the manifest's dtypes."""
    cfg, init_fn = _init_fn(FUSED)
    sup = tsup.TrainSupervisor(cfg, steps=2, seq=16, batch=4, strategy="fused",
                               devices=[CPU], init_fn=init_fn, ckpt_dir=str(tmp_path),
                               ckpt_every=2)
    assert {x.device.type for _, x in flatten_with_path(sup._like)} == {"meta"}
    sup.run()
    state, step = sup._load_latest()
    assert step == 2 and int(state["step"]) == 2
    for (path, a), (_, b) in zip(flatten_with_path(state), flatten_with_path(sup.state)):
        assert a.device == CPU and a.dtype == b.dtype and torch.equal(a, b), path


# ---------------------------------------------------------------------------
# pipeline: clean, slowdown (live re-cut) and kill (rescale 4 -> 3)
# ---------------------------------------------------------------------------

# name -> (fault plan, steps, checkpoints every 2 steps)
PIPE_RUNS = {"clean": ("", 12, False),
             "slowdown": ("slowdown:step=3,stage=2,factor=3", 12, False),
             "kill": ("kill:step=7,lose=1", 10, True)}

_REF_SCRIPT = r"""
import json, os, sys, tempfile
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.configs.base import get_config
from repro.ft import supervisor as sup_mod
from repro.ft.faults import FaultPlan
exec(CLOCK)
cfg = get_config("qwen3_0p6b").scaled_down(**PIPE)
out = {}
for name, (spec, steps, ckpt) in RUNS.items():
    sup_mod.time = FakeClock()
    with tempfile.TemporaryDirectory() as d:
        res = sup_mod.TrainSupervisor(
            cfg, steps=steps, seq=16, batch=4, strategy="pipeline", seed=0,
            fault_plan=FaultPlan.parse(spec) if spec else None,
            ckpt_dir=d if ckpt else None, ckpt_every=2 if ckpt else 0).run()
    out[name] = {"losses": res.losses,
                 "history": [list(b) for b in res.boundaries_history],
                 "events": [{"kind": e.kind, "step": e.step, "steps_lost": e.steps_lost,
                             "detail": e.detail} for e in res.events]}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("REF_SUPERVISOR_OK")
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's three pipeline runs from one 4-fake-device
    subprocess (the device override must not leak into this process)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path_factory.mktemp("ref_supervisor") / "ref.json"
    code = f"CLOCK = {CLOCK!r}\nPIPE = {PIPE!r}\nRUNS = {PIPE_RUNS!r}\n" + _REF_SCRIPT
    r = subprocess.run(
        [sys.executable, "-c", code, str(out)], capture_output=True, text=True,
        env={"PYTHONPATH": os.path.join(repo, "src"),
             "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "HOME": os.environ.get("HOME", "/tmp"),
             "JAX_PLATFORMS": "cpu"},
        cwd=repo, timeout=400)
    assert "REF_SUPERVISOR_OK" in r.stdout, r.stdout + r.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("name", list(PIPE_RUNS))
def test_pipeline_runs_match_reference(reference_runs, monkeypatch, tmp_path, name):
    spec, steps, ckpt = PIPE_RUNS[name]
    want = reference_runs[name]
    cfg, init_fn = _init_fn(PIPE)
    monkeypatch.setattr(tsup, "time", FakeClock())
    res = tsup.TrainSupervisor(
        cfg, steps=steps, seq=16, batch=4, strategy="pipeline", seed=0,
        fault_plan=tfaults.FaultPlan.parse(spec) if spec else None,
        ckpt_dir=str(tmp_path) if ckpt else None, ckpt_every=2 if ckpt else 0,
        devices=[CPU] * 4, init_fn=init_fn).run()
    got_events = [_event(e) for e in res.events]
    want_events = [_event(type("E", (), e)) for e in want["events"]]
    assert got_events == want_events
    assert [list(b) for b in res.boundaries_history] == want["history"]
    _close(res.losses, want["losses"])
    if name == "clean":
        assert res.events == [] and want["history"] == [[0, 2, 4, 6, 8]]
    if name == "slowdown":
        old, new = res.events_of("recut")[0].detail["old"], res.events_of("recut")[0].detail["new"]
        assert new[3] - new[2] < old[3] - old[2]  # stage 2 shrank
        base = reference_runs["clean"]["losses"][-1]
        assert abs(res.final_loss - base) <= 5e-2 * abs(base)
    if name == "kill":
        ev, = res.events_of("rescale")
        assert ev.detail["devices"] == "4->3" and ev.detail["stages"] == 3
        assert ev.steps_lost <= 2 and len(res.boundaries_history[-1]) == 4


# ---------------------------------------------------------------------------
# elastic: state_shardings and rescale
# ---------------------------------------------------------------------------


def _port_specs(specs, lead=None, path="", out=None):
    """{jax keystr path: [full spec of each layer]}: a list's layer entry
    in front of each per-layer spec, the reference's stacked spec."""
    out = {} if out is None else out
    if isinstance(specs, dict):
        for k, v in specs.items():
            _port_specs(v, lead, f"{path}['{k}']", out)
    elif isinstance(specs, tsh.LayerSpecs):
        for v in specs:
            _port_specs(v, (specs.layer,), path, out)
    elif isinstance(specs, tuple) and hasattr(specs, "_fields"):
        for f in specs._fields:
            _port_specs(getattr(specs, f), lead, f"{path}.{f}", out)
    else:
        out.setdefault(path, []).append(specs if lead is None else lead + specs)
    return out


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("strategy", list(tsh.SHARDING_STRATEGIES))
def test_state_shardings_equal_reference(strategy):
    jcfg = jget_config("qwen3_0p6b").scaled_down(**FUSED)
    cfg = get_config("qwen3_0p6b").scaled_down(**FUSED)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jstate = jax.eval_shape(lambda k: jstep.init_state(k, jcfg, jnp.float32),
                            jax.random.PRNGKey(0))
    want_sh = jelastic.state_shardings(jstate, jmesh, strategy)
    shapes = {jax.tree_util.keystr(k): v.shape
              for k, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    want = {jax.tree_util.keystr(k): (len(shapes[jax.tree_util.keystr(k)]), tuple(s.spec))
            for k, s in jax.tree_util.tree_flatten_with_path(
                want_sh, is_leaf=lambda x: isinstance(x, NamedSharding))[0]}
    state = init_state(cfg, generator=torch.Generator(), dtype=torch.float32, device="meta")
    got = _port_specs(telastic.state_shardings(state, telastic.make_mesh_for([CPU]), strategy))
    assert set(got) == set(want)
    for path, (ndim, spec) in want.items():
        assert all(_pad(s, ndim) == _pad(spec, ndim) for s in got[path]), (path, got[path], spec)


def _unstack(tree, n):
    return [jax.tree.map(lambda x, i=i: x[i], tree) for i in range(n)]


@pytest.mark.parametrize("mesh", ["fused", "pipeline"])
def test_rescale_restores_a_reference_checkpoint(tmp_path, mesh):
    """The reference trains one step and saves the state in the port's
    per-layer layout; the port's rescale restores every leaf bitwise from
    a meta template, onto one CPU or four pipeline stages on it."""
    jcfg = jget_config("qwen3_0p6b").scaled_down(**FUSED)
    cfg = get_config("qwen3_0p6b").scaled_down(**FUSED)
    jstate = jstep.init_state(jax.random.PRNGKey(0), jcfg, jnp.float32)
    from repro.data.pipeline import SyntheticLM

    jstate, _ = jax.jit(jstep.make_train_step(jcfg, JAdamWConfig(lr=1e-3)))(
        jstate, SyntheticLM(jcfg.vocab, 16, 4).batch(0))
    n = jcfg.num_layers

    def per_layer(p):
        return dict(p, blocks=_unstack(p["blocks"], n))

    opt = jstate["opt"]
    ported = {"params": per_layer(jstate["params"]),
              "opt": opt._replace(mu=per_layer(opt.mu), nu=per_layer(opt.nu)),
              "step": jstate["step"]}
    jckpt.save(str(tmp_path / "ck"), ported, step=1)
    like = init_state(cfg, generator=torch.Generator(), dtype=torch.float32, device="meta")
    if mesh == "fused":
        tmesh = telastic.make_mesh_for([CPU])
    else:
        tmesh = tsh.Mesh(np.array([CPU] * 4, dtype=object).reshape(1, 4), ("data", "model"))
    got = telastic.rescale(str(tmp_path / "ck"), like, tmesh, mesh)
    flat, want = flatten_with_path(got), jax.tree_util.tree_flatten_with_path(ported)[0]
    assert len(flat) == len(want)
    for (path, a), (_, b) in zip(flat, want):
        assert a.device == CPU and np.array_equal(a.numpy(), np.asarray(b)), path
    assert got["opt"].step.dtype == torch.int32 and int(got["step"]) == 1
