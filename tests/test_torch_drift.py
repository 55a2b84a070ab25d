"""The port's training over 20 steps against the reference, held to the
reference's own sensitivity to one rounding.

mamba2_2p7b and zamba2_2p7b ``scaled_down()`` in f32, S 32, batch 8,
grad_accum 2, AdamW (lr 1e-3, warmup 2), the reference's params
(``PRNGKey(0)``) carried over by ``convert.params_from_numpy``, one batch a
step from ``numpy.random.default_rng(5)`` (``tools/tp_drift_study.py``'s
inputs).  The reference's jitted step runs in this process on one CPU
device.

The envelope is the largest relative loss gap ``max_t |a_t - b_t| / |b_t|``
over the 20 steps between the reference's run and the same run from its
initial params moved by one rounding, three ways: every element one ulp
up, every element one ulp down, and each element one ulp up or down by a
seeded sign.  Two orders of one f32 computation drift apart as far as that
and no farther unless one of them departs, so the port's one process is
held within 2x the reference's envelope (ROADMAP queue 3).  The port's own
envelope and its processes' gap are read by ``tools/tp_drift_study.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in xdist workers that share the cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config  # noqa: E402
from repro.optim.adamw import AdamWConfig  # noqa: E402
from repro.train.step import init_state, make_train_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCHS = ("mamba2_2p7b", "zamba2_2p7b")
B, S, GA, STEPS = 8, 32, 2, 20
SIGN_SEED = 11
ENVELOPE_FACTOR = 2.0


def _gap(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _signs(params):
    """One sign tree a perturbation: +1, -1, and a seeded draw per element
    (numpy arrays in the reference's layout)."""
    rng = np.random.default_rng(SIGN_SEED)
    flat = jax.tree.map(np.asarray, params)
    return {"up": jax.tree.map(np.ones_like, flat),
            "down": jax.tree.map(lambda p: -np.ones_like(p), flat),
            "rand": jax.tree.map(lambda p: rng.choice(np.float32([-1, 1]), p.shape), flat)}


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Loss curves: the reference's jitted run, its three perturbed runs
    and the port's one process."""
    arch = request.param
    cfg, tcfg = get_config(arch).scaled_down(), t_get_config(arch).scaled_down()
    state0 = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32) for _ in range(STEPS)]
    signs = _signs(state0["params"])
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    step = jax.jit(make_train_step(cfg, opt, grad_accum=GA))

    def ref_run(params):
        state, losses = dict(state0, params=params), []
        for t in batches:
            state, met = step(state, {"tokens": jnp.asarray(t)})
            losses.append(float(met["loss"]))
        return losses

    ref = {"base": ref_run(state0["params"])}
    for name, sign in signs.items():
        ref[name] = ref_run(jax.tree.map(lambda p, s: jnp.nextafter(p, s * jnp.inf),
                                         state0["params"], sign))

    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, state0["params"]), tcfg, "cpu")
    topt = tadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=STEPS)
    tstep_fn = tstep.make_train_step(tcfg, topt, grad_accum=GA)
    state, port = tstep.make_state(tparams), []
    for t in batches:
        state, met = tstep_fn(state, {"tokens": torch.from_numpy(t).long()})
        port.append(float(met["loss"]))
    return arch, ref, port


def test_port_one_process_within_twice_the_reference_envelope(runs):
    arch, ref, port = runs
    ref_env = {k: _gap(v, ref["base"]) for k, v in ref.items() if k != "base"}
    envelope = max(ref_env.values())
    gap = _gap(port, ref["base"])
    print(f"{arch}: reference envelope {ref_env}, port one process vs reference "
          f"{gap:.3e} ({gap / envelope:.2f}x the reference envelope)")
    assert all(np.isfinite(port)) and len(port) == STEPS
    # one rounding moves the loss: the envelope is a measured yardstick, not 0
    assert envelope > 0
    assert gap <= ENVELOPE_FACTOR * envelope, (arch, gap, envelope)


@pytest.mark.parametrize("arch", ARCHS)
def test_perturbations_move_every_element_one_ulp(arch):
    """The study's port perturbation is the reference's: the signs carried
    over by ``convert`` move each port element to the reference's moved
    value."""
    cfg, tcfg = get_config(arch).scaled_down(), t_get_config(arch).scaled_down()
    params = init_state(jax.random.PRNGKey(0), cfg, jnp.float32, jnp.float32)["params"]
    sign = _signs(params)["rand"]
    moved = jax.tree.map(lambda p, s: np.asarray(jnp.nextafter(p, s * jnp.inf)), params, sign)
    want = convert.params_from_numpy(moved, tcfg, "cpu")
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    got = tree_map(lambda p, s: torch.nextafter(p, s * float("inf")), tparams,
                   convert.params_from_numpy(sign, tcfg, "cpu"))
    assert all(torch.equal(g, w) for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    assert all(bool((g != p).all()) for g, p in zip(jax.tree.leaves(got),
                                                     jax.tree.leaves(tparams)))
