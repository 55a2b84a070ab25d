"""The port's spec engine, meshes and placement against the reference's.

* ``param_specs`` for the four strategies on the meshes (1, 1), (2, 4),
  (16, 16) and (2, 16, 16) with ``pod``, every config at full size: the
  port's shapes from ``init(..., device="meta")`` (per-layer lists), the
  reference's from ``repro.launch.specs.param_shapes`` (stacked).  A
  per-layer leaf's spec with its list's ``LayerSpecs.layer`` in front
  equals the reference's stacked spec, for every layer.
* ``cache_specs`` (GQA, SWA, SSM and hybrid caches; MLA's one latent
  buffer by the port's rule), ``data_specs``, ``batch_spec``, the
  ``fix_spec`` property of ``tests/test_dist.py`` and its equality with
  the reference's, ``Placement`` / ``to_placement`` equal to the
  reference's (``tests/test_dist.py``'s ``TestPlacement`` cases).
* The spec engine reads only ``.shape`` / ``.axis_names``, so both
  packages get the same ``SimpleNamespace`` meshes.
* Meshes and ``place``: ``make_mesh_for`` / ``make_production_mesh`` /
  ``make_smoke_mesh`` shapes, a repeated device, and ``place`` routing a
  pipeline layout over two distinct devices (``cpu`` and ``meta``) while
  refusing every other layout there.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import placement as jplace  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import placement as tplace  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.ft.elastic import make_mesh_for  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

MESHES = {
    "1x1": SimpleNamespace(shape={"data": 1, "model": 1}, axis_names=("data", "model")),
    "2x4": SimpleNamespace(shape={"data": 2, "model": 4}, axis_names=("data", "model")),
    "16x16": SimpleNamespace(shape={"data": 16, "model": 16}, axis_names=("data", "model")),
    "2x16x16": SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16},
                               axis_names=("pod", "data", "model")),
}
CPU, META = torch.device("cpu"), torch.device("meta")


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference ShapeDtypeStruct tree, port meta-tensor tree) at full size."""
    cfg = get_config(arch)
    model = tencdec if cfg.is_enc_dec else ttf
    port = model.init(cfg, generator=torch.Generator(), dtype=torch.float32, device="meta")
    return jspecs.param_shapes(jget_config(arch)), port


def _ref_flat(tree, specs):
    """{dict-key path: (ndim, spec tuple)} of the reference's trees."""
    shapes = {jax.tree_util.keystr(k): v.shape
              for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jax.tree_util.keystr(k): (len(shapes[jax.tree_util.keystr(k)]), tuple(s))
            for k, s in flat}


def _port_flat(specs, lead=None, path="", out=None):
    """{dict-key path: [full spec of each layer]}: a list's layer entry in
    front of each per-layer spec, the reference's stacked spec."""
    out = {} if out is None else out
    if isinstance(specs, dict):
        for k, v in specs.items():
            _port_flat(v, lead, f"{path}['{k}']", out)
    elif isinstance(specs, tsh.LayerSpecs):
        for v in specs:
            _port_flat(v, (specs.layer,), path, out)
    else:
        out.setdefault(path, []).append(specs if lead is None else lead + specs)
    return out


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("strategy", list(tsh.SHARDING_STRATEGIES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal(arch, strategy, mesh):
    m = MESHES[mesh]
    ref_tree, port_tree = _shapes(arch)
    want = _ref_flat(ref_tree, jsh.param_specs(ref_tree, m, strategy))
    got = _port_flat(tsh.param_specs(port_tree, m, strategy))
    assert set(got) == set(want)
    for path, (ndim, spec) in want.items():
        layers = got[path]
        assert all(_pad(s, ndim) == _pad(spec, ndim) for s in layers), (path, layers[0], spec)
    blocks = "decoder" if get_config(arch).is_enc_dec else "blocks"
    specs = tsh.param_specs(port_tree, m, strategy)
    n = len(port_tree[blocks])
    expect = tsh.fix_spec((tsh.MDL,), (n,), m)[0] if strategy == "pipeline" else None
    assert specs[blocks].layer == expect


def test_param_specs_refuses_unknown_strategy():
    with pytest.raises(ValueError, match="unknown sharding strategy"):
        tsh.param_specs({"w": torch.zeros(2, 2)}, MESHES["1x1"], "nope")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3_0p6b", "mixtral_8x22b", "mamba2_2p7b",
                                  "zamba2_2p7b", "seamless_m4t_large_v2"])
def test_cache_specs_equal(arch, mesh):
    """The caches whose trees match the reference's leaf for leaf (the
    port's ``len`` is a host int, the reference's a stacked array: both
    replicate; the enc-dec decoder's caches sit under ``blocks`` in the
    port, at the top in the reference)."""
    m = MESHES[mesh]
    cfg = get_config(arch)
    model = tencdec if cfg.is_enc_dec else ttf
    port = model.init_caches(cfg, 32, 4096, torch.float32, "meta")
    ref = jspecs.cache_shapes(jget_config(arch), 32, 4096)
    want = _ref_flat(ref, jsh.cache_specs(ref, m))
    got = _port_flat(tsh.cache_specs(port, m))
    if cfg.is_enc_dec:
        got = {k.removeprefix("['blocks']"): v for k, v in got.items()}
    assert set(got) == set(want)
    for path, (ndim, spec) in want.items():
        assert all(_pad(s, ndim) == _pad(spec, ndim) for s in got[path]), path


def test_cache_specs_mla_latent():
    """MLA's cache is one (B, T, r + dr) latent buffer in the port (the
    reference keeps ``ckv`` and ``k_rope``): batch over the data axes,
    nothing on 'model', as the reference's rule gives both its leaves."""
    caches = ttf.init_caches(get_config("deepseek_v2_236b"), 32, 4096, torch.float32, "meta")
    for name, m in MESHES.items():
        specs = tsh.cache_specs(caches, m)
        assert specs["blocks"].layer is None
        want = (tsh._dp(m),) + (None, None)
        assert all(s["kv"] == tsh.fix_spec(want, (32, 4096, 1), m) and s["len"] == ()
                   for s in specs["blocks"]), name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_data_and_batch_specs_equal(mesh):
    m = MESHES[mesh]
    shapes = {"tokens": (64, 4097), "embeds": (64, 256, 8192), "frames": (3, 24, 64),
              "scalar": ()}
    ref = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}
    port = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    want = jsh.data_specs(ref, m)
    got = tsh.data_specs(port, m)
    assert {k: tuple(v) for k, v in want.items()} == got
    for ndim in (1, 2, 4):
        assert tsh.batch_spec(m, ndim) == tuple(jsh.batch_spec(m, ndim))
    assert tsh.dp_axes(m) == jsh.dp_axes(m) and tsh._dp(m) == jsh._dp(m)


def test_fix_spec_always_legal_and_equal():
    """tests/test_dist.py's property on the port's fix_spec, and the same
    result as the reference's for every drawn spec."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=100, deadline=None)
    @given(dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
           data=st.sampled_from([1, 2, 3, 4, 8]),
           model=st.sampled_from([1, 2, 4, 5, 16]),
           seed=st.integers(0, 100))
    def check(dims, data, model, seed):
        mesh = SimpleNamespace(shape={"data": data, "model": model},
                               axis_names=("data", "model"))
        rng = np.random.default_rng(seed)
        entries = [None, "data", "model", ("data", "model"), ("model", "data"), "pod"]
        spec = tuple(entries[rng.integers(len(entries))] for _ in dims)
        seen, deduped = set(), []
        for s in spec:  # a spec uses each axis once
            axes = s if isinstance(s, tuple) else (s,)
            if s is None or not seen.isdisjoint(axes):
                deduped.append(None)
            else:
                seen.update(axes)
                deduped.append(s)
        fixed = tsh.fix_spec(tuple(deduped), tuple(dims), mesh)
        assert fixed == jsh.fix_spec(tuple(deduped), tuple(dims), mesh)
        assert len(fixed) == len(dims)
        for d, s in zip(dims, fixed):
            assert d % tsh._axis_size(mesh, s) == 0
        assert tsh.fix_spec(fixed, tuple(dims), mesh) == fixed  # a fixpoint

    check()


# ---------------------------------------------------------------------------
# Placement / to_placement (tests/test_dist.py's TestPlacement)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["1x1", "2x4"])
@pytest.mark.parametrize("strategy", jstrat.STRATEGIES)
def test_to_placement_equal(strategy, mesh):
    m = MESHES[mesh]
    jg, tg = jgraph.resnet18_graph(), tgraph.resnet18_graph()
    jp, tp = jstrat.make_plan(jg, strategy, 4), tstrat.make_plan(tg, strategy, 4)
    for kw in ({}, dict(num_microbatches=4, schedule="1f1b")):
        want = jplace.to_placement(jp, m, **kw)
        got = tplace.to_placement(tp, m, **kw)
        assert got == tplace.Placement(**vars(want))
        assert got.strategy == strategy
        if strategy == "pipeline":
            assert got.pipeline_stages == m.shape["model"]
    # with a config graph: the plan's cuts re-balanced onto the mesh
    jcg = jgraph.config_graph(jget_config("qwen3_0p6b"), 256)
    tcg = tgraph.config_graph(get_config("qwen3_0p6b"), 256)
    jpl = jsched.rebalance(jcg, jstrat.make_plan(jcg, strategy, 4), {0: 0.25, 1: 1.0})
    tpl = tsched.rebalance(tcg, tstrat.make_plan(tcg, strategy, 4), {0: 0.25, 1: 1.0})
    want = jplace.to_placement(jpl, m, 4, graph=jcg)
    assert tplace.to_placement(tpl, m, 4, graph=tcg) == tplace.Placement(**vars(want))


def test_pipeline_plan_boundaries_without_graph():
    """A bare to_placement(plan, mesh) keeps a rebalanced plan's uneven
    cuts: the layer count comes from the plan's own op names."""
    kw = dict(num_layers=8, d_model=64, num_heads=4, kv_heads=2, d_ff=128, vocab=1000,
              seq_len=128)
    jtg, ttg = jgraph.transformer_graph("t", **kw), tgraph.transformer_graph("t", **kw)
    rates = {0: 0.25, 1: 1.0, 2: 1.0, 3: 1.0}
    jp = jsched.rebalance(jtg, jstrat.make_plan(jtg, "pipeline", 4), rates)
    tp = tsched.rebalance(ttg, tstrat.make_plan(ttg, "pipeline", 4), rates)
    mesh = SimpleNamespace(shape={"data": 1, "model": 4})
    got = tplace.to_placement(tp, mesh)
    assert got == tplace.Placement(**vars(jplace.to_placement(jp, mesh)))
    depths = np.diff(got.layer_boundaries)
    assert got.layer_boundaries[0] == 0 and got.layer_boundaries[-1] == 8
    assert depths[0] < depths.max()  # the straggler's short stage survived


@pytest.mark.parametrize("strategy", jstrat.STRATEGIES)
def test_placement_param_specs_equal(strategy):
    """Placement.param_specs goes through the port's spec engine: equal to
    the reference's on the fake 2x4 mesh, and every spec a fix_spec
    fixpoint."""
    jg, tg = jgraph.resnet18_graph(), tgraph.resnet18_graph()
    m = MESHES["2x4"]
    jpl = jplace.to_placement(jstrat.make_plan(jg, strategy, 4), m)
    tpl = tplace.to_placement(tstrat.make_plan(tg, strategy, 4), m)
    jc, tc = jget_config("qwen3_0p6b").scaled_down(), get_config("qwen3_0p6b").scaled_down()
    ref = jspecs.param_shapes(jc)
    port = ttf.init(tc, generator=torch.Generator(), dtype=torch.float32, device="meta")
    want = _ref_flat(ref, jpl.param_specs(ref, m))
    got = _port_flat(tpl.param_specs(port, m))
    assert set(got) == set(want)
    for path, (ndim, spec) in want.items():
        assert all(_pad(s, ndim) == _pad(spec, ndim) for s in got[path]), path
        for s in got[path]:
            assert tsh.fix_spec(_pad(s, ndim), (4,) * ndim, m) == _pad(s, ndim)


# ---------------------------------------------------------------------------
# meshes and place
# ---------------------------------------------------------------------------


def test_make_mesh_for_shapes():
    """The reference's rule: the largest power-of-two model axis <= sqrt(n),
    the rest on data; a device may be listed more than once."""
    for n in range(1, 17):
        mesh = make_mesh_for([CPU] * n)
        model = 1
        while model * 2 <= int(n ** 0.5):
            model *= 2
        assert mesh.shape == {"data": n // model, "model": model}
        assert mesh.axis_names == ("data", "model")
        assert mesh.distinct_devices() == [CPU]
    mesh = make_mesh_for([CPU] * 4, model_axis=4)
    assert mesh.shape == {"data": 1, "model": 4} and tsh.stage_devices(mesh) == [CPU] * 4
    with pytest.raises(ValueError, match="no devices"):
        make_mesh_for([])


def test_production_and_smoke_meshes():
    with pytest.raises(ValueError, match=r"must be >= the product of mesh_shape \(16, 16\)"):
        tmesh.make_production_mesh(devices=[CPU])
    assert tmesh.make_production_mesh(devices=[CPU] * 256).shape == {"data": 16, "model": 16}
    pod = tmesh.make_production_mesh(multi_pod=True, devices=[CPU] * 600)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert pod.size == 512
    assert tmesh.make_smoke_mesh(2, 4, devices=[CPU] * 3).shape == {"data": 2, "model": 1}
    assert tmesh.make_smoke_mesh(1, 2, devices=[CPU] * 4).shape == {"data": 1, "model": 2}
    assert tmesh.mesh_devices(CPU) == [CPU]
    assert tmesh.mesh_devices(torch.device("cuda", 3)) == [torch.device("cuda", 3)]


def _tiny_params():
    cfg = get_config("qwen3_0p6b").scaled_down(num_layers=4, d_model=32, vocab=64)
    return ttf.init(cfg, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
                    device="cpu")


@pytest.mark.parametrize("strategy", list(tsh.SHARDING_STRATEGIES))
def test_place_on_one_device_is_identity(strategy):
    params = _tiny_params()
    mesh = make_mesh_for([CPU] * 4)
    placed = tsh.place(params, tsh.param_specs(params, mesh, strategy), mesh)
    assert all(a is b for a, b in zip(_leaves(placed), _leaves(params)))
    caches = ttf.init_caches(get_config("qwen3_0p6b").scaled_down(num_layers=4, d_model=32,
                                                                   vocab=64), 2, 8,
                             torch.float32, "cpu")
    placed = tsh.place(caches, tsh.cache_specs(caches, mesh), mesh)
    assert placed["blocks"][0]["len"] == 0
    assert all(a is b for a, b in zip(_leaves(placed), _leaves(caches)))


def _leaves(tree):
    from repro_torch.tree import leaves

    return leaves(tree)


def test_place_pipeline_over_distinct_devices():
    """Two stages on two distinct devices (the CPU and ``meta``): each
    stage's contiguous half of the block list goes to its device, the
    rest to stage 0's; scatter_gather's replicas go once to the row's
    first device; a tensor split over 'model' there is refused, and so is
    one process on a data axis over distinct devices.  With a data group
    (one process per data position) each process places its row: process
    1 of the (2, 1) mesh holds its FSDP slices on ``meta``."""
    from repro_torch.dist.collective import DataGroup

    params = _tiny_params()
    mesh = tsh.Mesh(np.array([CPU, META], dtype=object).reshape(1, 2), ("data", "model"))
    assert tsh.stage_devices(mesh) == [CPU, META]
    placed = tsh.place(params, tsh.param_specs(params, mesh, "pipeline"), mesh)
    devs = [{leaf.device for leaf in _leaves(layer)} for layer in placed["blocks"]]
    assert devs == [{CPU}, {CPU}, {META}, {META}]
    assert placed["embed"]["table"].device == CPU
    replicas = tsh.place(params, tsh.param_specs(params, mesh, "scatter_gather"), mesh)
    assert all(leaf.device == CPU for leaf in _leaves(replicas))
    for strategy in ("ai_core_assignment", "fused"):
        # one process over distinct devices: refused, naming the torchrun
        # command that runs one process per mesh position
        with pytest.raises(NotImplementedError,
                           match=r"item 16.*torchrun --nproc-per-node 2 \(--strategy"):
            tsh.place(params, tsh.param_specs(params, mesh, strategy), mesh)
    data = tsh.Mesh(np.array([CPU, META], dtype=object).reshape(2, 1), ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 16"):
        tsh.place(params, tsh.param_specs(params, data, "pipeline"), data)
    with pytest.raises(NotImplementedError, match="item 16"):
        tsh.stage_devices(data)
    specs = tsh.param_specs(params, data, "fused")
    shards = _leaves_of(tsh.data_shards(specs, data))
    mine = tsh.place(params, specs, data, group=DataGroup(1, 2, "gloo"))
    for leaf, whole, shard in zip(_leaves(mine), _leaves(params), shards):
        assert leaf.device == META
        want = list(whole.shape)
        if shard is not None:
            want[shard[0]] //= 2
        assert list(leaf.shape) == want
    assert any(s is not None for s in shards)
    with pytest.raises(ValueError, match="2 data positions"):
        tsh.local_mesh(data, None)


def _leaves_of(shards):
    from repro_torch.dist.collective import _shard_leaves

    return _shard_leaves(shards)
