"""The port's mesh planning and sharding rules against the reference.

`runtime/elastic.py` (`plan_mesh`, `resize_plan`) and
`sharding/rules.py` (`param_spec`, `params_pspecs`, `cache_pspecs`,
`make_rules`, `use_dp_only`, `mesh_axis_sizes`) are pure shape logic:
the same inputs must give the reference's answers, a `PartitionSpec`
compared as a tuple. The leaves are the reference's own, from
`jax.eval_shape` of its init and of its cache makers, for every `--arch`
on meshes (1, 2), (2, 2), (4, 2) and (16, 16); the reference takes a
sizes dict, so no devices are needed. Also: `launch/mesh.py`'s
collective-backend rule and its mesh shapes, on one process.
"""
from __future__ import annotations

import dataclasses

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models.model import build_model as j_build_model
from repro.runtime import elastic as jel
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import elastic as tel
from repro_torch.sharding import rules as trules

from _torch_dist import one_torch_thread  # noqa: F401

MESHES = [(1, 2), (2, 2), (4, 2), (16, 16)]


def _sizes(shape):
    return dict(zip(("data", "model"), shape))


def _jmesh(shape):
    """The reference's rules read a mesh: an AbstractMesh needs no
    devices (jax 0.4.x takes ((name, size), ...), later versions
    (sizes, names))."""
    axes = ("data", "model")
    try:
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(shape), axes)


def _key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _leaves(tree):
    """(path as strings, shape) of every leaf of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(_key(k) for k in kp), tuple(leaf.shape))
            for kp, leaf in flat]


_SHAPES = {}


def _reference_shapes(arch):
    """The reference's abstract params and caches of `arch`."""
    if arch not in _SHAPES:
        model = j_build_model(j_get_config(arch),
                              JQuantPolicy(compute_dtype="float32"),
                              remat=False)
        params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
        caches = jax.eval_shape(lambda: model.init_caches(8, 64))
        _SHAPES[arch] = params, caches
    return _SHAPES[arch]


def test_archs_match():
    assert sorted(ARCHS) == sorted(J_ARCHS)


# ----------------------------------------------------------- elastic plans
@pytest.mark.parametrize("prefer_model", [1, 2, 4, 8, 16])
def test_plan_mesh_and_resize_match_reference(prefer_model):
    for n in range(1, 1025):
        got = tel.plan_mesh(n, prefer_model=prefer_model)
        ref = jel.plan_mesh(n, prefer_model=prefer_model)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref), n
        assert got.n_devices == ref.n_devices
    for old_n, new_n in [(512, 256), (256, 512), (256, 248), (16, 12),
                         (8, 6), (1024, 1000)]:
        got = tel.resize_plan(tel.plan_mesh(old_n, prefer_model), new_n)
        ref = jel.resize_plan(jel.plan_mesh(old_n, prefer_model), new_n)
        assert dataclasses.astuple(got.pop("new_plan")) == \
            dataclasses.astuple(ref.pop("new_plan"))
        assert got == ref


def test_plan_mesh_reference_cases():
    """The reference's own case (tests/test_integration_runtime.py) and
    the no-device error."""
    p = tel.plan_mesh(512, prefer_model=16)
    assert p.n_devices == 512 and p.axis_names == ("pod", "data", "model")
    r = tel.resize_plan(p, 256)
    assert r["new_plan"].n_devices == 256 and r["needs_reshard"]
    with pytest.raises(ValueError, match="no devices"):
        tel.plan_mesh(0)


def test_global_batch_caps_data_axis():
    for gb in (1, 6, 96, 100):
        for n in (12, 48, 96, 200):
            got = tel.plan_mesh(n, global_batch=gb)
            ref = jel.plan_mesh(n, global_batch=gb)
            assert dataclasses.astuple(got) == dataclasses.astuple(ref)


# -------------------------------------------------------------- the rules
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh):
    params, _ = _reference_shapes(arch)
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    sizes = _sizes(mesh)
    for dp_only in (False, True):
        for path, shape in _leaves(params):
            ref = jrules.param_spec(path, shape, jcfg, sizes, dp_only)
            got = trules.param_spec(path, shape, tcfg, sizes, dp_only)
            assert got == tuple(ref), (path, shape, dp_only)
            # a "/"-joined address gives the same spec
            assert trules.param_spec("/".join(path), shape, tcfg, sizes,
                                     dp_only) == got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch, mesh):
    _, caches = _reference_shapes(arch)
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    sizes = _sizes(mesh)
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), caches)
    for long_context in (False, True):
        ref = jrules.cache_pspecs(caches, jcfg, _jmesh(mesh),
                                  long_context=long_context)
        got = trules.cache_pspecs(meta, tcfg, sizes,
                                  long_context=long_context)
        ref_flat = jax.tree_util.tree_leaves(
            ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got_flat = jax.tree_util.tree_leaves(
            got, is_leaf=lambda x: isinstance(x, trules.Spec))
        assert [tuple(s) for s in ref_flat] == got_flat


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_make_rules_and_dp_only_match_reference(arch, mesh):
    tcfg, jcfg = get_config(arch), j_get_config(arch)
    sizes, jm = _sizes(mesh), _jmesh(mesh)
    plan = tel.MeshPlan(mesh, ("data", "model"), 0)
    for gb in (None, 7, 256, 1024):
        want = jrules.use_dp_only(jcfg, jm, gb)
        assert trules.use_dp_only(tcfg, sizes, gb) == want
        assert trules.use_dp_only(tcfg, plan, gb) == want
        for long_context in (False, True):
            assert trules.make_rules(tcfg, sizes, long_context, gb) == \
                jrules.make_rules(jcfg, jm, long_context, gb)


def test_port_params_pspecs_unrolled_layout():
    """The port's own unrolled tree (meta tensors) gets the reference's
    spec of each layer's stacked leaf, less its layer-group dim; a
    quantized leaf's data and scale split with their weight."""
    sizes = {"data": 2, "model": 2}
    for arch in ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "xlstm-350m"):
        from repro_torch.models.model import build_model
        cfg = get_config(arch)
        model = build_model(cfg, None)
        tree = {}
        for prefix, piece in model.init_stream(None, device="meta"):
            if prefix.startswith("layers/"):
                tree.setdefault("layers", []).append(piece)
            else:
                tree.update(piece)
        specs = trules.params_pspecs(tree, cfg, sizes)
        params, _ = _reference_shapes(arch)
        period = len(cfg.block_pattern)
        ref = {path: shape for path, shape in _leaves(params)}
        jcfg = j_get_config(arch)
        for i in range(period):
            for path, spec in _flat(specs["layers"][i], ("layers", str(i))):
                jpath = ("blocks", str(i)) + path[2:]
                want = jrules.param_spec(jpath, ref[jpath], jcfg, sizes)
                assert spec == tuple(want)[1:], (arch, path)
    qt = QuantizedTensor(data=torch.empty(32, 64, device="meta"),
                         scale=torch.empty(1, 64, device="meta"),
                         normal_dtype="int4", pair_axis=-2, orig_dim=64)
    got = trules.params_pspecs({"attn": {"wq": qt, "wo": qt}}, cfg, sizes)
    assert got["attn"]["wq"] == {"data": ("data", "model"),
                                 "scale": (None, "model")}
    assert got["attn"]["wo"] == {"data": ("model", "data"),
                                 "scale": (None, None)}


def _flat(tree, prefix):
    if isinstance(tree, dict) and not isinstance(tree, trules.Spec):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


# ------------------------------------------------------- mesh axis sizes
def test_mesh_axis_sizes_inputs():
    assert trules.mesh_axis_sizes({"data": 4, "model": 2}) == \
        {"data": 4, "model": 2}
    plan = tel.MeshPlan((4, 2), ("data", "model"), 0)
    assert trules.mesh_axis_sizes(plan) == {"data": 4, "model": 2}
    one = tmesh.make_mesh((1, 1), ("data", "model"))
    assert trules.mesh_axis_sizes(one) == {"data": 1, "model": 1}

    class Legacy:
        shape = (4, 2)
        axis_names = ("data", "model")

    class Bad:
        shape = (4, 2, 1)
        axis_names = ("data", "model")

    assert trules.mesh_axis_sizes(Legacy()) == \
        jrules.mesh_axis_sizes(Legacy())
    for fn in (trules.mesh_axis_sizes, jrules.mesh_axis_sizes):
        with pytest.raises(ValueError, match="do not match"):
            fn(Bad())
        with pytest.raises(AttributeError):
            fn(object())


# ------------------------------------------------------------ launch/mesh
@pytest.mark.parametrize("device,ranks,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 8, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 4, 2, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 8, "nccl")])
def test_collective_backend_rule(device, ranks, cards, want):
    assert tmesh.collective_backend(device, ranks, cards) == want


def test_mesh_shapes_on_one_process():
    assert tmesh.production_plan() == \
        tel.MeshPlan((16, 16), ("data", "model"), 0)
    assert tmesh.production_plan(multi_pod=True) == \
        tel.MeshPlan((2, 16, 16), ("pod", "data", "model"), 0)
    with pytest.raises(ValueError, match="nproc-per-node 256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="nproc-per-node 512"):
        tmesh.make_production_mesh(multi_pod=True)
    m = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert tmesh.batch_axes(m) == ("pod", "data")
    assert tmesh.batch_axes(tmesh.make_mesh((1, 1), ("data", "model"))) \
        == ("data",)
    assert (m.size("model"), m.coord("model"), m.groups) == (1, 0, {})
    x = torch.arange(6.0).reshape(2, 3)
    assert tmesh.all_gather(x, 1, m) is x and tmesh.rank_sum(x, m) is x
