"""`sharding/axes.py` and `launch/specs.py` against the reference's, on
the CPU, in one process (no process group: a stand-in `Mesh` at a given
rank, which is all the cell builders read):

- `resolve` gives the reference's `PartitionSpec` (as a tuple) for a
  set of logical name tuples under every arch's `make_rules` (default,
  long context, and at train_4k's global batch, which may turn dp_only
  on), on meshes (1, 2), (2, 2) and (2, 16, 16); `logical_sharding`
  is `resolve`'s spec; `logical` is the identity outside a mesh and,
  inside one, returns the tensor itself or raises the reference's
  ValueError on a rank mismatch.
- Per-rank shard shapes: `build_train_cell`'s state cut to rank r's
  parts (`Placement.local`, then `convert.state_to_reference` on
  "meta") equals, leaf by leaf, the reference's `NamedSharding(mesh,
  spec).shard_shape(global_shape)` of its own cell over the 8 forced CPU
  devices of `conftest.py`, on a (2, 4) and a (2, 2, 2) mesh, for the
  dense (dp_only), MoE (the TP and EP rules) and xLSTM (TP) smoke archs;
  the cells' notes and model FLOPs are the reference's.
  `build_serve_cell`'s KV caches and this rank's rows equal the
  reference's cache shard shapes (the serving path splits a cache by
  KV head, or its slots where the heads do not divide, as
  `cache_pspecs`; it splits a packed cache's scales with its codes'
  heads). The reference's cell replicates its attention and MLP
  quantized weights (its rules cannot name a QuantizedTensor's
  fields); the port holds every quantized weight as its `param_spec`
  part (`backends/sharded.py::local_shard`).
- `microbatches_for` and `serve_policy` by the reference's names.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.launch import specs as jspecs
from repro.sharding import axes as jaxes
from repro.sharding import rules as jrules
from repro.checkpoint.ckpt import _flatten as j_flatten
from repro_torch import convert
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs import get_config, get_shape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.sharding import axes
from repro_torch.sharding import rules as trules
from repro_torch.sharding import state as placement

from _torch_dist import one_torch_thread  # noqa: F401

MESHES = {(1, 2): ("data", "model"), (2, 2): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
NAMES = [("batch", "seq", "embed"), ("batch", "seq", "heads", None),
         ("batch", None, "kv_heads", None), ("expert", "expert_cap", "embed"),
         ("batch", "seq", "vocab"), ("seq", "batch"), ("embed", "ffn"),
         ("batch", "batch"), ("unknown", "heads"), (None,),
         ("ffn", "heads"), ("batch", "expert_cap"), ("vocab", "embed"),
         ()]


def _jmesh(shape, names):
    try:
        return jax.sharding.AbstractMesh(tuple(zip(names, shape)))
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(shape), names)


class StandIn(mesh_lib.Mesh):
    """A `Mesh` at rank `rank` of `shape` with no process group: what the
    cell builders read (axis names, sizes, this rank's coordinates)."""

    def __init__(self, shape, names, rank):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.rank = rank
        self.coords = {a: int(c) for a, c in
                       zip(names, np.unravel_index(rank, shape))}
        self.backend, self.groups = None, {}


@pytest.mark.parametrize("shape", list(MESHES), ids=str)
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_resolve_matches_reference_under_every_rule_set(arch, shape):
    names = MESHES[shape]
    cfg, jcfg = get_config(arch), j_get_config(arch)
    sizes = dict(zip(names, shape))
    for kw in ({}, {"long_context": True}, {"global_batch": 256}):
        rules = trules.make_rules(cfg, sizes, **kw)
        jr = jrules.make_rules(jcfg, _jmesh(shape, names), **kw)
        for n in NAMES:
            assert tuple(axes.resolve(n, rules)) == \
                tuple(jaxes.resolve(n, jr)), (kw, n)
            assert axes.logical_sharding(None, rules, *n) == \
                axes.resolve(n, rules)


def test_logical_is_a_checked_identity():
    x = torch.zeros((2, 3, 4))
    assert axes.logical(x, "batch", "seq") is x          # no mesh
    assert axes.current() is None
    rules = {"batch": "data"}
    mesh = StandIn((2, 2), ("data", "model"), 0)
    with axes.axis_rules(mesh, rules):
        assert axes.current() == (mesh, rules)
        assert axes.logical(x, "batch", "seq", "embed") is x
        with pytest.raises(ValueError) as got:
            axes.logical(x, "batch", "seq")
        with jaxes.axis_rules(_jmesh((2, 2), ("data", "model")), rules):
            with pytest.raises(ValueError) as want:
                jaxes.logical(jax.numpy.zeros((2, 3, 4)), "batch", "seq")
        assert str(got.value) == str(want.value)
        assert axes.batch_split(rules, mesh) == ("data",)
    assert axes.current() is None
    with axes.reentered((mesh, rules)):
        assert axes.current() == (mesh, rules)
    with axes.reentered(None):
        assert axes.current() is None


def _ref_shard_shapes(cell, which: int):
    """{path: shard shape} of the reference cell's argument `which`."""
    sds = j_flatten(cell.args_sds[which])
    sh = j_flatten(cell.in_shardings[which])
    return {k: tuple(sh[k].shard_shape(v.shape)) for k, v in sds.items()}


TRAIN_MESHES = [((2, 4), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model"))]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b-smoke",
                                  "qwen3-moe-30b-a3b-smoke",
                                  "xlstm-350m-smoke"])
@pytest.mark.parametrize("mesh", TRAIN_MESHES, ids=["2x4", "2x2x2"])
def test_train_cell_shard_shapes_match_reference(forced_devices, arch,
                                                 mesh):
    shape, names = mesh
    jcell = jspecs.build_train_cell(arch, "train_4k",
                                    jax.make_mesh(shape, names))
    want = _ref_shard_shapes(jcell, 0)
    cfg = get_config(arch)
    for rank in (0, 7):
        cell = specs.build_train_cell(arch, "train_4k",
                                      StandIn(shape, names, rank))
        local = cell.placement.local(cell.args[0])
        got = {k: tuple(v.shape) for k, v in flatten(
            convert.state_to_reference(local, cfg)).items()}
        assert got == want, rank
        assert cell.note == jcell.note
        assert cell.model_flops == jcell.model_flops
        assert cell.n_chips == 8
        # the batch: this rank's rows of the global one
        rows = specs._local_batch(cell.args[1], cell.in_specs[1],
                                  cell.mesh)["tokens"].shape
        assert tuple(rows) == _ref_shard_shapes(jcell, 1)["tokens"]


@pytest.mark.parametrize("arch,quant", [("qwen1.5-0.5b-smoke", "olive_kv"),
                                        ("qwen3-moe-30b-a3b-smoke",
                                         "olive")])
def test_serve_cell_caches_and_weights_match_reference(forced_devices,
                                                       arch, quant):
    shape, names = (2, 4), ("data", "model")
    jcell = jspecs.build_serve_cell(arch, "decode_32k",
                                    jax.make_mesh(shape, names), quant=quant)
    cell = specs.build_serve_cell(arch, "decode_32k",
                                  StandIn(shape, names, 5), quant=quant)
    # caches: the port's layer 0 against the reference's stack 0, less
    # its group dim
    want = {k[len("blocks/0/"):]: v[1:] for k, v in
            _ref_shard_shapes(jcell, 1).items() if k.startswith("blocks/0/")}
    got = {k[len("layers/0/"):]: tuple(v.shape) for k, v in
           flatten(cell.args[1]).items() if k.startswith("layers/0/")}
    # the serving path splits a cache as the reference's `cache_pspecs`
    # does (the sharded backend's `make_kv_site`: by KV head, or where
    # the heads do not divide, its slots over "model"); where it splits
    # the heads, a packed cache's per-token scales (B, S, H) go with the
    # codes' heads, where the reference keeps every head's on each rank
    jc = j_flatten(jax.tree_util.tree_map(lambda s: s.spec,
                                          jcell.in_shardings[1]))
    tp = shape[1]
    for k, v in want.items():
        spec = jc[f"blocks/0/{k}"]
        if k.endswith("_scl") and spec[-2] != "model":
            v = v[:-1] + (v[-1] // tp,)
        want[k] = v
    assert got == want
    # this rank's rows of the batch
    batch = specs._local_batch(cell.args[2], cell.in_specs[2], cell.mesh)
    assert tuple(batch["tokens"].shape) == \
        _ref_shard_shapes(jcell, 2)["tokens"]
    # quantized weights: the reference's cell replicates the attention
    # and MLP ones (its rules name a leaf by its last key, which for a
    # QuantizedTensor's fields is ".data" / ".scale", so only the
    # expert rule, which reads the path, matches); the serving path
    # holds each as its `param_spec` part (`local_shard`): "model" on a
    # column-parallel weight's N, a row-parallel one's packed K, an
    # expert stack's E, and "data" (FSDP) on the other dim
    jspec = j_flatten(jax.tree_util.tree_map(
        lambda s: s.spec, jcell.in_shardings[0]))
    jsds = j_flatten(jcell.args_sds[0])
    layer = cell.args[0]["layers"][0]
    moe = "moe" in layer
    sizes = dict(zip(names, shape))
    for leaf in ("attn/wq", "attn/wo",
                 "moe/experts/wg" if moe else "mlp/wg"):
        node = layer
        for k in leaf.split("/"):
            node = node[k]
        key = f"blocks/0/{leaf}/.data"
        if not leaf.startswith("moe"):      # experts: E over "model"
            assert all(e is None for e in jspec[key]), (leaf, jspec[key])
        whole = tuple(jsds[key].shape[1:])
        spec = trules.param_spec(f"layers/0/{leaf}/data", whole,
                                 get_config(arch), sizes)
        assert tuple(node.data.shape) == placement.local_shape(
            whole, spec, cell.mesh), leaf
        assert any(e == "model" for e in spec) and \
            any(e == "data" for e in spec), (leaf, spec)


def test_microbatches_and_serve_policies_match_reference():
    for arch in ("qwen1.5-0.5b", "qwen2-7b", "qwen3-moe-30b-a3b",
                 "xlstm-350m"):
        for shape in ("train_4k", "decode_32k"):
            assert specs.microbatches_for(get_config(arch),
                                          get_shape(shape)) == \
                jspecs.microbatches_for(j_get_config(arch),
                                        j_get_shape(shape))
    for quant in ("none", "olive", "olive_kv", "olive_w8"):
        got, want = specs.serve_policy(quant), jspecs.serve_policy(quant)
        for f in ("method", "wbits", "abits", "kv_bits", "w_normal_dtype",
                  "compute_dtype"):
            assert getattr(got, f) == getattr(want, f), (quant, f)
    with pytest.raises(ValueError):
        specs.serve_policy("nope")
