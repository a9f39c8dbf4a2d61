"""The dry run's records against the reference's, and the kernel
wrappers' "meta" branch, on the CPU:

- (records) the port's records of `qwen1.5-0.5b-smoke` decode_32k and
  prefill_32k (single: 256 fake ranks, `olive_kv`), traced in a child
  process (`_torch_dist.dryrun_cells`), against the reference's
  committed records in `EXPERIMENTS/dryrun/`: argument and output
  bytes a rank within 1 %, once the leaves named below take the
  reference's counts. Each leaf's reference count is computed from
  the reference's own specs (`params_pspecs`, `cache_pspecs`,
  `_batch_spec` over an `AbstractMesh` of (16, 16)), and their sum is
  the record's argument bytes exactly. The named leaves, with both
  counts:
  - every quantized attention and MLP leaf's codes, and the column-
    parallel ones' scales (a row-parallel weight's scales replicate on
    both sides): the reference's rules name a leaf by its last key,
    which for a QuantizedTensor's fields is ".data" / ".scale", so its
    cell replicates them; the port holds each as its `param_spec` part;
  - `lm_head/w_out` of the tied head: the port holds its part, the
    reference's record has no such argument (its step never reads it);
  - the logits: the port's head gathers the vocab's columns on every
    rank, the reference's stay split over "model".
  Collective kinds are not compared: XLA's all-reduce is the port's
  rank sum.
- (loops) records with every loop of equal iterations traced once on
  "meta" (`launch/mesh.py::loop`) equal the records with every
  iteration traced (`LOOPS_ONCE` off): `qwen1.5-0.5b-smoke` prefill_32k
  at 4 attention blocks of 8192 (olive_kv), `xlstm-350m-smoke` prefill
  of 256 tokens (the mLSTM's 4 chunks and the sLSTM's token loop), and a
  4-microbatch train cell of `qwen1.5-0.5b-smoke` (256 tokens, 4 rows)
  on 8 fake ranks, (1, 8): collectives, their bytes, the memory
  analysis and the roofline equal.
- ("meta") K2, K3 and K4's wrappers on "meta" tensors return their plain
  version's shape and dtype and count no launch; any other device
  raises (K1, K6 and K7 in their own test files).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.ckpt import _flatten as j_flatten
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.launch import specs as jspecs
from repro.models.model import build_model as j_build_model
from repro.sharding import rules as jrules
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import prefill_attn as tpa
from repro_torch.models import layers as tlayers

from _torch_dist import on_other_device, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = "qwen1.5-0.5b-smoke"


def _child(**kw) -> dict:
    """`_torch_dist.dryrun_cells(**kw)` in a child process (it starts a
    fake process group of its own)."""
    code = ("import json, sys, _torch_dist\n"
            "kw = json.loads(sys.argv[1])\n"
            "print(json.dumps(_torch_dist.dryrun_cells(**kw)))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    out = subprocess.run([sys.executable, "-c", code, json.dumps(kw)],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


# ------------------------------------------------------------ records
def _ref_leaf_bytes(arch, shape_name, quant):
    """{"p:" / "c:" / "b:" + path: bytes a rank} of the reference's serve
    cell on a (16, 16) mesh, from its own specs."""
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    cfg, shape = j_get_config(arch), j_get_shape(shape_name)
    rules = jrules.make_rules(cfg, mesh)
    policy = jspecs.serve_policy(quant, n_layers=cfg.n_layers)
    model = j_build_model(cfg, policy, remat=False)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               dtype=jnp.bfloat16))
    params = jax.eval_shape(lambda p: j_quantize_params(p, policy), params)
    caches = jax.eval_shape(lambda: model.init_caches(
        shape.global_batch, shape.seq_len, enc_len=0, dtype=jnp.bfloat16))
    batch, bspecs = jspecs._batch_spec(mesh, rules, cfg, shape, shape.kind)
    out = {}
    for tag, tree, specs in (
            ("p", params, jrules.params_pspecs(params, cfg, mesh)),
            ("c", caches, jrules.cache_pspecs(caches, cfg, mesh)),
            ("b", batch, bspecs)):
        flat_specs = j_flatten(jax.tree_util.tree_map(
            lambda s: s, specs,
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
        for path, leaf in j_flatten(tree).items():
            spec = tuple(flat_specs[path])
            n = leaf.dtype.itemsize
            for dim, entry in zip(leaf.shape, spec + (None,) * leaf.ndim):
                parts = 1
                for a in (entry,) if isinstance(entry, str) else \
                        (entry or ()):
                    parts *= sizes[a]
                n *= dim // parts
            out[f"{tag}:{path}"] = n
    return out


def _site(key: str) -> str:
    """A leaf's key without its layer ("blocks/<j>/", "layers/<i>/") and
    with a quantized field as "data" / "scale"."""
    tag, path = key.split(":", 1)
    parts = path.split("/")
    if parts[0] in ("blocks", "layers"):
        parts = parts[2:]
    return tag + ":" + "/".join(p.lstrip(".") for p in parts)


def _by_site(leaves):
    out = {}
    for key, n in leaves.items():
        out[_site(key)] = out.get(_site(key), 0) + n
    return out


@pytest.fixture(scope="module")
def port_records():
    return _child(cells=[[SMOKE, "decode_32k", "olive_kv", None],
                         [SMOKE, "prefill_32k", "olive_kv", None]])


# the named leaves: (port bytes, reference bytes) a rank, both layers
NAMED = {
    "decode_32k": {
        "p:attn/wq/data": (16, 4096), "p:attn/wk/data": (16, 4096),
        "p:attn/wv/data": (16, 4096), "p:attn/wo/data": (16, 4096),
        "p:attn/wq/scale": (32, 512), "p:attn/wk/scale": (32, 512),
        "p:attn/wv/scale": (32, 512),
        "p:mlp/wg/data": (32, 8192), "p:mlp/wu/data": (32, 8192),
        "p:mlp/wd/data": (32, 8192), "p:mlp/wg/scale": (64, 1024),
        "p:mlp/wu/scale": (64, 1024),
        "p:lm_head/w_out": (256, 0),
    },
}
NAMED["prefill_32k"] = NAMED["decode_32k"]
# logits: (port, reference) bytes a rank: every vocab column on the
# port, 1/16 of them on the reference, f32
LOGITS = {"decode_32k": (8 * 512 * 4, 8 * 32 * 4),
          "prefill_32k": (2 * 512 * 4, 2 * 32 * 4)}
RECORD = os.path.join(REPO, "EXPERIMENTS", "dryrun",
                      f"{SMOKE}__{{}}__single__olive_kv.json")


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_records_match_reference(port_records, shape):
    with open(RECORD.format(shape)) as f:
        want = json.load(f)["memory_analysis"]
    got = port_records[f"{SMOKE}__{shape}__olive_kv"]
    rec = got["record"]
    assert rec["status"] == "ok", rec.get("trace")
    mem = rec["memory_analysis"]
    port, ref = _by_site(got["leaves"]), _by_site(_ref_leaf_bytes(
        SMOKE, shape, "olive_kv"))
    ref.setdefault("p:lm_head/w_out", 0)
    # the reference's leaves sum to its record, less its unread head
    assert sum(ref.values()) - ref["p:lm_head/w_out"] == \
        want["argument_size_per_chip"]
    ref["p:lm_head/w_out"] = 0
    # every other leaf holds the reference's bytes; the named ones their
    # stated counts
    named = NAMED[shape]
    assert set(port) == set(ref), set(port) ^ set(ref)
    assert {k for k in port if port[k] != ref[k]} == set(named)
    assert {k: (port[k], ref[k]) for k in named} == named
    assert sum(port.values()) == mem["argument_size_per_chip"]
    adjusted = mem["argument_size_per_chip"] - sum(
        p - r for p, r in named.values())
    assert abs(adjusted - want["argument_size_per_chip"]) \
        <= 0.01 * want["argument_size_per_chip"]
    logits_port, logits_ref = LOGITS[shape]
    out = mem["output_size_per_chip"] - logits_port + logits_ref
    assert abs(out - want["output_size_per_chip"]) \
        <= 0.01 * want["output_size_per_chip"]
    # the caches are held as `cache_pspecs` parts: the slots over
    # "model" (4 KV heads do not divide 16), the rows over "data"
    assert mem["alias_size_per_chip"] == sum(
        v for k, v in ref.items() if k.startswith("c:"))
    assert rec["collective_ops"]["all-gather"] > 0


# -------------------------------------------------------------- loops
LOOP_CELLS = dict(
    attn=dict(cells=[[SMOKE, "prefill_32k", "olive_kv", None]],
              attn_chunk=8192),
    xlstm=dict(cells=[["xlstm-350m-smoke", "prefill_256", "none", None]],
               extra_shapes={"prefill_256": [256, 32, "prefill"]}),
    train=dict(cells=[[SMOKE, "train_smoke", "none", 4]], world=8,
               mesh_shape=[1, 8],
               extra_shapes={"train_smoke": [256, 4, "train"]}))


@pytest.mark.parametrize("case", sorted(LOOP_CELLS))
def test_loops_traced_once_change_no_record(case):
    got = _child(**LOOP_CELLS[case], both=True)
    once, whole = got["once"], got["whole"]
    assert once.keys() == whole.keys()
    for key in once:
        rec = once[key]["record"]
        assert rec["status"] == "ok", rec.get("trace")
        assert rec == whole[key]["record"]
        assert once[key]["leaves"] == whole[key]["leaves"]
    if case == "train":
        rec = next(iter(once.values()))["record"]
        assert "microbatches=4" in rec["note"]


# --------------------------------------------------------------- meta
def _slab(packed):
    gen = torch.Generator().manual_seed(0)
    if packed:
        return {"k_data": torch.randint(0, 256, (2, 16, 2, 8),
                                        dtype=torch.uint8, generator=gen),
                "v_data": torch.randint(0, 256, (2, 16, 2, 8),
                                        dtype=torch.uint8, generator=gen),
                "k_scl": torch.rand((2, 16, 2), generator=gen) + 0.5,
                "v_scl": torch.rand((2, 16, 2), generator=gen) + 0.5}
    return {"k": torch.randn((2, 16, 2, 16), generator=gen),
            "v": torch.randn((2, 16, 2, 16), generator=gen)}


def _meta(tree):
    return {k: v.to("meta") for k, v in tree.items()}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_attention_on_meta(packed, paged):
    """K2 (slab) and K3 (paged) on "meta": the plain version's shape and
    dtype, no launch; another device raises."""
    cache = _slab(packed)
    if paged:
        cache = dict(cache, block_table=torch.tensor([[1, 0], [0, 1]],
                                                     dtype=torch.int32))
    q = torch.randn((2, 1, 4, 16), generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([5, 11])
    want = tda.fused_decode_attention(q, cache, pos)
    counter = tda.fused_paged_decode_attention if paged \
        else tda.fused_decode_attention
    before = counter.launches
    got = tda.fused_decode_attention(q.to("meta"), _meta(cache),
                                     pos.to("meta"))
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert counter.launches == before
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tda.fused_decode_attention(on_other_device(q), cache, pos)


def test_prefill_attention_on_meta():
    """K4 on "meta": the plain version's output shape and dtype and the
    cache handed back unwritten, no launch; another device raises."""
    cache = tlayers.make_paged_kv_cache(4, 8, 1, 2, 2, 16, kv_bits=4,
                                        device="cpu")
    cache["block_table"][0] = torch.tensor([0, 1], dtype=torch.int32)
    gen = torch.Generator().manual_seed(2)
    cache["stage_k"] = torch.randn((1, 16, 2, 16), generator=gen)
    cache["stage_v"] = torch.randn((1, 16, 2, 16), generator=gen)
    q = torch.randn((1, 8, 4, 16), generator=gen)
    positions = torch.arange(8)[None]
    want, _ = tpa.fused_prefill_attention(q, dict(cache), positions)
    meta = _meta(cache)
    before = tpa.fused_prefill_attention.launches
    got, back = tpa.fused_prefill_attention(q.to("meta"), meta,
                                            positions.to("meta"))
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert back is meta and tpa.fused_prefill_attention.launches == before
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tpa.fused_prefill_attention(on_other_device(q), cache, positions)
