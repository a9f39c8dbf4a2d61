"""Serving on a mesh at the reference's placement, on the CPU, in gloo
ranks (`_torch_dist.mesh_serve`: each rank serves a seeded smoke model
on one rank, then on the mesh, through `Model.forward`, a 6-token
prefill and 8 greedy decode steps):

- sequence-split KV caches, where the KV heads do not divide "model"
  (the reference's `cache_pspecs` then splits the slots over "model"):
  `recurrentgemma-9b-smoke` (1 KV head, an 8-slot ring: the decode
  steps pass its first lap) on (1, 2) and `internvl2-1b-smoke` (2 KV
  heads) on (1, 4), W4 + the packed KV4 slab: logits within 1e-5 of
  one rank's (fp32, scaled by the largest logit), tokens equal, each
  rank's KV bytes 1/tp of one rank's, each rank's slots close to one
  rank's cache at those slots (scales and fp rows within 1e-5, at
  least 99 % of packed code bytes equal: the upstream row-parallel
  sums reassociate), a prefill-sized and a one-token write into a
  rank's slots of a whole cache byte-equal to the whole cache's write
  at those slots (every slot is written on its owner alone), the
  decode attention declined by `shard_hkv_lt_axis` (K2
  serves no part of the slots) and no other fallback; the partial
  attention + rank-order combine over a whole cache cut by slots held
  against the reference's decode attention (`repro.models.layers`, its
  Pallas kernel in interpret mode) on the whole cache, within 1e-5;
- the other placements: `--quant none` at TP 2 (raw column- and
  row-parallel linears through `torch.matmul`, the tied table looked up
  and applied vocab-parallel) on the tied `qwen1.5-0.5b-smoke` and the
  untied `qwen2-7b-smoke` (a raw vocab-split head), and W4 + KV4 on a
  (2, 2) mesh (every weight's FSDP part gathered over "data", the
  quantized head vocab-split): tokens equal, logits within 1e-5, and
  every leaf held at `local_shape(param_spec)` of its whole shape.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models import layers as jlayers

from _torch_dist import one_torch_thread, spawn  # noqa: F401

W4KV4 = {"method": "olive", "wbits": 4, "kv_bits": 4}
NONE = {}
CASES2 = {"rg-seq": ("recurrentgemma-9b-smoke", W4KV4, (1, 2)),
          "qwen-none-tp2": ("qwen1.5-0.5b-smoke", NONE, (1, 2)),
          "qwen2-none-tp2": ("qwen2-7b-smoke", NONE, (1, 2))}
CASES4 = {"vlm-seq": ("internvl2-1b-smoke", W4KV4, (1, 4)),
          "qwen2-w4-2x2": ("qwen2-7b-smoke", W4KV4, (2, 2))}


def _spawn(world, cases, tmp):
    res = spawn(world, [(name, "mesh_serve", dict(arch=a, policy=p,
                                                   shape=s))
                        for name, (a, p, s) in cases.items()], tmp)
    for rank in res:
        for name in cases:
            assert not isinstance(rank[name], str), rank[name]
    return res


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return _spawn(2, CASES2, tmp_path_factory.mktemp("mesh2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn(4, CASES4, tmp_path_factory.mktemp("mesh4"))


def _result(request, name):
    fixture = "ranks2" if name in CASES2 else "ranks4"
    return [r[name] for r in request.getfixturevalue(fixture)]


def _same_serving(res):
    for r in res:
        one, mesh = r["one"], r["mesh"]
        np.testing.assert_array_equal(mesh["tokens"], one["tokens"])
        tol = 1e-5 * max(1.0, float(np.abs(one["logits"]).max()))
        assert np.abs(mesh["logits"] - one["logits"]).max() <= tol
        assert not [k for k in mesh["stats"] if "fallback:shard_" in k
                    and "hkv_lt_axis" not in k], mesh["stats"]


@pytest.mark.parametrize("name", ["rg-seq", "vlm-seq"])
def test_sequence_split_caches_match_one_rank(request, name):
    res = _result(request, name)
    tp = CASES2.get(name, CASES4.get(name))[2][1]
    _same_serving(res)
    for rank, r in enumerate(res):
        one, mesh = r["one"], r["mesh"]
        assert mesh["kv_bytes"] * tp == one["kv_bytes"]
        assert mesh["slots"] and all(p is not None
                                     for p in mesh["slots"].values())
        for site, (first, count, length, axes) in mesh["slots"].items():
            assert axes == ("model",) and count * tp == length
            assert first == rank * count
            for path, part in mesh["kv"].items():
                if not path.startswith(site + "/"):
                    continue
                want = one["kv"][path][:, first:first + count]
                if part.dtype == np.uint8:
                    # packed codes: the 3σ scale may move by an ulp
                    assert np.mean(part == want) >= 0.99, path
                else:
                    np.testing.assert_allclose(part, want, rtol=1e-5,
                                               atol=1e-6)
        # the masked write: this rank's slots of a whole cache, written
        # alike, byte for byte
        for key, (mine, want) in r["write"].items():
            np.testing.assert_array_equal(mine, want)
        # K2 serves no part of the slots: every decode attention call
        # declines with the reference's code and is combined instead
        declined = {k: v for k, v in mesh["stats"].items()
                    if k.endswith("[decode_attn]")}
        assert list(declined) == \
            ["cuda_sharded->fallback:shard_hkv_lt_axis[decode_attn]"]
    att = res[0]["attention"]
    cache = {k: jnp.asarray(v) for k, v in att["cache"].items()}
    want = np.asarray(jlayers.decode_attention(
        jnp.asarray(att["q"]), cache, jnp.asarray(att["pos"]),
        window=att["window"], ring=att["ring"],
        policy=JQuantPolicy(kv_bits=4, backend="pallas_interpret")))
    for r in res:
        got = r["attention"]["out"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5
        assert r["attention"]["stats"] == {
            "cuda_sharded->fallback:shard_hkv_lt_axis[decode_attn]": 1}
    if name == "rg-seq":
        assert att["ring"] == 8 and att["pos"].max() >= 8


@pytest.mark.parametrize("name", ["qwen-none-tp2", "qwen2-none-tp2",
                                  "qwen2-w4-2x2"])
def test_placements_match_one_rank(request, name):
    res = _result(request, name)
    _same_serving(res)
    tp = CASES2.get(name, CASES4.get(name))[2][1]
    for r in res:
        mesh = r["mesh"]
        assert mesh["held"] == mesh["want"]
        # the head's vocab is split over "model": the tied table's rows,
        # an untied head's columns
        tied = name.startswith("qwen-")
        head = "embed/table" if tied else "lm_head/w_out"
        dim = 0 if tied else -1
        assert mesh["held"][head][dim] * tp == mesh["whole"][head][dim]
    if name == "qwen2-w4-2x2":
        # FSDP: a weight's other dim split over "data" too
        held, whole = res[0]["mesh"]["held"], res[0]["mesh"]["whole"]
        assert held["layers/0/attn/wq"][0] * 2 == \
            whole["layers/0/attn/wq"][0]
