"""The port's sharded backend (`cuda_sharded`) in gloo ranks on the CPU,
against its single-rank `cuda` output and the reference's
`pallas_sharded_interpret` on its (4, 2) mesh of 8 forced host devices
(tests/conftest.py).

Every rank case runs inside one module-scoped spawn of two gloo ranks
(`_torch_dist.py`, which imports no JAX), plus one spawn of four ranks
for the (2, 2) mesh, whose data axis replicates the work, and the
(4, 1) mesh, whose "model" axis of 1 serves as `cuda`. The contracts,
at the reference test's shapes (tests/test_sharded_backend.py):

- column-parallel and expert-parallel matmuls, and Hkv-split decode
  (slab and paged) and paged cache-write prefill, are bit-identical to
  one rank, every written pool byte included; across int4 weight-only,
  flint4 W4A4 and W4A8;
- row-parallel matmuls (`wo`, `wd`) agree within rtol = atol = 2e-5
  (fp32 reassociation of the K sum over two ranks);
- each agrees with the reference's sharded backend within the
  tolerances the port's kernel tests hold the plain versions to
  (matmul rtol 1e-5, atol 1e-5 of the largest output; attention atol
  1e-5; page codes exact, page scales rtol 1e-6);
- every rank gets the same full output;
- served engines (the reference test's tiny config at W4 + KV4, and the
  `bench_lm_30.npz` model paged with chunked prefill) and the launcher
  give tokens equal to one rank, with zero `shard_*` fallbacks and each
  rank's pool at half the bytes;
- every `shard_*` decline code, `shard_no_mesh` serving the fallback's
  tokens, the refusal of a captured engine under gloo, and the
  launcher's `--mesh` errors.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import one_torch_thread, spawn  # noqa: F401 (autouse)
from benchmarks import common
from repro import backends as jb
from repro.core import policy as jpol
from repro.core.ovp import QuantizedTensor as JQuantizedTensor
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.runtime.elastic import MeshPlan as JMeshPlan
from repro_torch import backends as tb
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.core.qlinear import (_quantize_mixed_experts,
                                     quantize_params, quantize_weight)
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model
from repro_torch.serve.engine import EngineCfg, ServingEngine
from repro_torch.serve.paging import PagePoolCfg

SB = "pallas_sharded_interpret"        # the reference's backend
PLAN42 = JMeshPlan(shape=(4, 2), axis_names=("data", "model"),
                   dropped_devices=0)
CASES = {
    "int4_weight_only": dict(),
    "flint4_w4a4": dict(abits=4, w_normal_dtype="flint4",
                        a_normal_dtype="flint4"),
    "w4a8": dict(abits=8),
}
ROW_TOL = dict(rtol=2e-5, atol=2e-5)
SITES = {"col": "layers/0/attn/wq", "row": "layers/0/attn/wo",
         "ep": "layers/0/moe/experts/wg"}
TINY = dict(name="shard-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
            block_pattern=("attn",))
SMOKE = ["--quant", "olive_serve", "--requests", "3", "--max-new", "4",
         "--max-len", "64"]


def _jpol(**kw):
    base = dict(method="olive", wbits=4, abits=0, compute_dtype="float32",
                backend=SB)
    base.update(kw)
    return jpol.QuantPolicy(**base)


def _tpol(**kw):
    base = dict(method="olive", wbits=4, abits=0, compute_dtype="float32",
                backend="cuda")
    base.update(kw)
    return tpol.QuantPolicy(**base)


def _jqt(q: QuantizedTensor):
    """The reference's QuantizedTensor of the same codes and scales."""
    return JQuantizedTensor(data=jnp.asarray(q.data.numpy()),
                            scale=jnp.asarray(q.scale.numpy()),
                            normal_dtype=q.normal_dtype,
                            pair_axis=q.pair_axis, orig_dim=q.orig_dim)


def _numpy_tree(tree):
    """A reference tree as dicts, lists and numpy arrays, quantized
    leaves as field dicts (what `params_from_numpy` takes; picklable
    into a rank that imports no JAX)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if hasattr(tree, "normal_dtype"):
        return {"data": np.asarray(tree.data), "scale": np.asarray(
            tree.scale), "normal_dtype": tree.normal_dtype,
            "pair_axis": tree.pair_axis, "orig_dim": tree.orig_dim}
    return np.asarray(tree)


# ---------------------------------------------------------------- inputs
def _matmul_inputs():
    """{name: (kind, case, x, fp32 weight)} at the reference test's shapes
    and seeds."""
    out = {}
    for case, kw in CASES.items():
        rng = np.random.default_rng(3)
        x = rng.standard_normal((4, 64)).astype(np.float32)
        w = rng.standard_normal((64, 128)).astype(np.float32)
        out[f"col-{case}"] = ("col", case, x, w)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((4, 128)).astype(np.float32)
        w = rng.standard_normal((128, 64)).astype(np.float32)
        out[f"row-{case}"] = ("row", case, x, w)
    rng = np.random.default_rng(5)
    xg = rng.standard_normal((4, 3, 64)).astype(np.float32)
    w = rng.standard_normal((4, 64, 128)).astype(np.float32)
    out["ep-int4_weight_only"] = ("ep", "int4_weight_only", xg, w)
    return out


def _packed_slab(rng, b, s, hkv, d):
    shape = (b, s, hkv, d // 2)
    return {"k_data": rng.integers(0, 256, size=shape).astype(np.uint8),
            "v_data": rng.integers(0, 256, size=shape).astype(np.uint8),
            "k_scl": rng.uniform(0.05, 0.4, size=shape[:3])
            .astype(np.float32),
            "v_scl": rng.uniform(0.05, 0.4, size=shape[:3])
            .astype(np.float32)}


def _attn_inputs():
    """The reference test's decode (slab, paged) and prefill inputs."""
    rng = np.random.default_rng(6)
    slab = _packed_slab(rng, 2, 32, 4, 16)
    q_slab = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    rng = np.random.default_rng(7)
    paged = _packed_slab(rng, 9, 8, 4, 16)        # 8 pages + the sink
    paged["block_table"] = np.array([[1, 4], [2, 6]], np.int32)
    q_paged = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    rng = np.random.default_rng(8)
    pages = (9, 8, 4, 8)                          # fresh, as make_kv_cache
    pre = {"k_data": np.zeros(pages, np.uint8),
           "v_data": np.zeros(pages, np.uint8),
           "k_scl": np.ones(pages[:3], np.float32),
           "v_scl": np.ones(pages[:3], np.float32),
           "block_table": np.array([[3, 5]], np.int32)}
    pre["stage_k"] = rng.standard_normal((1, 16, 4, 16)).astype(np.float32)
    pre["stage_v"] = rng.standard_normal((1, 16, 4, 16)).astype(np.float32)
    q_pre = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    return {"decode-slab": (q_slab, slab, np.array([5, 17], np.int32)),
            "decode-paged": (q_paged, paged, np.array([5, 11], np.int32)),
            "prefill": (q_pre, pre, np.arange(8, 16, dtype=np.int32)[None])}


def _tiny_tree():
    """The reference test's tiny model config, W4 + KV4, drawn from seed 1
    and quantized by the port, as numpy (the engines compare the port
    with itself; a JAX init and PTQ would only cost time)."""
    pol = _tpol(kv_bits=4)
    params = build_model(ArchConfig(**TINY), pol).init(
        torch.Generator().manual_seed(1), device="cpu",
        quantize=lambda tree, prefix: quantize_params(tree, pol,
                                                      prefix=prefix))
    return _numpy_tree(params)


def _tiny_requests():
    rng = np.random.default_rng(2)
    return [(rng.integers(0, TINY["vocab"], size=n).astype(np.int32), mn)
            for n, mn in zip((5, 9, 40), (4, 3, 5))]


_BENCH = {}


def _bench():
    """The `bench_lm_30.npz` model at W4, quantized by the reference, as
    numpy, with its port config and test_torch_paged_engine's prompts."""
    if not _BENCH:
        jcfg = common._lm_cfg()
        _, params, _ = common.trained_lm(steps=30)
        jp = dataclasses.replace(jpol.OLIVE_W4, kv_bits=0,
                                 compute_dtype="float32")
        q = jax.jit(j_quantize_params, static_argnums=1)(params, jp)
        fields = {f.name for f in dataclasses.fields(ArchConfig)}
        tcfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg)
                             .items() if k in fields})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, jcfg.vocab, size=int(rng.integers(4, 25)))
                   .astype(np.int32) for _ in range(5)]
        prompts.insert(2, rng.integers(0, jcfg.vocab, size=40)
                       .astype(np.int32))
        _BENCH.update(tree=_numpy_tree(q), cfg=tcfg,
                      requests=[(p, 8) for p in prompts])
    return _BENCH


BENCH_ENGINE = dict(batch_slots=4, max_len=64, page_pool=PagePoolCfg(16),
                    prefill_chunk=16)
TINY_ENGINE = dict(batch_slots=2, max_len=64, page_pool=PagePoolCfg(16),
                   prefill_chunk=16)


# ---------------------------------------------------------------- ranks
@pytest.fixture(scope="module")
def inputs():
    mm = _matmul_inputs()
    qts = {name: quantize_weight(torch.from_numpy(w), _tpol(**CASES[case]))
           for name, (kind, case, x, w) in mm.items()}
    return {"mm": mm, "qts": qts, "attn": _attn_inputs(),
            "tiny": _tiny_tree(), "bench": _bench()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Results of every two-rank case, by rank."""
    cases = []
    for name, (kind, case, x, w) in inputs["mm"].items():
        qt = inputs["qts"][name]
        cases.append((name, "matmul", dict(x=x, w=qt, policy=CASES[case],
                                           site=SITES[kind])))
        cases.append((name + "@whole", "matmul", dict(
            x=x, w=qt, policy=CASES[case], site=SITES[kind] + "@whole")))
    name = "ep-int4_weight_only"
    cases.append(("ep-fill", "matmul", dict(
        x=inputs["mm"][name][2], w=inputs["qts"][name], policy={},
        site=SITES["ep"], fill=np.array([3, 1, 0, 2], np.int32))))
    for name, (q, cache, pos) in inputs["attn"].items():
        fn = "prefill" if name == "prefill" else "decode"
        cases.append((name, fn, dict(q=q, cache=cache, pos=pos)
                      if fn == "decode" else dict(q=q, cache=cache,
                                                  positions=pos)))
        cases.append((name + "@whole", fn, dict(cases[-1][2], whole=True)))
    cases += _decline_cases()
    tiny_cfg = ArchConfig(**TINY)
    cases.append(("engine-tiny", "engine", dict(
        cfg=tiny_cfg, tree=inputs["tiny"], policy=dict(kv_bits=4),
        requests=_tiny_requests(), engine_kw=TINY_ENGINE)))
    bench = inputs["bench"]
    cases.append(("engine-bench", "engine", dict(
        cfg=bench["cfg"], tree=bench["tree"], policy=dict(kv_bits=4),
        requests=bench["requests"], engine_kw=BENCH_ENGINE)))
    cases.append(("placed", "params_from_numpy", dict(tree=bench["tree"])))
    cases.append(("capture", "capture_refused", dict(cfg=tiny_cfg)))
    for name, argv in LAUNCHER.items():
        cases.append((name, "serve", dict(
            argv=argv + ["--backend", "cuda_sharded", "--mesh", "1,2"])))
    return spawn(2, cases, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks4(inputs, tmp_path_factory):
    """The (2, 2) mesh's engine and the (4, 1) mesh's matmul, in four
    ranks."""
    bench = inputs["bench"]
    kind, case, x, _ = inputs["mm"]["col-flint4_w4a4"]
    cases = [("engine-2x2", "engine", dict(
        cfg=bench["cfg"], tree=bench["tree"], policy=dict(kv_bits=4),
        requests=bench["requests"], engine_kw=BENCH_ENGINE, shape=(2, 2))),
        ("col-4x1", "matmul", dict(
            x=x, w=inputs["qts"]["col-flint4_w4a4"],
            policy=CASES[case], site=SITES[kind], shape=(4, 1)))]
    return spawn(4, cases, tmp_path_factory.mktemp("ranks4"))


def _result(ranks, name):
    """The case's result, the same on every rank (an error fails)."""
    got = [r[name] for r in ranks]
    for g in got:
        assert not (isinstance(g, str) and g.startswith("ERROR")), g
    return got


def _raised(ranks, name, message):
    """The case raised on every rank, with `message` in its error."""
    for got in (r[name] for r in ranks):
        assert isinstance(got, str) and got.startswith("ERROR"), got
        assert "ValueError" in got and message in got, got


def _no_shard_fallbacks(stats):
    bad = {k: v for k, v in stats.items() if "->fallback" in k}
    assert not bad, f"sharded path fell back: {bad}"


# ------------------------------------------------------------ registry
def test_sharded_backend_registered():
    assert "cuda_sharded" in tb.available()
    assert tb.get_backend("cuda_sharded").fallback == "eager"
    assert tb.current_mesh() is None


# ---------------------------------------------------------- the matmuls
def _port_single(x, qt, case, fill=None):
    return tb.dispatch(torch.from_numpy(x), qt, _tpol(**CASES[case]),
                       fill=None if fill is None else torch.from_numpy(fill)
                       ).numpy()


def _reference_sharded(x, q, case, site):
    jb.configure_mesh(PLAN42)
    try:
        jb.reset_dispatch_stats()
        y = jb.dispatch(jnp.asarray(x), _jqt(q), _jpol(**CASES[case]),
                        site=site)
        assert not any("->fallback" in k for k in jb.dispatch_stats())
        return np.asarray(y)
    finally:
        jb.configure_mesh(None)


@pytest.mark.parametrize("kind", ["col", "row"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_matmul(ranks, inputs, forced_devices, kind, case):
    name = f"{kind}-{case}"
    _, _, x, _ = inputs["mm"][name]
    q = inputs["qts"][name]
    single = _port_single(x, q, case)
    for y, stats, mode in _result(ranks, name):
        assert stats == {"cuda_sharded": 1}
        assert mode == kind
        if kind == "col":                   # no collective sum: exact
            np.testing.assert_array_equal(y, single)
        else:
            np.testing.assert_allclose(y, single, **ROW_TOL)
    _raised(ranks, name + "@whole", "place the weights first")
    ref = _reference_sharded(x, q, case, SITES[kind])
    y = _result(ranks, name)[0][0]
    np.testing.assert_allclose(y, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_expert_parallel_matmul(ranks, inputs, forced_devices):
    name = "ep-int4_weight_only"
    _, case, xg, _ = inputs["mm"][name]
    q = inputs["qts"][name]
    single = _port_single(xg, q, case)
    for y, stats, mode in _result(ranks, name):
        assert stats == {"cuda_sharded[stacked]": 1}
        assert mode == "expert"
        np.testing.assert_array_equal(y, single)
    _raised(ranks, name + "@whole", "place the weights first")
    ref = _reference_sharded(xg, q, case, SITES["ep"])
    np.testing.assert_allclose(_result(ranks, name)[0][0], ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    # with a fill each rank computes its experts' filled rows only
    fill = np.array([3, 1, 0, 2], np.int32)
    single = _port_single(xg, q, case, fill=fill)
    for y, _, _ in _result(ranks, "ep-fill"):
        for e, f in enumerate(fill):
            np.testing.assert_array_equal(y[e, :f], single[e, :f])


# --------------------------------------------------------- attention
def _port_single_attn(name, q, cache, pos):
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    pol = _tpol(kv_bits=4)
    if name == "prefill":
        y, new = tb.prefill_attention(torch.from_numpy(q), cache,
                                      torch.from_numpy(pos), policy=pol)
        return y.numpy(), {k: v.numpy() for k, v in new.items()}
    return tb.decode_attention(torch.from_numpy(q), cache,
                               torch.from_numpy(pos), policy=pol).numpy(), \
        None


def _reference_attn(name, q, cache, pos):
    jb.configure_mesh(PLAN42)
    try:
        jb.reset_dispatch_stats()
        jc = {k: jnp.asarray(v) for k, v in cache.items()}
        pol = _jpol(kv_bits=4)
        if name == "prefill":
            y, new = jb.prefill_attention(jnp.asarray(q), jc,
                                          jnp.asarray(pos, jnp.int32),
                                          policy=pol)
            new = {k: np.asarray(v) for k, v in new.items()}
        else:
            y, new = jb.decode_attention(jnp.asarray(q), jc,
                                         jnp.asarray(pos), policy=pol), None
        assert not any("->fallback" in k for k in jb.dispatch_stats())
        return np.asarray(y), new
    finally:
        jb.configure_mesh(None)


@pytest.mark.parametrize("name", ["decode-slab", "decode-paged", "prefill"])
def test_kv_head_split_attention(ranks, inputs, forced_devices, name):
    q, cache, pos = inputs["attn"][name]
    single, single_pool = _port_single_attn(name, q, cache, pos)
    ref, ref_pool = _reference_attn(name, q, cache, pos)
    marker = "[prefill_attn]" if name == "prefill" else "[decode_attn]"
    hkv = cache["k_data"].shape[2]
    for res in _result(ranks, name):
        y, stats = res[0], res[-1]
        assert stats == {"cuda_sharded" + marker: 1}
        np.testing.assert_array_equal(y, single)
        np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5)
        if name != "prefill":
            continue
        pool, h0 = res[1], res[2]
        for key in ("k_data", "v_data", "k_scl", "v_scl"):
            # this rank's heads of every page
            assert pool[key].shape[2] == hkv // 2
            want = single_pool[key][:, :, h0:h0 + hkv // 2]
            ref_part = ref_pool[key][:, :, h0:h0 + hkv // 2]
            np.testing.assert_array_equal(pool[key], want)
            if key.endswith("_data"):
                np.testing.assert_array_equal(pool[key], ref_part)
            else:           # as test_torch_prefill_attn holds the scales
                np.testing.assert_allclose(pool[key], ref_part, rtol=1e-6,
                                           atol=0)
    # a whole cache the backend would split was never placed
    _raised(ranks, name + "@whole", "allocate it split")


# ----------------------------------------------------------- declines
def _decline_cases():
    pol = _tpol()
    ones = torch.ones
    cases = [
        ("no-mesh", "decline", dict(
            x=np.ones((4, 64), np.float32),
            w=quantize_weight(ones(64, 128), pol), policy={},
            site=SITES["col"], mesh=False)),
        ("n-indivisible", "decline", dict(
            x=np.ones((4, 64), np.float32),
            w=quantize_weight(ones(64, 65), pol), policy={},
            site=SITES["col"])),
        ("k-indivisible", "decline", dict(
            x=np.ones((4, 66), np.float32),
            w=quantize_weight(ones(66, 64), pol), policy={},
            site=SITES["row"])),
        ("k-int8-straddle", "decline", dict(
            x=np.ones((4, 70), np.float32),
            w=quantize_weight(ones(70, 64), _tpol(wbits=8)),
            policy=dict(wbits=8), site=SITES["row"])),
        ("k-int8-whole-pairs", "decline", dict(
            x=np.ones((4, 72), np.float32),
            w=quantize_weight(ones(72, 64), _tpol(wbits=8)),
            policy=dict(wbits=8), site=SITES["row"])),
        ("expert-indivisible", "decline", dict(
            x=np.ones((3, 2, 64), np.float32),
            w=quantize_weight(ones(3, 64, 128), pol), policy={},
            site=SITES["ep"])),
    ]
    rng = np.random.default_rng(9)
    for hkv, h in ((1, 4), (3, 6)):
        cache = _packed_slab(rng, 2, 32, hkv, 16)
        q = np.ones((2, 1, h, 16), np.float32)
        cases.append((f"hkv{hkv}-decode", "attn_decline",
                      dict(q=q, cache=cache, kind="decode")))
        # two pages of 32 rows back the 64-row stage
        paged = dict(cache, block_table=np.zeros((1, 2), np.int32),
                     stage_k=np.zeros((1, 64, hkv, 16), np.float32),
                     stage_v=np.zeros((1, 64, hkv, 16), np.float32))
        cases.append((f"hkv{hkv}-prefill", "attn_decline", dict(
            q=np.ones((1, 8, h, 16), np.float32), cache=paged,
            kind="prefill")))
    # a part of a cache with a call the kernels decline: raises
    cache = _packed_slab(rng, 2, 32, 4, 16)
    cases.append(("partial-declined", "partial_declined", dict(
        q=np.ones((2, 2, 8, 16), np.float32), cache=cache,
        pos=np.array([5, 17], np.int32))))
    for hd in (15, 16):
        cases.append((f"kv-site-d{hd}", "kv_site_heads",
                      dict(head_dim=hd)))
    # an E-indivisible stack placed inside each expert: column-split wg,
    # row-split wd (K6 declines the part, the fallback computes it split)
    rng3 = np.random.default_rng(12)
    for site, (k, n) in (("layers/0/moe/experts/wg", (64, 128)),
                         ("layers/0/moe/experts/wd", (128, 64))):
        w3 = torch.from_numpy(rng3.standard_normal((3, k, n))
                              .astype(np.float32) / 8)
        cases.append((f"expert-split-{site[-2:]}", "matmul", dict(
            x=rng3.standard_normal((2, 3, 4, k)).astype(np.float32),
            w=quantize_weight(w3, pol), policy={}, site=site)))
    w = torch.from_numpy(np.random.default_rng(10)
                         .standard_normal((4, 64, 128)).astype(np.float32))
    mixed = _quantize_mixed_experts(w, [pol, pol, _tpol(wbits=8),
                                        _tpol(wbits=8)])
    xg = np.random.default_rng(11).standard_normal((4, 3, 64)) \
        .astype(np.float32)
    cases.append(("mixed", "mixed_experts", dict(x=xg, w=mixed, policy={},
                                                 site=SITES["ep"])))
    return cases


@pytest.mark.parametrize("name,code", [
    ("no-mesh", "shard_no_mesh"),
    ("n-indivisible", "shard_n_indivisible"),
    ("k-indivisible", "shard_k_indivisible"),
    ("k-int8-straddle", "shard_k_indivisible"),
    ("k-int8-whole-pairs", None),
    ("expert-indivisible", "shard_expert_indivisible"),
    ("hkv1-decode", "shard_hkv_lt_axis"),
    ("hkv1-prefill", "shard_hkv_lt_axis"),
    ("hkv3-decode", "shard_hkv_indivisible"),
    ("hkv3-prefill", "shard_hkv_indivisible")])
def test_decline_codes(ranks, name, code):
    assert _result(ranks, name) == [code, code]


def test_partial_cache_never_falls_back(ranks):
    """A cache holding this rank's KV heads meets a call the decode
    kernels decline: no fallback serves a part of the heads, so the
    call raises instead of attending the whole q over half the heads."""
    _raised(ranks, "partial-declined", "decode_q_tokens_gt_1")


@pytest.mark.parametrize("head_dim,split", [(15, False), (16, True)])
def test_kv_site_split_reads_the_decline_chain(ranks, head_dim, split):
    """`make_kv_site` splits the heads only where the attention kernels
    serve the part: an odd head dim (`decode_head_dim_odd`) keeps the
    cache whole, so its calls decline and fall back whole."""
    for r, (heads, part) in enumerate(_result(ranks,
                                              f"kv-site-d{head_dim}")):
        if split:
            assert (heads, part) == (2, (2 * r, 2, 4))
        else:
            assert (heads, part) == (4, None)


@pytest.mark.parametrize("leaf,mode", [("wg", "col"), ("wd", "row")])
def test_expert_stack_split_inside_experts(ranks, leaf, mode):
    """An expert stack whose E does not divide the "model" axis is held
    split inside each expert, as `param_spec` splits it (wg's N, wd's
    K); K6 declines the part with the reference's code and the fallback
    computes it split: equal to one device's eager output."""
    case = next(c for c in _decline_cases()
                if c[0] == f"expert-split-{leaf}")[2]
    want = tb.dispatch(torch.from_numpy(case["x"]), case["w"],
                       _tpol(backend="eager")).numpy()
    for y, stats, got in _result(ranks, f"expert-split-{leaf}"):
        assert got == mode
        assert stats == {"cuda_sharded->fallback:shard_expert_indivisible"
                         "[stacked]": 1}
        np.testing.assert_allclose(y, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_mixed_expert_group_declines_whole(ranks):
    """Ragged per-expert precision groups are held as their `param_spec`
    parts (each group's E over "model"), decline in one piece, are
    gathered whole for the call, and the fallback's output is
    eager's."""
    x, w = (_decline_cases()[-1][2][k] for k in ("x", "w"))
    want = tb.dispatch(torch.from_numpy(x), w, _tpol(backend="eager")
                       ).numpy()
    for y, stats, groups in _result(ranks, "mixed"):
        assert groups == [(1, 2), (1, 2)]
        assert stats["cuda_sharded->fallback:shard_mixed_expert_group"
                     "[stacked]"] == 1
        np.testing.assert_array_equal(y, want)


# ------------------------------------------------------------- engines
def _single_engine(cfg, tree, requests, engine_kw, backend="cuda"):
    tb.reset_dispatch_stats()
    eng = ServingEngine(build_model(cfg, _tpol(kv_bits=4)),
                        params_from_numpy(tree, device="cpu"),
                        EngineCfg(backend=backend, **engine_kw),
                        device="cpu")
    for p, mn in requests:
        eng.submit(p, max_new_tokens=mn)
    return {r.uid: list(r.out_tokens) for r in eng.run_until_drained()}


def _check_engine(results, want):
    for tokens, stats, pool, audit, st in results:
        assert tokens == want
        _no_shard_fallbacks(stats)
        assert stats and all(k.startswith("cuda_sharded") for k in stats)
        assert stats["cuda_sharded[prefill_attn]"] > 0
        assert stats["cuda_sharded[decode_attn]"] > 0
        assert pool["n_devices"] == 2
        assert pool["pool_bytes_per_device"] * 2 == pool["pool_bytes_total"]
        assert len(pool["occupancy_per_device"]) == 2
        assert "gloo" in audit["eager_steps"] and "gloo" in st["eager_steps"]


def test_engine_tiny_tokens_equal_single_rank(ranks, inputs):
    """The reference test's W4 + KV4 model, paged with chunked prefill,
    on a (1, 2) mesh."""
    want = _single_engine(ArchConfig(**TINY), inputs["tiny"],
                          _tiny_requests(), TINY_ENGINE)
    _check_engine(_result(ranks, "engine-tiny"), want)


@pytest.fixture(scope="module")
def bench_single(inputs):
    b = inputs["bench"]
    return _single_engine(b["cfg"], b["tree"], b["requests"], BENCH_ENGINE)


def test_engine_bench_lm_tokens_equal_single_rank(ranks, bench_single):
    """`bench_lm_30.npz` at W4 + KV4, paged, chunked prefill, (1, 2)."""
    res = _result(ranks, "engine-bench")
    _check_engine(res, bench_single)
    assert all(len(t) == 8 for t in res[0][0].values())


def test_engine_on_2x2_mesh(ranks4, bench_single):
    """Four ranks: the data axis replicates the work; each "model" pair
    splits it as on (1, 2)."""
    _check_engine(_result(ranks4, "engine-2x2"), bench_single)


def test_model_axis_of_one_serves_as_cuda(ranks4, inputs):
    kind, case, x, _ = inputs["mm"]["col-flint4_w4a4"]
    single = _port_single(x, inputs["qts"]["col-flint4_w4a4"], case)
    for y, stats, mode in _result(ranks4, "col-4x1"):
        # held as its FSDP part over "data", gathered for the call
        assert stats == {"cuda_sharded": 1} and mode == "whole"
        np.testing.assert_array_equal(y, single)


def test_params_from_numpy_places_shards(ranks, inputs):
    """A reference tree converted with the mesh: quantized column, row
    and stacked leaves cut to the rank's shard (whole pairs, scales
    with them), raw leaves to their `param_spec` parts (the vocab of
    the embedding), norms whole."""
    whole = params_from_numpy(inputs["bench"]["tree"], device="cpu")
    for r, placed in enumerate(_result(ranks, "placed")):
        layer = whole["layers"][1]
        wq, wo = layer["attn"]["wq"], layer["attn"]["wo"]
        got = placed["layers/1/attn/wq"]
        n = wq.data.shape[1] // 2
        assert got == ("col", (wq.data.shape[0], n),
                       tuple(wq.scale.shape[:-1]) + (n,), wq.orig_dim)
        np.testing.assert_array_equal(placed["layers/1/attn/wq@data"],
                                      wq.data[:, r * n:(r + 1) * n].numpy())
        got = placed["layers/1/attn/wo"]
        k = wo.data.shape[0] // 2
        assert got == ("row", (k, wo.data.shape[1]), tuple(wo.scale.shape),
                       wo.orig_dim // 2)
        np.testing.assert_array_equal(placed["layers/1/attn/wo@data"],
                                      wo.data[r * k:(r + 1) * k].numpy())
        # the embedding's vocab splits over "model" (`param_spec`)
        v, d = whole["embed"]["table"].shape
        assert placed["embed/table"] == (v // 2, d)
        assert placed["layers/1/ln1/gamma_scale"] == \
            tuple(layer["ln1"]["gamma_scale"].shape)


def test_no_mesh_serves_the_fallback(inputs):
    """No mesh installed: every call declines with `shard_no_mesh` and
    the fallback (eager) serves its own tokens."""
    tb.configure_mesh(None)
    cfg, tree = ArchConfig(**TINY), inputs["tiny"]
    want = _single_engine(cfg, tree, _tiny_requests(), TINY_ENGINE,
                          backend="eager")
    got = _single_engine(cfg, tree, _tiny_requests(), TINY_ENGINE,
                         backend="cuda_sharded")
    stats = tb.dispatch_stats()
    assert got == want
    assert stats["cuda_sharded->fallback:shard_no_mesh"] > 0
    assert not any(k == "cuda_sharded" or k.startswith("cuda_sharded[")
                   for k in stats)


def test_capture_refused_under_gloo(ranks):
    for msg in _result(ranks, "capture"):
        assert msg is not None and "gloo" in msg and "capture" in msg


# ------------------------------------------------------------ launcher
LAUNCHER = {
    "serve-paged": ["--arch", "qwen1.5-0.5b-smoke", *SMOKE, "--paged",
                    "16", "--prefill-chunk", "16"],
    "serve-moe": ["--arch", "qwen3-moe-30b-a3b-smoke", *SMOKE],
}


@pytest.mark.parametrize("name", sorted(LAUNCHER))
def test_launcher_mesh_tokens_equal_single_rank(ranks, name):
    tb.configure_mesh(None)
    want = tserve.run(LAUNCHER[name], device="cpu")["outputs"]
    res = _result(ranks, name)
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["outputs"] == want
        _no_shard_fallbacks(r["dispatch"])
        if name == "serve-moe":          # expert stacks served split
            assert r["dispatch"]["cuda_sharded[stacked]"] > 0
        else:
            assert r["pool"]["pool_bytes_per_device"] * 2 == \
                r["pool"]["pool_bytes_total"]


@pytest.mark.parametrize("mesh,message", [
    ("1", "two positive sizes"), ("0,2", "two positive sizes"),
    ("a,b", "two positive sizes"), ("1,2,1", "two positive sizes"),
    ("1,2", "torchrun --nproc-per-node 2"),
    ("2,2", "torchrun --nproc-per-node 4")])
def test_launcher_mesh_errors(capsys, mesh, message):
    with pytest.raises(SystemExit):
        tserve.run(["--arch", "qwen1.5-0.5b-smoke", "--backend",
                    "cuda_sharded", "--mesh", mesh], device="cpu")
    assert message in capsys.readouterr().err
