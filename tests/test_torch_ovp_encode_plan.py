"""K7, the OVP encoder, on the CPU: its launch geometry, its plain version
against the reference's encoder, and the KV-cache write's route through
the backends' `encode_kv`.

- `encode_plan`: every output pair is encoded by exactly one thread's
  grid-stride walk, 16-byte loads only where K and the alignment allow
  them, the grid under its cap, the served KV writes one short wave.
- `kernels.ops.ovp_encode` (what its wrapper runs for CPU tensors) byte
  for byte against `repro.kernels.ops.ovp_encode(..., interpret=True)`,
  at a scalar and a per-row (M, 1) scale, f32 and bf16 inputs; values at
  the code boundaries; a scale where x / s and x * (1/s) round to other
  codes (the kernel divides, as the reference does).
- `cache_write` under the `cuda` policy encodes K and V once each per
  call through `CudaBackend.encode_kv` (K7 on the card), `eager` and
  `policy=None` through the base's torch ops, for slab decode, slab
  prefill and paged decode, each against the reference's `cache_write`;
  K4's plain version still quantizes through `_quant_kv_token`.

Byte equality throughout: the encode and the division are exact.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# repro.core first: the reference's kernels package imports cleanly only
# once it has loaded
import repro.core  # noqa: F401
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch import backends as tb
from repro_torch.core import policy as tpol
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovp_encode as tenc
from repro_torch.kernels import prefill_attn as tpa
from repro_torch.models import layers as tlayers

from _torch_dist import one_torch_thread  # noqa: F401

R_CASES = (1, 4, 16, 64, 192, 2048)
K_CASES = (2, 6, 64, 128, 1024, 2816, 4096)


# --------------------------------------------------------------------------
# encode_plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", K_CASES)
@pytest.mark.parametrize("r", R_CASES)
def test_plan_covers_every_pair_once(r, k):
    for aligned in (True, False):
        plan = tenc.encode_plan(r, k, torch.float32, "row", aligned)
        for dtype in tenc.DTYPES:           # the geometry is the shape's
            for kind in tenc.SCALE_KINDS:
                assert tenc.encode_plan(r, k, dtype, kind, aligned) == plan
        assert k % plan.vec == 0            # an item stays in one row
        if plan.vec > 2:
            assert aligned and k % 8 == 0
        else:
            assert not aligned or k % 8
        assert plan.items * plan.vec == r * k
        assert 1 <= plan.blocks <= tenc._CAP_BLOCKS
        assert plan.threads % 32 == 0 and plan.threads <= tenc.MAX_THREADS
        # the kernel's grid-stride walk: thread t takes items t, t +
        # stride, ...; each item is vec / 2 consecutive output pairs
        n_iter = -(-plan.items // plan.stride)
        items = (np.arange(n_iter)[:, None] * plan.stride
                 + np.arange(plan.stride)[None, :])
        items = items[items < plan.items]
        pairs = (items[:, None] * (plan.vec // 2)
                 + np.arange(plan.vec // 2)[None, :]).reshape(-1)
        counts = np.bincount(pairs, minlength=r * k // 2)
        assert counts.shape == (r * k // 2,) and bool((counts == 1).all())


@pytest.mark.parametrize("r,k", [(64, 64), (16, 128), (4, 1024)])
def test_plan_small_calls_are_one_short_wave(r, k):
    """The served KV writes (phase A's R 64 x K 64, phase E's R 16 x K
    128) and the API's rows 4: the fewest blocks that cover the items,
    every thread one item at most, 16-byte loads."""
    plan = tenc.encode_plan(r, k, torch.float32, "row")
    assert plan.vec == 8
    assert plan.stride >= plan.items > plan.stride - plan.threads
    assert plan.blocks == -(-plan.items // plan.threads)


def test_plan_large_call_strides_under_the_cap():
    plan = tenc.encode_plan(2048, 4096, torch.bfloat16, "scalar")
    assert plan.vec == 16 and plan.threads == tenc.MAX_THREADS
    assert plan.blocks == tenc._CAP_BLOCKS
    assert plan.items > plan.stride


def test_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="K even"):
        tenc.encode_plan(4, 7)
    with pytest.raises(ValueError, match="kernel takes"):
        tenc.encode_plan(4, 8, torch.float64)
    with pytest.raises(ValueError, match="scale kind"):
        tenc.encode_plan(4, 8, torch.float32, "column")


# --------------------------------------------------------------------------
# the plain version against the reference
# --------------------------------------------------------------------------
def _inputs(shape, dtype, granularity, seed):
    """(x as the reference takes it, x as the port takes it, the scale as
    numpy) on seeded data with outliers."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x.reshape(-1)[::7] *= 12.0
    xj = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16"
                     else jnp.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    if granularity == "scalar":
        s = np.float32(0.7)
    else:
        s = (x.std(axis=-1, keepdims=True) * 3 / 7 + 1e-3).astype(
            np.float32)
    return xj, xt, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("granularity", ["scalar", "row"])
@pytest.mark.parametrize("shape", [(37, 272), (8, 64), (5, 6), (3, 1040)])
def test_ops_encode_matches_reference(shape, granularity, dtype):
    xj, xt, s = _inputs(shape, dtype, granularity, seed=sum(shape))
    ref = np.asarray(jops.ovp_encode(xj, jnp.asarray(s), interpret=True))
    scale = float(s) if granularity == "scalar" else torch.from_numpy(s)
    got = tops.ovp_encode(xt, scale).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    # every scale form the kernel takes gives the same bytes: (M,), a
    # 1-element tensor, a numpy scalar
    if granularity == "row":
        flat = tops.ovp_encode(xt, torch.from_numpy(s.reshape(-1)))
        np.testing.assert_array_equal(flat.numpy(), ref)
    else:
        for alt in (torch.tensor([s]), np.float32(s)):
            np.testing.assert_array_equal(tops.ovp_encode(xt, alt).numpy(),
                                          ref)


# (pair, expected byte) at scale 1: int4 rounds half to even (6.5 -> 6,
# 1.5 -> 2, 2.5 -> 2, -6.5 -> -6), 7 is the last normal; an outlier
# (|u| > 7) is E2M1 abfloat on the grid {12, 16, 24, 32, 48, 64, 96}
# (clamped, ties to even: 14 and 20 -> 16, 28 and 40 -> 32, 56 and 80 ->
# 64) with its neighbour the victim (8); of two outliers the larger
# stays, equal magnitudes keep the left one
BOUNDARY_PAIRS = [
    ((6.5, 1.5), 0x62), ((-6.5, 2.5), 0xA2), ((5.5, -1.5), 0x6E),
    ((0.5, -0.5), 0x00), ((7.0, -7.0), 0x79), ((7.5, 1.0), 0x18),
    ((-7.5, 1.0), 0x98), ((1.0, 14.0), 0x82), ((1.0, -14.0), 0x8A),
    ((13.999999, 0.0), 0x18), ((20.0, -20.0), 0x28), ((-20.0, 24.0), 0x83),
    ((28.0, 3.0), 0x48), ((40.0, 3.0), 0x48), ((48.0, 3.0), 0x58),
    ((56.0, 3.0), 0x68), ((80.0, 3.0), 0x68), ((95.99999, 3.0), 0x78),
    ((96.0, 3.0), 0x78), ((1e6, -1e7), 0x8F), ((12.0, 11.999999), 0x18),
    ((16.0, 15.999999), 0x28), ((32.0, 31.999998), 0x48),
    ((64.0, 63.999996), 0x68)]


def test_code_boundaries():
    x = np.asarray([p for p, _ in BOUNDARY_PAIRS], np.float32)
    want = np.asarray([b for _, b in BOUNDARY_PAIRS], np.uint8)[:, None]
    got = tops.ovp_encode(torch.from_numpy(x), 1.0).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jops.ovp_encode(jnp.asarray(x), jnp.float32(1.0),
                                     interpret=True))
    np.testing.assert_array_equal(ref, want)


def test_division_not_reciprocal():
    """At s = 0.3, values whose quotient x / s lands on or next to an
    int4 rounding tie round to another code through x * (1/s): the port
    gives the division's codes, as the reference does."""
    s = np.float32(0.3)
    inv = np.float32(1) / s
    cand = []
    for n in range(-7, 7):
        base = np.float32((n + 0.5) * s)
        for ulps in range(-4, 5):
            x = np.float32(base)
            for _ in range(abs(ulps)):
                x = np.nextafter(x, np.float32(np.sign(ulps) * np.inf))
            cand.append(x)
    cand = np.unique(np.asarray(cand, np.float32))
    div, mul = cand / s, cand * inv
    codes = lambda u: np.rint(np.clip(u, -7, 7)).astype(np.int32)
    split = cand[codes(div) != codes(mul)]
    assert split.size >= 2
    x = np.stack([split, np.zeros_like(split)], -1)
    got = tops.ovp_encode(torch.from_numpy(x), float(s)).numpy()[:, 0] >> 4
    np.testing.assert_array_equal(got, codes(split / s) & 15)
    assert not np.array_equal(got, codes(split * inv) & 15)
    ref = np.asarray(jops.ovp_encode(jnp.asarray(x), jnp.asarray(s),
                                     interpret=True))[:, 0] >> 4
    np.testing.assert_array_equal(got, ref)


def test_cpu_entry_launches_no_kernel():
    x = torch.from_numpy(_inputs((6, 64), "float32", "row", 1)[1].numpy())
    before = tenc.fused_ovp_encode.launches
    for scale in (None, 0.5, torch.tensor(0.5), torch.full((6, 1), 0.5),
                  torch.full((6,), 0.5)):
        tenc.fused_ovp_encode(x, scale=scale)
        tops.ovp_encode(x, 0.5 if scale is None else scale)
    tb.get_backend("cuda").encode_kv(x.reshape(2, 3, 64),
                                     torch.full((2, 3), 0.5))
    assert tenc.fused_ovp_encode.launches == before == 0


def test_encode_rejects_a_scale_of_another_length():
    with pytest.raises(ValueError, match="one scale a row"):
        tenc.fused_ovp_encode(torch.zeros((4, 8)), scale=torch.ones(3))


# --------------------------------------------------------------------------
# the KV-cache write's route
# --------------------------------------------------------------------------
@pytest.fixture
def encode_spy(monkeypatch):
    """Counts of `CudaBackend.encode_kv`, the base backend's (eager) and
    `layers._quant_kv_token` calls."""
    calls = {"cuda": 0, "base": 0, "quant_kv_token": 0}

    def wrap(owner, name, key):
        orig = getattr(owner, name)

        def spy(*args, **kw):
            calls[key] += 1
            return orig(*args, **kw)
        monkeypatch.setattr(owner, name, spy)

    wrap(tb.CudaBackend, "encode_kv", "cuda")
    wrap(tb.QuantizedMatmulBackend, "encode_kv", "base")
    wrap(tlayers, "_quant_kv_token", "quant_kv_token")
    return calls


HKV, D = 2, 16


def _caches(layout):
    """(reference cache, port cache, pos) of a packed slab (length 32) or
    paged (4 pages of 8, table rows of 2) cache for 2 rows."""
    if layout == "paged":
        bt = np.array([[1, 3], [0, 2]], np.int32)
        jc = jlayers.make_paged_kv_cache(4, 8, 2, 2, HKV, D,
                                         dtype=jnp.float32, kv_bits=4)
        jc["block_table"] = jnp.asarray(bt)
        tc = tlayers.make_paged_kv_cache(4, 8, 2, 2, HKV, D, kv_bits=4,
                                         device="cpu")
        tc["block_table"] = torch.from_numpy(bt)
        return jc, tc, np.array([9, 3], np.int32)
    jc = jlayers.make_kv_cache(2, 32, HKV, D, kv_bits=4)
    tc = tlayers.make_kv_cache(2, 32, HKV, D, kv_bits=4, device="cpu")
    return jc, tc, np.array([5, 30], np.int32)


def _write(case, policy, seed):
    """One cache_write of seeded K/V (with outliers) into a fresh packed
    cache: (port cache, reference cache after the same write)."""
    t = 5 if case == "slab_prefill" else 1
    rng = np.random.default_rng(seed)
    k_new = (rng.standard_normal((2, t, HKV, D)) * 2).astype(np.float32)
    v_new = rng.standard_normal((2, t, HKV, D)).astype(np.float32)
    k_new.reshape(-1)[::11] *= 9.0
    jc, tc, pos = _caches(case.split("_")[0])
    ref = jlayers.cache_write(jc, jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(pos))
    out = tlayers.cache_write(tc, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), torch.from_numpy(pos),
                              policy)
    assert out is tc
    return out, ref, (k_new, v_new, pos)


@pytest.mark.parametrize("backend", ["cuda", "eager", None])
@pytest.mark.parametrize("case", ["slab_decode", "slab_prefill",
                                  "paged_decode"])
def test_cache_write_routes_the_kv_encode(case, backend, encode_spy):
    """The route changes no byte: the cache equals the one K4's plain
    version would write (`_quant_kv_token`) exactly. Against the reference: scales within rtol 1e-6
    (XLA's std sums in another order, a ulp at most), and the codes byte
    for byte in every (token, head) row whose scale is bit-equal."""
    policy = None if backend is None else \
        tpol.OLIVE_W4.with_backend(backend)
    out, ref, (k_new, v_new, pos) = _write(case, policy, seed=len(case))
    want = {"cuda": 2 if backend == "cuda" else 0,
            "base": 0 if backend == "cuda" else 2, "quant_kv_token": 0}
    assert encode_spy == want
    kd, ks = tlayers._quant_kv_token(torch.from_numpy(k_new))
    vd, vs = tlayers._quant_kv_token(torch.from_numpy(v_new))
    written = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    for b in range(2):
        for t in range(k_new.shape[1]):
            idx = int(pos[b]) + t
            if case == "paged_decode":
                at = (int(out["block_table"][b, idx // 8]), idx % 8)
            elif idx < 32:
                at = (b, idx)
            else:
                continue                                # dropped
            for key, val in written.items():
                assert torch.equal(out[key][at], val[b, t])
    n = out["k_data"].shape[0] - (case == "paged_decode")  # not the sink
    for kv in "kv":
        scl, rscl = out[f"{kv}_scl"][:n].numpy(), np.asarray(
            ref[f"{kv}_scl"])
        np.testing.assert_allclose(scl, rscl, rtol=1e-6, atol=0)
        same = scl == rscl
        assert same.mean() > 0.5
        np.testing.assert_array_equal(out[f"{kv}_data"][:n].numpy()[same],
                                      np.asarray(ref[f"{kv}_data"])[same])


def test_k4_plain_quantizes_through_quant_kv_token(encode_spy):
    """K4's plain version writes its pages itself, with
    `_quant_kv_token`'s torch ops, and asks no backend to encode."""
    rng = np.random.default_rng(3)
    ps, n_pages, s, c = 8, 6, 16, 8
    cache = tlayers.make_paged_kv_cache(n_pages, ps, 1, s // ps, HKV, D,
                                        kv_bits=4, device="cpu")
    cache["block_table"] = torch.tensor([[4, 1]], dtype=torch.int32)
    for key in ("stage_k", "stage_v"):
        cache[key] = torch.from_numpy(
            rng.standard_normal((1, s, HKV, D)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, c, 2 * HKV, D))
                         .astype(np.float32))
    tpa.fused_prefill_attention(q, cache, torch.arange(c)[None])
    assert encode_spy == {"cuda": 0, "base": 0, "quant_kv_token": 2}
    kd, ks = tlayers._quant_kv_token(cache["stage_k"])
    assert torch.equal(cache["k_data"][4], kd[0, :ps])
    assert torch.equal(cache["k_scl"][1], ks[0, ps:])
