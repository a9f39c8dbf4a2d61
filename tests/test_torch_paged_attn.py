"""K3, paged decode attention, and the paged cache write: the port against
the reference on the same pools and block tables.

- K3's plain version (what the wrapper runs for CPU tensors) against the
  reference Pallas kernel run with `interpret=True` through
  `fused_decode_attention` on paged caches: packed and fp32, a shuffled
  block table over a pool with pages no row owns, mixed positions and one
  parked row (all-zero table row, pos = pages_per_row * page_size), plus
  a ring/window case. Tolerance atol 1e-5 (decoded codes are exact; only
  fp32 summation order and the tile-wise softmax rescaling differ).
- The paged dense path (`eager`) against the reference's
  `xla_decode_attention`: atol 1e-5, both round a packed cache to
  bfloat16 the same way.
- `gather_paged_cache` equal; the paged decline codes equal.
- The one-token paged `cache_write`: a parked slot and a live slot that
  both map to page 0 in the same step. The live row must land, and the
  pool's pages must equal the reference's (`mode="drop"`) bytes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's layers first: its kernels package imports cleanly only
# once repro.core has loaded
from repro.models import layers as jlayers
from repro.kernels import decode_attn as jda
from repro_torch.kernels import decode_attn as tda
from repro_torch.models import layers as tlayers

from _torch_dist import one_torch_thread  # noqa: F401


def _paged_case(packed, *, b=3, n=4, ps=8, hkv=2, g=2, d=16, n_pool=16,
                seed=0, parked=True):
    """Pools of `n_pool` pages, a shuffled (b, n) table and positions;
    the last row is parked when `parked`."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, ps, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, ps, hkv, d)).astype(np.float32)
    if packed:
        quant = jax.jit(jlayers._quant_kv_token)
        kd, ks = quant(jnp.asarray(k))
        vd, vs = quant(jnp.asarray(v))
        cache = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    else:
        cache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    bt = rng.permutation(n_pool)[:b * n].reshape(b, n).astype(np.int32)
    pos = np.array([0, n * ps // 2 + 1, n * ps - 1, 5][:b], np.int32)
    if parked:
        bt[-1] = 0
        pos[-1] = n * ps
    cache["block_table"] = jnp.asarray(bt)
    np_cache = {key: np.asarray(val) for key, val in cache.items()}
    return q, cache, np_cache, pos


def _torch(np_cache):
    return {key: torch.from_numpy(val.copy()) for key, val in
            np_cache.items()}


# (packed, window, ring, parked)
CASES = [(True, 0, 0, True), (False, 0, 0, True), (True, 0, 0, False),
         (True, 10, 24, False), (False, 12, 0, True)]


@pytest.mark.parametrize("packed,window,ring,parked", CASES)
def test_k3_plain_matches_pallas_interpret(packed, window, ring, parked):
    q, cache, np_cache, pos = _paged_case(packed, parked=parked,
                                          seed=window + ring)
    if ring:
        pos = pos + 2 * ring           # positions past two ring laps
    ref = np.asarray(jda.fused_decode_attention(
        jnp.asarray(q), cache, jnp.asarray(pos), window=window, ring=ring,
        interpret=True))
    tc = _torch(np_cache)
    got = tda.fused_decode_attention(torch.from_numpy(q), tc,
                                     torch.from_numpy(pos), window=window,
                                     ring=ring)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the paged wrapper is the same function
    got2 = tda.fused_paged_decode_attention(
        torch.from_numpy(q), tc, torch.from_numpy(pos), window=window,
        ring=ring)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("packed,ring", [(True, 0), (False, 0), (True, 24)])
def test_paged_dense_path_matches_reference(packed, ring):
    q, cache, np_cache, pos = _paged_case(packed, seed=7)
    pos = pos + (2 * ring if ring else 0)
    ref = np.asarray(jax.jit(jda.xla_decode_attention,
                             static_argnames=("window", "ring"))(
        jnp.asarray(q), cache, jnp.asarray(pos), ring=ring))
    got = tda.xla_decode_attention(torch.from_numpy(q), _torch(np_cache),
                                   torch.from_numpy(pos), ring=ring)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("packed", (True, False))
def test_gather_paged_cache_equal(packed):
    _, cache, np_cache, _ = _paged_case(packed, seed=3)
    ref = jda.gather_paged_cache(cache)
    got = tda.gather_paged_cache(_torch(np_cache))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))


def test_paged_decline_codes_match():
    q = np.zeros((2, 1, 4, 8), np.float32)
    pool = np.zeros((6, 4, 2, 8), np.float32)
    bt = np.zeros((2, 3), np.int32)
    cases = {
        "paged_no_pool": {"block_table": bt},
        "paged_table_rank": {"k": pool, "v": pool,
                             "block_table": bt.reshape(-1)},
        "paged_page_misaligned": {"k": pool[:, :3], "v": pool[:, :3],
                                  "block_table": bt},
        "decode_empty_cache": {"k": pool, "v": pool,
                               "block_table": bt[:, :0]},
        "decode_head_dim_odd": {"k": pool[..., :7], "v": pool[..., :7],
                                "block_table": bt},
        None: {"k": pool, "v": pool, "block_table": bt},
    }
    for code, np_cache in cases.items():
        jc = {key: jnp.asarray(val) for key, val in np_cache.items()}
        assert jda.decline_reason(jnp.asarray(q), jc) == code
        assert tda.decline_reason(torch.from_numpy(q), _torch(np_cache)) \
            == code
    float_table = {"k": pool, "v": pool,
                   "block_table": bt.astype(np.float32)}
    assert tda.decline_reason(torch.from_numpy(q), _torch(float_table)) \
        == jda.decline_reason(jnp.asarray(q), {
            key: jnp.asarray(val) for key, val in float_table.items()}) \
        == "paged_table_rank"


@pytest.mark.parametrize("kv_bits", (4, 0))
def test_one_token_write_live_row_lands_beside_parked_slot(kv_bits):
    """Slot 0 is parked (all-zero table row, pos = capacity): its write
    must drop. Clamped into the table it would land on row 0 of page 0,
    which live slot 1 owns and writes in the same step. The port routes
    the parked row to its sink page, so the live row lands, and the pool
    equals the reference's byte for byte."""
    n_pages, ps, n, hkv, d = 4, 8, 2, 2, 16
    rng = np.random.default_rng(5)
    k_new = rng.standard_normal((2, 1, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((2, 1, hkv, d)).astype(np.float32)
    bt = np.array([[0, 0], [0, 2]], np.int32)
    pos = np.array([n * ps, 0], np.int32)
    jc = jlayers.make_paged_kv_cache(n_pages, ps, 2, n, hkv, d,
                                     dtype=jnp.float32, kv_bits=kv_bits)
    jc["block_table"] = jnp.asarray(bt)
    ref = jlayers.cache_write(jc, jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(pos))
    tc = tlayers.make_paged_kv_cache(n_pages, ps, 2, n, hkv, d,
                                     kv_bits=kv_bits, device="cpu")
    tc["block_table"] = torch.from_numpy(bt)
    sink = {key: val[n_pages].clone() for key, val in tc.items()
            if key != "block_table"}
    out = tlayers.cache_write(tc, torch.from_numpy(k_new),
                              torch.from_numpy(v_new), torch.from_numpy(pos))
    assert out is tc                                  # written in place
    for key, val in out.items():
        if key == "block_table":
            continue
        assert val.shape[0] == n_pages + 1            # the sink page
        np.testing.assert_array_equal(val[:n_pages].numpy(),
                                      np.asarray(ref[key]))
    live = "k" if kv_bits == 0 else "k_data"
    assert not torch.equal(out[live][0, 0], torch.zeros_like(out[live][0, 0]))
    # the parked row went to the sink
    assert any(not torch.equal(out[key][n_pages], sink[key]) for key in sink)
