"""K4, fused cache-write prefill: the port against the reference on the
same pools, block-table row and raw stage.

- K4's plain version (what the wrapper runs for CPU tensors) against the
  reference Pallas kernel run with `interpret=True`, chunk by chunk over
  a growing stage: output atol 1e-5 (fp32 summation order and the
  tile-wise softmax rescaling); page codes equal and scales within 1e-6
  relative after every chunk (the two population-std sums may differ in
  the last bit); pages outside the table keep their bytes.
- Chunked equals one-shot, as the reference's own test holds its kernel:
  outputs atol 2e-5, page bytes equal.
- The dense twin (`eager`) against the reference's
  `xla_prefill_attention`: the same tolerances.
- The decline codes equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# repro.core first: the reference's kernels package imports cleanly only
# once it has loaded
import repro.core  # noqa: F401
from repro.kernels.prefill_attn import (fused_prefill_attention,
                                        prefill_decline_reason,
                                        xla_prefill_attention)
from repro_torch.kernels import prefill_attn as tpa

from _torch_dist import one_torch_thread  # noqa: F401

POOLS = {True: ("k_data", "v_data", "k_scl", "v_scl"), False: ("k", "v")}


def _pools(rng, packed, n_pages, ps, hkv, d):
    """Random pre-existing pool content (numpy)."""
    if packed:
        return {"k_data": rng.integers(0, 255, (n_pages, ps, hkv, d // 2),
                                       dtype=np.uint8),
                "v_data": rng.integers(0, 255, (n_pages, ps, hkv, d // 2),
                                       dtype=np.uint8),
                "k_scl": rng.normal(size=(n_pages, ps, hkv))
                .astype(np.float32),
                "v_scl": rng.normal(size=(n_pages, ps, hkv))
                .astype(np.float32)}
    return {"k": rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32),
            "v": rng.normal(size=(n_pages, ps, hkv, d)).astype(np.float32)}


def _jax(np_cache):
    return {key: jnp.asarray(val) for key, val in np_cache.items()}


def _torch(np_cache):
    return {key: torch.from_numpy(np.array(val)) for key, val in
            np_cache.items()}


def _assert_pools_match(got, ref, packed):
    for key in POOLS[packed]:
        x, y = got[key].numpy(), np.asarray(ref[key])
        if x.dtype == np.uint8:
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("hkv,g", [(2, 2), (4, 1)])
def test_k4_plain_matches_pallas_interpret_chunk_by_chunk(packed, hkv, g):
    """A 24-token prompt in three chunks of 8 over a 24-row stage: the
    port's plain version and the reference kernel see the same stage,
    table row and pools before every chunk, and must leave the same
    pools after it."""
    rng = np.random.default_rng(0)
    ps, n_pages, d, s, c = 8, 12, 16, 24, 8
    bt_row = [5, 2, 9]
    pools = _pools(rng, packed, n_pages, ps, hkv, d)
    k_all = rng.normal(size=(1, s, hkv, d)).astype(np.float32)
    v_all = rng.normal(size=(1, s, hkv, d)).astype(np.float32)
    q_all = rng.normal(size=(1, s, hkv * g, d)).astype(np.float32)
    stage = {"stage_k": np.zeros_like(k_all), "stage_v": np.zeros_like(v_all)}
    jc = _jax(dict(pools, **stage,
                   block_table=np.asarray([bt_row], np.int32)))
    tc = _torch(dict(pools, **stage,
                     block_table=np.asarray([bt_row], np.int32)))
    for lo in range(0, s, c):
        hi = lo + c
        for cache in (jc, tc):    # append the chunk's raw K/V to the stage
            for key, src in (("stage_k", k_all), ("stage_v", v_all)):
                if isinstance(cache[key], torch.Tensor):
                    cache[key][:, lo:hi] = torch.from_numpy(src[:, lo:hi])
                else:
                    cache[key] = cache[key].at[:, lo:hi].set(src[:, lo:hi])
        positions = np.arange(lo, hi, dtype=np.int32)[None]
        assert prefill_decline_reason(jnp.asarray(q_all[:, lo:hi]), jc) \
            is None
        assert tpa.prefill_decline_reason(
            torch.from_numpy(q_all[:, lo:hi]), tc) is None
        ref, jc = fused_prefill_attention(
            jnp.asarray(q_all[:, lo:hi]), jc, jnp.asarray(positions),
            interpret=True)
        got, tc2 = tpa.fused_prefill_attention(
            torch.from_numpy(q_all[:, lo:hi]), tc,
            torch.from_numpy(positions))
        assert tc2 is tc                          # pools written in place
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
        _assert_pools_match(tc, jc, packed)
        for key in POOLS[packed]:                 # untouched pages intact
            for p in range(n_pages):
                if p not in bt_row:
                    np.testing.assert_array_equal(tc[key][p].numpy(),
                                                  pools[key][p])


def test_chunked_equals_one_shot():
    """Two chunks of 8 equal one 16-token chunk: the same attention (the
    raw stage, not the pages, is attended) and the same page bytes
    (history tiles are rewritten idempotently every chunk)."""
    rng = np.random.default_rng(1)
    ps, n_pages, d, hkv, g, s = 8, 10, 16, 2, 2, 16
    base = dict(_pools(rng, True, n_pages, ps, hkv, d),
                block_table=np.asarray([[7, 3]], np.int32),
                stage_k=rng.normal(size=(1, s, hkv, d)).astype(np.float32),
                stage_v=rng.normal(size=(1, s, hkv, d)).astype(np.float32))
    q_all = torch.from_numpy(rng.normal(size=(1, s, hkv * g, d))
                             .astype(np.float32))
    one = _torch(base)
    o1, _ = tpa.fused_prefill_attention(q_all, one,
                                        torch.arange(s)[None])
    chunked = _torch(dict(base, stage_k=np.zeros_like(base["stage_k"]),
                          stage_v=np.zeros_like(base["stage_v"])))
    outs = []
    for lo in (0, 8):
        for key in ("stage_k", "stage_v"):
            chunked[key][:, lo:lo + 8] = torch.from_numpy(
                base[key][:, lo:lo + 8])
        o, _ = tpa.fused_prefill_attention(q_all[:, lo:lo + 8], chunked,
                                           torch.arange(lo, lo + 8)[None])
        outs.append(o)
    np.testing.assert_allclose(o1.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=2e-5, atol=2e-5)
    for key in POOLS[True]:
        assert torch.equal(one[key], chunked[key])


@pytest.mark.parametrize("packed", [True, False])
def test_dense_twin_matches_reference(packed):
    rng = np.random.default_rng(2)
    ps, n_pages, d, hkv, g, s, c = 8, 9, 16, 2, 2, 24, 8
    np_cache = dict(_pools(rng, packed, n_pages, ps, hkv, d),
                    block_table=np.asarray([[4, 0, 6]], np.int32),
                    stage_k=rng.normal(size=(1, s, hkv, d))
                    .astype(np.float32),
                    stage_v=rng.normal(size=(1, s, hkv, d))
                    .astype(np.float32))
    q = rng.normal(size=(1, c, hkv * g, d)).astype(np.float32)
    positions = np.arange(s - c, s, dtype=np.int32)[None]
    ref, ref_cache = xla_prefill_attention(jnp.asarray(q), _jax(np_cache),
                                           jnp.asarray(positions))
    tc = _torch(np_cache)
    got, _ = tpa.xla_prefill_attention(torch.from_numpy(q), tc,
                                       torch.from_numpy(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    _assert_pools_match(tc, ref_cache, packed)


def test_decline_codes_match():
    pool = np.zeros((6, 8, 2, 16), np.float32)
    stage = np.zeros((1, 16, 2, 16), np.float32)
    bt = np.zeros((1, 2), np.int32)
    q1 = np.zeros((1, 8, 4, 16), np.float32)
    full = {"k": pool, "v": pool, "block_table": bt, "stage_k": stage,
            "stage_v": stage}
    cases = [
        (q1, None, "prefill_not_paged"),
        (q1, {"k": pool, "v": pool}, "prefill_not_paged"),
        (q1, {"k": pool, "v": pool, "block_table": bt}, "prefill_no_stage"),
        (np.zeros((2, 8, 4, 16), np.float32), full, "prefill_batch_gt_1"),
        (q1, {"block_table": bt, "stage_k": stage, "stage_v": stage},
         "paged_no_pool"),
        (q1, dict(full, k=pool[:, :3], v=pool[:, :3]),
         "paged_page_misaligned"),
        (q1, dict(full, block_table=bt[:, :1]), "prefill_stage_misaligned"),
        (q1, dict(full, stage_k=stage[:, :12], stage_v=stage[:, :12]),
         "prefill_stage_misaligned"),
        (q1, dict(full, k=pool[..., :15], v=pool[..., :15]),
         "decode_head_dim_odd"),
        (q1, full, None),
    ]
    for q, cache, code in cases:
        jc = None if cache is None else _jax(cache)
        tc = None if cache is None else _torch(cache)
        assert prefill_decline_reason(jnp.asarray(q), jc) == code
        assert tpa.prefill_decline_reason(torch.from_numpy(q), tc) == code
        assert tpa.is_paged_prefill(tc) == (cache is not None and
                                            "stage_k" in cache and
                                            "block_table" in cache)
