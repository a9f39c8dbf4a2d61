"""K2, slab decode attention: the port's plain version (what the wrapper
runs for CPU tensors) against the reference Pallas kernel run with
`interpret=True` through `fused_decode_attention`, and the port's dense
path against the reference's dense path.

Tolerance: atol 1e-5 on outputs of magnitude O(1). Decoded codes are
exact on both sides; the score dot products, the exp and the reference's
tile-wise online-softmax rescaling differ from the plain version's dense
softmax only in fp32 rounding order.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attn as jda
from repro.models import layers as jlayers
from repro_torch.kernels import decode_attn as tda

from _torch_dist import one_torch_thread  # noqa: F401


def _case(b, s_len, hkv, g, d, packed, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    if packed:
        quant = jax.jit(jlayers._quant_kv_token)
        kd, ks = quant(jnp.asarray(k))
        vd, vs = quant(jnp.asarray(v))
        cache = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    else:
        cache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    np_cache = {key: np.asarray(val) for key, val in cache.items()}
    pos = np.array([0, s_len - 1, s_len // 2, 5][:b], np.int32)
    return q, cache, np_cache, pos


def _torch_cache(np_cache):
    return {key: torch.from_numpy(val.copy()) for key, val in
            np_cache.items()}


# (B, S, Hkv, G, D, packed, window, ring): MHA and GQA G=2, packed and
# fp, mixed positions including 0 and S-1, plus the ring/window masks
CASES = [(4, 64, 4, 1, 16, True, 0, 0),
         (3, 48, 2, 2, 16, True, 0, 0),
         (4, 64, 2, 2, 32, False, 0, 0),
         (2, 40, 2, 1, 16, False, 0, 0),
         (3, 32, 2, 2, 16, True, 12, 0),
         (2, 16, 2, 1, 16, True, 16, 16)]


@pytest.mark.parametrize("b,s_len,hkv,g,d,packed,window,ring", CASES)
def test_plain_matches_pallas_interpret(b, s_len, hkv, g, d, packed,
                                        window, ring):
    q, cache, np_cache, pos = _case(b, s_len, hkv, g, d, packed,
                                    seed=s_len + g)
    if ring:
        pos = pos + 3 * ring          # positions past one ring lap
    ref = np.asarray(jda.fused_decode_attention(
        jnp.asarray(q), cache, jnp.asarray(pos), window=window, ring=ring,
        interpret=True))
    got = tda.fused_decode_attention(torch.from_numpy(q),
                                     _torch_cache(np_cache),
                                     torch.from_numpy(pos), window=window,
                                     ring=ring)
    assert got.shape == ref.shape == (b, 1, hkv * g, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("packed", (True, False))
def test_dense_path_matches_reference_dense_path(packed):
    """The eager backend's path (packed caches round to bfloat16 as the
    reference's does): the same tolerance, since both round the same
    operands to bfloat16 and accumulate in fp32."""
    q, cache, np_cache, pos = _case(2, 32, 2, 2, 16, packed, seed=11)
    ref = np.asarray(jax.jit(jda.xla_decode_attention)(
        jnp.asarray(q), cache, jnp.asarray(pos)))
    got = tda.xla_decode_attention(torch.from_numpy(q),
                                   _torch_cache(np_cache),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_slot_validity_matches():
    pos = np.array([0, 5, 17, 40], np.int32)
    slots = np.arange(24, dtype=np.int32)
    for window, ring in ((0, 0), (6, 0), (0, 8), (6, 8)):
        ja, jv = jda.slot_validity(jnp.asarray(pos), jnp.asarray(slots),
                                   window=window, ring=ring)
        ta, tv = tda.slot_validity(torch.from_numpy(pos),
                                   torch.from_numpy(slots), window=window,
                                   ring=ring)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_decline_reasons_match():
    q = np.zeros((1, 2, 2, 8), np.float32)
    cache = {"k": np.zeros((1, 4, 2, 8), np.float32),
             "v": np.zeros((1, 4, 2, 8), np.float32)}
    assert tda.decline_reason(torch.from_numpy(q), _torch_cache(cache)) \
        == jda.decline_reason(jnp.asarray(q), cache) == \
        "decode_q_tokens_gt_1"
    assert tda.decline_reason(torch.from_numpy(q[:, :1]), {}) == \
        "decode_no_kv_cache"


def test_cpu_tensors_never_launch():
    q, _, np_cache, pos = _case(2, 16, 2, 1, 16, True, seed=2)
    before = tda.fused_decode_attention.launches
    tda.fused_decode_attention(torch.from_numpy(q), _torch_cache(np_cache),
                               torch.from_numpy(pos))
    assert tda.fused_decode_attention.launches == before
