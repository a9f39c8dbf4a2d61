"""The hybrid family's layers (RecurrentGemma-9B: RG-LRU blocks and local
attention over a ring KV cache) against the reference, on inputs made
with numpy from a seed:

- the configs `recurrentgemma-9b`, full and `-smoke`, equal the
  reference's field for field (the port's fields), and `param_count`
  equals the reference's on them and on a 5-layer variant with a tail;
- `conv1d_causal`: a prefill, then chained one-token decodes carrying
  the state, atol 1e-6 (four products summed in the same order);
- `rglru_forward` (unquantized, fp32) at T 1, 2, 7, 64 and 301 (odd and
  even lengths reach both branches of the scan's recursion), then
  chained decodes: outputs and the final h / conv state within atol
  2e-5 on outputs of magnitude O(1) (XLA's exp, softplus and the
  scan's products round differently from torch's in the last bits;
  the recursion follows `jax.lax.associative_scan`'s order);
- sliding-window prefill attention (`causal_attention(window=)`)
  against `local_blockwise_attention`: T 11 at window 4, T 600 at
  window 256, T 1100 at window 700 (past one 512-block), and Hkv 1 /
  G 4 / D 16; atol 1e-5 on unit-normal inputs, the blocked attention
  tests' tolerance (online rescaling against one dense softmax);
- `cache_write(..., ring=)` on fp and packed caches: a prefill with
  T < ring and one with T > ring, then one-token decodes that wrap,
  equal to the reference's: fp leaves and codes byte for byte, scales
  within 1e-6 relative (XLA's std sums in another order);
- decode attention with a window and a ring: the eager backend's dense
  path against the reference's `xla` path at the smoke shapes, atol
  1e-5, and at Hkv 1 / G 16 / D 256 over a 2048-slot ring, atol 2e-5
  (sums of 2048 bf16-rounded products in another fp32 order); and K2's plain
  version against the reference Pallas kernel in interpret mode at
  Hkv 1 / G 16 / D 256, atol 1e-5 (the decode attention tests').
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import QuantPolicy as JPolicy
from repro.kernels import decode_attn as jda
from repro.models import layers as jl
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.kernels import decode_attn as tda
from repro_torch.models import layers as tl

from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-9b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread (the suite's workers
    share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(tbase.ArchConfig)}
    return tbase.ArchConfig(**{k: v for k, v in
                               dataclasses.asdict(jcfg).items()
                               if k in fields})


def _to_port(tree):
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy({"sub": np_tree}, device="cpu")["sub"]


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", ["", "-smoke"])
def test_config_matches_reference(smoke):
    jcfg = jconfigs.get_config(ARCH + smoke)
    tcfg = tconfigs.get_config(ARCH + smoke)
    assert _port_cfg(jcfg) == tcfg
    assert tcfg.block_pattern == ("rglru", "rglru", "local_attn")
    assert (tcfg.window, tcfg.d_rnn) == ((8, 64) if smoke else (2048, 4096))
    assert tcfg.n_layers == (6 if smoke else 38)


@pytest.mark.parametrize("n_layers", [None, 5, 38])
@pytest.mark.parametrize("smoke", ["", "-smoke"])
def test_param_count_matches_reference(smoke, n_layers):
    jcfg = jconfigs.get_config(ARCH + smoke)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    assert _port_cfg(jcfg).param_count() == jcfg.param_count()


# --------------------------------------------------------------------------
# conv1d_causal and the RG-LRU
# --------------------------------------------------------------------------
def test_conv1d_causal_prefill_then_decodes():
    rng = np.random.default_rng(1)
    d, t = 24, 9
    p = {"conv_kernel": rng.standard_normal((4, d)).astype(np.float32),
         "conv_bias": rng.standard_normal(d).astype(np.float32)}
    xs = rng.standard_normal((2, t + 5, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref, jst = jl.conv1d_causal(jp, jnp.asarray(xs[:, :t]))
    got, tst = tl.conv1d_causal(tp, torch.from_numpy(xs[:, :t]))
    outs = [(np.asarray(ref), got.numpy())]
    for i in range(t, t + 5):
        ref, jst = jl.conv1d_causal(jp, jnp.asarray(xs[:, i:i + 1]), jst)
        got, tst = tl.conv1d_causal(tp, torch.from_numpy(xs[:, i:i + 1]),
                                    tst)
        outs.append((np.asarray(ref), got.numpy()))
    for ref, got in outs + [(np.asarray(jst), tst.numpy())]:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _rglru_params(d, dr, seed):
    p = jl.rglru_params(jax.random.PRNGKey(seed), d, dr)
    # a spread of decays, not the init's constant 2.0
    a = np.random.default_rng(seed).uniform(-1.0, 3.0, dr).astype(np.float32)
    return dict(p, a_param=jnp.asarray(a))


@pytest.mark.parametrize("t", [1, 2, 7, 64, 301])
def test_rglru_prefill_then_decodes(t):
    d, dr, steps = 32, 48, 4
    jp = _rglru_params(d, dr, seed=t)
    tp = _to_port(jp)
    x = np.random.default_rng(t).standard_normal(
        (2, t + steps, d)).astype(np.float32)
    cfg = jconfigs.get_config(ARCH + "-smoke")
    jpol, tpol = JPolicy(compute_dtype="float32"), \
        TPolicy(compute_dtype="float32")
    jst = jl.rglru_init_state(2, dr)
    tst = tl.rglru_init_state(2, dr, device="cpu")
    fwd = jax.jit(lambda p, xx, st: jl.rglru_forward(
        p, xx, cfg, jpol, state=st, mode="decode"))
    outs = []
    for lo, hi in [(0, t)] + [(i, i + 1) for i in range(t, t + steps)]:
        ref, jst = fwd(jp, jnp.asarray(x[:, lo:hi]), jst)
        got, tst = tl.rglru_forward(tp, torch.from_numpy(x[:, lo:hi]), tpol,
                                    state=tst)
        outs.append((np.asarray(ref), got.numpy()))
    outs += [(np.asarray(jst["h"]), tst["h"].numpy()),
             (np.asarray(jst["conv"]), tst["conv"].numpy())]
    for ref, got in outs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_rglru_without_state_is_a_fresh_prefill():
    """No state: h0 and the conv's history are zeros, as a fresh cache."""
    tp = _to_port(_rglru_params(16, 16, seed=3))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 13, 16)).astype(np.float32))
    pol = TPolicy(compute_dtype="float32")
    a, _ = tl.rglru_forward(tp, x, pol)
    b, st = tl.rglru_forward(tp, x, pol,
                             state=tl.rglru_init_state(1, 16, device="cpu"))
    assert torch.equal(a, b) and float(st["h"].abs().sum()) > 0


# --------------------------------------------------------------------------
# Sliding-window prefill attention
# --------------------------------------------------------------------------
def _qkv(t, seed, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, t, n, d)).astype(np.float32)
                 for n in (h, hkv, hkv))


@pytest.mark.parametrize("t,window,h,hkv,d", [
    (11, 4, 4, 2, 16), (600, 256, 4, 2, 16), (1100, 700, 4, 2, 16),
    (37, 9, 4, 1, 16)])
def test_window_attention_matches_reference(t, window, h, hkv, d):
    q, k, v = _qkv(t, t + window, h, hkv, d)
    ref = np.asarray(jax.jit(lambda a, b, c: jl.local_blockwise_attention(
        a, b, c, window=window))(q, k, v))
    got = tl.causal_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_window_attention_skips_key_blocks_below_the_window(monkeypatch):
    """Blocks of 4 over 29 tokens at window 5: the key blocks each query
    block reads start at the block of its first query's window, and the
    result equals one dense masked softmax."""
    monkeypatch.setattr(tl, "ATTN_CHUNK", 4)
    q, k, v = map(torch.from_numpy, _qkv(29, 2))
    seen = []
    real = torch.matmul

    def spy(a, b):
        if b.ndim == 5 and b.shape[-2] == 16:          # q @ k^T scores
            seen.append(1)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    got = tl.causal_attention(q, k, v, window=5)
    monkeypatch.setattr(torch, "matmul", real)
    # query block q0 reads key blocks from (q0 - 4) // 4 * 4 to q0
    assert len(seen) == sum(len(range(max(0, q0 - 4) // 4 * 4, q0 + 1, 4))
                            for q0 in range(0, 29, 4))
    pos = torch.arange(29)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 5)
    qg = q.reshape(2, 29, 2, 2, 16).permute(0, 2, 3, 1, 4)
    s = qg @ k.permute(0, 2, 3, 1)[:, :, None] / 4.0
    p = torch.softmax(torch.where(mask, s, tl.NEG_INF), dim=-1)
    ref = (p @ v.permute(0, 2, 1, 3)[:, :, None]).permute(0, 3, 1, 2, 4)
    np.testing.assert_allclose(got.numpy(), ref.reshape(2, 29, 4, 16),
                               rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# Ring cache writes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("prompt", [5, 13], ids=["T<ring", "T>ring"])
@pytest.mark.parametrize("kv_bits", [0, 4], ids=["fp", "packed"])
def test_ring_cache_write_matches_reference(kv_bits, prompt):
    ring, b, hkv, d = 8, 2, 2, 16
    rng = np.random.default_rng(prompt + kv_bits)
    jc = jl.make_kv_cache(b, ring, hkv, d, jnp.float32, kv_bits)
    tc = tl.make_kv_cache(b, ring, hkv, d, kv_bits=kv_bits, device="cpu")
    writes = [(rng.standard_normal((2, b, prompt, hkv, d)),
               np.array([0, 3], np.int32))]
    writes += [(rng.standard_normal((2, b, 1, hkv, d)),
                np.array([prompt + i, prompt + 3 + i], np.int32))
               for i in range(11)]
    write = jax.jit(jl.cache_write, static_argnames="ring")
    for kv, pos in writes:
        kv = kv.astype(np.float32)
        jc = write(jc, jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                   jnp.asarray(pos), ring=ring)
        tl.cache_write(tc, torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
                       torch.from_numpy(pos), ring=ring)
        for key, ref in jc.items():
            ref, got = np.asarray(ref), tc[key].numpy()
            if key.endswith("_scl"):
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
            else:
                assert np.array_equal(got, ref), key


def test_cache_len_of_slab_ring_and_paged_caches():
    assert tl.cache_len(None) == 0
    assert tl.cache_len(tl.make_kv_cache(2, 8, 1, 16, kv_bits=4,
                                         device="cpu")) == 8
    assert tl.cache_len(tl.make_paged_kv_cache(4, 16, 2, 3, 1, 16,
                                               device="cpu")) == 48


# --------------------------------------------------------------------------
# Decode attention with a window and a ring
# --------------------------------------------------------------------------
def _cache(b, s_len, hkv, d, packed, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    if packed:
        quant = jax.jit(jl._quant_kv_token)
        (kd, ks), (vd, vs) = quant(jnp.asarray(k)), quant(jnp.asarray(v))
        cache = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    else:
        cache = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    return cache, {key: torch.from_numpy(np.asarray(val).copy())
                   for key, val in cache.items()}


@pytest.mark.parametrize("hkv,g,d,s_len,window,ring", [
    (2, 2, 16, 8, 8, 8), (2, 2, 16, 32, 8, 0), (1, 16, 256, 2048, 2048,
                                                2048)])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "fp"])
def test_dense_decode_attention_with_window_and_ring(hkv, g, d, s_len,
                                                     window, ring, packed):
    jc, tc = _cache(3, s_len, hkv, d, packed, seed=d + s_len)
    q = np.random.default_rng(d).standard_normal(
        (3, 1, hkv * g, d)).astype(np.float32)
    pos = np.array([3, s_len + 5, 3 * s_len + 1], np.int32) if ring \
        else np.array([3, s_len // 2, s_len - 1], np.int32)
    ref = np.asarray(jax.jit(lambda a, c, p: jda.xla_decode_attention(
        a, c, p, window=window, ring=ring))(jnp.asarray(q), jc,
                                            jnp.asarray(pos)))
    got = tda.xla_decode_attention(torch.from_numpy(q), tc,
                                   torch.from_numpy(pos), window=window,
                                   ring=ring)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 if s_len > 64 else 1e-5)


@pytest.mark.parametrize("window,ring", [(48, 64), (0, 64), (40, 0)])
def test_plain_decode_attention_at_recurrentgemma_layout(window, ring):
    """K2's plain version at RecurrentGemma's layout (MQA, G 16, D 256)
    against the reference kernel in interpret mode."""
    jc, tc = _cache(2, 64, 1, 256, True, seed=5)
    q = np.random.default_rng(6).standard_normal(
        (2, 1, 16, 256)).astype(np.float32)
    pos = np.array([20, 64 * 3 + 7], np.int32) if ring \
        else np.array([20, 63], np.int32)
    ref = np.asarray(jda.fused_decode_attention(
        jnp.asarray(q), jc, jnp.asarray(pos), window=window, ring=ring,
        interpret=True))
    got = tda.fused_decode_attention(torch.from_numpy(q), tc,
                                     torch.from_numpy(pos), window=window,
                                     ring=ring)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
