"""The encoder-decoder's layers (SeamlessM4T-large-v2: cross attention
over an fp encoder cache, the GELU MLP) and the two last configs
against the reference, on inputs made with numpy from a seed:

- the configs `seamless-m4t-large-v2` and `internvl2-1b`, full and
  `-smoke`, equal the reference's field for field (the port's fields),
  and `param_count` equals the reference's on them (the encdec_attn
  row and the encoder's term);
- `gelu_mlp` (wi + bi, tanh-approximate GELU, wd + bd) at atol 1e-5;
- non-causal prefill attention with a key length S other than T, within
  one 512-key block and past it (S 600, 1100), against the reference's
  `blockwise_attention(causal=False)` at atol 1e-5;
- `make_kv_cache(track_len=True)`: the reference's leaves, shapes and
  dtypes, "src_len" a per-row int32 of zeros;
- cross attention (fp32, unquantized, smoke width: 4 heads of 16): a
  prefill of 10 encoder rows into a 16-slot cache, then 4 decode steps
  over it, against the reference's `attention_forward(kv_x=...)`
  branches: outputs at atol 1e-5, the written rows and "src_len" equal
  to the reference's; the decode through the `cuda` backend (K2's plain
  version on the CPU) at atol 1e-5 too; and the same decode over a
  tight 10-slot cache within 1e-6 of the padded one (the unwritten tail
  gets no softmax mass; a bit-for-bit claim across cache lengths is not
  made, see the reference's failing
  `test_padded_encoder_cross_attention_matches_tight_cache`).
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
from repro.models import layers as jl
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy as TPolicy
from repro_torch.models import layers as tl

from _torch_dist import one_torch_thread  # noqa: F401

ARCHS = ("seamless-m4t-large-v2", "internvl2-1b")
SMOKE = "seamless-m4t-large-v2-smoke"
ATOL = 1e-5


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
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# Configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", ["", "-smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    jcfg = jconfigs.get_config(arch + smoke)
    tcfg = tconfigs.get_config(arch + smoke)
    assert _port_cfg(jcfg) == tcfg
    assert tcfg.param_count() == jcfg.param_count()
    assert (tcfg.enc_dec, tcfg.n_enc_layers, tcfg.frontend,
            tcfg.frontend_dim, tcfg.n_frontend_tokens) == \
        (jcfg.enc_dec, jcfg.n_enc_layers, jcfg.frontend, jcfg.frontend_dim,
         jcfg.n_frontend_tokens)


def test_param_counts_of_the_published_configs():
    """The encdec_attn row (2 attention blocks + MLP) and the encoder term
    (n_enc_layers attention blocks + MLP), formula for formula."""
    assert tconfigs.get_config("seamless-m4t-large-v2").param_count() == \
        1_632_006_144
    assert tconfigs.get_config("internvl2-1b").param_count() == 629_592_320
    smoke = tconfigs.get_config(SMOKE)
    assert (smoke.n_enc_layers, smoke.frontend_dim,
            smoke.n_frontend_tokens) == (2, 32, 4)


# --------------------------------------------------------------------------
# The GELU MLP and non-causal attention
# --------------------------------------------------------------------------
def test_gelu_mlp_matches_reference():
    d, f = 64, 128
    jp = jl.gelu_mlp_params(jax.random.PRNGKey(3), d, f)
    jp = dict(jp, bi=jnp.asarray(_rand(4, f)), bd=jnp.asarray(_rand(5, d)))
    x = _rand(6, 2, 7, d) * 2
    pol = JPolicy(compute_dtype="float32")
    ref = np.asarray(jl.gelu_mlp(jp, jnp.asarray(x), pol))
    got = tl.gelu_mlp(_to_port(jp), torch.from_numpy(x),
                      TPolicy(compute_dtype="float32"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("t,s", [(7, 10), (5, 600), (600, 1100)])
def test_non_causal_attention_matches_reference(t, s):
    h, hkv, d = 4, 2, 16
    q, k, v = _rand(7, 2, t, h, d), _rand(8, 2, s, hkv, d), \
        _rand(9, 2, s, hkv, d)
    ref = np.asarray(jl.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    got = tl.causal_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


# --------------------------------------------------------------------------
# The cross cache and cross attention
# --------------------------------------------------------------------------
def test_track_len_cache_matches_reference():
    ref = jl.make_kv_cache(3, 16, 4, 16, dtype=jnp.float32, track_len=True)
    got = tl.make_kv_cache(3, 16, 4, 16, device="cpu", track_len=True)
    assert sorted(got) == sorted(ref) == ["k", "src_len", "v"]
    for key, leaf in ref.items():
        assert tuple(got[key].shape) == leaf.shape
        assert str(got[key].dtype).split(".")[-1] == str(leaf.dtype)
    assert got["src_len"].dtype == torch.int32
    assert not got["src_len"].any()
    assert "src_len" not in tl.make_kv_cache(3, 16, 4, 16, device="cpu")


def _cross(enc_len, steps, tp):
    """Cross attention of the smoke config: the reference's prefill of a
    6-token x over 10 encoder rows into an `enc_len`-slot cache, then
    `steps` one-token decodes (the reference passes zeros as kv_x); the
    port's `cross_attention` on the same inputs under `tp`. Returns
    ((ref outs, ref cache), (port outs, port cache))."""
    cfg = jconfigs.get_config(SMOKE)
    b, t, s, d = 2, 6, 10, cfg.d_model
    jp = jl.attention_params(jax.random.PRNGKey(11), d, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim, True)
    jp = dict(jp, bk=jnp.asarray(_rand(12, cfg.n_kv_heads * cfg.head_dim)))
    x, enc = _rand(13, b, t, d), _rand(14, b, s, d)
    xs = [_rand(15 + i, b, 1, d) for i in range(steps)]
    jpol = JPolicy(compute_dtype="float32", backend="xla")
    cache = jl.make_kv_cache(b, enc_len, cfg.n_kv_heads, cfg.head_dim,
                             dtype=jnp.float32, track_len=True)
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    out, cache = jl.attention_forward(
        jp, jnp.asarray(x), pos, cfg, jpol, causal=False, cache=cache,
        mode="prefill", kv_x=jnp.asarray(enc), use_rope=False, site="xattn")
    ref = [np.asarray(out)]
    for i, xi in enumerate(xs):
        xi = jnp.asarray(xi)
        out, _ = jl.attention_forward(
            jp, xi, jnp.full((b, 1), t + i), cfg, jpol, cache=cache,
            mode="decode", kv_x=jnp.zeros_like(xi), use_rope=False,
            site="xattn")
        ref.append(np.asarray(out))
    tcfg = tconfigs.get_config(SMOKE)
    tp_params = _to_port(jp)
    tcache = tl.make_kv_cache(b, enc_len, tcfg.n_kv_heads, tcfg.head_dim,
                              device="cpu", track_len=True)
    out, tcache = tl.cross_attention(tp_params, torch.from_numpy(x),
                                     torch.from_numpy(enc), tcfg, tp,
                                     cache=tcache, mode="prefill")
    got = [out.numpy()]
    for xi in xs:
        out, tcache = tl.cross_attention(tp_params, torch.from_numpy(xi),
                                         None, tcfg, tp, cache=tcache,
                                         mode="decode")
        got.append(out.numpy())
    return (ref, cache), (got, tcache)


@pytest.mark.parametrize("backend", ["eager", "cuda"])
def test_cross_attention_prefill_and_decode_match_reference(backend):
    (ref, rcache), (got, gcache) = _cross(16, 4, TPolicy(
        compute_dtype="float32", backend=backend))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)
    assert gcache["src_len"].tolist() == np.asarray(rcache["src_len"]) \
        .tolist() == [10, 10]
    for key in ("k", "v"):
        np.testing.assert_allclose(gcache[key].numpy(),
                                   np.asarray(rcache[key]), rtol=0,
                                   atol=ATOL)
        assert not gcache[key][:, 10:].any()      # the tail stays unwritten


def test_cross_decode_over_a_padded_cache_matches_the_tight_one():
    tp = TPolicy(compute_dtype="float32", backend="cuda")
    _, (padded, pc) = _cross(16, 3, tp)
    _, (tight, tc) = _cross(10, 3, tp)
    assert pc["k"].shape[1] == 16 and tc["k"].shape[1] == 10
    for a, b in zip(padded, tight):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_encoder_longer_than_the_cache_fills_it():
    """S = 10 encoder rows into a 6-slot cache: the first 6 rows are
    kept, as the reference's dropped scatter keeps them, and src_len is
    6."""
    (_, rcache), (_, gcache) = _cross(6, 1, TPolicy(compute_dtype="float32",
                                                    backend="eager"))
    assert gcache["src_len"].tolist() == [6, 6] == \
        np.asarray(rcache["src_len"]).tolist()
    np.testing.assert_allclose(gcache["k"].numpy(), np.asarray(rcache["k"]),
                               rtol=0, atol=ATOL)
