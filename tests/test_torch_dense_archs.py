"""The three dense 7-8B configs (`qwen2-7b`, `yi-6b`, `minitron-8b`), the
config accounting, and the chunked slab prefill attention, against the
reference.

- The configs, full and `-smoke`, equal the reference's field for field
  (the port's fields; `source` strings included).
- `param_count` equals the reference's on every ported config and its
  smoke variant, and counts the linear weights the port's `Model.init`
  draws in the layers and an encoder's layers (plus the vocab-wide
  embedding and head).
- Smoke-size logits of each new arch under `olive_serve` (W4A4 + KV4,
  fp32 compute): the reference's `xla` backend against the port's
  `eager` (which mirrors its bfloat16 rounding of a packed cache), on
  the reference's weights quantized by the reference and carried across
  with `convert.params_from_numpy`; prefill + 3 decode steps on the
  reference's greedy tokens (the shared loop of `_torch_parity.py`);
  atol 1e-4, the model tests' tolerance. One JAX compile of each step
  per arch.
- Slab prefill attention (`layers.causal_attention`) in blocks of 512
  queries x 512 keys: at T <= 512 bit for bit the one-block version it
  replaced (kept below), at T 600 and 1100 against the reference's
  `blockwise_attention` at atol 1e-5 on unit-normal inputs (fp32
  summation order and the online rescaling differ), and with blocks of
  4 at T 11 against the one-block version at the same tolerance.
- The launcher serving `qwen2-7b-smoke` on the CPU, slab and paged.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models import layers as jlayers
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.qlinear import tree_paths
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model as t_build_model

from _torch_parity import jax_greedy, port_forced
from _torch_dist import one_torch_thread  # noqa: F401

NEW = ("qwen2-7b", "yi-6b", "minitron-8b")
PORTED = sorted(tconfigs.ARCHS)
B, T, MAX_LEN, STEPS = 2, 8, 32, 3


def _port_cfg(jcfg):
    """The port's ArchConfig with the reference config's values."""
    fields = {f.name for f in dataclasses.fields(tbase.ArchConfig)}
    return tbase.ArchConfig(**{k: v for k, v in
                               dataclasses.asdict(jcfg).items()
                               if k in fields})


@pytest.mark.parametrize("smoke", ["", "-smoke"])
@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch, smoke):
    jcfg = jconfigs.get_config(arch + smoke)
    tcfg = tconfigs.get_config(arch + smoke)
    assert _port_cfg(jcfg) == tcfg
    assert tcfg.family == "dense" and tcfg.block_pattern == ("attn",)
    assert not tcfg.tie_embeddings and tcfg.source == jcfg.source


@pytest.mark.parametrize("smoke", ["", "-smoke"])
@pytest.mark.parametrize("arch", PORTED)
def test_accounting_matches_reference(arch, smoke):
    jcfg = jconfigs.get_config(arch + smoke)
    assert tconfigs.get_config(arch + smoke).param_count() == \
        jcfg.param_count()


# the xLSTM rows (family "ssm") keep the reference's formula, which does
# not count the drawn weights: test_torch_xlstm.py holds them to it
@pytest.mark.parametrize(
    "arch", [a for a in PORTED if tconfigs.get_config(a).family != "ssm"])
def test_param_count_counts_the_drawn_weights(arch):
    cfg = tconfigs.get_config(arch + "-smoke")
    params = t_build_model(cfg).init(torch.Generator().manual_seed(0),
                                     device="cpu")
    # the linear weights of the layers and of an encoder's layers: the
    # depthwise conv kernel of an RG-LRU block is 2-D too, and the
    # reference's count leaves it out (as it leaves out a frontend's
    # projection, which is not among the layers)
    blocks = {key: params[key] for key in ("layers", "enc_blocks")
              if key in params}
    drawn = sum(w.numel() for path, w in tree_paths(blocks)
                if w.ndim >= 2 and not path.endswith("/conv_kernel"))
    assert cfg.param_count() == drawn + 2 * cfg.vocab * cfg.d_model


# --------------------------------------------------------------------------
# Smoke logits
# --------------------------------------------------------------------------
POLICY = dict(compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's smoke model, weights and W4 PTQ (shared by the
    cases of one arch)."""
    jcfg = jconfigs.get_config(arch + "-smoke")
    jp = dataclasses.replace(jpol.get_policy("olive_serve"), backend="xla",
                             **POLICY)
    model = j_build_model(jcfg, jp, remat=False)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    qparams = jax.jit(j_quantize_params, static_argnums=1)(
        params, dataclasses.replace(jp, abits=0, kv_bits=0))
    return jcfg, jp, model, qparams


@pytest.mark.parametrize("arch", NEW)
def test_smoke_logits_match_reference(arch):
    jcfg, _, model, qparams = _reference(arch)
    tp = dataclasses.replace(tpol.get_policy("olive_serve"), backend="eager",
                             **POLICY)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(B, T)).astype(np.int32)
    ref, fed = jax_greedy(model, qparams, toks, MAX_LEN, STEPS)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                               device="cpu")
    got = port_forced(t_build_model(tconfigs.get_config(arch + "-smoke"),
                                    tp), params, toks, fed, MAX_LEN)
    assert got.shape == ref.shape == (B, STEPS + 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# Chunked slab prefill attention
# --------------------------------------------------------------------------
def one_block_attention(q, k, v):
    """The port's slab prefill attention before it was chunked: one
    (B, Hkv, G, T, T) score block."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, t, hkv, g, d).to(f32).permute(0, 2, 3, 1, 4)
    kt = k.to(f32).permute(0, 2, 3, 1)[:, :, None]
    s = torch.matmul(qg, kt) * (1.0 / math.sqrt(d))
    pos = torch.arange(t)
    s = torch.where(pos[:, None] >= pos[None, :], s, tlayers.NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=tlayers.NEG_INF)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.to(f32).permute(0, 2, 1, 3)[:, :, None])
    out = acc / torch.clamp(l_sum, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def _qkv(t, seed, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, t, n, d)).astype(np.float32)
                 for n in (h, hkv, hkv))


@pytest.mark.parametrize("t", [1, 7, 64, 512])
def test_prefill_attention_up_to_one_chunk_is_the_one_block(t):
    q, k, v = map(torch.from_numpy, _qkv(t, t))
    got = tlayers.causal_attention(q, k, v)
    assert torch.equal(got, one_block_attention(q, k, v))


@pytest.mark.parametrize("t", [600, 1100])
def test_chunked_prefill_attention_matches_reference(t):
    q, k, v = _qkv(t, t)
    ref = np.asarray(jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tlayers.causal_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_small_chunks_match_the_one_block(monkeypatch):
    """Blocks of 4 over 11 tokens (a ragged last block) with G 3."""
    monkeypatch.setattr(tlayers, "ATTN_CHUNK", 4)
    q, k, v = map(torch.from_numpy, _qkv(11, 5, h=6, hkv=2, d=8))
    np.testing.assert_allclose(
        tlayers.causal_attention(q, k, v).numpy(),
        one_block_attention(q, k, v).numpy(), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--paged", "16", "--prefill-chunk",
                                        "16"]], ids=["slab", "paged"])
def test_launcher_serves_qwen2_7b_smoke_on_cpu(extra):
    res = serve.run(["--arch", "qwen2-7b-smoke", "--quant", "olive_serve",
                     "--requests", "3", "--max-new", "4", "--slots", "2",
                     "--max-len", "64"] + extra, device="cpu")
    assert res["tokens"] == 12 and len(res["completed"]) == 3
    cfg = res["model"].cfg
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.rope_theta) == (4, 2, 1e6)
    assert "bq" in res["params"]["layers"][0]["attn"]
    # untied: the head is its own fp32 matrix
    assert res["params"]["lm_head"]["w_out"].shape == (64, 512)
    assert res["engine"].paged == bool(extra)
