"""The port's dense model against the JAX reference: logits of one prefill
plus 3 decode steps on the same weights (the reference's tree carried
across with `convert.params_from_numpy`, already quantized, so the two
PTQ scale searches need not agree to the last bit).

Configs: `qwen1.5-0.5b-smoke` with its JAX random init, and the
committed `bench_lm_30.npz` fixture (GQA 4/2). Policies: fp32,
`olive_w4` and `olive_serve` (W4A4 + KV4), all in fp32 compute. The
reference runs its default `xla` backend, whose dense decode attention
rounds a packed cache to bfloat16 — the port's `eager` backend mirrors
that — or `pallas_interpret`, which the port's `cuda` backend (plain
versions on the CPU) mirrors. Decode tokens are the reference's greedy
picks, fed to both sides.

Tolerance: atol 1e-4 on the logits (fp32 summation order through every
layer; the inputs of every rounding decision agree to ~1e-7 relative).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common
from repro.configs import get_config as j_get_config
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro_torch.configs import base as tcfg
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.models.model import build_model as t_build_model

from _torch_dist import one_torch_thread  # noqa: F401

B, T, MAX_LEN, STEPS = 2, 8, 32, 3

PRESET = {"fp32": None, "olive_w4": "olive_w4",
          "olive_serve": "olive_serve"}


def _port_cfg(jcfg):
    """The port's ArchConfig with the reference config's values."""
    fields = {f.name for f in dataclasses.fields(tcfg.ArchConfig)}
    return tcfg.ArchConfig(**{k: v for k, v in
                              dataclasses.asdict(jcfg).items()
                              if k in fields})


@functools.lru_cache(maxsize=None)
def _reference(arch):
    if arch == "bench-lm":
        _, params, _ = common.trained_lm(steps=30)
        return common._lm_cfg(), params
    jcfg = j_get_config("qwen1.5-0.5b-smoke")
    model = j_build_model(jcfg, jpol.QuantPolicy(compute_dtype="float32"),
                          remat=False)
    return jcfg, model.init(jax.random.PRNGKey(0), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _quantized(arch, wpolicy):
    """The reference's PTQ of `arch` under a weight policy, shared by the
    cases that quantize weights alike (W4 and W4A4 + KV4)."""
    jcfg, params = _reference(arch)
    return jax.jit(j_quantize_params, static_argnums=1)(params, wpolicy)


def _run_jax(arch, jcfg, params, policy, toks):
    model = j_build_model(jcfg, policy, remat=False)
    if policy.enabled:
        params = _quantized(arch, dataclasses.replace(
            policy, abits=0, kv_bits=0, backend="xla"))
    caches = model.init_caches(B, MAX_LEN, dtype=jnp.float32)
    prefill = jax.jit(lambda p, c, t: model.forward(
        p, {"tokens": t}, mode="prefill", caches=c)[:2])
    decode = jax.jit(lambda p, c, t, pos: model.forward(
        p, {"tokens": t, "pos": pos}, mode="decode", caches=c)[:2])
    logits, caches = prefill(params, caches, jnp.asarray(toks))
    out, fed = [np.asarray(logits[:, -1])], []
    for i in range(STEPS):
        nxt = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, caches = decode(params, caches, jnp.asarray(nxt),
                                jnp.full((B,), T + i, jnp.int32))
        out.append(np.asarray(logits[:, 0]))
    return params, np.stack(out, 1), fed


def _run_port(tcfg_, qparams, policy, toks, fed):
    model = t_build_model(tcfg_, policy)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                               device="cpu")
    caches = model.init_caches(B, MAX_LEN, device="cpu")
    logits, caches = model.forward(params, {"tokens": torch.from_numpy(toks)},
                                   mode="prefill", caches=caches)
    out = [logits[:, -1].numpy()]
    for i, nxt in enumerate(fed):
        logits, caches = model.forward(
            params, {"tokens": torch.from_numpy(nxt),
                     "pos": torch.full((B,), T + i, dtype=torch.int64)},
            mode="decode", caches=caches)
        out.append(logits[:, 0].numpy())
    return np.stack(out, 1)


CASES = [("qwen1.5-0.5b-smoke", "fp32", "xla", "cuda"),
         ("qwen1.5-0.5b-smoke", "olive_w4", "xla", "cuda"),
         ("qwen1.5-0.5b-smoke", "olive_serve", "pallas_interpret", "cuda"),
         ("bench-lm", "fp32", "xla", "cuda"),
         ("bench-lm", "olive_w4", "xla", "cuda"),
         ("bench-lm", "olive_serve", "xla", "eager")]


@pytest.mark.parametrize("arch,pol,j_backend,t_backend", CASES)
def test_logits_match_reference(arch, pol, j_backend, t_backend):
    jcfg, params = _reference(arch)
    jp = dataclasses.replace(jpol.get_policy(PRESET[pol]),
                             compute_dtype="float32", backend=j_backend)
    tp = dataclasses.replace(tpol.get_policy(PRESET[pol]),
                             compute_dtype="float32", backend=t_backend)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab, size=(B, T)).astype(np.int32)
    qparams, ref, fed = _run_jax(arch, jcfg, params, jp, toks)
    got = _run_port(_port_cfg(jcfg), qparams, tp, toks.astype(np.int64),
                    fed)
    assert got.shape == ref.shape == (B, STEPS + 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_smoke_config_matches_reference():
    assert _port_cfg(j_get_config("qwen1.5-0.5b-smoke")) == \
        t_get_config("qwen1.5-0.5b-smoke")
    assert _port_cfg(j_get_config("qwen1.5-0.5b")) == \
        t_get_config("qwen1.5-0.5b")
