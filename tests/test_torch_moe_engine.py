"""The port's MoE model and serving engine against the JAX package on
qwen3-moe-30b-a3b-smoke (2 layers, d_model 64, 8 experts top-2
renormalised, GQA 4/2, head_dim 16), with the reference's random init
(`PRNGKey(0)`) and its PTQ carried across (`convert.params_from_numpy`
unstacks the scanned `blocks/0/moe/experts/*` stacks).

- Model: logits of one prefill (B 2, T 8) plus 3 decode steps fed the
  reference's greedy tokens, at fp32, W4, and W4 + KV4 (the launcher's
  `olive_serve`: activations unquantized), within atol 1e-4 (fp32
  summation order through every layer; the routed experts agree).
  The reference runs `xla` for fp32 and W4 and `pallas_interpret` for
  the packed cache, which the port's `cuda` backend (plain versions on
  the CPU) mirrors.
- Engine: greedy tokens and `finish_reason` identical to the JAX
  engine's, with no tolerance, slab and paged (page 16, prefill chunk 16,
  so the 40-token prompt splits in three), W4 weights over an fp32 cache:
  4 slots, max_len 64, six requests of 8 new tokens (prompts of 4-24
  tokens from `np.random.default_rng(0)` and one of 40).
- Launcher: `launch.serve.run(..., device="cpu")` serves the smoke model
  slab and paged (layer-by-layer init + PTQ), every expert matmul
  dispatched as a stack on the `cuda` backend with no fallback, and no
  kernel launched from a CPU tensor.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch import backends as tbackends
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg
from _torch_dist import one_torch_thread  # noqa: F401 (autouse)

ARCH = "qwen3-moe-30b-a3b-smoke"
B, T, MAX_LEN, STEPS = 2, 8, 32, 3
SLOTS, E_MAX_LEN, MAX_NEW, PAGE = 4, 64, 8, 16


@functools.lru_cache(maxsize=None)
def _reference():
    jcfg = j_get_config(ARCH)
    model = j_build_model(jcfg, jpol.QuantPolicy(compute_dtype="float32"),
                          remat=False)
    return jcfg, model.init(jax.random.PRNGKey(0), dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _w4_params():
    """The reference's W4 PTQ of the smoke model (weights only)."""
    _, params = _reference()
    wp = dataclasses.replace(jpol.OLIVE_W4, compute_dtype="float32",
                             backend="xla")
    return jax.jit(j_quantize_params, static_argnums=1)(params, wp)


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _policies(kind, j_backend, t_backend):
    if kind == "fp32":
        jp, tp = jpol.QuantPolicy(), tpol.QuantPolicy()
    elif kind == "w4":
        jp, tp = jpol.OLIVE_W4, tpol.OLIVE_W4
    else:                       # the launcher's olive_serve: W4 + KV4
        jp = dataclasses.replace(jpol.OLIVE_SERVE, abits=0)
        tp = tpol.OLIVE_SERVE.replace_all(abits=0)
    return (dataclasses.replace(jp, compute_dtype="float32",
                                backend=j_backend),
            dataclasses.replace(tp, compute_dtype="float32",
                                backend=t_backend))


@pytest.mark.parametrize("kind,j_backend", [("fp32", "xla"),
                                            ("w4", "xla"),
                                            ("w4_kv4", "pallas_interpret")])
def test_model_logits_match_reference(kind, j_backend):
    jcfg, params = _reference()
    jp, tp = _policies(kind, j_backend, "cuda")
    qparams = params if kind == "fp32" else _w4_params()
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, size=(B, T)) \
        .astype(np.int32)

    jm = j_build_model(jcfg, jp, remat=False)
    caches = jm.init_caches(B, MAX_LEN, dtype=jnp.float32)
    prefill = jax.jit(lambda p, c, t: jm.forward(
        p, {"tokens": t}, mode="prefill", caches=c)[:2])
    decode = jax.jit(lambda p, c, t, pos: jm.forward(
        p, {"tokens": t, "pos": pos}, mode="decode", caches=c)[:2])
    logits, caches = prefill(qparams, caches, jnp.asarray(toks))
    ref, fed = [np.asarray(logits[:, -1])], []
    for i in range(STEPS):
        nxt = np.argmax(ref[-1], axis=-1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, caches = decode(qparams, caches, jnp.asarray(nxt),
                                jnp.full((B,), T + i, jnp.int32))
        ref.append(np.asarray(logits[:, 0]))

    tm = t_build_model(t_get_config(ARCH), tp)
    tparams = _port(qparams)
    tcaches = tm.init_caches(B, MAX_LEN, device="cpu")
    logits, tcaches = tm.forward(
        tparams, {"tokens": torch.from_numpy(toks.astype(np.int64))},
        mode="prefill", caches=tcaches)
    got = [logits[:, -1].numpy()]
    for i, nxt in enumerate(fed):
        logits, tcaches = tm.forward(
            tparams, {"tokens": torch.from_numpy(nxt.astype(np.int64)),
                      "pos": torch.full((B,), T + i, dtype=torch.int64)},
            mode="decode", caches=tcaches)
        got.append(logits[:, 0].numpy())
    got, ref = np.stack(got, 1), np.stack(ref, 1)
    assert got.shape == ref.shape == (B, STEPS + 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(4, 25)))
               .astype(np.int32) for _ in range(5)]
    prompts.insert(2, rng.integers(0, vocab, size=40).astype(np.int32))
    return prompts


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


@pytest.mark.parametrize("paged", [False, True])
def test_engine_greedy_tokens_identical(paged):
    jcfg, _ = _reference()
    jp, tp = _policies("w4", "xla", "cuda")
    cfg = dict(batch_slots=SLOTS, max_len=E_MAX_LEN)
    jcfg_extra, tcfg_extra = {}, {}
    if paged:
        jcfg_extra = dict(page_pool=jpg.PagePoolCfg(PAGE),
                          prefill_chunk=16)
        tcfg_extra = dict(page_pool=tpg.PagePoolCfg(PAGE),
                          prefill_chunk=16)
    prompts = _prompts(jcfg.vocab)
    ref_eng = jeng.ServingEngine(j_build_model(jcfg, jp, remat=False),
                                 _w4_params(),
                                 jeng.EngineCfg(**cfg, **jcfg_extra))
    ref = _serve(ref_eng, prompts)
    eng = teng.ServingEngine(t_build_model(t_get_config(ARCH), tp),
                             _port(_w4_params()),
                             teng.EngineCfg(**cfg, **tcfg_extra),
                             device="cpu")
    got = _serve(eng, prompts)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    if paged:
        st, ref_st = eng.stats(), ref_eng.stats()
        assert st["prefill_chunks_run"] == ref_st["prefill_chunks_run"] \
            > len(prompts)
        assert st["page_pool"] == ref_st["page_pool"]
        assert st["page_pool"]["used_pages"] == 0


def test_launcher_serves_moe_smoke_on_cpu():
    args = ["--arch", ARCH, "--quant", "olive_serve", "--requests", "3",
            "--max-new", "4", "--slots", "2", "--max-len", "64"]
    for extra in ([], ["--paged", "16", "--prefill-chunk", "16"]):
        tbackends.reset_dispatch_stats()
        tserve.reset_kernel_launches()
        res = tserve.run(args + extra, device="cpu")
        stats = tbackends.dispatch_stats()
        st = res["engine"].stats()
        forwards = st["prefills_run"] + st["prefill_chunks_run"] \
            + st["decodes_run"]
        assert res["tokens"] == 12 and res["ptq_s"] > 0
        assert not any("->fallback" in key for key in stats)
        assert stats["cuda[stacked]"] == 3 * 2 * forwards
        assert not any(tserve.kernel_launches().values())
        assert res["params"]["layers"][0]["moe"]["experts"]["wg"] \
            .data.shape == (8, 32, 128)
