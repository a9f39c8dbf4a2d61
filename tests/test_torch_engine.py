"""The port's slab serving engine against the JAX engine: greedy tokens
must be identical (no tolerance), on the committed `bench_lm_30.npz`
fixture at W4 and at W4 + a 4-bit OVP KV cache, with `batch_slots=4`,
`max_len=64` and 6 requests of 8 new tokens whose prompt lengths (4-24)
come from `np.random.default_rng(0)`, so some requests queue for a slot.

Both engines serve the same quantized weights (the reference's PTQ
carried across). The reference runs its default `xla` backend; the port
runs `cuda` (plain versions on the CPU) where the reference's attention
is fp32, and `eager` where the reference's dense path rounds a packed
cache to bfloat16.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from benchmarks import common
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import engine as teng

from _torch_dist import one_torch_thread  # noqa: F401

SLOTS, MAX_LEN, N_REQ, MAX_NEW = 4, 64, 6, 8


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 25)))
            .astype(np.int32) for _ in range(N_REQ)]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


@pytest.mark.parametrize("kv_bits,t_backend", [(0, "cuda"), (4, "eager")])
def test_greedy_tokens_identical(kv_bits, t_backend):
    jcfg = common._lm_cfg()
    _, params, _ = common.trained_lm(steps=30)
    jp = dataclasses.replace(jpol.OLIVE_W4, kv_bits=kv_bits,
                             compute_dtype="float32")
    qparams = jax.jit(j_quantize_params, static_argnums=1)(
        params, dataclasses.replace(jp, kv_bits=0))
    prompts = _prompts(jcfg.vocab)
    ref = _serve(jeng.ServingEngine(j_build_model(jcfg, jp, remat=False),
                                    qparams,
                                    jeng.EngineCfg(batch_slots=SLOTS,
                                                   max_len=MAX_LEN)),
                 prompts)

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    tcfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                         if k in fields})
    tp = dataclasses.replace(tpol.OLIVE_W4, kv_bits=kv_bits,
                             compute_dtype="float32")
    eng = teng.ServingEngine(
        t_build_model(tcfg, tp),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                          device="cpu"),
        teng.EngineCfg(batch_slots=SLOTS, max_len=MAX_LEN,
                       backend=t_backend), device="cpu")
    got = _serve(eng, prompts)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    assert eng.stats()["prefills_run"] == N_REQ
