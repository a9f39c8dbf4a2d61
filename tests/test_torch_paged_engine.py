"""The port's paged serving engine against the JAX paged engine, and
against its own slab mode.

Parity fixture: the committed `bench_lm_30.npz` (4 layers, GQA 4/2,
head_dim 32), W4 weights carried across from the reference's PTQ, 4
slots, max_len 64, page size 16, and six requests of 8 new tokens: five
prompts of 4-24 tokens from `np.random.default_rng(0)` and one of 40
tokens, so a 16-token prefill chunk splits it in three (stage 64). Greedy
tokens and `finish_reason` must be identical, with no tolerance, at
`prefill_chunk` 0 and 16. The reference runs its default `xla` backend;
the port runs `cuda` (plain versions on the CPU) over an fp32 cache, and
`eager` over the 4-bit cache, where the reference's dense decode path
rounds a packed cache to bfloat16, as in `test_torch_engine.py`.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest

from benchmarks import common
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.launch import serve as tserve
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg
from _torch_dist import one_torch_thread  # noqa: F401 (autouse)

SLOTS, MAX_LEN, MAX_NEW, PAGE = 4, 64, 8, 16


@functools.lru_cache(maxsize=None)
def _fixture():
    """(reference cfg, reference W4 params as numpy, port cfg)."""
    jcfg = common._lm_cfg()
    _, params, _ = common.trained_lm(steps=30)
    jp = dataclasses.replace(jpol.OLIVE_W4, kv_bits=0,
                             compute_dtype="float32")
    qparams = jax.jit(j_quantize_params, static_argnums=1)(params, jp)
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    tcfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                         if k in fields})
    return jcfg, qparams, tcfg


def _prompts(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=int(rng.integers(4, 25)))
               .astype(np.int32) for _ in range(5)]
    prompts.insert(2, rng.integers(0, vocab, size=40).astype(np.int32))
    return prompts


def _j_engine(kv_bits, **cfg):
    jcfg, qparams, _ = _fixture()
    jp = dataclasses.replace(jpol.OLIVE_W4, kv_bits=kv_bits,
                             compute_dtype="float32")
    return jeng.ServingEngine(j_build_model(jcfg, jp, remat=False), qparams,
                              jeng.EngineCfg(**cfg))


def _t_engine(kv_bits, backend, **cfg):
    _, qparams, tcfg = _fixture()
    tp = dataclasses.replace(tpol.OLIVE_W4, kv_bits=kv_bits,
                             compute_dtype="float32")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                               device="cpu")
    return teng.ServingEngine(t_build_model(tcfg, tp), params,
                              teng.EngineCfg(backend=backend, **cfg),
                              device="cpu")


def _serve(eng, prompts, max_new=MAX_NEW):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("kv_bits,t_backend", [(0, "cuda"), (4, "eager")])
def test_paged_greedy_tokens_identical_to_reference(kv_bits, t_backend,
                                                    chunk):
    cfg = dict(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=chunk)
    prompts = _prompts(_fixture()[0].vocab)
    ref_eng = _j_engine(kv_bits, page_pool=jpg.PagePoolCfg(PAGE), **cfg)
    ref = _serve(ref_eng, prompts)
    eng = _t_engine(kv_bits, t_backend, page_pool=tpg.PagePoolCfg(PAGE),
                    **cfg)
    got = _serve(eng, prompts)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    st, ref_st = eng.stats(), ref_eng.stats()
    assert st["prefill_chunks_run"] == ref_st["prefill_chunks_run"]
    assert st["page_pool"] == ref_st["page_pool"]
    if chunk:                               # the 40-token prompt split
        assert st["prefill_chunks_run"] > len(prompts)


def test_paged_equals_slab_and_returns_every_page():
    prompts = _prompts(_fixture()[0].vocab)
    slab = _serve(_t_engine(4, "cuda", batch_slots=SLOTS, max_len=MAX_LEN),
                  prompts)
    eng = _t_engine(4, "cuda", batch_slots=SLOTS, max_len=MAX_LEN,
                    page_pool=tpg.PagePoolCfg(PAGE), prefill_chunk=16)
    assert _serve(eng, prompts) == slab
    pool = eng.stats()["page_pool"]
    assert pool["used_pages"] == 0 and pool["allocs"] == pool["frees"] > 0
    # the sink page is the pool's last and the allocator never hands it out
    site = eng.caches["layers"][0]["kv"]
    assert site["k_data"].shape[0] == pool["n_pages"] + 1


def _admission_trace(eng, prompts, max_new):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    trace = []
    while eng.has_work():
        ev = eng.step()
        trace.append((ev.admitted, ev.prefill_chunks, ev.decode_batch,
                      ev.queue_depth, ev.active, ev.prefilling))
    return trace, {r.uid: r.out_tokens for r in eng.completed}


def test_small_pool_blocks_head_of_line_in_reference_order():
    """Three 40-token requests each reserve 4 pages (stage 64 = 4 tiles
    of 16); a 4-page pool serves one at a time, so the queue blocks at
    its head. Every step's events and the pool counters equal the
    reference's."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, _fixture()[0].vocab, size=40)
               .astype(np.int32) for _ in range(3)]
    cfg = dict(batch_slots=2, max_len=MAX_LEN, prefill_chunk=16)
    ref_eng = _j_engine(0, page_pool=jpg.PagePoolCfg(PAGE, n_pages=4),
                        **cfg)
    eng = _t_engine(0, "cuda", page_pool=tpg.PagePoolCfg(PAGE, n_pages=4),
                    **cfg)
    ref = _admission_trace(ref_eng, prompts, 3)
    got = _admission_trace(eng, prompts, 3)
    assert got == ref
    pool = eng.stats()["page_pool"]
    assert pool == ref_eng.stats()["page_pool"]
    assert pool["alloc_failures"] >= 1 and pool["peak_used"] <= 4


def test_defrag_mid_serve_keeps_tokens():
    prompts = _prompts(_fixture()[0].vocab)[:4]
    cfg = dict(batch_slots=2, max_len=MAX_LEN,
               page_pool=tpg.PagePoolCfg(PAGE), prefill_chunk=16)
    ref = _serve(_t_engine(4, "cuda", **cfg), prompts, max_new=5)
    eng = _t_engine(4, "cuda", **cfg)
    for p in prompts:
        eng.submit(p, max_new_tokens=5)
    steps, moved = 0, 0
    while eng.has_work():
        eng.step()
        steps += 1
        if steps % 2 == 0:                  # churn the layout mid-flight
            remap = eng.defrag()
            moved += sum(old != new for old, new in remap.items())
    assert moved > 0
    assert {r.uid: (r.out_tokens, r.finish_reason)
            for r in eng.completed} == ref
    assert eng.stats()["page_pool"]["used_pages"] == 0


def test_launcher_paged_run_and_flag_validation():
    res = tserve.run(["--arch", "qwen1.5-0.5b-smoke", "--quant",
                      "olive_serve", "--requests", "3", "--max-new", "4",
                      "--slots", "2", "--max-len", "64", "--paged", "16",
                      "--prefill-chunk", "16"], device="cpu")
    assert res["tokens"] == 12 and res["engine"].paged
    st = res["engine"].stats()
    assert st["prefill_chunks_run"] >= 3
    assert st["page_pool"]["used_pages"] == 0
    with pytest.raises(SystemExit):
        tserve.run(["--arch", "qwen1.5-0.5b-smoke", "--prefill-chunk",
                    "16"], device="cpu")
