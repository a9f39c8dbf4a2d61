"""The port's compiled engine steps (`repro_torch/serve/capture.py` and the
engine's trace audit and LRU of prefill entries) against the JAX engine's
jitted steps, on the CPU, where every entry runs eagerly on its static
buffers.

Parity fixture: the committed `bench_lm_30.npz` (4 layers, GQA 4/2,
head_dim 32), W4 weights carried across from the reference's PTQ, over
an fp32 cache, 2 slots, max_len 64, prompts of 5, 20 and 9 tokens from
`np.random.default_rng(4)` (buckets 16, 32, 16; in paged mode, page 16 and
prefill chunk 16, stage lengths 16, 32, 16), 3 new tokens each.
`trace_audit()`, the prefill entries' `stats()` keys and the greedy
tokens must equal the reference's exactly, slab and paged, with
`capture=True` and `capture=False` alike. With `prefill_cache_cap=1`
both engines evict twice and keep one entry; the reference's
`prefill_traces` then stays below its `prefill_jits` (jax keeps its own
trace cache for the re-jitted function), while the port builds a dropped
entry again, so its traces equal its jits: that one count is held to the
port's own rule.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from benchmarks import common
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch import backends as tbackends
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.kernels import (decode_attn, ovp_matmul,
                                 prefill_attn)
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import capture
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg

from _torch_dist import one_torch_thread  # noqa: F401

SLOTS, MAX_LEN, MAX_NEW, PAGE, CHUNK = 2, 64, 3, 16, 16
STAT_KEYS = ("steps_run", "prefill_traces", "prefill_cache_size",
             "prefill_cache_evictions", "prefill_chunks_run")


@functools.lru_cache(maxsize=None)
def _fixture():
    """(reference cfg, reference W4 params, port cfg)."""
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
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in (5, 20, 9)]


def _serve(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    done = eng.run_until_drained()
    return {r.uid: (list(r.out_tokens), r.finish_reason) for r in done}


def _reference(paged: bool, cap: int = 8):
    jcfg, qparams, _ = _fixture()
    jp = dataclasses.replace(jpol.OLIVE_W4, kv_bits=0,
                             compute_dtype="float32")
    extra = dict(page_pool=jpg.PagePoolCfg(PAGE), prefill_chunk=CHUNK) \
        if paged else {}
    eng = jeng.ServingEngine(
        j_build_model(jcfg, jp, remat=False), qparams,
        jeng.EngineCfg(batch_slots=SLOTS, max_len=MAX_LEN,
                       prefill_cache_cap=cap, **extra))
    return _serve(eng, _prompts(jcfg.vocab)), eng


def _port(paged: bool, cap: int = 8, capture_steps: bool = True):
    _, qparams, tcfg = _fixture()
    tp = dataclasses.replace(tpol.OLIVE_W4, kv_bits=0,
                             compute_dtype="float32")
    extra = dict(page_pool=tpg.PagePoolCfg(PAGE), prefill_chunk=CHUNK) \
        if paged else {}
    eng = teng.ServingEngine(
        t_build_model(tcfg, tp),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                          device="cpu"),
        teng.EngineCfg(batch_slots=SLOTS, max_len=MAX_LEN,
                       prefill_cache_cap=cap, **extra),
        device="cpu", capture=capture_steps)
    return eng


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_trace_audit_and_stats_match_reference(paged):
    ref, ref_eng = _reference(paged)
    audit, stats = ref_eng.trace_audit(), ref_eng.stats()
    assert audit == {"prefill_traces": 2, "prefill_jits": 2,
                     "decode_traces": 1, "unexpected_retraces": 0}
    for capture_steps in (True, False):
        eng = _port(paged, capture_steps=capture_steps)
        got = _serve(eng, _prompts(_fixture()[0].vocab))
        assert got == ref
        assert eng.trace_audit() == audit
        st = eng.stats()
        assert {k: st[k] for k in STAT_KEYS} == \
            {k: stats[k] for k in STAT_KEYS}


def test_prefill_cache_lru_eviction_matches_reference():
    """As `tests/test_serving_engine.py::test_prefill_cache_lru_eviction`:
    cap 1 with buckets 16, 32, 16 evicts twice and keeps one entry; the
    default cap keeps both with no eviction and the same tokens."""
    ref, ref_eng = _reference(paged=False, cap=1)
    eng = _port(paged=False, cap=1)
    got = _serve(eng, _prompts(_fixture()[0].vocab))
    assert got == ref
    st, ref_st = eng.stats(), ref_eng.stats()
    assert st["prefill_cache_size"] == ref_st["prefill_cache_size"] == 1
    assert st["prefill_cache_evictions"] == \
        ref_st["prefill_cache_evictions"] == 2
    audit, ref_audit = eng.trace_audit(), ref_eng.trace_audit()
    # the reference re-jits bucket 16 without tracing it again; the port
    # builds the dropped entry again
    assert ref_audit == {"prefill_traces": 2, "prefill_jits": 3,
                         "decode_traces": 1, "unexpected_retraces": 0}
    assert audit == dict(ref_audit, prefill_traces=3)
    assert st["prefill_traces"] == 3

    default = _port(paged=False)
    assert default.cfg.prefill_cache_cap == teng.EngineCfg().prefill_cache_cap \
        == 8
    assert _serve(default, _prompts(_fixture()[0].vocab)) == got
    st2 = default.stats()
    assert st2["prefill_cache_size"] == 2
    assert st2["prefill_cache_evictions"] == 0


def test_paged_requests_of_one_stage_length_each_get_a_zeroed_stage():
    """Two queued requests of stage length 32 (two chunks each) share
    their entry's static stage one after the other: the second finds it
    zeroed past its first chunk, though the first filled all of it, and
    each gets the tokens it gets when served alone."""
    vocab = _fixture()[0].vocab
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, size=n).astype(np.int32)
               for n in (20, 18)]
    eng = _port(paged=True)
    for p in prompts:
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()                                  # first request, chunk 1
    first = eng._prefilling[0]
    stage = first.stage
    assert first.written == CHUNK and len(eng._prefilling) == 2
    eng.step()                                  # first request, chunk 2
    assert all(bool(leaf[0, CHUNK:].abs().sum() > 0)
               for st in stage for leaf in st.values())
    eng.step()                                  # second request, chunk 1
    second = eng._prefilling[0]
    assert second is not first and second.written == CHUNK
    for st, mine in zip(stage, second.stage):
        for key, leaf in st.items():
            assert mine[key] is leaf            # the entry's static stage
            assert bool(leaf[0, :CHUNK].abs().sum() > 0)
            assert not bool(leaf[0, CHUNK:].any())
    assert eng.stats()["prefill_cache_size"] == 1
    together = [r.out_tokens for r in
                sorted(eng.run_until_drained(), key=lambda r: r.uid)]
    alone = []
    for p in prompts:
        solo = _port(paged=True)
        solo.submit(p, max_new_tokens=MAX_NEW)
        alone.append(solo.run_until_drained()[0].out_tokens)
    assert together == alone


@contextlib.contextmanager
def _restored_counts():
    before = capture.host_counts()
    try:
        yield before
    finally:
        capture.add_counts(capture.count_delta(capture.host_counts(),
                                               before))


def test_count_delta_rolls_back_and_replays():
    with _restored_counts() as before:
        ovp_matmul.fused_ovp_matmul.mode_launches["fp"] += 3
        prefill_attn.fused_prefill_attention.launches += 2
        tbackends._record("cuda", None, "[prefill_attn]")
        tbackends.record_act_scale("static")
        after = capture.host_counts()
        delta = capture.count_delta(before, after)
        assert delta == {"ovp_matmul[fp]": 3, "prefill_attn": 2,
                         "dispatch:cuda[prefill_attn]": 1,
                         "act_scale:static": 1}
        capture.add_counts(capture.count_delta(after, before))
        assert capture.host_counts() == before
        # a counter key the rollback emptied is gone, not left at 0
        assert tbackends.dispatch_stats().get("cuda[prefill_attn]", 0) == \
            before.get("dispatch:cuda[prefill_attn]", 0)
        if "dispatch:cuda[prefill_attn]" not in before:
            assert "cuda[prefill_attn]" not in tbackends.dispatch_stats()
        capture.add_counts(delta)
        capture.add_counts(delta)
        twice = capture.host_counts()
        assert capture.count_delta(before, twice) == \
            {key: 2 * n for key, n in delta.items()}


def test_cache_dtype_counts_roll_back_and_replay():
    """K2's and K3's launches by cache dtype are host counters like the
    rest: listed under "<kernel><dtype>", rolled back and replayed, and
    zeroed by a reset."""
    k2 = decode_attn.fused_decode_attention
    k3 = decode_attn.fused_paged_decode_attention
    with _restored_counts() as before:
        k2.launches += 2
        k2.cache_launches["float32"] += 2
        k3.launches += 1
        k3.cache_launches["int4"] += 1
        after = capture.host_counts()
        delta = capture.count_delta(before, after)
        assert delta == {"decode_attn": 2, "decode_attn<float32>": 2,
                         "paged_decode_attn": 1,
                         "paged_decode_attn<int4>": 1}
        capture.add_counts(capture.count_delta(after, before))
        assert capture.host_counts() == before
        capture.add_counts(delta)
        assert capture.host_counts() == after
        capture.reset_launch_counts()
        counts = capture.launch_counts()
        assert not any(counts.values())
        assert {f"{name}<{dtype}>" for name in ("decode_attn",
                                                 "paged_decode_attn")
                for dtype in decode_attn.CACHE_DTYPES} <= set(counts)


class _FakeGraph:
    """Stands in for `torch.cuda.CUDAGraph` on the CPU: a capture runs
    the function (as the card would record it) and a replay runs
    nothing, so only the engine-side bookkeeping is exercised."""
    replays = 0

    def replay(self):
        _FakeGraph.replays += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None):
    yield


def test_step_graph_counts_device_executions(monkeypatch):
    """Warm-up counts one execution, the capture none (rolled back), and
    every replay one execution's delta; replays return the captured
    outputs."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    calls, builds = [], []

    def step(x):
        calls.append(1)
        prefill_attn.fused_prefill_attention.launches += 1
        tbackends._record("cuda", None, "[prefill_attn]")
        return x + len(calls)

    with _restored_counts() as before:
        g = capture.StepGraph(step, {"x": torch.zeros(2)}, capture=True,
                              on_build=lambda: builds.append(1))
        g.cuda = g.capture = True       # the card's path, run on the CPU
        out = g.run()
        assert torch.equal(out, torch.ones(2)) and len(calls) == 2
        assert builds == [1] and g.graph is not None
        one = {"prefill_attn": 1, "dispatch:cuda[prefill_attn]": 1}
        assert capture.count_delta(before, capture.host_counts()) == one
        assert g.delta == one
        for _ in range(3):
            assert g.run() is g.outputs
        assert len(calls) == 2 and builds == [1]
        assert capture.count_delta(before, capture.host_counts()) == \
            {key: 4 * n for key, n in one.items()}


def test_step_graph_runs_eagerly_on_the_cpu():
    calls = []

    def step(x):
        calls.append(1)
        return x * 2

    g = capture.StepGraph(step, {"x": torch.zeros(3, dtype=torch.int64)},
                          capture=True)
    assert not g.capture
    for i in range(3):
        out = g.run(x=np.full(3, i, np.int64))
        assert torch.equal(out, torch.full((3,), 2 * i))
    assert len(calls) == 3 and g.built and g.graph is None


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_multi_token_cache_write_drops_rows_past_the_cache(kv_bits):
    """The slab prefill's write (T tokens a row, no host sync) against a
    row-by-row loop: rows past the cache length drop, the rest keep their
    values."""
    gen = torch.Generator().manual_seed(0)
    b, t, length, hkv, d = 2, 6, 8, 2, 4
    cache = tlayers.make_kv_cache(b, length, hkv, d, kv_bits=kv_bits,
                                  device="cpu")
    for leaf in cache.values():
        leaf.copy_(torch.randint(0, 200, leaf.shape, generator=gen)
                   .to(leaf.dtype))
    want = {key: leaf.clone() for key, leaf in cache.items()}
    k = torch.randn((b, t, hkv, d), generator=gen)
    v = torch.randn((b, t, hkv, d), generator=gen)
    pos = torch.tensor([0, 5], dtype=torch.int32)
    tlayers.cache_write(cache, k, v, pos)
    if kv_bits:
        kd, ks = tlayers._quant_kv_token(k)
        vd, vs = tlayers._quant_kv_token(v)
        new = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    else:
        new = {"k": k, "v": v}
    for row in range(b):
        for i in range(t):
            j = int(pos[row]) + i
            if j < length:
                for key, val in new.items():
                    want[key][row, j] = val[row, i]
    for key in cache:
        assert torch.equal(cache[key], want[key]), key
