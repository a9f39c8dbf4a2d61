"""The port's asyncio streaming front end and metrics ledger
(`repro_torch.serve.frontend`, `repro_torch.serve.metrics`): the
contracts of the reference's `tests/test_serve_frontend.py` that need no
mesh, and parity with the reference on the same carried weights.

- streaming: each request's tokens arrive through its `TokenStream` in
  sampling order, over several engine steps, and a stream finishes after
  its last token;
- continuous intake: a request submitted from a stream consumer runs in
  the same front-end run;
- async equals drained token for token (fp slab; OVP KV cache, paged,
  chunked), with no fallback in the ledger;
- TTFT is monotone in queue position at `batch_slots=1`;
- `stats()` scalars are lifetime counters;
- the ledger samples the pool gauges every step, and
  `pool_device_occupancy == [pool_occupancy]` on one device;
- snapshot and JSONL trace round trip;
- lifecycle errors, and a step that raises surfaces at `drain`, at
  `submit` and in every open stream;
- every step runs on the front end's one step thread;
- parity: the port's ledger (async) and the reference's (drained) on the
  same weights and prompts have equal step records in every field that
  is neither a time nor a `dispatch` dict, and equal request uid,
  `n_tokens` and `finish_reason`; the reference's `load_trace` reads the
  port's trace back as the port's own `load_trace` does. Exact.

The tiny config has 2 layers (d_model 64, GQA 4/2, head_dim 16).
"""
from __future__ import annotations

import asyncio
import threading

import jax
import numpy as np
import pytest

from repro.configs.base import ArchConfig as JArchConfig
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models.model import build_model as j_build_model
from repro.serve import EngineCfg as JEngineCfg
from repro.serve import MetricsLedger as JMetricsLedger
from repro.serve import ServingEngine as JServingEngine
from repro.serve import load_trace as j_load_trace
from repro.serve.paging import PagePoolCfg as JPagePoolCfg
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.model import build_model
from repro_torch.serve import (AsyncFrontend, EngineCfg, MetricsLedger,
                               ServingEngine, load_trace)
from repro_torch.serve.paging import PagePoolCfg

from _torch_dist import one_torch_thread  # noqa: F401

TINY = dict(name="fe-tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
            block_pattern=("attn",))
KV4 = dict(method="olive", kv_bits=4, compute_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    """The reference's tiny model's weights: (reference params, the same
    arrays in the port)."""
    model = j_build_model(JArchConfig(**TINY),
                          JQuantPolicy(compute_dtype="float32"), remat=False)
    params = model.init(jax.random.PRNGKey(1))
    return params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _prompts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab"], size=n).astype(np.int32)
            for n in sizes]


def _engine(params, policy=None, page_pool=None, prefill_chunk=0,
            batch_slots=2, max_len=128, backend=None):
    model = build_model(ArchConfig(**TINY),
                        policy or QuantPolicy(compute_dtype="float32"))
    return ServingEngine(model, params, EngineCfg(
        batch_slots=batch_slots, max_len=max_len, backend=backend,
        page_pool=page_pool, prefill_chunk=prefill_chunk), device="cpu")


def _drained(eng, prompts, max_news, metrics=None):
    for p, mn in zip(prompts, max_news):
        eng.submit(p, max_new_tokens=mn)
    done = eng.run_until_drained(metrics=metrics)
    return {r.uid: r.out_tokens for r in done}


def _async(eng, prompts, max_news, metrics=None, consume=True):
    """Serve `prompts` through the front end; returns (tokens by uid, each
    stream's reads [(token, steps_run, stream.done)], finish reasons)."""

    async def go():
        records = {}

        async def consumer(stream):
            recs = []
            async for tok in stream:
                recs.append((tok, eng.steps_run, stream.done))
            records[stream.uid] = recs

        async with AsyncFrontend(eng, metrics=metrics) as fe:
            streams = [fe.submit(p, max_new_tokens=mn)
                       for p, mn in zip(prompts, max_news)]
            if consume:
                await asyncio.gather(*(consumer(s) for s in streams))
            else:
                await fe.drain()
        outs = {s.uid: list(s.tokens) for s in streams}
        reasons = {s.uid: s.finish_reason for s in streams}
        return outs, records, reasons

    return asyncio.run(go())


def test_stream_order_and_incremental_arrival(weights):
    """Queueing, chunked prefill and interleaved decode: every stream
    yields its tokens in sampling order, and the reads span several
    engine steps rather than one burst at the end."""
    eng = _engine(weights[1], page_pool=PagePoolCfg(page_size=16),
                  prefill_chunk=16)
    max_news = [4, 7, 5, 1, 3]
    outs, records, reasons = _async(eng, _prompts((5, 9, 64, 13, 40),
                                                  seed=3), max_news)
    by_uid = {r.uid: r for r in eng.completed}
    assert sorted(outs) == sorted(by_uid)
    for uid, toks in outs.items():
        req = by_uid[uid]
        assert toks == req.out_tokens
        assert [t for t, _, _ in records[uid]] == req.out_tokens
        assert reasons[uid] == req.finish_reason
        assert all(not done for _, _, done in records[uid])
        assert len(toks) <= max_news[uid - 1]
    seen = sorted({s for recs in records.values() for _, s, _ in recs})
    assert len(seen) >= 3, seen
    assert seen[0] < eng.steps_run


def test_submit_while_running(weights):
    eng = _engine(weights[1])

    async def go():
        async with AsyncFrontend(eng) as fe:
            first = fe.submit(_prompts((6,))[0], max_new_tokens=3)
            late = []
            async for _ in first:
                if not late:
                    late.append(fe.submit(_prompts((9,), seed=5)[0],
                                          max_new_tokens=2))
            toks = [t async for t in late[0]]
            return first.tokens, toks, late[0].finish_reason

    first_toks, late_toks, late_reason = asyncio.run(go())
    assert len(first_toks) == 3 and len(late_toks) == 2
    assert late_reason == "max_new_tokens"
    assert len(eng.completed) == 2


def test_async_matches_drained_fp_slab(weights):
    prompts, max_news = _prompts((5, 9, 13, 20), seed=1), [4, 4, 4, 4]
    drained = _drained(_engine(weights[1]), prompts, max_news)
    outs, _, _ = _async(_engine(weights[1]), prompts, max_news,
                        consume=False)
    assert outs == drained


def test_async_matches_drained_quantized_paged(weights):
    """The OVP KV cache on the paged, chunked engine (K3/K4/K7's plain
    versions through the `cuda` backend on the CPU): async equals
    drained, with no fallback in the ledger."""
    prompts, max_news = _prompts((5, 9, 40), seed=2), [4, 3, 5]

    def eng():
        return _engine(weights[1], policy=QuantPolicy(**KV4),
                       page_pool=PagePoolCfg(page_size=16),
                       prefill_chunk=16, max_len=64)

    drained = _drained(eng(), prompts, max_news)
    ledger = MetricsLedger()
    outs, _, _ = _async(eng(), prompts, max_news, metrics=ledger)
    assert outs == drained
    snap = ledger.snapshot()
    assert snap["fallbacks"] == 0, snap["dispatch"]
    assert snap["requests"] == len(prompts)
    assert any("[decode_attn]" in k for k in snap["dispatch"])


def test_ttft_monotone_in_queue_position(weights):
    ledger = MetricsLedger()
    eng = _engine(weights[1], batch_slots=1)
    _async(eng, _prompts((5, 6, 7, 8), seed=4), [2, 2, 2, 2],
           metrics=ledger, consume=False)
    recs = sorted(ledger.request_records, key=lambda r: r["uid"])
    assert len(recs) == 4
    ttfts = [r["ttft_s"] for r in recs]
    assert all(a <= b for a, b in zip(ttfts, ttfts[1:])), ttfts
    assert all(t > 0 for t in ttfts)


def test_stats_counters_are_lifetime(weights):
    eng = _engine(weights[1], page_pool=PagePoolCfg(page_size=16))
    _drained(eng, _prompts((5, 9), seed=6), [3, 3])
    st1 = eng.stats()
    pool1 = st1["page_pool"]
    assert st1["steps_run"] > 0 and st1["prefill_chunks_run"] > 0
    assert pool1["allocs"] > 0 and pool1["frees"] == pool1["allocs"]
    assert pool1["used_pages"] == 0
    _drained(eng, _prompts((6, 7), seed=7), [2, 2])
    st2 = eng.stats()
    pool2 = st2["page_pool"]
    assert st2["steps_run"] > st1["steps_run"]
    assert st2["prefill_chunks_run"] > st1["prefill_chunks_run"]
    assert len(eng.completed) == 4
    assert pool2["allocs"] > pool1["allocs"]
    assert pool2["peak_used"] >= pool1["peak_used"]


def test_pool_gauges_sampled_per_step(weights):
    ledger = MetricsLedger()
    eng = _engine(weights[1], page_pool=PagePoolCfg(page_size=16))
    _drained(eng, _prompts((20, 30), seed=8), [3, 3], metrics=ledger)
    occ = [r["pool_occupancy"] for r in ledger.step_records]
    assert max(occ) > 0.0 and occ[-1] == 0.0
    assert all(0.0 <= r["pool_fragmentation"] < 1.0
               for r in ledger.step_records)
    assert all(r["pool_device_occupancy"] == [r["pool_occupancy"]]
               for r in ledger.step_records)
    st = eng.device_pool_stats()
    assert st["n_devices"] == 1 and st["occupancy_per_device"] == [0.0]
    assert st["pool_bytes_total"] == st["pool_bytes_per_device"] > 0
    assert _engine(weights[1]).device_pool_stats()[
        "occupancy_per_device"] == []


def test_metrics_snapshot_and_jsonl_roundtrip(weights, tmp_path):
    ledger = MetricsLedger()
    eng = _engine(weights[1], page_pool=PagePoolCfg(page_size=16),
                  prefill_chunk=16)
    outs, _, _ = _async(eng, _prompts((5, 9, 64), seed=9), [3, 4, 2],
                        metrics=ledger)
    snap = ledger.snapshot()
    assert snap["steps"] == len(ledger.step_records) == eng.steps_run
    assert snap["requests"] == 3
    assert snap["tokens"] == sum(len(v) for v in outs.values())
    assert snap["ttft_s"]["n"] == 3
    assert snap["tpot_s"]["n"] == sum(1 for v in outs.values()
                                      if len(v) > 1)
    assert snap["prefill_chunk_steps"] > 0
    assert snap["prefill_interleave_ratio"] is not None
    assert snap["pool_device_occupancy"]["n_devices"] == 1
    assert snap["pool_device_occupancy"]["final"] == [0.0]
    path = tmp_path / "trace.jsonl"
    ledger.write_jsonl(str(path))
    trace = load_trace(str(path))
    assert trace["meta"]["paged"] is True
    assert trace["meta"]["page_size"] == 16
    assert trace["steps"] == ledger.step_records
    assert trace["requests"] == ledger.request_records
    assert trace["summary"] == snap


def test_frontend_lifecycle_errors(weights):
    eng = _engine(weights[1])
    fe = AsyncFrontend(eng)
    with pytest.raises(RuntimeError, match="not running"):
        fe.submit(np.zeros(4, np.int32))

    async def double_start():
        async with AsyncFrontend(eng) as fe2:
            with pytest.raises(RuntimeError, match="already started"):
                fe2.start()

    asyncio.run(double_start())


def test_step_error_surfaces(weights, monkeypatch):
    """A step that raises ends the serve loop: `drain` and `submit`
    re-raise it, the open stream raises at its next read, and `aclose`
    re-raises it after shutting the step thread down."""
    eng = _engine(weights[1])
    calls = []

    def broken_step():
        calls.append(1)
        raise ValueError("step failed")

    monkeypatch.setattr(eng, "step", broken_step)

    async def go():
        fe = AsyncFrontend(eng)
        fe.start()
        stream = fe.submit(_prompts((5,))[0], max_new_tokens=2)
        with pytest.raises(ValueError, match="step failed"):
            await fe.drain()
        with pytest.raises(ValueError, match="step failed"):
            fe.submit(_prompts((5,))[0])
        with pytest.raises(RuntimeError, match="exited before"):
            await stream.__anext__()
        with pytest.raises(ValueError, match="step failed"):
            await fe.aclose()
        return fe

    fe = asyncio.run(go())
    assert calls == [1] and fe._executor is None


def test_steps_run_on_one_thread(weights, monkeypatch):
    """Every step (so every capture and replay on the card) runs on the
    front end's one step thread, never on the loop's."""
    eng = _engine(weights[1], page_pool=PagePoolCfg(page_size=16),
                  prefill_chunk=16)
    threads = []
    step = eng.step

    def recorded():
        threads.append(threading.get_ident())
        return step()

    monkeypatch.setattr(eng, "step", recorded)
    _async(eng, _prompts((5, 40, 9), seed=11), [3, 3, 3])
    assert len(threads) == eng.steps_run > 3
    assert len(set(threads)) == 1
    assert threads[0] != threading.get_ident()


STEP_FIELDS = ("step", "admitted", "prefill_chunks", "decode_batch",
               "batch_occupancy", "tokens", "first_tokens", "completed",
               "queue_depth", "active", "prefilling", "pool_occupancy",
               "pool_used_pages", "pool_fragmentation",
               "pool_alloc_failures", "pool_device_occupancy")
CASES = {"fp-slab": (dict(compute_dtype="float32"), None, 0, "cuda"),
         "kv4-paged-chunked": (KV4, 16, 16, "eager")}


@pytest.fixture(scope="module", params=sorted(CASES))
def ledgers(request, weights):
    """One case served by the reference engine (drained, `xla`) and by
    the port's engine through the front end, each with a ledger. Over
    the packed cache the port runs `eager`, where the reference's dense
    decode rounds a packed cache to bfloat16 (tests/test_torch_engine.py
    explains the pairing)."""
    pol, page, chunk, t_backend = CASES[request.param]
    prompts = _prompts((5, 9, 40, 13, 2), seed=12)
    max_news = [4, 6, 3, 1, 5]
    jmodel = j_build_model(JArchConfig(**TINY),
                           JQuantPolicy(**pol), remat=False)
    jeng = JServingEngine(jmodel, weights[0], JEngineCfg(
        batch_slots=2, max_len=64, prefill_chunk=chunk,
        page_pool=JPagePoolCfg(page_size=page) if page else None))
    jledger = JMetricsLedger()
    _drained(jeng, prompts, max_news, metrics=jledger)
    ledger = MetricsLedger()
    eng = _engine(weights[1], policy=QuantPolicy(**pol), max_len=64,
                  page_pool=PagePoolCfg(page_size=page) if page else None,
                  prefill_chunk=chunk, backend=t_backend)
    _async(eng, prompts, max_news, metrics=ledger)
    return jledger, ledger


def test_ledger_records_match_reference(ledgers):
    jledger, ledger = ledgers
    assert ledger.meta == jledger.meta
    assert len(ledger.step_records) == len(jledger.step_records)
    for got, ref in zip(ledger.step_records, jledger.step_records):
        assert set(got) - {"dispatch"} == set(ref) - {"dispatch"}
        assert {k: got[k] for k in STEP_FIELDS if k in ref} == \
            {k: ref[k] for k in STEP_FIELDS if k in ref}
    keys = ("kind", "uid", "n_tokens", "finish_reason")
    assert [{k: r[k] for k in keys} for r in ledger.request_records] == \
        [{k: r[k] for k in keys} for r in jledger.request_records]
    assert all(set(r) == set(j) for r, j in zip(ledger.request_records,
                                                jledger.request_records))
    snap, jsnap = ledger.snapshot(), jledger.snapshot()
    assert set(snap) == set(jsnap)
    for key in ("steps", "requests", "tokens", "prefill_chunk_steps",
                "interleaved_steps", "prefill_interleave_ratio",
                "finish_reasons", "fallbacks", "queue_depth",
                "batch_occupancy", "pool_occupancy", "pool_fragmentation",
                "pool_device_occupancy"):
        assert snap.get(key) == jsnap.get(key), key


def test_reference_reads_the_port_trace(ledgers, tmp_path):
    _, ledger = ledgers
    path = str(tmp_path / "port.jsonl")
    ledger.write_jsonl(path)
    ref, got = j_load_trace(path), load_trace(path)
    assert ref == got
    assert got["steps"] == ledger.step_records
    assert got["summary"] == ledger.snapshot()
