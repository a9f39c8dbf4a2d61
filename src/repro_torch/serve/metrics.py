"""Step-level serving observability: the TTFT/TPOT SLO ledger. Port of
`repro/serve/metrics.py`.

`MetricsLedger.on_step(events, engine)` takes the `StepEvents` that
`ServingEngine.step()` returns (the events the async front end publishes
tokens from) and keeps two record streams:

  step records     one per engine step: wall time, queue depth, batch
                   occupancy, decode batch size, prefill chunks, the
                   page-pool gauges (paged mode), and the step's delta of
                   `backends.dispatch_stats()`;
  request records  one per completed request: TTFT, TPOT, end-to-end
                   latency, token count, finish reason.

The vocabulary is the reference's (docs/serving.md quotes its table; all
times are `time.monotonic()` seconds):

| metric             | definition                                        |
|--------------------|---------------------------------------------------|
| `ttft_s`           | `t_first - t_submit`: the prefill token's sample  |
|                    | time minus submission                             |
| `tpot_s`           | `(t_done - t_first) / (n_tokens - 1)`; `None` for |
|                    | single-token requests                             |
| `latency_s`        | `t_done - t_submit`                               |
| `queue_depth`      | requests waiting in the engine queue after a step |
| `batch_occupancy`  | decode batch size / `batch_slots`                 |
| `pool_occupancy`   | `PagePool` used / total pages after the step      |
| `pool_fragmentation` | free fraction of the pool's live span           |
| `pool_device_occupancy` | the occupancy per device: `[pool_occupancy]`|
|                    | once per "model" shard under a mesh (pages        |
|                    | allocate globally; devices hold different heads)  |
| `prefill_interleave_ratio` | of the steps that ran a prefill chunk,    |
|                    | the fraction that also decoded                    |
| `dispatch` / `fallbacks` | summed `backends.dispatch_stats()` deltas;  |
|                    | `fallbacks` sums every `"->fallback:"` key        |
|                    | (quantized serving wants 0)                       |

Distributions (`_dist`) report `n/mean/p50/p95/min/max`.

One difference from the reference: its `dispatch_stats()` count jit
traces, so a step's `dispatch` delta lands only on the step that traced.
The port's count device executions (`serve/capture.py` adds one
execution's counts on every graph replay), so every step that ran a
forward carries a delta, and the summary's `dispatch` counts calls.

The JSONL trace (`write_jsonl`) is the reference's, key for key and in
its record order: one JSON object a line, discriminated by `"kind"`:
`"meta"`, then the `"step"` and `"request"` records in emission order,
then one `"summary"` (the `snapshot()` dict). The reference's
`load_trace` reads it, and so does this module's.
"""
from __future__ import annotations

import collections
import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch import backends
from repro_torch.serve.engine import ServingEngine, StepEvents


def _dist(xs: List[Optional[float]]) -> Dict[str, float]:
    """n/mean/p50/p95/min/max of the entries that are not None
    (`{"n": 0}` when none is)."""
    vals = [x for x in xs if x is not None]
    if not vals:
        return {"n": 0}
    a = np.asarray(vals, dtype=np.float64)
    return {"n": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "min": float(a.min()), "max": float(a.max())}


class MetricsLedger:
    """Step and request records from `StepEvents` (the module docstring
    gives the vocabulary). One ledger serves one engine run, fed by
    `run_until_drained(metrics=...)` or by `AsyncFrontend(metrics=...)`:
    both call `on_step` with the same events."""

    def __init__(self):
        self.step_records: List[dict] = []
        self.request_records: List[dict] = []
        self.meta: Optional[dict] = None
        self._t0: Optional[float] = None
        self._completed_seen = 0
        # the dispatch counters are process-wide; deltas give each step
        # its own
        self._last_dispatch = collections.Counter(backends.dispatch_stats())
        self._dispatch_total: collections.Counter = collections.Counter()

    def _capture_meta(self, engine: ServingEngine) -> dict:
        cfg = engine.cfg
        meta = {"kind": "meta", "batch_slots": cfg.batch_slots,
                "max_len": cfg.max_len, "paged": engine.paged,
                "prefill_chunk": cfg.prefill_chunk}
        if engine.paged:
            meta["page_size"] = engine.pool.page_size
            meta["n_pages"] = engine.pool.n_pages
        return meta

    def on_step(self, ev: StepEvents, engine: ServingEngine) -> dict:
        """Record one step's events; returns the step record. Host work
        only: it reads counters and the engine's host state, never the
        device."""
        if self.meta is None:
            self.meta = self._capture_meta(engine)
        if self._t0 is None:
            self._t0 = ev.t_start
        cur = collections.Counter(backends.dispatch_stats())
        delta = cur - self._last_dispatch
        self._last_dispatch = cur
        self._dispatch_total += delta
        rec = {
            "kind": "step",
            "step": ev.step,
            "t_s": ev.t_end - self._t0,
            "dt_s": ev.t_end - ev.t_start,
            "admitted": list(ev.admitted),
            "prefill_chunks": ev.prefill_chunks,
            "decode_batch": ev.decode_batch,
            "batch_occupancy": ev.decode_batch / engine.cfg.batch_slots,
            "tokens": len(ev.tokens),
            "first_tokens": sum(1 for t in ev.tokens if t.first),
            "completed": [t.uid for t in ev.tokens if t.done],
            "queue_depth": ev.queue_depth,
            "active": ev.active,
            "prefilling": ev.prefilling,
        }
        if engine.paged:
            pool = engine.pool
            rec["pool_occupancy"] = pool.occupancy()
            rec["pool_used_pages"] = pool.used_pages
            rec["pool_fragmentation"] = pool.fragmentation()
            rec["pool_alloc_failures"] = pool.alloc_failures
            rec["pool_device_occupancy"] = \
                engine.device_pool_stats()["occupancy_per_device"]
        if delta:
            rec["dispatch"] = dict(delta)
        self.step_records.append(rec)
        # engine.completed only grows: harvest the new requests
        for req in engine.completed[self._completed_seen:]:
            n = len(req.out_tokens)
            self.request_records.append({
                "kind": "request",
                "uid": req.uid,
                "n_tokens": n,
                "finish_reason": req.finish_reason,
                "ttft_s": req.t_first - req.t_submit,
                "tpot_s": ((req.t_done - req.t_first) / (n - 1)
                           if n > 1 else None),
                "latency_s": req.t_done - req.t_submit,
            })
        self._completed_seen = len(engine.completed)
        return rec

    def snapshot(self) -> dict:
        """The summary of everything recorded so far (the `"summary"`
        record): TTFT/TPOT/latency distributions over requests,
        queue-depth and occupancy distributions over steps, the
        chunked-prefill interleave ratio, and the summed dispatch counts
        with their fallback total."""
        steps = self.step_records
        reqs = self.request_records
        chunk_steps = [r for r in steps if r["prefill_chunks"] > 0]
        interleaved = [r for r in chunk_steps if r["decode_batch"] > 0]
        fallbacks = sum(v for k, v in self._dispatch_total.items()
                        if "->fallback:" in k)
        snap = {
            "kind": "summary",
            "steps": len(steps),
            "requests": len(reqs),
            "tokens": sum(r["tokens"] for r in steps),
            "wall_s": steps[-1]["t_s"] if steps else 0.0,
            "ttft_s": _dist([r["ttft_s"] for r in reqs]),
            "tpot_s": _dist([r["tpot_s"] for r in reqs]),
            "latency_s": _dist([r["latency_s"] for r in reqs]),
            "queue_depth": _dist([r["queue_depth"] for r in steps]),
            "batch_occupancy": _dist([r["batch_occupancy"]
                                      for r in steps]),
            "prefill_chunk_steps": len(chunk_steps),
            "interleaved_steps": len(interleaved),
            "prefill_interleave_ratio": (
                len(interleaved) / len(chunk_steps) if chunk_steps
                else None),
            "finish_reasons": dict(collections.Counter(
                r["finish_reason"] for r in reqs)),
            "dispatch": dict(self._dispatch_total),
            "fallbacks": fallbacks,
        }
        if steps and "pool_occupancy" in steps[0]:
            snap["pool_occupancy"] = _dist(
                [r.get("pool_occupancy") for r in steps])
            snap["pool_fragmentation"] = _dist(
                [r.get("pool_fragmentation") for r in steps])
        if steps and "pool_device_occupancy" in steps[0]:
            per_dev = [r.get("pool_device_occupancy") or [] for r in steps]
            snap["pool_device_occupancy"] = {
                "n_devices": max((len(p) for p in per_dev), default=0),
                "peak": max((max(p) for p in per_dev if p), default=0.0),
                "final": (per_dev[-1] if per_dev and per_dev[-1]
                          else []),
            }
        return snap

    def write_jsonl(self, path: str) -> None:
        """Write the trace: the meta line, the step and request records
        in emission order, then one summary line (`snapshot()`)."""
        with open(path, "w") as f:
            if self.meta is not None:
                f.write(json.dumps(self.meta) + "\n")
            for rec in self.step_records:
                f.write(json.dumps(rec) + "\n")
            for rec in self.request_records:
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps(self.snapshot()) + "\n")


def load_trace(path: str) -> Dict[str, object]:
    """Read a `write_jsonl` trace back, grouped by record kind:
    `{"meta": dict | None, "steps": [...], "requests": [...],
    "summary": dict | None}`."""
    out = {"meta": None, "steps": [], "requests": [], "summary": None}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "meta":
                out["meta"] = rec
            elif kind == "step":
                out["steps"].append(rec)
            elif kind == "request":
                out["requests"].append(rec)
            elif kind == "summary":
                out["summary"] = rec
    return out
