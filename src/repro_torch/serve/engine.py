"""Batched serving engine: continuous batching over fixed decode slots.
Port of the slab and paged modes of `repro/serve/engine.py`.

Requests queue up; a free slot takes the next request, whose prompt is
prefilled into a fresh one-row cache (right-padded to a power-of-two
bucket of at least 16 tokens, exactly as the reference pads, so dynamic
activation scales see the same rows; a model with recurrent or ring
caches, which would absorb the pads, prefills at the prompt's exact
length) and spliced into the slot: every leaf of every cache site, KV
and recurrent state alike. Every step then runs one batched greedy
decode over all slots; slots free on EOS, max-new-tokens or the length
cap. `step()` returns `StepEvents`.
Caches are fp32 (or OVP-packed when the policy's kv_bits = 4) and are
updated in place.

PAGED mode (`EngineCfg.page_pool`): every cache site holds a shared pool
of fixed-size pages (`serve/paging.py`) and a per-slot block table maps
logical token rows to physical pages. Admission reserves a request's
worst-case pages up front (all or nothing; a head-of-line request that
does not fit blocks the queue), so a running request never runs out of
pages. Prefill runs in chunks of `EngineCfg.prefill_chunk` tokens (0: the
whole staged prompt at once): each step runs at most ONE chunk, one
fused cache-write prefill dispatch per layer (`backends.prefill_attention`,
K4 on the card) that attends the chunk over the request's raw K/V stage
and writes every stage tile onto its pages; decode reads K/V through the
block table (K3 on the card). Slots free their pages on completion;
`defrag()` compacts the pool.

STATIC scales (`EngineCfg.calibration`, or a model policy already
calibrated): the artifact is overlaid on the policy at construction, and
every quantized site that wants a static activation scale must have one
(`MissingStaticScaleError` lists the misses); the `cuda` backend then
runs every such linear on the static-scale kernel (K5).

COMPILED STEPS (`serve/capture.py`), as the reference jits its steps:
the decode step (greedy argmax included) is one `StepGraph`, the slab
prefill one per prompt bucket (or exact length), the paged prefill
chunk one per stage length; the prefill entries sit in an LRU of
`EngineCfg.prefill_cache_cap` entries. On the card each entry is
captured once as a CUDA graph, into one memory pool the engine's graphs
share, and replayed after; `capture=False` runs the same entries
eagerly (the CPU always does).
Every graph reads static buffers: the caches and block table (written in
place), one (1, max_len) row cache for the slab prefill, each paged
entry's raw K/V stage, and each entry's inputs, filled from the host
before a run. `trace_audit()` counts the builds as the reference counts
its traces.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.core.calibration import (CalibrationArtifact,
                                          MissingStaticScaleError,
                                          apply_calibration,
                                          static_scale_misses,
                                          uses_static_scales)
from repro_torch.kernels.prefill_attn import STAGE_KEYS
from repro_torch.models.model import Model
from repro_torch.serve.capture import StepGraph
from repro_torch.serve.paging import PagePool, PagePoolCfg, pages_for


def bucketable(cfg) -> bool:
    """Whether slab prefills may right-pad prompts to a bucket: under a
    causal mask real tokens never see the trailing pads, and the pad
    rows sit past `pos`, where decode overwrites them first; a recurrent
    state or a ring (sliding-window) cache absorbs them, so those block
    types keep the exact-length prefill (the reference's `_bucket_ok`)."""
    return all(bt in ("attn", "moe") for bt in cfg.block_pattern)


def check_servable(cfg) -> None:
    """Refuse an encoder-decoder: the engine feeds tokens only, and an
    encoder-decoder's prefill needs its encoder's input (`frames`). The
    reference engine fails there at the first prefill (a KeyError on
    `frames`); such a model runs through `Model.forward`."""
    if cfg.enc_dec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its prefill needs the "
            f"encoder's input frames, and the serving engine feeds tokens "
            f"only; run it through Model.forward (batch 'frames' and "
            f"'tokens', then decode steps)")


def check_pageable(cfg) -> None:
    """The reference engine's refusal of a page pool for a pattern that
    is not pure attn/moe."""
    if not bucketable(cfg):
        raise ValueError(
            f"page_pool needs a pure attn/moe block pattern "
            f"(ring/recurrent state does not page); got "
            f"{cfg.block_pattern}")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (T,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # "eos" | "max_new_tokens" | "length_cap"
    finish_reason: Optional[str] = None
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


@dataclasses.dataclass
class TokenEvent:
    """One sampled token, attributed to its request."""
    uid: int
    token: int
    index: int                  # 0-based position in Request.out_tokens
    first: bool                 # True for the prefill (TTFT) token
    done: bool
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class StepEvents:
    """What one `ServingEngine.step()` did; counts are per step."""
    step: int
    t_start: float
    t_end: float
    admitted: List[int]         # uids leaving the queue this step
    prefill_chunks: int         # chunked-prefill dispatches run (0 or 1)
    decode_batch: int           # active slots in this step's decode
    tokens: List[TokenEvent]
    queue_depth: int            # queued requests after the step
    active: int                 # occupied decode slots after the step
    prefilling: int             # requests mid-chunked-prefill after it


@dataclasses.dataclass
class _Prefilling:
    """One request mid-chunked-prefill (paged mode): its pages are
    reserved, its raw prompt K/V accumulates in per-layer stage tensors
    (its stage length's compiled entry's static stage, zeroed and handed
    over at the first chunk), and `step()` feeds one chunk per step
    until `written` reaches `target`."""
    req: Request
    slot: int
    toks: np.ndarray        # (stage_len,) right-padded prompt
    t: int                  # true prompt length
    chunk: int              # tokens per chunk (page-size multiple)
    stage_tiles: int        # staged rows // page_size
    pages: List[int]        # physical pages, logical order
    gen_pages: int          # pages kept after prefill (decode horizon)
    target: int             # chunked tokens to run: ceil(t/chunk)*chunk
    written: int            # tokens already prefilled
    stage: Optional[list] = None    # per layer {"stage_k", "stage_v"}


@dataclasses.dataclass
class EngineCfg:
    batch_slots: int = 4
    max_len: int = 256
    eos_id: int = -1            # -1: no EOS, run to max_new_tokens
    # execution backend override; None keeps the model policy's backend
    backend: Optional[str] = None
    # calibrated static activation scales, overlaid on the model policy
    # at construction (`apply_calibration`); with static-mode sites,
    # construction checks that every one has a scale and raises
    # `MissingStaticScaleError` with the full list otherwise
    calibration: Optional[CalibrationArtifact] = None
    # paged KV cache: a shared page pool + block tables instead of the
    # (batch_slots, max_len) slab, with chunked prefill. None = slab.
    page_pool: Optional[PagePoolCfg] = None
    # chunked-prefill chunk size in tokens (paged mode; rounded up to a
    # page multiple). 0 = the whole staged prompt in one chunk. Either
    # way at most ONE chunk runs per engine step, interleaved with decode.
    prefill_chunk: int = 0
    # LRU cap on the compiled prefill entries (slab: one per prompt
    # bucket; paged: one per stage length), as the reference caps its
    # jitted ones; an evicted entry's graph is dropped
    prefill_cache_cap: int = 8
    # device mesh for the sharded backend: a `runtime.elastic.MeshPlan`
    # over the running process group (or a built `launch.mesh.Mesh`),
    # installed by `backends.configure_mesh` at construction, before the
    # caches are made, so they hold this rank's KV heads. None leaves any
    # process-level mesh as it is: without one `cuda_sharded` declines
    # every call with `shard_no_mesh` and serves through its fallback.
    mesh: Optional[object] = None


class ServingEngine:
    """Engine on `device` (the tensors' device decides whether the
    kernels or their plain versions run), slab or paged; one rank of a
    mesh under `EngineCfg.mesh`, every rank running the same steps.
    On the card its steps are captured as CUDA graphs; `capture=False`
    runs them eagerly (the counterpart of the reference under
    `jax.disable_jit()`). `capture=None` captures unless the mesh's
    "model" axis runs its collectives over gloo, which works on the host
    where a CUDA graph cannot follow: those steps run eagerly, and
    `capture=True` there raises."""

    def __init__(self, model: Model, params, cfg: EngineCfg,
                 device="cuda", capture: Optional[bool] = None):
        if cfg.backend is not None and \
                model.policy.backends() != frozenset((cfg.backend,)):
            model = copy.copy(model)
            model.policy = model.policy.with_backend(cfg.backend)
        if cfg.calibration is not None:
            model = copy.copy(model)
            model.policy = apply_calibration(model.policy, cfg.calibration)
        for name in model.policy.backends():
            backends.get_backend(name)
        check_servable(model.cfg)
        if uses_static_scales(model.policy):
            misses = static_scale_misses(params, model.policy)
            if misses:
                raise MissingStaticScaleError(misses)
        if cfg.mesh is not None:
            backends.configure_mesh(cfg.mesh)
        self.eager_reason = _eager_reason(backends.current_mesh())
        if self.eager_reason and capture:
            raise ValueError(f"capture=True: {self.eager_reason}")
        capture = not self.eager_reason if capture is None else capture
        self._bucket_ok = bucketable(model.cfg)
        if cfg.page_pool is not None:
            check_pageable(model.cfg)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * cfg.batch_slots
        self.pos = np.zeros((cfg.batch_slots,), np.int32)
        self.completed: List[Request] = []
        self._uid = 0
        self.steps_run = 0
        self.prefills_run = 0
        self.prefill_chunks_run = 0
        self.decodes_run = 0
        self._token_events: List[TokenEvent] = []
        self._admitted_uids: List[int] = []
        self.capture = capture
        # one memory pool for every graph of the engine: a prefill graph
        # at bucket 256 holds (1, 256, vocab) f32 logits, so a pool per
        # graph would hold that once per cached entry
        self._pool = torch.cuda.graph_pool_handle() \
            if capture and self.device.type == "cuda" else None
        self.prefill_traces = 0     # prefill entries built
        self.decode_traces = 0      # the decode entry is built once
        self._prefill_jits = 0      # prefill entries created
        self.prefill_cache_evictions = 0
        # LRU over compiled prefill entries, keyed by bucket or exact
        # prompt length (slab) or ("paged", stage_len)
        self._prefill_cache: collections.OrderedDict[object, StepGraph] = \
            collections.OrderedDict()
        b = cfg.batch_slots
        self._decode = self._step_graph(
            self._decode_fn,
            {"tokens": torch.zeros((b, 1), dtype=torch.int64,
                                   device=self.device),
             "pos": torch.zeros((b,), dtype=torch.int32,
                                device=self.device)},
            "decode_traces")
        self.paged = cfg.page_pool is not None
        if not self.paged:
            self.caches = model.init_caches(b, cfg.max_len,
                                            device=self.device)
            # the slab prefill's static row cache, reset from a fresh
            # one inside every prefill (spliced rows match a fresh cache)
            self._row_cache = model.init_caches(1, cfg.max_len,
                                                device=self.device)
            self._row_fresh = model.init_caches(1, cfg.max_len,
                                                device=self.device)
            return
        pp = cfg.page_pool
        # the table covers the BUCKETED stage of the longest prompt, not
        # just max_len (buckets round up to powers of two)
        self.pages_per_row = pages_for(self._bucket(cfg.max_len),
                                       pp.page_size)
        n_pages = pp.n_pages or cfg.batch_slots * self.pages_per_row
        self.pool = PagePool(n_pages, pp.page_size)
        self._bt = np.zeros((cfg.batch_slots, self.pages_per_row), np.int32)
        self.caches = model.init_paged_caches(
            n_pages, pp.page_size, cfg.batch_slots, self.pages_per_row,
            device=self.device)
        # one device table shared by every site: page ids back the same
        # token rows in every layer
        self._bt_dev = torch.zeros(self._bt.shape, dtype=torch.int32,
                                   device=self.device)
        for site in self._sites():
            site["block_table"] = self._bt_dev
        self._prefilling: collections.deque[_Prefilling] = \
            collections.deque()
        self._prefill_slots: set = set()
        # inactive slots decode in the batch like everyone else; park
        # their write index past the table capacity so the write goes to
        # the sink page instead of page 0, which a live request may own
        self._pos_parked = self.pages_per_row * pp.page_size
        self.pos[:] = self._pos_parked
        self._sync_tables()

    # -------------------------------------------------------------- API
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16) -> int:
        self._uid += 1
        self.queue.append(Request(uid=self._uid,
                                  prompt=np.asarray(prompt, np.int32),
                                  max_new_tokens=max_new_tokens,
                                  t_submit=time.monotonic()))
        return self._uid

    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def _emit_token(self, req: Request, tok: int, first: bool):
        self._token_events.append(TokenEvent(
            uid=req.uid, token=tok, index=len(req.out_tokens) - 1,
            first=first, done=req.done, finish_reason=req.finish_reason))

    # ---------------------------------------------------- compiled steps
    def _step_graph(self, fn, inputs, counter: str) -> StepGraph:
        """A compiled entry whose build bumps the trace counter
        `counter`."""
        def built():
            setattr(self, counter, getattr(self, counter) + 1)
        return StepGraph(fn, inputs, capture=self.capture, pool=self._pool,
                         on_build=built)

    def _prefill_entry(self, key, make) -> StepGraph:
        """The compiled prefill entry for `key`, from the LRU or made by
        `make()` (the reference's `_jit_prefill`); past the cap the least
        recently used entry and its graph are dropped."""
        cache = self._prefill_cache
        if key in cache:
            cache.move_to_end(key)
            return cache[key]
        entry = make()
        self._prefill_jits += 1
        cache[key] = entry
        while len(cache) > max(1, self.cfg.prefill_cache_cap):
            cache.popitem(last=False)
            self.prefill_cache_evictions += 1
        return entry

    def trace_audit(self) -> Dict[str, int]:
        """The reference's trace ledger: entry builds ("traces") against
        entries created ("jits"). A prefill entry built twice, or a
        decode entry built more than once, counts as unexpected. An
        evicted entry is built again when its key returns (the reference
        keeps jax's trace cache, so its traces can stay below its jits)."""
        audit = {
            "prefill_traces": self.prefill_traces,
            "prefill_jits": self._prefill_jits,
            "decode_traces": self.decode_traces,
            "unexpected_retraces":
                max(0, self.prefill_traces - self._prefill_jits)
                + max(0, self.decode_traces - 1),
        }
        if self.eager_reason:
            audit["eager_steps"] = self.eager_reason
        return audit

    def _decode_fn(self, tokens, pos):
        """One batched greedy decode over every slot; the caches are
        written in place. Returns the logits (B, V) and the tokens (B,)."""
        logits, _ = self.model.forward(
            self.params, {"tokens": tokens, "pos": pos}, mode="decode",
            caches=self.caches)
        logits = logits[:, 0]
        return logits, torch.argmax(logits, dim=-1)

    def _slab_prefill_fn(self, tokens, last):
        """Prefill one prompt (1, bucket or length) into the reset row
        cache; the logits (V,) at index `last` (1,) and their argmax."""
        for fresh, row in zip(_leaves(self._row_fresh),
                              _leaves(self._row_cache)):
            row.copy_(fresh)
        logits, _ = self.model.forward(self.params, {"tokens": tokens},
                                       mode="prefill",
                                       caches=self._row_cache)
        logits = torch.index_select(logits[0], 0, last)[0]
        return logits, torch.argmax(logits)

    def _prefill(self, prompt: np.ndarray):
        """Prefill one prompt into the row cache through its bucket's
        entry (its length's, where the model cannot bucket); returns the
        logits at the last prompt token and the greedy token (device
        tensors)."""
        t = len(prompt)
        bucket = self._bucket(t) if self._bucket_ok else t
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :t] = prompt  # right-pad; the causal mask shields the pads

        def make():
            return self._step_graph(
                self._slab_prefill_fn,
                {"tokens": torch.zeros((1, bucket), dtype=torch.int64,
                                       device=self.device),
                 "last": torch.zeros((1,), dtype=torch.int64,
                                     device=self.device)},
                "prefill_traces")

        entry = self._prefill_entry(bucket, make)
        out = entry.run(tokens=toks, last=np.array([t - 1], np.int64))
        self.prefills_run += 1
        return out

    def _admit(self):
        if self.paged:
            self._admit_paged()
        else:
            self._admit_slab()

    def _admit_slab(self):
        """Fill free slots from the queue, one prefill per request."""
        for s in range(self.cfg.batch_slots):
            # a request finished by its own prefill token frees the slot
            # for the next queued request in the same pass
            while self.slots[s] is None and self.queue:
                req = self.queue.popleft()
                self._admitted_uids.append(req.uid)
                _, nxt = self._prefill(req.prompt)
                nxt = int(nxt)
                _splice_slot(self.caches, self._row_cache, s)
                self.pos[s] = len(req.prompt)
                req.out_tokens.append(nxt)
                req.t_first = time.monotonic()
                finished = self._finish_at_admit(req, nxt)
                self._emit_token(req, nxt, first=True)
                if not finished:
                    self.slots[s] = req

    def _finish_at_admit(self, req: Request, nxt: int) -> bool:
        """The prefill token already meets the budget or is EOS."""
        if self.cfg.eos_id >= 0 and nxt == self.cfg.eos_id:
            req.finish_reason = "eos"
        elif len(req.out_tokens) >= req.max_new_tokens:
            req.finish_reason = "max_new_tokens"
        else:
            return False
        req.done = True
        req.t_done = time.monotonic()
        self.completed.append(req)
        return True

    # ------------------------------------------------------- paged mode
    def _sites(self):
        return [layer["kv"] for layer in self.caches["layers"]]

    def _sync_tables(self):
        """Push the host block table to the device table every site
        shares."""
        self._bt_dev.copy_(torch.from_numpy(self._bt))

    def _chunk_fn(self, stage, tokens, positions, table, len_m1):
        """One chunked-prefill dispatch of one request: tokens (1, C) at
        absolute positions (1, C) over its raw stage and its block-table
        row `table` (1, stage_tiles); the pools are written in place.
        Returns the logits at the prompt's last index `len_m1` (1,),
        clipped into the chunk, and their argmax."""
        view = {"layers": [{"kv": dict(site, block_table=table, **st)}
                           for site, st in zip(self._sites(), stage)]}
        logits, _ = self.model.forward(self.params, {"tokens": tokens},
                                       mode="prefill", caches=view,
                                       positions=positions)
        idx = torch.clamp(len_m1 - positions[0, :1], 0,
                          tokens.shape[1] - 1)
        logits = torch.index_select(logits[0], 0, idx)[0]
        return logits, torch.argmax(logits)

    def _chunk_entry(self, pf: _Prefilling) -> StepGraph:
        """The compiled chunk entry of `pf`'s stage length, with its
        static stage."""
        stage_len = len(pf.toks)
        cfg = self.model.cfg

        def make():
            # a site's stage holds the KV heads its pool holds
            stage = [{key: torch.zeros(
                (1, stage_len, _kv_leaf(site).shape[2], cfg.head_dim),
                device=self.device) for key in STAGE_KEYS}
                for site in self._sites()]
            return self._step_graph(
                self._chunk_fn,
                {"stage": stage,
                 "tokens": torch.zeros((1, pf.chunk), dtype=torch.int64,
                                       device=self.device),
                 "positions": torch.zeros((1, pf.chunk), dtype=torch.int64,
                                          device=self.device),
                 "table": torch.zeros((1, pf.stage_tiles),
                                      dtype=torch.int32, device=self.device),
                 "len_m1": torch.zeros((1,), dtype=torch.int64,
                                       device=self.device)},
                "prefill_traces")

        return self._prefill_entry(("paged", stage_len), make)

    def _admit_paged(self):
        """Reserve pages + a slot for queued requests and move them into
        the chunked-prefill pipeline. Admission is all-or-nothing on the
        request's WORST-CASE page budget (prompt stage + full decode
        horizon), so a running request never runs out of pages; FIFO
        order holds — a head-of-line request that does not fit blocks
        the queue until frees make room."""
        ps = self.pool.page_size
        for s in range(self.cfg.batch_slots):
            if not self.queue:
                return
            if self.slots[s] is not None or s in self._prefill_slots:
                continue
            req = self.queue[0]
            t = len(req.prompt)
            chunk = self.cfg.prefill_chunk
            chunk = -(-chunk // ps) * ps if chunk else 0
            stage_len = -(-self._bucket(t) // (chunk or ps)) * (chunk or ps)
            chunk = chunk or stage_len
            stage_tiles = stage_len // ps
            horizon = min(t + req.max_new_tokens, self.cfg.max_len)
            gen_pages = pages_for(horizon, ps)
            need = max(gen_pages, stage_tiles)
            got = self.pool.alloc(need, req.uid)
            if got is None:
                return
            self.queue.popleft()
            self._admitted_uids.append(req.uid)
            toks = np.zeros((stage_len,), np.int64)
            toks[:t] = req.prompt
            self._bt[s, :] = 0
            self._bt[s, :need] = got
            self._sync_tables()
            self._prefilling.append(_Prefilling(
                req=req, slot=s, toks=toks, t=t, chunk=chunk,
                stage_tiles=stage_tiles, pages=got,
                gen_pages=gen_pages, target=-(-t // chunk) * chunk,
                written=0))
            self._prefill_slots.add(s)

    def _run_prefill_chunk(self):
        """Feed ONE chunk of the oldest mid-prefill request through the
        fused cache-write prefill: the per-step prefill budget that keeps
        long prompts from stalling the decode batch. Only this head
        request runs chunks until its prompt is done, so it holds its
        stage length's static stage from its first chunk on (zeroed
        then, as a fresh stage)."""
        if not self._prefilling:
            return
        pf = self._prefilling[0]
        off = pf.written
        entry = self._chunk_entry(pf)
        if off == 0:
            pf.stage = entry.inputs["stage"]
            for st in pf.stage:
                for leaf in st.values():
                    leaf.zero_()
        _, nxt = entry.run(
            tokens=pf.toks[None, off:off + pf.chunk],
            positions=np.arange(off, off + pf.chunk, dtype=np.int64)[None],
            table=np.asarray(pf.pages[:pf.stage_tiles], np.int32)[None],
            len_m1=np.array([pf.t - 1], np.int64))
        self.prefill_chunks_run += 1
        pf.written += pf.chunk
        if pf.written < pf.target:
            return
        # prompt fully prefilled: release the stage-only page surplus
        # (stage tiles past the decode horizon) and activate the slot
        req, s = pf.req, pf.slot
        self._prefilling.popleft()
        self._prefill_slots.discard(s)
        if len(pf.pages) > pf.gen_pages:
            self.pool.free(req.uid, pf.pages[pf.gen_pages:])
        self._bt[s, :] = 0
        self._bt[s, :pf.gen_pages] = pf.pages[:pf.gen_pages]
        self._sync_tables()
        nxt = int(nxt)
        req.out_tokens.append(nxt)
        req.t_first = time.monotonic()
        finished = self._finish_at_admit(req, nxt)
        self._emit_token(req, nxt, first=True)
        if finished:
            self._free_slot_pages(s, req)
            return
        self.pos[s] = pf.t
        self.slots[s] = req

    def _free_slot_pages(self, s: int, req: Request):
        self.pool.free(req.uid)
        self._bt[s, :] = 0
        self.pos[s] = self._pos_parked
        self._sync_tables()

    def defrag(self):
        """Compact live pages onto the low end of the pool (paged mode):
        gathers every site's pool by the compaction source map, in place
        (the sink page stays last), and rebuilds the block tables. Pages
        are position-independent, so served tokens do not change.
        Returns the page-id remap, or None in slab mode."""
        if not self.paged:
            return None
        src, remap = self.pool.compact()
        n = self.pool.n_pages
        src_dev = torch.as_tensor(src, dtype=torch.int64, device=self.device)
        for site in self._sites():
            for key, leaf in site.items():
                if key != "block_table":
                    leaf[:n] = leaf[src_dev]
        self._bt[:] = 0
        for pf in self._prefilling:
            pf.pages = self.pool.pages_of(pf.req.uid)
            self._bt[pf.slot, :len(pf.pages)] = pf.pages
        for s, r in enumerate(self.slots):
            if r is not None:
                pages = self.pool.pages_of(r.uid)
                self._bt[s, :len(pages)] = pages
        self._sync_tables()
        return remap

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def step(self) -> StepEvents:
        """Admit, at most one prefill chunk (paged mode), then one batched
        greedy decode over every active slot."""
        t_start = time.monotonic()
        self._token_events = []
        self._admitted_uids = []
        chunks_before = self.prefill_chunks_run
        self._admit()
        if self.paged:
            self._run_prefill_chunk()
        act = self._active()
        if act:
            tokens = np.zeros((self.cfg.batch_slots, 1), np.int64)
            for i in act:
                tokens[i, 0] = self.slots[i].out_tokens[-1]
            _, nxt = self._decode.run(tokens=tokens, pos=self.pos)
            self.decodes_run += 1
            nxt = nxt.cpu().numpy()     # the step's one host sync
            for i in act:
                req = self.slots[i]
                self.pos[i] += 1
                tok = int(nxt[i])
                req.out_tokens.append(tok)
                if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
                    reason = "eos"
                elif len(req.out_tokens) >= req.max_new_tokens:
                    reason = "max_new_tokens"
                elif int(self.pos[i]) >= self.cfg.max_len - 1:
                    reason = "length_cap"
                else:
                    self._emit_token(req, tok, first=False)
                    continue
                req.done = True
                req.finish_reason = reason
                req.t_done = time.monotonic()
                self.completed.append(req)
                self.slots[i] = None
                if self.paged:
                    self._free_slot_pages(i, req)
                self._emit_token(req, tok, first=False)
        ev = StepEvents(
            step=self.steps_run, t_start=t_start, t_end=time.monotonic(),
            admitted=self._admitted_uids,
            prefill_chunks=self.prefill_chunks_run - chunks_before,
            decode_batch=len(act), tokens=self._token_events,
            queue_depth=len(self.queue), active=len(self._active()),
            prefilling=len(self._prefilling) if self.paged else 0)
        self.steps_run += 1
        return ev

    def has_work(self) -> bool:
        """True while a step could make progress: requests queued,
        decoding, or mid-chunked-prefill."""
        return bool(self.queue or self._active()
                    or (self.paged and self._prefilling))

    def run_until_drained(self, max_steps: int = 10000,
                          metrics=None) -> List[Request]:
        """Step until no request is queued, prefilling or decoding.
        `metrics` (a `serve.metrics.MetricsLedger`) records every step's
        events, as the async front end feeds it, so the two loops give
        comparable traces."""
        steps = 0
        while self.has_work() and steps < max_steps:
            ev = self.step()
            if metrics is not None:
                metrics.on_step(ev, self)
            steps += 1
        return self.completed

    def stats(self) -> Dict[str, object]:
        """Lifetime counters since construction (slab prefills, prefill
        chunks, batched decode forwards, steps; the model's forward calls
        are the sum of the first three; prefill entries built and
        evicted), the gauge `prefill_cache_size`, and in paged mode the
        page pool's `PagePool.stats()` under "page_pool", whose
        used/free/occupancy entries are gauges."""
        st: Dict[str, object] = {"steps_run": self.steps_run,
                                 "prefills_run": self.prefills_run,
                                 "prefill_chunks_run":
                                     self.prefill_chunks_run,
                                 "decodes_run": self.decodes_run,
                                 "prefill_traces": self.prefill_traces,
                                 "prefill_cache_size":
                                     len(self._prefill_cache),
                                 "prefill_cache_evictions":
                                     self.prefill_cache_evictions}
        if self.paged:
            st["page_pool"] = self.pool.stats()
        if self.eager_reason:
            st["eager_steps"] = self.eager_reason
        return st

    def device_pool_stats(self) -> Dict[str, object]:
        """The KV pool's footprint per device (paged mode). Under a mesh
        whose "model" axis splits the KV heads, each of its `tp` devices
        holds 1/tp of the pool bytes, measured from this rank's own pool,
        at the same page occupancy (pages allocate globally; devices
        differ only in which heads of a page they hold), so the
        occupancy repeats once per device. Otherwise one device holds
        every pool byte. Slab mode reports no pool."""
        if not self.paged:
            return {"n_devices": 1, "pool_bytes_total": 0,
                    "pool_bytes_per_device": 0, "occupancy_per_device": []}
        local = sum(leaf.numel() * leaf.element_size()
                    for site in self._sites()
                    for key, leaf in site.items() if key != "block_table")
        part = backends.sharded.cache_part(self._sites()[0])
        tp = part[2] // part[1] if part else 1
        return {"n_devices": tp, "pool_bytes_total": int(local) * tp,
                "pool_bytes_per_device": int(local),
                "occupancy_per_device": [float(self.pool.occupancy())] * tp}


def _kv_leaf(site) -> torch.Tensor:
    return site["k"] if "k" in site else site["k_data"]


def _eager_reason(mesh) -> Optional[str]:
    """Why steps on `mesh` cannot be captured, or None."""
    if mesh is None or mesh.backend != "gloo" or all(
            mesh.size(a) == 1 for a in mesh.axis_names):
        return None
    return ("the mesh runs its collectives (the \"model\" axis's, and the "
            "FSDP gathers of the batch axes) over gloo, on the host, which "
            "a CUDA graph cannot capture: steps run eagerly")


def _leaves(caches) -> List[torch.Tensor]:
    """Every tensor of a slab cache tree (KV caches and recurrent states,
    nested ones such as an mLSTM site's `mem` included), in a fixed
    order: depth first, in each dict's key order."""
    def walk(node):
        if isinstance(node, torch.Tensor):
            return [node]
        return [leaf for child in node.values() for leaf in walk(child)]

    return [leaf for layer in caches["layers"] for leaf in walk(layer)]


def _splice_slot(full_caches, row_caches, slot: int) -> None:
    """Copy a one-row cache tree into row `slot` of the batched caches,
    in place."""
    for full, row in zip(_leaves(full_caches), _leaves(row_caches)):
        full[slot:slot + 1].copy_(row)
