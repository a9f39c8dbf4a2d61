"""Batched serving engine: continuous batching over fixed decode slots.
Port of the slab mode of `repro/serve/engine.py`.

Requests queue up; a free slot takes the next request, whose prompt is
prefilled into a fresh one-row cache (right-padded to a power-of-two
bucket of at least 16 tokens, exactly as the reference pads, so dynamic
activation scales see the same rows) and spliced into the slot. Every
step then runs one batched greedy decode over all slots; slots free on
EOS, max-new-tokens or the length cap. `step()` returns `StepEvents`.
Caches are fp32 (or OVP-packed when the policy's kv_bits = 4) and are
updated in place.
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
from repro_torch.models.model import Model


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
    admitted: List[int]
    decode_batch: int
    tokens: List[TokenEvent]
    queue_depth: int
    active: int


@dataclasses.dataclass
class EngineCfg:
    batch_slots: int = 4
    max_len: int = 256
    eos_id: int = -1            # -1: no EOS, run to max_new_tokens
    # execution backend override; None keeps the model policy's backend
    backend: Optional[str] = None


class ServingEngine:
    """Single-device slab engine on `device` (the tensors' device decides
    whether the kernels or their plain versions run)."""

    def __init__(self, model: Model, params, cfg: EngineCfg,
                 device="cuda"):
        if cfg.backend is not None and \
                model.policy.backends() != frozenset((cfg.backend,)):
            model = copy.copy(model)
            model.policy = model.policy.with_backend(cfg.backend)
        for name in model.policy.backends():
            backends.get_backend(name)
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
        self._token_events: List[TokenEvent] = []
        self._admitted_uids: List[int] = []
        self.caches = model.init_caches(cfg.batch_slots, cfg.max_len,
                                        device=self.device)

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

    def _prefill(self, prompt: np.ndarray):
        """Logits at the last prompt token and the filled one-row cache."""
        t = len(prompt)
        toks = np.zeros((self._bucket(t),), np.int64)
        toks[:t] = prompt  # right-pad; the causal mask shields the pads
        row_cache = self.model.init_caches(1, self.cfg.max_len,
                                           device=self.device)
        logits, row_cache = self.model.forward(
            self.params, {"tokens": torch.as_tensor(toks[None],
                                                    device=self.device)},
            mode="prefill", caches=row_cache)
        self.prefills_run += 1
        return logits[0, t - 1], row_cache

    def _admit_slab(self):
        """Fill free slots from the queue, one prefill per request."""
        for s in range(self.cfg.batch_slots):
            # a request finished by its own prefill token frees the slot
            # for the next queued request in the same pass
            while self.slots[s] is None and self.queue:
                req = self.queue.popleft()
                self._admitted_uids.append(req.uid)
                logits, row_cache = self._prefill(req.prompt)
                _splice_slot(self.caches, row_cache, s)
                self.pos[s] = len(req.prompt)
                nxt = int(torch.argmax(logits))
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

    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def step(self) -> StepEvents:
        """Admit, then one batched greedy decode over every slot."""
        t_start = time.monotonic()
        self._token_events = []
        self._admitted_uids = []
        self._admit_slab()
        act = self._active()
        if act:
            tokens = np.zeros((self.cfg.batch_slots, 1), np.int64)
            for i in act:
                tokens[i, 0] = self.slots[i].out_tokens[-1]
            logits, self.caches = self.model.forward(
                self.params,
                {"tokens": torch.as_tensor(tokens, device=self.device),
                 "pos": torch.as_tensor(self.pos, device=self.device)},
                mode="decode", caches=self.caches)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
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
                self._emit_token(req, tok, first=False)
        ev = StepEvents(
            step=self.steps_run, t_start=t_start, t_end=time.monotonic(),
            admitted=self._admitted_uids, decode_batch=len(act),
            tokens=self._token_events, queue_depth=len(self.queue),
            active=len(self._active()))
        self.steps_run += 1
        return ev

    def has_work(self) -> bool:
        return bool(self.queue or self._active())

    def run_until_drained(self, max_steps: int = 10000) -> List[Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

    def stats(self) -> Dict[str, object]:
        """Lifetime counters since construction."""
        return {"steps_run": self.steps_run,
                "prefills_run": self.prefills_run}


def _splice_slot(full_caches, row_caches, slot: int) -> None:
    """Copy a one-row cache tree into row `slot` of the batched caches,
    in place."""
    for full, row in zip(full_caches["layers"], row_caches["layers"]):
        for key, leaf in full["kv"].items():
            leaf[slot:slot + 1].copy_(row["kv"][key])
