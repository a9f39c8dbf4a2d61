"""Trainer: the fault-tolerant training loop. Port of
`repro/train/trainer.py`.

Wires together the stateless loader, the train step, async
checkpointing (in the reference's on-disk layout, `convert`),
preemption handling and the straggler monitor. Restart-safe: resuming
from step N replays the exact data stream from N (stateless loader) on
top of the restored state. On a mesh (`placement`, a
`sharding.state.Placement`) each rank holds its parts of the state and
runs the sharded step (`step_fn`, `eval_fn`), a save gathers the whole
state leaf by leaf to the host and rank 0 writes it in the same layout,
and a restore reads the whole state and keeps this rank's parts under
its own plan: a checkpoint crosses mesh shapes and packages. Unlike the reference, a run whose last save
(periodic or on preemption) holds its final step waits for that save
instead of writing the same state again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.data.loader import SyntheticLoader
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault import (PreemptionHandler, StepTimer,
                                       StragglerMonitor)

from .train_step import TrainState, init_state, lm_loss, make_train_step


@dataclasses.dataclass
class TrainerCfg:
    total_steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    ckpt_async: bool = True
    eval_every: int = 0
    eval_batches: int = 2
    log_every: int = 10
    n_microbatches: int = 1
    seed: int = 0


class Trainer:
    def __init__(self, model: Model, optimizer: AdamW,
                 loader: SyntheticLoader, tcfg: TrainerCfg,
                 log_fn: Callable[[str], None] = print, device="cuda",
                 placement=None, step_fn=None, eval_fn=None):
        self.model = model
        self.optimizer = optimizer
        self.loader = loader
        self.tcfg = tcfg
        self.log = log_fn
        self.device = torch.device(device)
        self.preempt = PreemptionHandler()
        self.monitor = StragglerMonitor(n_hosts=1)
        self.placement = placement
        self.step_fn = step_fn or make_train_step(
            model, optimizer, n_microbatches=tcfg.n_microbatches)
        # (params, batch) -> the batch's CE
        self.eval_fn = eval_fn or (lambda params, batch: lm_loss(
            model, params, batch)[1]["ce"])
        self.state: Optional[TrainState] = None
        self.step = 0
        self._pending_save = None
        self._saved = (None, 0.0)           # (step, start) of the last save
        # seconds from the start of a save to its publication, the last
        # one the trainer waited for, and of the restore (read, placement
        # on the device, layout)
        self.ckpt_seconds = {"save": None, "restore": None}

    # ------------------------------------------------------------ state
    def init_or_restore(self, state: Optional[TrainState] = None):
        """Restore the newest checkpoint of `ckpt_dir` when there is one;
        else start from `state`, or from params drawn by `Model.init`
        with a generator seeded by `seed` on the trainer's device."""
        start = None
        if self.tcfg.ckpt_dir:
            start = ckpt.latest_step(self.tcfg.ckpt_dir)
        if start is not None:
            t0 = time.perf_counter()
            # the structure and dtypes on "meta": no memory, no draws
            meta = init_state(self.model, self.optimizer, None,
                              device="meta")
            template = convert.state_to_reference(meta, self.model.cfg)
            if self.placement is None:
                got = ckpt.restore(self.tcfg.ckpt_dir, start,
                                   {"state": template}, device=self.device)
                self.state = convert.state_from_reference(got["state"],
                                                          self.device)
            else:
                got = ckpt.restore(self.tcfg.ckpt_dir, start,
                                   {"state": template}, device="cpu")
                self.state = self.placement.local(
                    convert.state_from_reference(got["state"], "cpu"),
                    self.device)
            self.ckpt_seconds["restore"] = time.perf_counter() - t0
            self.step = start
            self.log(f"[trainer] restored step {start} from "
                     f"{self.tcfg.ckpt_dir}")
        else:
            if state is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    self.tcfg.seed)
                if self.placement is None:
                    state = init_state(self.model, self.optimizer, gen,
                                       device=self.device)
                else:
                    state = self.placement.init(self.model, self.optimizer,
                                                gen, self.device)
            self.state = state
            self.step = 0
        return self

    def _wait_save(self):
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None
            self.ckpt_seconds["save"] = time.perf_counter() - self._saved[1]

    def save(self, blocking=False, tag=""):
        if not self.tcfg.ckpt_dir:
            return
        self._wait_save()
        self._saved = (self.step, time.perf_counter())
        state = self.state
        if self.placement is not None:
            state = self.placement.whole(state, "cpu")   # every rank
            if not self.placement.writer:
                self.ckpt_seconds["save"] = time.perf_counter() \
                    - self._saved[1]
                return
        self._pending_save = ckpt.save(
            self.tcfg.ckpt_dir, self.step,
            {"state": convert.state_to_reference(state, self.model.cfg)},
            blocking=blocking or not self.tcfg.ckpt_async)
        if self._pending_save is None:
            self.ckpt_seconds["save"] = time.perf_counter() - self._saved[1]
        if tag:
            self.log(f"[trainer] checkpoint @ step {self.step} ({tag})")

    def _batch(self, step: int, eval_split: bool = False):
        return {k: v.to(self.device) for k, v in
                self.loader.global_batch_at(step, eval_split).items()}

    # ------------------------------------------------------------- loop
    def run(self) -> Dict[str, list]:
        assert self.state is not None, "call init_or_restore() first"
        history = {"step": [], "loss": [], "grad_norm": [],
                   "step_time": []}
        while self.step < self.tcfg.total_steps:
            if self.preempt.should_stop:
                self.save(blocking=True, tag="preemption")
                self.log(f"[trainer] preempted at step {self.step}; "
                         "state saved")
                break
            batch = self._batch(self.step)
            with StepTimer(self.monitor, host=0, device=self.device) as t:
                self.state, metrics = self.step_fn(self.state, batch)
            self.step += 1
            loss = float(metrics["loss"])
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.total_steps:
                self.log(f"[trainer] step {self.step} "
                         f"loss {loss:.4f} "
                         f"gnorm {float(metrics['grad_norm']):.3f} "
                         f"({t.last * 1e3:.0f} ms)")
            history["step"].append(self.step)
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["step_time"].append(t.last)
            if self.tcfg.ckpt_every and \
                    self.step % self.tcfg.ckpt_every == 0:
                self.save(tag="periodic")
            if self.tcfg.eval_every and \
                    self.step % self.tcfg.eval_every == 0:
                ppl = self.evaluate()
                self.log(f"[trainer] step {self.step} eval ppl {ppl:.3f}")
            if not self.monitor.healthy():
                self.log(f"[trainer] stragglers: "
                         f"{self.monitor.stragglers()}")
        if self.tcfg.ckpt_dir and self._saved[0] == self.step:
            # the newest save already holds this step: wait for it, not
            # write the same state again
            self._wait_save()
        else:
            self.save(blocking=True, tag="final")
        return history

    # ------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, n_batches: Optional[int] = None) -> float:
        """Held-out perplexity: exp of the mean CE over the first
        `n_batches` batches of the eval split."""
        n = n_batches or self.tcfg.eval_batches
        tot, cnt = 0.0, 0
        for i in range(n):
            tot += float(self.eval_fn(self.state.params,
                                      self._batch(i, eval_split=True)))
            cnt += 1
        return float(np.exp(tot / max(cnt, 1)))
