"""Stateless data loader, restart-safe by construction. Port of
`repro/data/loader.py`.

The batch for (step, rank) is a pure function of the run's corpus seed:
after a crash or preemption the trainer resumes at `step` and every
rank makes exactly the batch it would have seen, with no iterator state
to checkpoint. Batches are int64 CPU tensors {"tokens", "labels"} (the
labels are the tokens shifted by one).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .synthetic import CorpusCfg, sample_batch


@dataclasses.dataclass(frozen=True)
class LoaderCfg:
    global_batch: int
    seq_len: int
    n_ranks: int = 1           # data-parallel ranks
    corpus: CorpusCfg = CorpusCfg()
    eval_offset: int = 1 << 30  # held-out doc-id range


class SyntheticLoader:
    def __init__(self, cfg: LoaderCfg):
        assert cfg.global_batch % cfg.n_ranks == 0
        self.cfg = cfg
        self.per_rank = cfg.global_batch // cfg.n_ranks

    def doc_ids(self, step: int, rank: int,
                eval_split: bool = False) -> np.ndarray:
        base = step * self.cfg.global_batch + rank * self.per_rank
        if eval_split:
            base += self.cfg.eval_offset
        return np.arange(base, base + self.per_rank, dtype=np.int64)

    def batch_at(self, step: int, rank: int = 0,
                 eval_split: bool = False) -> Dict[str, torch.Tensor]:
        toks = torch.from_numpy(sample_batch(
            self.cfg.corpus, self.doc_ids(step, rank, eval_split),
            self.cfg.seq_len + 1, self.per_rank))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch_at(self, step: int, eval_split: bool = False
                        ) -> Dict[str, torch.Tensor]:
        """All ranks concatenated (one process)."""
        parts = [self.batch_at(step, r, eval_split)
                 for r in range(self.cfg.n_ranks)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
