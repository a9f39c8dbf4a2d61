"""Roofline terms of one step on the H100: the port of
`repro/roofline/analysis.py`.

    compute term    = FLOPs / 989 TFLOP/s (dense bf16, `hw.PEAK_FLOPS_BF16`)
    memory term     = bytes / 3.35 TB/s (`hw.HBM_BW`)
    collective term = collective bytes / 450 GB/s (NVLink; 0 on one card)

`Roofline` keeps the reference's fields, properties and `as_dict()`
keys. The reference's `analyze` read a compiled XLA executable (its
HLO's FLOPs, bytes and collective bytes); the port's reads a
`step_stats.StepStats`, the work counted from the step's shapes and its
tensors. `collective_bytes` and `count_collectives` parse XLA HLO and
come with the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from . import hw
from .step_stats import StepStats


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    n_chips: int
    model_flops_global: float = 0.0   # 6·N·D (train) / 2·N·tokens (decode)
    arg_bytes_per_chip: float = 0.0   # resident state (params + caches)
    raw_cost_analysis: Optional[dict] = None    # the reference's XLA count
    collective_counts: Optional[dict] = None
    flags: Optional[dict] = None

    @property
    def t_compute(self) -> float:
        return hw.compute_time_s(self.flops_per_chip)

    @property
    def t_memory(self) -> float:
        return hw.memory_time_s(self.bytes_per_chip)

    @property
    def t_collective(self) -> float:
        return hw.collective_time_s(self.coll_bytes_per_chip)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Roofline step time: the dominant term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over the step's counted FLOPs (global)."""
        counted = self.flops_per_chip * self.n_chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilisation at the roofline bound."""
        if not self.t_bound:
            return 0.0
        return (self.model_flops_global /
                (self.n_chips * hw.PEAK_FLOPS_BF16 * self.t_bound))

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "arg_bytes_per_chip": self.arg_bytes_per_chip,
            "n_chips": self.n_chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound_s": self.t_bound,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "raw_cost_analysis": self.raw_cost_analysis,
            "collective_counts": self.collective_counts,
            "flags": self.flags,
        }


def analyze(stats: StepStats, n_chips: int = 1,
            model_flops_global: Optional[float] = None) -> Roofline:
    """Roofline terms of a step counted by `step_stats`, split evenly over
    `n_chips` (one card: no collective). `model_flops_global` defaults to
    the count's own model FLOPs (2·N·tokens, or 6·N·D for training)."""
    return Roofline(
        flops_per_chip=stats.flops / n_chips,
        bytes_per_chip=stats.bytes / n_chips,
        coll_bytes_per_chip=0.0,
        n_chips=n_chips,
        model_flops_global=stats.model_flops if model_flops_global is None
        else model_flops_global,
        arg_bytes_per_chip=stats.arg_bytes / n_chips,
        flags={"kind": stats.kind, "tokens": stats.tokens})
