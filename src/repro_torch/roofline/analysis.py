"""Roofline terms of one step on the H100: the port of
`repro/roofline/analysis.py`.

    compute term    = FLOPs / 989 TFLOP/s (dense bf16, `hw.PEAK_FLOPS_BF16`)
    memory term     = bytes / 3.35 TB/s (`hw.HBM_BW`)
    collective term = collective bytes / 450 GB/s (NVLink; 0 on one card)

`Roofline` keeps the reference's fields, properties and `as_dict()`
keys. The reference's `analyze` read a compiled XLA executable (its
HLO's FLOPs, bytes and collective bytes); the port's reads a
`step_stats.StepStats`, the work counted from the step's shapes and its
tensors, and the collective bytes a step moved.

`count_collectives` and `collective_bytes` read a
`launch/mesh.py::collective_stats()` record of a step that ran (the dry
run's traced step) where the reference parsed its HLO text: every loop
(layers, microbatches, the backward's regathers) is counted as it ran,
which is what the reference's trip-count walker (`hlo_stats`)
reconstructed. Bytes are what a rank receives: an all-gather's whole
result, and a `rank_sum` as the all-gather it is (the sum is then added
locally in rank order), so it costs one gather's bytes, not a ring
all-reduce's 2x its operand.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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


# the mesh's counter names -> the reference's collective kinds
_KINDS = {"all_gather": "all-gather", "sum": "rank-sum"}


def count_collectives(stats: Dict[str, int]) -> Dict[str, int]:
    """Collective calls by kind from a `collective_stats()` record:
    {"all-gather": n, "rank-sum": n}, kinds that ran only."""
    return {kind: int(stats[key]) for key, kind in _KINDS.items()
            if stats.get(key)}


def collective_bytes(stats: Dict[str, int]) -> Dict[str, float]:
    """Bytes each rank received by kind, and their "total", from a
    `collective_stats()` record (a rank_sum at its gather's bytes)."""
    out = {kind: float(stats[f"{key}_bytes"]) for key, kind in
           _KINDS.items() if stats.get(f"{key}_bytes")}
    out["total"] = sum(out.values())
    return out


def analyze(stats: StepStats, n_chips: int = 1,
            model_flops_global: Optional[float] = None, *,
            per_chip: bool = False, coll_bytes_per_chip: float = 0.0,
            arg_bytes_per_chip: Optional[float] = None,
            collective_counts: Optional[dict] = None) -> Roofline:
    """Roofline terms of a step counted by `step_stats`: the whole step's
    work split evenly over `n_chips`, or (`per_chip`) one chip's work as
    counted. `model_flops_global` defaults to the count's own model
    FLOPs (2·N·tokens, or 6·N·D for training); `coll_bytes_per_chip`
    (0 on one card) and `collective_counts` come from a traced step
    (`collective_bytes`, `count_collectives`)."""
    div = 1 if per_chip else n_chips
    return Roofline(
        flops_per_chip=stats.flops / div,
        bytes_per_chip=stats.bytes / div,
        coll_bytes_per_chip=coll_bytes_per_chip,
        n_chips=n_chips,
        model_flops_global=stats.model_flops if model_flops_global is None
        else model_flops_global,
        arg_bytes_per_chip=stats.arg_bytes / div
        if arg_bytes_per_chip is None else arg_bytes_per_chip,
        collective_counts=collective_counts,
        flags={"kind": stats.kind, "tokens": stats.tokens})
