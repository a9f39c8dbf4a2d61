"""`repro_torch.analysis` — the port's static contract checker: the port
of `repro/analysis/`.

OliVe's encoding is locally checkable: one byte is one outlier-victim
pair, every scale travels with its tile, and every dispatch decline is a
registered code. This package enforces those conventions over the port,
runnable as ``python -m repro_torch.analysis`` (exit 1 on any finding)
and as pytest (`tests/test_torch_analysis.py`). Four passes:

- **vocabulary** (`vocab.py`): AST-scans the port's `backends/` and
  `kernels/` for decline-code and dispatch-stats literals and holds them
  against `backends/base.py::DECLINE_CODES`, and the registry against
  the quoted tables of docs/backends.md and docs/sharding.md.
- **kernels** (`kernels.py`): the kernel contracts, rewritten for the
  CUDA launch configs: every launch plan (`launch_plan`,
  `grouped_launch_plan`, `decode_plan`, `prefill_plan`, `encode_plan`)
  at the reference's eight cases and at every shape the served configs
  launch is checked for tile divisibility, pair-whole K tiles, page
  tiles, the shared-memory budget, in-place pool writes, and that a
  CUDA operand reaches the kernel launch.
- **policies** (`policies.py`): every preset `PolicyProgram` (and any
  calibration artifact) against the param trees of the config zoo:
  dead rules, shadowed precedence, globs that match nothing.
- **hygiene** (`hygiene.py`): no bare or overbroad `except` in
  `src/repro_torch/`.

The finding codes are the reference's (docs/static_analysis.md), with
two renamed for the card: `KC_SMEM_BUDGET` (shared memory a block, in
place of `KC_VMEM_BUDGET`) and `KC_NO_LAUNCH` (a CUDA operand that
reaches no kernel launch, in place of `KC_NO_PALLAS_CALL`).
`KC_SHARD_SPLIT` sweeps the sharded backend's row-split predicate.

`sanitize.py` is the runtime side: ``REPRO_SANITIZE=1`` turns on the
checks in the OVP encode/decode paths and in front of the KV encoder,
the logits' finiteness check (`configure()`) and the engine's trace
audit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding: `code` a stable finding id, `where` a
    file/symbol anchor, `message` the defect."""
    code: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.code} {self.where}: {self.message}"


PASS_NAMES = ("vocab", "kernels", "policies", "hygiene")


def run_pass(name: str, fixtures: Sequence[str] = (),
             smem_budget: Optional[int] = None) -> List[Finding]:
    """Run one pass by name. `fixtures` are extra .py files (seeded-
    violation modules) folded into the pass's scan or case set."""
    # the pass modules import the rest of the port lazily, so importing
    # this package (the sanitizer's hooks do) pulls in nothing else
    if name == "vocab":
        from . import vocab
        return vocab.check(fixtures=fixtures)
    if name == "kernels":
        from . import kernels
        return kernels.check(fixtures=fixtures, smem_budget=smem_budget)
    if name == "policies":
        from . import policies
        return policies.check(fixtures=fixtures)
    if name == "hygiene":
        from . import hygiene
        return hygiene.check(fixtures=fixtures)
    raise KeyError(f"unknown analysis pass {name!r}; "
                   f"options: {PASS_NAMES}")


def run_all(passes: Sequence[str] = PASS_NAMES,
            fixtures: Sequence[str] = (),
            smem_budget: Optional[int] = None) -> List[Finding]:
    findings: List[Finding] = []
    for name in passes:
        findings.extend(run_pass(name, fixtures=fixtures,
                                 smem_budget=smem_budget))
    return findings


__all__ = ["Finding", "PASS_NAMES", "run_pass", "run_all"]
