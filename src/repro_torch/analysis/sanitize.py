"""REPRO_SANITIZE=1: the runtime sanitizer mode, the port of
`repro/analysis/sanitize.py`.

Every wire is off unless the environment variable is set when the call
runs; then nothing is added, no op and no kernel (the gate is a Python
branch, so a captured step holds exactly the kernels it holds without
the sanitizer).

- `check(pred, msg)`: the OVP encode and decode paths (`core/ovp.py`:
  finite scaled input, no pair whose two codes are both the identifier,
  positive finite scales) and the KV write in front of the encoder K7
  (`backends/base.py::encode_rows`) assert through it. A Python bool or
  a CPU tensor is checked at once and raises `AssertionError(
  "REPRO_SANITIZE: ...")`. A CUDA tensor is never read on the host (a
  captured step may not sync): the check is a device-side assert
  (`torch._assert_async`) in the stream. A failed device assert
  poisons the CUDA context, and the error surfaces at the next sync
  with CUDA's own message; with `CUDA_LAUNCH_BLOCKING=1` it surfaces at
  the check itself, which then raises the AssertionError naming it. A
  check meant to fail on the card runs in a child process.
- `configure()`: the counterpart of `jax_debug_nans`, a device-side
  finiteness assert on every step's logits (`Model.head`). It is
  coarser than JAX's per-op check: a NaN is caught where it reaches the
  logits, not at the op that made it.
- `audit_traces(engine)`: the engine's trace ledger
  (`ServingEngine.trace_audit()`) must show no unexpected rebuild of a
  compiled step.

The port has no jit to functionalize checks for, so the reference's
`jit_checked` and `run_checked` have no counterpart: a check inside a
captured step is a node of its graph. This module imports nothing of the
rest of the port, so any layer can hook it.
"""
from __future__ import annotations

import collections
import os
from typing import Dict

import torch

_CONFIG = {"debug_nans": False}
# checks placed (on the host) since the process started, by message: a
# captured step places its checks once, at capture, and replays them
_PLACED: collections.Counter = collections.Counter()


def enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0")


def configure() -> None:
    """Turn the logits' finiteness check on (idempotent); a no-op unless
    REPRO_SANITIZE=1."""
    if enabled():
        _CONFIG["debug_nans"] = True


def check(pred, msg: str, **fmt) -> None:
    """Sanitizer assertion; nothing at all unless REPRO_SANITIZE=1. `pred`
    a Python bool or a boolean tensor (every element must hold)."""
    if not enabled():
        return
    text = "REPRO_SANITIZE: " + msg.format(**fmt)
    _PLACED[msg] += 1
    if isinstance(pred, torch.Tensor) and pred.device.type == "cuda":
        try:
            torch._assert_async(pred.all(), text)
        except RuntimeError as err:
            # only blocking launches tie a launch's error to this check
            if os.environ.get("CUDA_LAUNCH_BLOCKING", "") in ("", "0"):
                raise
            raise AssertionError(text) from err
        return
    if not bool(pred.all() if isinstance(pred, torch.Tensor) else pred):
        raise AssertionError(text)


def check_counts() -> Dict[str, int]:
    """Checks placed so far, by message."""
    return dict(_PLACED)


def check_logits(logits: torch.Tensor) -> None:
    """The `configure()`d finiteness check of one step's logits."""
    if _CONFIG["debug_nans"] and enabled():
        check(torch.isfinite(logits), "non-finite logits (a NaN or Inf "
              "reached the head)")


def audit_traces(engine) -> Dict[str, int]:
    """The engine's `trace_audit()` ledger; raises if a compiled step was
    built again where its bucket, stage length or the single decode
    entry should have served it. `python -m repro_torch.analysis
    --sanitize-smoke` fails on exactly this."""
    audit = engine.trace_audit()
    if audit["unexpected_retraces"]:
        raise AssertionError(
            f"unexpected step rebuilds under REPRO_SANITIZE=1: {audit} — "
            f"a shape or dtype drifted between calls that should share "
            f"one compiled step")
    return audit
