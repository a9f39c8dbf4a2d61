"""Quantized-execution backend registry. Port of `repro/backends/`.

`dispatch(x, w, policy)` executes every quantized matmul,
`decode_attention(q, cache, pos, policy=...)` every decode-step
attention and `prefill_attention(q, cache, positions, policy=...)` every
chunk of a paged prefill, on the backend `policy.backend` names:
  cuda   — the hand-written kernels (default; plain versions on CPU)
  eager  — dequantize-then-torch.matmul and the dense attention paths
           (the fallback)
A backend that declines an operand layout falls back one hop, and
`dispatch_stats()` counts served / declined-with-reason calls under the
reference's key vocabulary ("cuda", "cuda->fallback:<code>",
"...[decode_attn]", "...[prefill_attn]"); `act_scale_stats()` counts
how each quantized matmul resolved its activation scale.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

from repro_torch.core.policy import QuantPolicy

from .base import (ACT_SCALE_KEYS, ALL_DECLINE_CODES, DECLINE_CODES,
                   DISPATCH_MARKERS, QuantizedMatmulBackend,
                   act_normal_dtype, act_scale_stats, decline,
                   dispatch_key, quantize_activation, record_act_scale,
                   reset_act_scale_stats, resolve_act_scale)
from .cuda import CudaBackend
from .eager import EagerBackend

_REGISTRY: Dict[str, QuantizedMatmulBackend] = {}


def register(backend: QuantizedMatmulBackend) -> QuantizedMatmulBackend:
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> QuantizedMatmulBackend:
    if name not in _REGISTRY:
        raise KeyError(f"unknown quantized-matmul backend {name!r}; "
                       f"registered: {available()}")
    return _REGISTRY[name]


def available() -> list:
    return sorted(_REGISTRY)


register(EagerBackend())
register(CudaBackend())

_DISPATCH_STATS: collections.Counter = collections.Counter()


def reset_dispatch_stats() -> None:
    _DISPATCH_STATS.clear()


def dispatch_stats() -> Dict[str, int]:
    """Counter keyed "backend" (served) / "backend->fallback:reason"
    (declined), with a site-kind marker suffix; one count per call."""
    return dict(_DISPATCH_STATS)


def _record(backend_name: str, reason: Optional[str],
            marker: str = "") -> None:
    _DISPATCH_STATS[dispatch_key(backend_name, reason, marker)] += 1


def dispatch(x: torch.Tensor, w, policy: QuantPolicy,
             act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (…, K) @ dequant(w) (K, N) on the policy's backend, falling back
    one hop when it declines the layout."""
    backend = get_backend(policy.backend)
    reason = backend.decline_reason(x, w, policy)
    _record(backend.name, reason, "[stacked]" if w.data.ndim > 2 else "")
    if reason is not None:
        backend = get_backend(backend.fallback)
    return backend.matmul(x, w, policy, act_scale=act_scale)


def decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                     policy: Optional[QuantPolicy] = None,
                     window: int = 0, ring: int = 0) -> torch.Tensor:
    """Single-token decode attention (q (B, 1, H, D), pos (B,)) over a KV
    cache on the policy's backend; `policy=None` is the dense path."""
    backend = get_backend(policy.backend if policy is not None else "eager")
    reason = backend.decode_attn_decline_reason(q, cache)
    _record(backend.name, reason, "[decode_attn]")
    if reason is not None:
        backend = get_backend(backend.fallback)
    return backend.decode_attention(q, cache, pos, window=window, ring=ring)


def prefill_attention(q: torch.Tensor, cache, positions: torch.Tensor, *,
                      policy: Optional[QuantPolicy] = None):
    """Paged cache-write prefill of one chunk (q (1, C, H, D), positions
    (1, C) absolute) on the policy's backend: `cuda` runs K4, `eager` the
    dense twin; `policy=None` is the dense twin. Declines fall back one
    hop and record a "...[prefill_attn]" key. Returns (out, cache) with
    the pools written in place."""
    backend = get_backend(policy.backend if policy is not None else "eager")
    reason = backend.prefill_attn_decline_reason(q, cache)
    _record(backend.name, reason, "[prefill_attn]")
    if reason is not None:
        backend = get_backend(backend.fallback)
    return backend.prefill_attention(q, cache, positions)


__all__ = ["QuantizedMatmulBackend", "register", "get_backend", "available",
           "DECLINE_CODES", "ALL_DECLINE_CODES", "DISPATCH_MARKERS",
           "decline", "dispatch_key", "dispatch",
           "decode_attention", "prefill_attention", "dispatch_stats",
           "reset_dispatch_stats",
           "quantize_activation", "resolve_act_scale", "act_normal_dtype",
           "ACT_SCALE_KEYS", "act_scale_stats", "record_act_scale",
           "reset_act_scale_stats", "CudaBackend", "EagerBackend"]
