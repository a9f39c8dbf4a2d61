"""Quantized-execution backend registry. Port of `repro/backends/`.

`dispatch(x, w, policy)` executes every quantized matmul,
`decode_attention(q, cache, pos, policy=...)` every decode-step
attention, `prefill_attention(q, cache, positions, policy=...)` every
chunk of a paged prefill and `encode_kv(x, scale, policy=...)` the
packing of every other KV-cache write, on the backend `policy.backend`
names:
  cuda   — the hand-written kernels (default; plain versions on CPU)
  cuda_sharded — the same kernels, one shard a rank, on the "model"
           axis of the mesh `configure_mesh` installs: column-, row- and
           expert-parallel matmuls and KV-head-split attention
           (`backends/sharded.py`)
  eager  — dequantize-then-torch.matmul and the dense attention paths
           (the fallback)
  reference — the fp32 oracle (`backends/reference.py`): dequantize,
           fake-quantize the activation, one fp32 `torch.matmul`; never
           declines, and runs only where a policy names it
Stacked per-expert weights (3-D data) run the grouped path; a
`MixedExpertQuant` dispatches each homogeneous group and puts the
outputs back in expert order. A backend that declines an operand layout
falls back one hop, and
`dispatch_stats()` counts served / declined-with-reason calls under the
reference's key vocabulary ("cuda", "cuda->fallback:<code>",
"...[decode_attn]", "...[prefill_attn]"); `act_scale_stats()` counts
how each quantized matmul resolved its activation scale.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.core.policy import QuantPolicy

from .base import (ACT_SCALE_KEYS, ALL_DECLINE_CODES, DECLINE_CODES,
                   DISPATCH_MARKERS, QuantizedMatmulBackend,
                   act_normal_dtype, act_scale_stats, decline,
                   dispatch_key, quantize_activation, record_act_scale,
                   reset_act_scale_stats, resolve_act_scale, torch_dtype)
from .cuda import CudaBackend
from .eager import EagerBackend
from .reference import ReferenceBackend
from . import sharded
from .sharded import ShardedCudaBackend, configure_mesh, current_mesh

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
register(ReferenceBackend())
register(ShardedCudaBackend())

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
             act_scale: Optional[torch.Tensor] = None,
             fill: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (…, K) @ dequant(w) (K, N) on the policy's backend, falling back
    one hop when it declines the layout. A stacked (E, K, N) weight takes
    an (…, E, C, K) lhs; a `MixedExpertQuant` runs group by group.
    `fill` (…, E), stacked weights only: the filled capacity rows of each
    (…, expert); a backend may leave the rows past it unwritten (K6
    does), so the caller reads only filled rows."""
    if isinstance(w, MixedExpertQuant):
        w = sharded.gathered(w)
        backend = get_backend(policy.backend)
        reason = backend.mixed_expert_decline_reason(x, w, policy)
        if reason is not None:
            _record(backend.name, reason, "[stacked]")
            policy = policy.with_backend(backend.fallback)
        return _dispatch_mixed_experts(x, w, policy, act_scale, fill)
    w = sharded.gathered(w)
    backend = get_backend(policy.backend)
    reason = backend.decline_reason(x, w, policy)
    _record(backend.name, reason, "[stacked]" if w.data.ndim > 2 else "")
    if reason is not None and isinstance(w, sharded.QuantShard) \
            and w.parts > 1:
        # a declined part: the fallback computes it split
        return sharded.declined_split_matmul(x, w, policy, fill=fill)
    if reason is not None:
        backend = get_backend(backend.fallback)
    return backend.matmul(x, w, policy, act_scale=act_scale, fill=fill)


def _dispatch_mixed_experts(x: torch.Tensor, w: MixedExpertQuant,
                            policy: QuantPolicy,
                            act_scale: Optional[torch.Tensor],
                            fill: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Per-expert mixed precision: each homogeneous group goes through
    `dispatch` (W4 and W8 groups each run the grouped kernel), and the
    group outputs are put back in expert order. Only the weight side is
    per expert: the A side, backend and compute dtype come from the
    call-site policy. An unquantized group runs a plain matmul. Per-slot
    scales carrying the expert dim ((…, E, C, 1) or (…, E, C)) and the
    fill (…, E) are gathered down to each group's experts, through the
    index tensors the stack holds on its device (no host copy, so a
    captured step can run it)."""
    cdt = torch_dtype(policy.compute_dtype)
    outs = []
    for qt, idx in zip(w.groups, w.group_index):
        xg = torch.index_select(x, x.ndim - 3, idx)
        scale = act_scale
        if isinstance(scale, torch.Tensor) and scale.ndim:
            if scale.ndim >= 3 and scale.shape[-3] == w.n_experts \
                    and scale.shape[-1] == 1:
                scale = torch.index_select(scale, scale.ndim - 3, idx)
            elif scale.ndim >= 2 and scale.shape[-2:] == x.shape[-3:-1]:
                scale = torch.index_select(scale, scale.ndim - 2, idx)
        if isinstance(qt, QuantizedTensor):
            fg = None if fill is None else torch.index_select(
                fill, fill.ndim - 1, idx)
            outs.append(dispatch(xg, qt, policy, act_scale=scale, fill=fg))
        else:
            outs.append(torch.matmul(xg.to(cdt), qt.to(cdt)))
    cat = torch.cat([o.to(cdt) for o in outs], dim=-3)
    return torch.index_select(cat, cat.ndim - 3, w.order)


def decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                     policy: Optional[QuantPolicy] = None,
                     window: int = 0, ring: int = 0) -> torch.Tensor:
    """Single-token decode attention (q (B, 1, H, D), pos (B,)) over a KV
    cache on the policy's backend; `policy=None` is the dense path."""
    backend = get_backend(policy.backend if policy is not None else "eager")
    reason = backend.decode_attn_decline_reason(q, cache)
    _record(backend.name, reason, "[decode_attn]")
    if reason is not None and sharded.seq_part(cache) is not None:
        # a part of the slots: the partial attention and its combine
        return sharded.seq_decode_attention(q, cache, pos, window=window,
                                            ring=ring)
    if reason is not None:
        backend = get_backend(backend.fallback)
    return backend.decode_attention(q, cache, pos, window=window, ring=ring)


def encode_kv(x: torch.Tensor, scale: torch.Tensor, *,
              policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """Packed int4 OVP bytes (…, D/2) of one cache write's new K or V rows
    x (…, D) at their per-row scale (…), on the cache site's backend:
    `cuda` launches K7 once, `eager` and `policy=None` run the torch ops.
    Not counted in `dispatch_stats()`, whose keys stay the reference's."""
    backend = get_backend(policy.backend if policy is not None else "eager")
    return backend.encode_kv(x, scale)


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
           "decode_attention", "prefill_attention", "encode_kv",
           "dispatch_stats",
           "reset_dispatch_stats",
           "quantize_activation", "resolve_act_scale", "act_normal_dtype",
           "ACT_SCALE_KEYS", "act_scale_stats", "record_act_scale",
           "reset_act_scale_stats", "CudaBackend", "EagerBackend",
           "ReferenceBackend", "ShardedCudaBackend", "configure_mesh",
           "current_mesh"]
