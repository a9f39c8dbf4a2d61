"""Compiled engine steps: the port's counterpart of the reference engine's
`jax.jit` / `sanitize.jit_checked` over one step function.

A `StepGraph` holds one step function and the static device buffers it
reads. `run(**host_inputs)` copies the named host arrays into their
buffers (through pinned memory, without a host sync) and runs the step.
On the card the first `run` executes the function eagerly (a real step,
and the warm-up: each kernel's one-time `cudaFuncSetAttribute` happens
here, outside any capture), then captures it into a
`torch.cuda.CUDAGraph`; every later `run` is one replay that returns the
same static output tensors. On the CPU, or with `capture=False`, every
`run` calls the function on the same static buffers. Either way the
first `run` is the entry's one build, which `on_build` reports: the
engine counts builds as the reference counts traces.

Host counters under replay. The kernel wrappers count launches, and the
backends count dispatches and activation-scale resolutions, on the host
(`host_counts()` lists them all). Every counter counts device
executions: a capture executes nothing, so what it added is rolled back
(`count_delta`, `add_counts`), and each replay adds the recorded delta
of one execution.

A graph's outputs live in the memory pool it shares with the engine's
other graphs: read them before another graph of that pool replays.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import backends
from repro_torch.backends import base, sharded
from repro_torch.kernels import (decode_attn, ovp_encode, ovp_matmul,
                                 prefill_attn)

# wrappers whose `.mode_launches` dict counts launches per activation mode
# and whose `.weight_launches` dict counts the same launches per weight
# dtype
_MODE_COUNTED = {"ovp_matmul": ovp_matmul.fused_ovp_matmul,
                 "grouped": ovp_matmul.grouped_ovp_matmul}
# wrappers whose `.launches` int counts launches
_COUNTED = {"ovp_encode": ovp_encode.fused_ovp_encode,
            "decode_attn": decode_attn.fused_decode_attention,
            "paged_decode_attn": decode_attn.fused_paged_decode_attention,
            "prefill_attn": prefill_attn.fused_prefill_attention}
# the `_COUNTED` wrappers whose `.cache_launches` dict counts the same
# launches per KV-cache dtype
_CACHE_COUNTED = ("decode_attn", "paged_decode_attn")
# the backends' module-level Counters, keyed "<prefix>:<counter key>"
_COUNTERS = {"dispatch": backends._DISPATCH_STATS,
             "act_scale": base._ACT_SCALE_STATS,
             "shard": sharded._SHARD_LAUNCHES}


def launch_counts() -> Dict[str, int]:
    """Launch counts of the port's kernels since they were last reset:
    the fused OVP matmul per activation mode ("ovp_matmul[<mode>]";
    `ovp_matmul[static]` is K5), the grouped per-expert matmul K6 per
    mode ("grouped[<mode>]"; `grouped[fp]` on the MoE serving path), the
    same launches of both by weight dtype ("ovp_matmul<int8>",
    "grouped<int4>", ...), the encoder K7 ("ovp_encode") and the three
    attention kernels, K2's and K3's launches also by cache dtype
    ("decode_attn<int4>", "decode_attn<float32>", ...). A captured engine
    step counts each replay."""
    counts = {}
    for name, fn in _MODE_COUNTED.items():
        for mode, n in fn.mode_launches.items():
            counts[f"{name}[{mode}]"] = n
        for w_dtype, n in fn.weight_launches.items():
            counts[f"{name}<{w_dtype}>"] = n
    for name, fn in _COUNTED.items():
        counts[name] = fn.launches
    for name in _CACHE_COUNTED:
        for kv_dtype, n in _COUNTED[name].cache_launches.items():
            counts[f"{name}<{kv_dtype}>"] = n
    return counts


def reset_launch_counts() -> None:
    """Set every counter of `launch_counts()` to 0."""
    for fn in _MODE_COUNTED.values():
        fn.mode_launches = dict.fromkeys(ovp_matmul.A_MODES, 0)
        fn.weight_launches = dict.fromkeys(ovp_matmul.W_DTYPES, 0)
    for fn in _COUNTED.values():
        fn.launches = 0
    for name in _CACHE_COUNTED:
        _COUNTED[name].cache_launches = dict.fromkeys(
            decode_attn.CACHE_DTYPES, 0)


def host_counts() -> Dict[str, int]:
    """Every host-side counter of device work, flat: `launch_counts()`,
    and "dispatch:<key>" / "act_scale:<key>" / "shard:<key>" for
    `backends.dispatch_stats()`, `act_scale_stats()` and
    `backends.sharded.shard_launches()`."""
    counts = launch_counts()
    for prefix, counter in _COUNTERS.items():
        for key, n in counter.items():
            counts[f"{prefix}:{key}"] = n
    return counts


def count_delta(before: Dict[str, int],
                after: Dict[str, int]) -> Dict[str, int]:
    """after - before, over both snapshots' keys, without zero entries."""
    delta = {key: after.get(key, 0) - before.get(key, 0)
             for key in set(before) | set(after)}
    return {key: n for key, n in delta.items() if n}


def add_counts(delta: Dict[str, int]) -> None:
    """Add a `count_delta` to the live counters (a negative delta rolls
    counts back). A Counter entry that reaches 0 is removed, so the
    stats read as if the rolled-back work never ran."""
    for key, n in delta.items():
        prefix, sep, sub = key.partition(":")
        if sep:
            counter = _COUNTERS[prefix]
            counter[sub] += n
            if counter[sub] == 0:
                del counter[sub]
        elif key.endswith("]"):
            name, mode = key[:-1].split("[")
            _MODE_COUNTED[name].mode_launches[mode] += n
        elif key.endswith(">"):
            name, dtype = key[:-1].split("<")
            if name in _CACHE_COUNTED:
                _COUNTED[name].cache_launches[dtype] += n
            else:
                _MODE_COUNTED[name].weight_launches[dtype] += n
        else:
            _COUNTED[key].launches += n


class StepGraph:
    """One compiled step: `fn(**inputs)` over static `inputs` (tensors, or
    lists of them that `fn` reads in place), captured on the card when
    `capture` is set, eager otherwise and on the CPU. `pool` is the
    engine's shared graph memory pool (`torch.cuda.graph_pool_handle()`).
    A capture or replay error raises: there is no eager fallback."""

    def __init__(self, fn: Callable, inputs: Dict[str, object], *,
                 capture: bool, pool=None,
                 on_build: Optional[Callable[[], None]] = None):
        self.fn = fn
        self.inputs = inputs
        first = next(t for t in inputs.values()
                     if isinstance(t, torch.Tensor))
        self.cuda = first.device.type == "cuda"
        self.capture = capture and self.cuda
        self.pool = pool
        self.on_build = on_build
        self.built = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.delta: Dict[str, int] = {}

    def run(self, **host_inputs: np.ndarray):
        """Copy each named host array into its static buffer, then run the
        step; returns its outputs (on a replay, the graph's static
        output tensors)."""
        for name, value in host_inputs.items():
            src = torch.from_numpy(np.ascontiguousarray(value))
            if self.cuda:
                src = src.pin_memory()
            self.inputs[name].copy_(src, non_blocking=True)
        if self.graph is not None:
            self.graph.replay()
            add_counts(self.delta)
            return self.outputs
        out = self.fn(**self.inputs)
        if not self.built:
            if self.capture:
                self._capture()
            self.built = True
            if self.on_build is not None:
                self.on_build()
        return out

    def _capture(self) -> None:
        """Record `fn` into a CUDA graph after its eager warm-up; keep the
        counters' delta of one execution and roll the capture's back."""
        before = host_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn(**self.inputs)
        finally:
            after = host_counts()
            add_counts(count_delta(after, before))
        self.delta = count_delta(before, after)
        self.graph, self.outputs = graph, outputs
