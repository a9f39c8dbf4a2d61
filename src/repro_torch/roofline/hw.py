"""NVIDIA H100 SXM constants for the roofline model (NVIDIA's data
sheet, dense rates without sparsity, at the full 700 W power limit; a
card set below it runs slower under load, so every measurement is
printed beside `nvidia-smi`'s power limit).

Two peaks are in use, and each caller names the one it means:
- a step's roofline (`roofline.analysis.Roofline`) divides its FLOPs by
  `PEAK_FLOPS_BF16`, the dense bf16 tensor-core rate, as the reference's
  `Roofline` divides by its chip's bf16 peak: what a step could reach
  with its matmuls on the tensor cores;
- a kernel's bound (`bound_s(..., peak=PEAK_FLOPS_FP32)`) keeps the fp32
  rate of the CUDA cores, the peak PERF.md's kernel table states: the
  port's kernels compute in fp32 outside the tensor cores.

The collective term divides the bytes a rank receives by `NVLINK_BW`
(0 on one card).
"""
from __future__ import annotations

from typing import Tuple

PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 / fp16 tensor cores
PEAK_FLOPS_FP8 = 1979e12        # FLOP/s, dense fp8 (int8: the same, TOP/s)
PEAK_OPS_INT8 = 1979e12
PEAK_FLOPS_TF32 = 495e12        # FLOP/s, dense TF32 tensor cores
PEAK_FLOPS_FP32 = 67e12         # FLOP/s, fp32 on the CUDA cores
HBM_BW = 3.35e12                # B/s, HBM3
HBM_BYTES = 80e9                # 80 GB of device memory
NVLINK_BW = 450e9               # B/s each way, one card to the others
SMEM_PER_BLOCK = 232448         # bytes of shared memory a block may opt into


def compute_time_s(flops: float, peak: float = PEAK_FLOPS_BF16) -> float:
    return flops / peak


def memory_time_s(n_bytes: float) -> float:
    return n_bytes / HBM_BW


def collective_time_s(coll_bytes: float) -> float:
    return coll_bytes / NVLINK_BW


def bound_s(n_bytes: float, flops: float,
            peak: float = PEAK_FLOPS_BF16) -> Tuple[float, str]:
    """The least time the card could take to move `n_bytes` through HBM
    and do `flops` at `peak`: (seconds, "bytes" or "operations", the term
    that sets it)."""
    t_bytes, t_ops = memory_time_s(n_bytes), compute_time_s(flops, peak)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
