"""Public kernel API: the port of `repro/kernels/ops.py`.

These are the entry points of the paper's accelerator dataflow, in which
both matmul operands arrive OVP-packed: `ovp_encode` packs real values
at a scale (K7), and `ovp_matmul`, `matmul_w4a4` and `matmul_w8a8`
multiply a packed activation by a packed weight, decoding both in one
launch of the fused matmul kernel (K1's `codes4` / `codes8` modes).
`fused_ovp_matmul` is the single-dispatch matmul of every mode,
including the static-scale K5, and `grouped_ovp_matmul` its per-expert
twin over a stacked (E, K, N) weight, one launch of K6, in the same
modes (`kernels/ovp_matmul.py`). CPU tensors take each kernel's plain
version; CUDA tensors launch the kernel or raise. Results are f32.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.ovp import QuantizedTensor

from . import ovp_encode as _enc
from . import ovp_matmul as _mm
from .ovp_matmul import fused_ovp_matmul, grouped_ovp_matmul


def _rows(s, a: torch.Tensor) -> torch.Tensor:
    """A scalar or per-row activation scale -> (M,) f32."""
    return _mm._row_scale(s, a.shape[:-1], a.device)


def matmul_w4a16(a: torch.Tensor, w_data: torch.Tensor, w_scale,
                 normal_dtype: str = "int4") -> torch.Tensor:
    """a (M, K) fp @ packed w (K/2, N): decode and scales in-kernel."""
    n = w_data.shape[1]
    return _mm.run(a.to(torch.float32), None, w_data,
                   _mm._col_scale(w_scale, n, w_data.device),
                   w_dtype=normal_dtype, a_mode="fp")


def matmul_w4a4(a_data: torch.Tensor, a_scale, w_data: torch.Tensor,
                w_scale, normal_dtype: str = "int4") -> torch.Tensor:
    """packed a (M, K/2) @ packed w (K/2, N): both decoded in-kernel,
    per-row a scale and per-channel w scale in the epilogue."""
    n = w_data.shape[1]
    return _mm.run(a_data, _rows(a_scale, a_data), w_data,
                   _mm._col_scale(w_scale, n, w_data.device),
                   w_dtype=normal_dtype, a_mode="codes4",
                   a_dtype=normal_dtype)


def matmul_w8a8(a_data: torch.Tensor, a_scale, w_data: torch.Tensor,
                w_scale) -> torch.Tensor:
    """int8 OVP codes a (M, K) @ w codes (K, N), one code per byte."""
    n = w_data.shape[1]
    return _mm.run(a_data, _rows(a_scale, a_data), w_data,
                   _mm._col_scale(w_scale, n, w_data.device),
                   w_dtype="int8", a_mode="codes8", a_dtype="int8")


def ovp_matmul(a: Union[torch.Tensor, QuantizedTensor],
               w: QuantizedTensor) -> torch.Tensor:
    """Dispatch from operand types: a pre-quantized `QuantizedTensor`
    lhs (4-bit packed or int8 OVP) or a real one (W4A16). Leading lhs
    dims fold into rows."""
    return fused_ovp_matmul(a, w)


def ovp_encode(x: torch.Tensor, scale, normal_dtype: str = "int4"
               ) -> torch.Tensor:
    """x (M, K) real values -> packed OVP bytes (M, K/2) at `scale` (a
    scalar or per-row (M, 1)): u = x / scale and the encode in one launch
    of the encoder kernel (K7), a scalar scale passed by value."""
    return _enc.fused_ovp_encode(x, normal_dtype, scale=scale)


__all__ = ["fused_ovp_matmul", "grouped_ovp_matmul", "matmul_w4a16",
           "matmul_w4a4", "matmul_w8a8", "ovp_matmul", "ovp_encode"]
