"""fp32 oracle backend. Port of `repro/backends/reference.py`.

The same quantization semantics as every other backend (the activation
rule of `backends.base`, static calibrated scales included), but all in
float32 with no kernel, no padding and no compute-dtype cast: the
weight is dequantized, the activation (with `policy.abits`) fake-
quantized through a materialized OVP round trip, and one `torch.matmul`
runs, on any device. Tests and callers name it to compare the real
backends against it; it is never a fallback. It never declines; its
dispatch and act-scale keys are the registry's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ovp import QuantizedTensor, ovp_dequantize
from repro_torch.core.policy import QuantPolicy

from .base import QuantizedMatmulBackend, quantize_activation


class ReferenceBackend(QuantizedMatmulBackend):
    name = "reference"
    # device dispatches a quantized matmul with activation quantization
    # takes when nothing is fused: encode, matmul, scale
    dispatches_per_matmul = 3

    def matmul(self, x: torch.Tensor, w: QuantizedTensor,
               policy: QuantPolicy,
               act_scale: Optional[torch.Tensor] = None,
               fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        # every row is computed: `fill` only says which are read
        wd = ovp_dequantize(w, dtype=torch.float32)
        xd = x.to(torch.float32)
        if policy.abits:
            xd = ovp_dequantize(quantize_activation(x, policy, act_scale),
                                dtype=torch.float32)
        return torch.matmul(xd, wd)
