"""Eager decode-and-matmul backend (the reference's `xla` / `reference`
role): dequantize the weight (and, with `policy.abits`, a materialized
OVP round trip of the activation) to the compute dtype and run
`torch.matmul`, which broadcasts a stacked (E, K, N) expert weight
against an (…, E, C, K) lhs; decode attention takes the dense path.
Serves any layout, so it is the registry's fallback."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ovp import QuantizedTensor, ovp_dequantize
from repro_torch.core.policy import QuantPolicy

from .base import QuantizedMatmulBackend, quantize_activation, torch_dtype


class EagerBackend(QuantizedMatmulBackend):
    name = "eager"

    def matmul(self, x: torch.Tensor, w: QuantizedTensor,
               policy: QuantPolicy,
               act_scale: Optional[torch.Tensor] = None,
               fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        # every row is computed: `fill` only says which are read
        cdt = torch_dtype(policy.compute_dtype)
        wd = ovp_dequantize(w, dtype=cdt)
        if policy.abits:
            xd = ovp_dequantize(quantize_activation(x, policy, act_scale),
                                dtype=cdt)
            return torch.matmul(xd, wd).to(cdt)
        return torch.matmul(x.to(cdt), wd)
