"""CUDA backend (the reference's `pallas` role), the port's default: one
launch of the fused OVP matmul kernel (`kernels/ovp_matmul.py`) per
quantized matmul, with in-kernel activation quantization at the dynamic
3σ scale (K1) or, for a calibrated static site, at its scale passed to
the kernel as one scalar with no per-step std (K5); one launch of the
grouped per-expert matmul (K6) per stacked (E, K, N) expert weight
whose lhs carries the matching expert dim, computing only the filled
capacity rows when the caller passes the fill; the slab (K2) or
paged (K3) decode-attention kernel
(`kernels/decode_attn.py`) for every decode step; the fused
cache-write prefill kernel (K4, `kernels/prefill_attn.py`) for every
chunk of a paged prefill; and one launch of the OVP encoder (K7,
`kernels/ovp_encode.py`) for each of K and V of every other packed
cache write, at the per-row 3σ scale. CPU tensors take each
kernel's plain version, as `pallas_interpret` runs the reference's
kernels on the CPU; CUDA tensors launch the kernel or raise."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ovp import QuantizedTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import (decode_attn, ovp_encode, ovp_matmul,
                                 prefill_attn)

from .base import (QuantizedMatmulBackend, decline, encode_rows,
                   resolve_act_scale, torch_dtype)


class CudaBackend(QuantizedMatmulBackend):
    name = "cuda"

    @staticmethod
    def _experts(w) -> int:
        """The E of a stacked weight, as the lhs must carry it."""
        return w.data.shape[0]

    def decline_reason(self, x, w: QuantizedTensor,
                       policy: QuantPolicy) -> Optional[str]:
        if w.pair_axis % 2 != 0:
            return decline("pair_axis_not_reduction")
        if w.data.ndim == 2:
            return None if x.ndim >= 2 else decline("lhs_rank_lt_2")
        if w.data.ndim == 3:
            # grouped path: the lhs carries the matching expert dim at -3
            if x.ndim < 3:
                return decline("grouped_lhs_rank_lt_3")
            if x.shape[-3] != self._experts(w):
                return decline("grouped_lhs_expert_mismatch")
            return None
        return decline("stacked_rank_gt_3")

    def matmul(self, x: torch.Tensor, w: QuantizedTensor,
               policy: QuantPolicy,
               act_scale: Optional[torch.Tensor] = None,
               fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        a_dtype = scale = static = None
        if policy.abits:
            scale, a_dtype = resolve_act_scale(x, policy, act_scale)
            if isinstance(scale, float):
                # calibrated scalar: no std, one scale word to K5
                static, scale = scale, None
        kw = dict(a_dtype=a_dtype, act_scale=scale, static_act_scale=static)
        if w.data.ndim == 3:
            out = ovp_matmul.grouped_ovp_matmul(x, w, fill=fill, **kw)
        else:
            out = ovp_matmul.fused_ovp_matmul(x, w, **kw)
        return out.to(torch_dtype(policy.compute_dtype))

    def decode_attn_decline_reason(self, q, cache) -> Optional[str]:
        return decline(decode_attn.decline_reason(q, cache))

    def decode_attention(self, q: torch.Tensor, cache, pos: torch.Tensor,
                         *, window: int = 0, ring: int = 0) -> torch.Tensor:
        return decode_attn.fused_decode_attention(q, cache, pos,
                                                  window=window, ring=ring)

    def encode_kv(self, x: torch.Tensor, scale: torch.Tensor
                  ) -> torch.Tensor:
        return encode_rows(ovp_encode.fused_ovp_encode, x, scale)

    fuses_prefill_attention = True

    def prefill_attn_decline_reason(self, q, cache) -> Optional[str]:
        return decline(prefill_attn.prefill_decline_reason(q, cache))

    def prefill_attention(self, q: torch.Tensor, cache,
                          positions: torch.Tensor):
        return prefill_attn.fused_prefill_attention(q, cache, positions)
