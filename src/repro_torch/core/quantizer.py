"""OliVe PTQ scale search (paper §3.4): MSE minimisation seeded at the 3σ
point. Port of `repro/core/quantizer.py`.

The per-channel search is vectorised over channels: every channel tries
candidate i of its own grid in one tensor op, so a full-width weight
takes n_grid passes over (C, K) on the device instead of C sequential
searches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .datatypes import NORMAL_MAX, AbfloatSpec
from .ovp import (QuantizedTensor, ovp_dequantize, ovp_fake_quant,
                  ovp_quantize)

# The reference's `jnp.geomspace(0.35, 2.2, n)` grids (float32) for the
# grid sizes PTQ (11, 23) and the sensitivity pass (15) use. XLA's
# float32 pow differs from numpy's in the last bit, and a last-bit
# difference in a candidate scale changes codes, so these are kept bit
# for bit; other sizes use numpy's geomspace.
_REFERENCE_GRIDS = {
    11: ("0x1.666666p-2", "0x1.aeba76p-2", "0x1.02d39cp-1", "0x1.370f68p-1",
         "0x1.75d5bcp-1", "0x1.c14736p-1", "0x1.0df92ap+0", "0x1.4474d2p+0",
         "0x1.85ef40p+0", "0x1.d4a07cp+0", "0x1.19999ap+1"),
    15: ("0x1.666666p-2", "0x1.98b07ap-2", "0x1.d208fep-2", "0x1.09b6b8p-1",
         "0x1.2eff6ap-1", "0x1.598364p-1", "0x1.89fe90p-1", "0x1.c14738p-1",
         "0x1.0028dep+0", "0x1.241a5ep+0", "0x1.4d16fep+0", "0x1.7bd3e8p+0",
         "0x1.b11fb2p+0", "0x1.ede5ecp+0", "0x1.19999ap+1"),
    23: ("0x1.666666p-2", "0x1.85a24ep-2", "0x1.a7970ap-2", "0x1.cc8154p-2",
         "0x1.f4a332p-2", "0x1.102238p-1", "0x1.27d984p-1", "0x1.41a1eep-1",
         "0x1.5da98cp-1", "0x1.7c2282p-1", "0x1.9d4352p-1", "0x1.c14738p-1",
         "0x1.e86e9ep-1", "0x1.097fc4p+0", "0x1.20a30ep+0", "0x1.39ca8cp+0",
         "0x1.55233ap+0", "0x1.72de02p+0", "0x1.933010p+0", "0x1.b6532cp+0",
         "0x1.dc8636p+0", "0x1.0306bap+1", "0x1.19999ap+1"),
}


def _grid(lo: float, hi: float, n: int, device) -> torch.Tensor:
    if (lo, hi) == (0.35, 2.2) and n in _REFERENCE_GRIDS:
        vals = np.array([float.fromhex(h) for h in _REFERENCE_GRIDS[n]],
                        np.float32)
    else:
        vals = np.geomspace(lo, hi, n).astype(np.float32)
    return torch.as_tensor(vals, device=device)


def _pop_std(x: torch.Tensor, dim=None, keepdim: bool = False):
    """Population std (ddof=0, as `jnp.std`), written as the reference's
    two passes: mean, then the mean squared deviation."""
    if dim is None:
        mu = x.mean()
        return torch.sqrt(((x - mu) ** 2).mean())
    mu = x.mean(dim=dim, keepdim=True)
    return torch.sqrt(((x - mu) ** 2).mean(dim=dim, keepdim=keepdim))


def sigma_init_scale(x: torch.Tensor, normal_dtype: str,
                     k_sigma: float = 3.0, dim=None) -> torch.Tensor:
    """3σ rule initial scale (§3.4): k·σ maps to the normal max."""
    return sigma_scale(_pop_std(x, dim=dim, keepdim=dim is not None),
                       normal_dtype, k_sigma)


def sigma_scale(sigma: torch.Tensor, normal_dtype: str,
                k_sigma: float = 3.0) -> torch.Tensor:
    """The 3σ rule's scale of a given σ."""
    nmax = float(NORMAL_MAX[normal_dtype])
    return torch.clamp(k_sigma * sigma / nmax, min=1e-8)


def _search(x: torch.Tensor, s0: torch.Tensor, normal_dtype: str,
            spec: Optional[AbfloatSpec], n_grid: int, lo: float, hi: float,
            pair_axis: int, mse_dim) -> torch.Tensor:
    """Shared MSE grid search. s0 is the 3σ seed (a scalar, or (C, 1) for
    per-row search); the grid always contains s0 itself, so the search
    never loses to the 3σ init. Ties keep the first candidate. On "meta"
    (a dry run's PTQ) only the result's shape exists: no candidate is
    tried."""
    if x.device.type == "meta":
        return s0[..., 0] if s0.ndim else s0
    grid = _grid(lo, hi, n_grid - 1, x.device)
    cands = torch.stack([s0 * g for g in grid] + [s0], dim=-1)
    xf = x.to(torch.float32)
    mses = torch.stack(
        [((ovp_fake_quant(x, cands[..., i], normal_dtype, spec, pair_axis)
           - xf) ** 2).mean(dim=mse_dim) for i in range(n_grid)], dim=-1)
    best = torch.argmin(mses, dim=-1, keepdim=True)
    return torch.gather(cands.reshape(mses.shape), -1, best)[..., 0]


def ovp_search_scale(x: torch.Tensor, normal_dtype: str = "int4",
                     spec: Optional[AbfloatSpec] = None, n_grid: int = 24,
                     lo: float = 0.35, hi: float = 2.2,
                     pair_axis: int = -1) -> torch.Tensor:
    """Per-tensor MSE grid search around the 3σ init. Returns a scalar."""
    s0 = sigma_init_scale(x, normal_dtype)
    return _search(x, s0, normal_dtype, spec, n_grid, lo, hi, pair_axis,
                   mse_dim=None)


def ovp_search_scale_per_channel(x: torch.Tensor, channel_axis: int,
                                 normal_dtype: str = "int4",
                                 spec: Optional[AbfloatSpec] = None,
                                 n_grid: int = 16, lo: float = 0.35,
                                 hi: float = 2.2) -> torch.Tensor:
    """Per-channel MSE search, all channels at once. Pairing runs along
    each channel's flattened row. Returns (C,) scales."""
    flat = torch.movedim(x, channel_axis, 0).reshape(x.shape[channel_axis],
                                                     -1)
    s0 = sigma_init_scale(flat, normal_dtype, dim=-1)          # (C, 1)
    return _search(flat, s0, normal_dtype, spec, n_grid, lo, hi, -1,
                   mse_dim=-1)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize one tensor."""
    normal_dtype: str = "int4"          # int4 | flint4 | int8
    granularity: str = "tensor"         # tensor | channel
    channel_axis: int = -1
    pair_axis: int = -1
    n_grid: int = 24
    abfloat: Optional[AbfloatSpec] = None

    @property
    def bits(self) -> int:
        return 8 if self.normal_dtype == "int8" else 4


def quantize(x: torch.Tensor, spec: QuantSpec = QuantSpec()
             ) -> QuantizedTensor:
    """Full OliVe PTQ for one tensor: scale search + OVP encode + pack."""
    if spec.granularity == "tensor":
        s = ovp_search_scale(x, spec.normal_dtype, spec.abfloat, spec.n_grid)
        return ovp_quantize(x, s, spec.normal_dtype, spec.abfloat,
                            spec.pair_axis)
    ca = spec.channel_axis % x.ndim
    pa = spec.pair_axis % x.ndim
    if ca == pa:
        raise ValueError("channel_axis must differ from pair_axis")
    s = ovp_search_scale_per_channel(x, ca, spec.normal_dtype, spec.abfloat,
                                     max(8, spec.n_grid // 2))
    shape = [1] * x.ndim
    shape[ca] = x.shape[ca]
    return ovp_quantize(x, s.reshape(shape), spec.normal_dtype, spec.abfloat,
                        spec.pair_axis)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return ovp_dequantize(qt, dtype=dtype)


def fake_quant_ste(x: torch.Tensor, scale, normal_dtype: str = "int4",
                   spec: Optional[AbfloatSpec] = None,
                   pair_axis: int = -1) -> torch.Tensor:
    """QAT fake-quant with the straight-through estimator (§3.4, STE
    [5]): the forward value is `ovp_fake_quant`'s, the gradient passes
    to x unchanged (none reaches `scale`)."""
    xh = ovp_fake_quant(x.detach(), scale, normal_dtype, spec, pair_axis)
    return x + (xh - x.detach())


def quantization_error(x: torch.Tensor, spec: QuantSpec = QuantSpec()
                       ) -> dict:
    """MSE / SQNR diagnostics of one tensor under full OliVe PTQ."""
    qt = quantize(x, spec)
    xf = x.to(torch.float32)
    mse = ((dequantize(qt) - xf) ** 2).mean()
    power = (xf ** 2).mean()
    sqnr = 10.0 * torch.log10(torch.clamp(power, min=1e-30)
                              / torch.clamp(mse, min=1e-30))
    return {"mse": float(mse), "sqnr_db": float(sqnr), "scale": qt.scale,
            "bytes": qt.nbytes(), "fp32_bytes": x.numel() * 4}
