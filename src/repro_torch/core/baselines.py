"""Quantization baselines the paper compares against (§5.1–5.2). Port of
`repro/core/baselines.py`.

Every baseline is fake-quant (quantize + dequantize: the result is a
dense tensor of x's shape), so the benchmark harness can rank methods by
round-trip error and memory footprint on identical tensors.

  uniform int4/int8   — symmetric uniform quantization (max- or MSE-scaled)
  ANT                 — per-tensor adaptive type: best of {int4, flint4}
                        by MSE (Guo et al., MICRO'22) [32]
  GOBO                — weight-only: outliers (>kσ) kept fp32 in a coordinate
                        list, normal values -> centroid codebook [85]
  AdaptivFloat        — float with tensor-wise exponent bias [76]
  outlier-clip        — clip at kσ then uniform int4 (Fig. 3 "clipping")
  prune-random/victim — Fig. 3 pruning controls

The MSE searches try their 40 candidates one at a time (the reference's
`lax.map` is sequential too), so a full-width weight never holds more
than a few fp32 copies of itself; ties keep the first candidate, as
`jnp.argmin` does.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .datatypes import FLINT4_LUT, flint4_decode, flint4_encode
from .quantizer import _pop_std

# The reference's float32 `jnp.geomspace(0.05, 1.0, 40)` (uniform int
# clip points, times max|x|) and `jnp.geomspace(0.08, 1.1, 40)` (flint4
# scales, times max|x| / 16), and `jnp.linspace(1/32, 31/32, 16)` (GOBO's
# 4-bit initial centroid quantiles). XLA's float32 arithmetic differs
# from numpy's in the last bit at 23, 21 and 14 of those points, and a
# last-bit difference in a candidate changes codes, so they are kept bit
# for bit.
_INT_GRID = (
    "0x1.999996p-5", "0x1.ba4d84p-5", "0x1.dd9ddcp-5", "0x1.01dffap-4",
    "0x1.1676cp-4", "0x1.2cb258p-4", "0x1.44b45ep-4", "0x1.5ea116p-4",
    "0x1.7a9faap-4", "0x1.98da76p-4", "0x1.b97f1ep-4", "0x1.dcbfp-4",
    "0x1.0167a8p-3", "0x1.15f4d4p-3", "0x1.2c260cp-3", "0x1.441cdcp-3",
    "0x1.5dfd7ap-3", "0x1.79ef08p-3", "0x1.981bbp-3", "0x1.b8b124p-3",
    "0x1.dbe08ap-3", "0x1.00ef9p-2", "0x1.157324p-2", "0x1.2b9ap-2",
    "0x1.4385a2p-2", "0x1.5d5a2ep-2", "0x1.793eaep-2", "0x1.975d46p-2",
    "0x1.b7e382p-2", "0x1.db028p-2", "0x1.0077acp-1", "0x1.14f1acp-1",
    "0x1.2b0e34p-1", "0x1.42eeacp-1", "0x1.5cb72ap-1", "0x1.788ea6p-1",
    "0x1.969f34p-1", "0x1.b7164p-1", "0x1.da24dcp-1", "0x1.0p+0")
_FLINT4_GRID = (
    "0x1.47ae1p-4", "0x1.5e7578p-4", "0x1.76d246p-4", "0x1.90e09cp-4",
    "0x1.acbea8p-4", "0x1.ca8ca2p-4", "0x1.ea6d04p-4", "0x1.064256p-3",
    "0x1.187d82p-3", "0x1.2bfd26p-3", "0x1.40d7c4p-3", "0x1.572586p-3",
    "0x1.6f0028p-3", "0x1.88835cp-3", "0x1.a3cc86p-3", "0x1.c0fb52p-3",
    "0x1.e03166p-3", "0x1.00c97ep-2", "0x1.12a348p-2", "0x1.25bac4p-2",
    "0x1.3a26p-2", "0x1.4ffc9cp-2", "0x1.6757dap-2", "0x1.8052cp-2",
    "0x1.9b0a32p-2", "0x1.b79d16p-2", "0x1.d62c7ep-2", "0x1.f6dbbcp-2",
    "0x1.0ce852p-1", "0x1.1f99dp-1", "0x1.3397fcp-1", "0x1.48f9fp-1",
    "0x1.5fd86ep-1", "0x1.784de4p-1", "0x1.9276a2p-1", "0x1.ae70e6p-1",
    "0x1.cc5d1p-1", "0x1.ec5dbap-1", "0x1.074bf4p+0", "0x1.19999ap+0")
_GOBO_QS4 = (
    "0x1.0p-5", "0x1.800002p-4", "0x1.400002p-3", "0x1.c00002p-3",
    "0x1.200002p-2", "0x1.600002p-2", "0x1.a00002p-2", "0x1.e00002p-2",
    "0x1.100002p-1", "0x1.300002p-1", "0x1.500002p-1", "0x1.700002p-1",
    "0x1.900002p-1", "0x1.b00002p-1", "0x1.d00002p-1", "0x1.fp-1")


def _hex_tensor(vals, device) -> torch.Tensor:
    return torch.as_tensor(np.array([float.fromhex(h) for h in vals],
                                    np.float32), device=device)


def _argmin_of(candidates: torch.Tensor, mse_at) -> torch.Tensor:
    """The candidate of least `mse_at(candidate)`, one candidate at a
    time; the first one on a tie."""
    mses = torch.stack([mse_at(c) for c in candidates])
    return candidates[torch.argmin(mses)]


# --------------------------------------------------------------------------
# Uniform symmetric int quantization
# --------------------------------------------------------------------------
def _int_round_trip(x: torch.Tensor, s: torch.Tensor, nmax: int):
    return torch.clamp(torch.round(x / s), -nmax - 1, nmax) * s


def uniform_int_fake_quant(x: torch.Tensor, bits: int,
                           scale_mode: str = "mse") -> torch.Tensor:
    nmax = (1 << (bits - 1)) - 1
    amax = torch.max(torch.abs(x))
    if scale_mode == "max":
        return _int_round_trip(x, torch.clamp(amax / nmax, min=1e-8), nmax)
    # MSE grid search on the clip point (standard PTQ practice [4])
    grid = torch.clamp(amax, min=1e-8) * _hex_tensor(_INT_GRID, x.device)
    c = _argmin_of(grid, lambda c: torch.mean(
        (_int_round_trip(x, c / nmax, nmax) - x) ** 2))
    return _int_round_trip(x, c / nmax, nmax)


def uniform_int_dynamic_act(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor dynamic (max-scaled) activation fake-quant: the standard
    runtime path of int8/int4 baselines (no grid search in the hot
    loop)."""
    nmax = (1 << (bits - 1)) - 1
    s = torch.clamp(torch.max(torch.abs(x)) / nmax, min=1e-8)
    return _int_round_trip(x, s, nmax)


# --------------------------------------------------------------------------
# ANT: adaptive data type (int4 vs flint4), per-tensor by MSE
# --------------------------------------------------------------------------
def _flint4_round_trip(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return flint4_decode(flint4_encode(x / s)) * s


def flint4_fake_quant(x: torch.Tensor) -> torch.Tensor:
    fmax = float(FLINT4_LUT[-1])
    amax = torch.max(torch.abs(x))
    grid = torch.clamp(amax, min=1e-8) / fmax \
        * _hex_tensor(_FLINT4_GRID, x.device)
    s = _argmin_of(grid, lambda s: torch.mean(
        (_flint4_round_trip(x, s) - x) ** 2))
    return _flint4_round_trip(x, s)


def ant_fake_quant(x: torch.Tensor) -> torch.Tensor:
    """ANT 4-bit: the better of int4 / flint4 for this tensor (int4 on a
    tie)."""
    a = uniform_int_fake_quant(x, 4, "mse")
    b = flint4_fake_quant(x)
    mse_a = torch.mean((a - x) ** 2)
    mse_b = torch.mean((b - x) ** 2)
    return torch.where(mse_a <= mse_b, a, b)


# --------------------------------------------------------------------------
# GOBO-style: outliers exact (sparse fp32), normals -> centroid codebook
# --------------------------------------------------------------------------
def _quantile(flat: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """`jnp.quantile(flat, qs)` (method "linear"), in its float32 steps:
    position q·(n-1), floor and ceil, weights q - low and 1 - that."""
    a = torch.sort(flat).values
    n = float(np.float32(a.numel()))
    pos = qs * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    low = torch.clamp(low, 0, n - 1).to(torch.int64)
    high = torch.clamp(high, 0, n - 1).to(torch.int64)
    return a[low] * w_low + a[high] * w_high


def _nearest(flat: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    return torch.argmin(torch.abs(flat[:, None] - cent[None, :]), dim=1)


def gobo_fake_quant(x: torch.Tensor, bits: int = 4, k_sigma: float = 3.0,
                    iters: int = 6) -> Tuple[torch.Tensor, dict]:
    """Returns (x_hat, stats). stats carries the GOBO byte accounting:
    normals at `bits` + outliers at 32 bits value + 32 bits coordinate —
    the unaligned overhead OliVe's Table 1 criticises."""
    mu, sigma = torch.mean(x), _pop_std(x)
    is_out = torch.abs(x - mu) > k_sigma * sigma
    normals = torch.where(is_out, mu, x)

    k = 1 << bits
    qs = _hex_tensor(_GOBO_QS4, x.device) if k == 16 else torch.as_tensor(
        np.linspace(0.5 / k, 1 - 0.5 / k, k).astype(np.float32),
        device=x.device)
    flat = normals.reshape(-1)
    cent = _quantile(flat, qs)
    for _ in range(iters):          # Lloyd iterations
        assign = _nearest(flat, cent)
        sums = torch.zeros(k, device=x.device).index_add_(0, assign, flat)
        cnts = torch.zeros(k, device=x.device).index_add_(
            0, assign, torch.ones_like(flat))
        cent = torch.where(cnts > 0, sums / torch.clamp(cnts, min=1), cent)
    qn = cent[_nearest(flat, cent)].reshape(x.shape)
    xh = torch.where(is_out, x, qn)  # outliers kept exact (fp32 side list)

    n_out = int(torch.sum(is_out))
    bytes_ = (x.numel() - n_out) * bits / 8 + n_out * (4 + 4) + k * 4
    return xh, {"outlier_frac": float(torch.mean(is_out.to(torch.float32))),
                "bytes": float(bytes_)}


# --------------------------------------------------------------------------
# AdaptivFloat: float with a tensor-wise exponent bias [76]
# --------------------------------------------------------------------------
def adaptivfloat_fake_quant(x: torch.Tensor, bits: int = 4,
                            ebits: int = 2) -> torch.Tensor:
    mb = bits - 1 - ebits
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-12)
    # the bias aligns the max representable with the tensor max exponent
    max_mant = 2.0 - 2.0 ** (-mb)
    ebias = torch.floor(torch.log2(amax / max_mant))
    emin = ebias - ((1 << ebits) - 1)

    sign = torch.sign(x)
    a = torch.abs(x)
    e = torch.clamp(torch.floor(torch.log2(torch.clamp(a, min=1e-30))),
                    emin, ebias)
    step = torch.exp2(e - mb)
    mant = torch.clamp(torch.round(a / step), 0, (2 ** (mb + 1)) - 1)
    xh = sign * mant * step
    # flush below the least representable magnitude's half
    return torch.where(a < torch.exp2(emin) / 2, 0.0, xh)


# --------------------------------------------------------------------------
# Fig. 3 controls: clip outliers / prune victims / prune random normals
# --------------------------------------------------------------------------
def clip_outliers(x: torch.Tensor, k_sigma: float = 3.0) -> torch.Tensor:
    mu, sigma = torch.mean(x), _pop_std(x)
    return torch.clamp(x, mu - k_sigma * sigma, mu + k_sigma * sigma)


def prune_victims(x: torch.Tensor, k_sigma: float = 3.0,
                  pair_axis: int = -1) -> torch.Tensor:
    """Zero the normal neighbour of each outlier (and the smaller of an
    outlier-outlier pair); everything else keeps full precision
    (Fig. 3)."""
    v = torch.movedim(x, pair_axis, -1)
    mu, sigma = torch.mean(v), _pop_std(v)
    t = k_sigma * sigma
    x0, x1 = v[..., 0::2], v[..., 1::2]
    a0, a1 = torch.abs(x0 - mu), torch.abs(x1 - mu)
    o0, o1 = a0 > t, a1 > t
    first_out = o0 & (~o1 | (a0 >= a1))
    second_out = o1 & ~first_out
    y0 = torch.where(second_out, 0.0, x0)   # victim of a right outlier
    y1 = torch.where(first_out, 0.0, x1)    # victim of a left outlier
    out = torch.stack([y0, y1], dim=-1).reshape(v.shape)
    return torch.movedim(out, -1, pair_axis)


def prune_random(x: torch.Tensor, frac: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Zero each value with probability `frac` (draws from `generator`,
    which must live on x's device)."""
    mask = torch.rand(x.shape, generator=generator, device=x.device) < frac
    return torch.where(mask, 0.0, x)
