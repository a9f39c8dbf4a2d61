"""Plain oracles for the kernels' contract. Port of
`repro/kernels/ref.py`.

The kernels compute in scaled units (codes decoded, scales applied by
the wrapper); these oracles do the same in fp32, so a test can hold a
kernel's unscaled result to them.
"""
from __future__ import annotations

import torch

from repro_torch.core.ovp import (ovp_decode_codes, ovp_encode_codes, pack4,
                                  unpack4)


def decode_packed(packed: torch.Tensor, normal_dtype: str,
                  pair_axis: int) -> torch.Tensor:
    """uint8 packed codes (int8: one code a byte) -> decoded values in
    scaled units (float32)."""
    codes = unpack4(packed, pair_axis) if normal_dtype != "int8" else packed
    return ovp_decode_codes(codes, normal_dtype, pair_axis=pair_axis)


def ovp_matmul_w4a16_ref(a: torch.Tensor, w_packed: torch.Tensor,
                         normal_dtype: str = "int4") -> torch.Tensor:
    """a (M, K) real @ w_packed (K/2, N) paired along K: (M, N) float32
    in w-scaled units (the caller applies the weight scales)."""
    wd = decode_packed(w_packed, normal_dtype, pair_axis=0)
    return torch.matmul(a.to(torch.float32), wd)


def ovp_matmul_w4a4_ref(a_packed: torch.Tensor, w_packed: torch.Tensor,
                        normal_dtype: str = "int4") -> torch.Tensor:
    """a_packed (M, K/2) @ w_packed (K/2, N), both paired along K: (M, N)
    float32 in (a·w)-scaled units."""
    ad = decode_packed(a_packed, normal_dtype, pair_axis=1)
    wd = decode_packed(w_packed, normal_dtype, pair_axis=0)
    return torch.matmul(ad, wd)


def ovp_encode_ref(u: torch.Tensor, normal_dtype: str = "int4"
                   ) -> torch.Tensor:
    """u (M, K) scaled values -> (M, K/2) packed uint8 codes."""
    return pack4(ovp_encode_codes(u, normal_dtype, pair_axis=-1),
                 pair_axis=-1)


def matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.to(torch.float32), w.to(torch.float32))
