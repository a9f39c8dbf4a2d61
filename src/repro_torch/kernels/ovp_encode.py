"""K7: the standalone OVP encoder — hand-written CUDA kernel + plain
version.

Replaces the TPU kernel `repro/kernels/ovp_encode.py:59`
(`ovp_encode_pallas`, body `_encode_kernel` :42): scaled values u (R, K)
f32 -> packed OVP bytes (R, K/2) uint8, int4 normals with E2M1 abfloat
outliers, the even value of each pair in the high nibble. Int4 only, as
the reference asserts. The kernel source is `csrc/ovp_encode.cu`; its
header says what bounds it on the H100.

`fused_ovp_encode` takes `ovp_encode_plain` for CPU tensors and launches
the kernel for CUDA tensors (or raises); `fused_ovp_encode.launches`
counts kernel launches. The host wrapper that scales real values first
is `kernels.ops.ovp_encode`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ovp import ovp_encode_codes, pack4

from . import _build

_SIGNATURE = {"ovp_encode_launch": [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def ovp_encode_plain(u: torch.Tensor) -> torch.Tensor:
    """(R, K) scaled f32 -> (R, K/2) packed int4 OVP bytes: Algorithm 1
    and 2 in torch ops (`core.ovp.ovp_encode_codes`), then `pack4`."""
    return pack4(ovp_encode_codes(u.to(torch.float32), "int4"))


def _launch(u: torch.Tensor) -> torch.Tensor:
    if u.dtype != torch.float32:
        raise TypeError(f"ovp_encode kernel takes f32, got {u.dtype}")
    r, k = u.shape
    u = u.contiguous()
    if u.data_ptr() % 8:
        u = u.clone()
    out = torch.empty((r, k // 2), dtype=torch.uint8, device=u.device)
    lib = _build.load("ovp_encode", _SIGNATURE)
    err = lib.ovp_encode_launch(u.data_ptr(), out.data_ptr(), r, k,
                                torch.cuda.current_stream(u.device)
                                .cuda_stream)
    _build.check(err, "ovp_encode")
    fused_ovp_encode.launches += 1
    return out


def fused_ovp_encode(u: torch.Tensor, normal_dtype: str = "int4"
                     ) -> torch.Tensor:
    """(R, K) scaled values -> (R, K/2) packed OVP bytes: the plain
    version for CPU tensors, one kernel launch for CUDA tensors, an
    error for anything else."""
    if normal_dtype != "int4":
        raise ValueError("the encoder kernel targets int4 activations, "
                         f"not {normal_dtype!r}")
    if u.ndim != 2 or u.shape[1] % 2:
        raise ValueError(f"ovp_encode takes (R, K) with K even, got "
                         f"{tuple(u.shape)}")
    if u.device.type == "cpu":
        return ovp_encode_plain(u)
    if u.device.type != "cuda":
        raise ValueError(f"ovp_encode runs on cpu or cuda, not {u.device}")
    return _launch(u)


fused_ovp_encode.launches = 0
