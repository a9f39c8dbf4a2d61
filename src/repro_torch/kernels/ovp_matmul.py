"""K1: the fused OVP matmul — hand-written CUDA kernel + plain version.

Replaces the TPU kernel `repro/kernels/ovp_matmul.py:367`
(`fused_ovp_matmul_kernel`, body `_fused_mm_kernel` :224) and its host
wrapper `repro/kernels/ops.py:114` (`fused_ovp_matmul`) in the `fp` and
`quantize` activation modes:

    out[..., n] = (Σ_k a'[..., k] · w'[k, n]) · sa[...] · sw[n]

with w' the OVP-decoded weight (int4/flint4 nibbles packed along K, even
k in the high nibble, or int8 codes) and a' the activation as-is (`fp`)
or OVP fake-quantized in the kernel prologue at the per-row scale
(`quantize`). The kernel source is `csrc/ovp_matmul.cu`; its header says
how it is tiled and what bounds it on the H100.

`fused_ovp_matmul` folds the lead dims into rows, broadcasts the scales
to (rows,) and (N,), and pads N to the kernel's 16-column tile. CPU
tensors take `fused_ovp_matmul_plain`; CUDA tensors launch the kernel (or
raise); `fused_ovp_matmul.launches` counts kernel launches. The
pre-quantized `codes4`/`codes8` modes are not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.datatypes import (ABFLOAT_FOR_NORMAL, NORMAL_MAX,
                                        abfloat_decode, abfloat_encode)
from repro_torch.core.ovp import QuantizedTensor, decode_pair_planes

from . import _build

_DTYPE_CODE = {"int4": 0, "flint4": 1, "int8": 2}
_BN = 16          # the kernel's output-column tile
_BM = 8           # the kernel's row tile
_BK2 = 256        # the kernel's K-stage, in pairs
_SPLIT_BELOW = 100  # split K in two when the grid has fewer blocks


# --------------------------------------------------------------------------
# Plain version (the kernel's arithmetic in torch ops)
# --------------------------------------------------------------------------
def weight_planes(w_data: torch.Tensor, w_dtype: str):
    """Packed (K/2, N) nibbles or (K, N) int8 codes -> (even, odd)
    decoded fp32 planes, each (K/2, N)."""
    if w_dtype == "int8":
        return decode_pair_planes(w_data[0::2], w_data[1::2], w_dtype)
    return decode_pair_planes((w_data >> 4) & 0xF, w_data & 0xF, w_dtype)


def _roundtrip_normal(u: torch.Tensor, normal_dtype: str) -> torch.Tensor:
    if normal_dtype == "int4":
        return torch.clamp(torch.round(u), -7, 7)
    if normal_dtype == "int8":
        return torch.clamp(torch.round(u), -127, 127)
    # flint4: nearest of {0,1,2,3,4,6,8,16}, midpoint ties to the smaller
    a = torch.abs(u)
    mag = torch.full_like(a, 16.0)
    for edge, val in ((12.0, 8.0), (7.0, 6.0), (5.0, 4.0), (3.5, 3.0),
                      (2.5, 2.0), (1.5, 1.0), (0.5, 0.0)):
        mag = torch.where(a <= edge, val, mag)
    return torch.where((u < 0) & (mag > 0), -mag, mag)


def quantize_pair_planes(u0: torch.Tensor, u1: torch.Tensor,
                         normal_dtype: str):
    """Scaled activation planes -> OVP fake-quantized planes: the same
    outlier/victim selection and rounding as `core.ovp.ovp_encode_codes`,
    in the value domain (the kernel's quantize prologue)."""
    spec = ABFLOAT_FOR_NORMAL[normal_dtype]
    t = float(NORMAL_MAX[normal_dtype])
    a0, a1 = torch.abs(u0), torch.abs(u1)
    o0, o1 = a0 > t, a1 > t
    first_out = o0 & (~o1 | (a0 >= a1))
    second_out = o1 & ~first_out

    def outlier(u):
        return abfloat_decode(abfloat_encode(u, spec), spec)

    q0 = torch.where(first_out, outlier(u0),
                     torch.where(second_out, 0.0,
                                 _roundtrip_normal(u0, normal_dtype)))
    q1 = torch.where(second_out, outlier(u1),
                     torch.where(first_out, 0.0,
                                 _roundtrip_normal(u1, normal_dtype)))
    return q0.to(torch.float32), q1.to(torch.float32)


def fused_ovp_matmul_plain(a: torch.Tensor, sa: Optional[torch.Tensor],
                           w_data: torch.Tensor, sw: torch.Tensor, *,
                           w_dtype: str, a_dtype: Optional[str]
                           ) -> torch.Tensor:
    """a (R, K) f32; sa (R,) row scales (quantize mode) or None (fp);
    w_data packed/int8 codes; sw (N,) -> (R, N) f32."""
    w_even, w_odd = weight_planes(w_data, w_dtype)
    af = a.to(torch.float32)
    if a_dtype is not None:
        u = af / sa[:, None]
        a_even, a_odd = quantize_pair_planes(u[:, 0::2], u[:, 1::2], a_dtype)
    else:
        a_even, a_odd = af[:, 0::2], af[:, 1::2]
    acc = a_even @ w_even + a_odd @ w_odd
    if a_dtype is not None:
        acc = acc * sa[:, None]
    return acc * sw[None, :]


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------
_SIGNATURE = {"ovp_mm_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
              + [ctypes.c_void_p]}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(a: torch.Tensor, sa: Optional[torch.Tensor],
            w_data: torch.Tensor, sw: torch.Tensor, *, w_dtype: str,
            a_dtype: Optional[str]) -> torch.Tensor:
    r, k = a.shape
    n = w_data.shape[1]
    if a.dtype != torch.float32 or w_data.dtype != torch.uint8:
        raise TypeError(f"ovp_matmul kernel takes f32 activations and "
                        f"uint8 codes, got {a.dtype} and {w_data.dtype}")
    if {t.device for t in (a, w_data, sw)} != {a.device}:
        raise ValueError("ovp_matmul operands must share one device")
    if n % _BN:
        pad = _BN - n % _BN
        w_data = torch.nn.functional.pad(w_data, (0, pad))
        sw = torch.nn.functional.pad(sw, (0, pad), value=1.0)
    np_ = w_data.shape[1]
    blocks = (np_ // _BN) * (-(-r // _BM))
    split = 2 if blocks < _SPLIT_BELOW and k // 2 >= 2 * _BK2 else 1
    out = (torch.zeros if split > 1 else torch.empty)(
        (r, np_), dtype=torch.float32, device=a.device)
    a, w_data, sw = _aligned(a), _aligned(w_data), _aligned(sw.float())
    sa = sw if sa is None else _aligned(sa.float())
    lib = _build.load("ovp_matmul", _SIGNATURE)
    err = lib.ovp_mm_launch(
        a.data_ptr(), sa.data_ptr(), w_data.data_ptr(), sw.data_ptr(),
        out.data_ptr(), r, k, np_, _DTYPE_CODE[w_dtype],
        0 if a_dtype is None else 1, _DTYPE_CODE[a_dtype or "int4"], split,
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ovp_matmul")
    fused_ovp_matmul.launches += 1
    return out[:, :n]


def run(a: torch.Tensor, sa: Optional[torch.Tensor], w_data: torch.Tensor,
        sw: torch.Tensor, *, w_dtype: str, a_dtype: Optional[str]
        ) -> torch.Tensor:
    """(R, K) x codes -> (R, N): the plain version for CPU tensors, the
    kernel for CUDA tensors, an error for anything else."""
    expect = w_data.shape[0] * (1 if w_dtype == "int8" else 2)
    if a.shape[1] != expect or a.shape[1] % 2:
        raise ValueError(f"lhs K={a.shape[1]} does not match the "
                         f"{w_dtype} weight {tuple(w_data.shape)}")
    if a.device.type == "cpu":
        return fused_ovp_matmul_plain(a, sa, w_data, sw, w_dtype=w_dtype,
                                      a_dtype=a_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"ovp_matmul runs on cpu or cuda, not {a.device}")
    return _launch(a, sa, w_data, sw, w_dtype=w_dtype, a_dtype=a_dtype)


def fused_ovp_matmul(x: torch.Tensor, w: QuantizedTensor, *,
                     a_dtype: Optional[str] = None,
                     act_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(…, K) @ OVP (K, N) -> (…, N) f32, one kernel launch on CUDA.

    `a_dtype` set: activations are OVP-quantized in the prologue at
    `act_scale` (a per-tensor scalar or one scale per row); unset: W4A16.
    Weight pairs must run along K (`pair_axis == -2`)."""
    if w.data.ndim != 2 or w.pair_axis % 2 != 0:
        raise ValueError("fused_ovp_matmul takes a 2-D weight paired "
                         "along K")
    n = w.data.shape[-1]
    lead = x.shape[:-1]
    a = x.reshape(-1, x.shape[-1]).to(torch.float32)
    sw = torch.broadcast_to(w.scale.to(torch.float32).reshape(-1)
                            if w.scale.ndim else w.scale.float(), (n,))
    sa = None
    if a_dtype is not None:
        if act_scale is None:
            raise ValueError("in-kernel activation quantization needs an "
                             "act_scale (per-tensor or per-row)")
        s = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
        if s.ndim and s.shape == lead:
            s = s.reshape(-1)
        sa = torch.broadcast_to(s, (a.shape[0],))
    out = run(a, sa, w.data, sw, w_dtype=w.normal_dtype, a_dtype=a_dtype)
    return out.reshape(*lead, n)


fused_ovp_matmul.launches = 0
