"""K2: slab decode attention over (optionally OVP-packed) KV caches —
hand-written CUDA kernel + plain version, and the dense path.

Replaces the TPU kernel `repro/kernels/decode_attn.py:358`
(`_decode_attn_call`, bodies `_decode_attn_kernel_packed` :308 and
`_decode_attn_kernel_fp` :336) and its wrapper `fused_decode_attention`
:485 for slab caches. Single-token GQA attention: q (B, 1, H, D) against
a packed cache ({"k_data", "v_data"} (B, S, Hkv, D/2) uint8 nibbles +
{"k_scl", "v_scl"} (B, S, Hkv) f32) or an fp32 cache ({"k", "v"}
(B, S, Hkv, D)), with length / ring / sliding-window masking from `pos`
(B,). The kernel source is `csrc/decode_attn.cu`.

`fused_decode_attention` takes `decode_attention_plain` for CPU tensors
and launches the kernel for CUDA tensors (or raises);
`fused_decode_attention.launches` counts kernel launches.
`xla_decode_attention` is the port of the reference's dense path (what
the `eager` backend serves): whole-cache dequantize, then einsum, in
bfloat16 for packed caches exactly as the reference rounds it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ovp import ovp_decode_codes, unpack4

from . import _build

NEG_INF = -1e30
KV_NORMAL_DTYPE = "int4"
_DMAX, _GMAX = 128, 8   # the kernel's shared-memory limits


def dequant_codes(data: torch.Tensor) -> torch.Tensor:
    """Packed (…, D/2) nibbles -> (…, D) decoded f32 codes (unscaled)."""
    return ovp_decode_codes(unpack4(data, -1), KV_NORMAL_DTYPE, pair_axis=-1)


def dequant_kv(data: torch.Tensor, scl: torch.Tensor) -> torch.Tensor:
    """Packed (…, T, Hkv, D/2) nibbles + (…, T, Hkv) scales -> f32."""
    return dequant_codes(data) * scl[..., None]


def read_cache_dense(cache, dtype=None):
    """(k, v) dense views of a slab cache dict. dtype=None keeps fp
    caches native and decodes packed caches to bfloat16 (the reference's
    `cache_read` contract)."""
    if "k" in cache:
        k, v = cache["k"], cache["v"]
        return (k, v) if dtype is None else (k.to(dtype), v.to(dtype))
    dtype = torch.bfloat16 if dtype is None else dtype
    return (dequant_kv(cache["k_data"], cache["k_scl"]).to(dtype),
            dequant_kv(cache["v_data"], cache["v_scl"]).to(dtype))


def slot_validity(pos: torch.Tensor, slots: torch.Tensor, *, window: int,
                  ring: int):
    """(abs_pos, valid) for cache slots given per-row `pos` (B,). `ring`
    > 0: slot i holds the largest p' <= pos with p' % ring == i."""
    p = pos[:, None]
    if ring:
        abs_pos = p - torch.remainder(p - slots[None, :], ring)
        valid = abs_pos >= 0
    else:
        abs_pos = torch.broadcast_to(slots[None, :],
                                     (pos.shape[0], slots.shape[0]))
        valid = abs_pos <= p
    if window:
        valid = valid & (abs_pos > p - window) & (abs_pos <= p)
    return abs_pos, valid


def _qscale(d: int) -> float:
    """float32(sqrt(D)), the divisor the reference scales queries by."""
    return float(np.float32(math.sqrt(d)))


def xla_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                         window: int = 0, ring: int = 0) -> torch.Tensor:
    """Dense path: dequantize the whole cache, then einsum + softmax.
    Operands round to the cache's dense dtype (bfloat16 for packed
    caches) and products accumulate in f32, as the reference does."""
    k, v = read_cache_dense(cache)
    b, s_len, hkv, d = k.shape
    h = q.shape[2]
    g = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, hkv, g, d).to(k.dtype).to(f32)
    s = torch.matmul(qg, k.to(f32).permute(0, 2, 3, 1)) * (1.0
                                                           / math.sqrt(d))
    _, valid = slot_validity(pos, torch.arange(s_len, device=q.device),
                             window=window, ring=ring)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).to(f32)
    out = torch.matmul(p, v.to(f32).permute(0, 2, 1, 3))
    return out.reshape(b, 1, h, d).to(q.dtype)


def decline_reason(q: torch.Tensor, cache) -> Optional[str]:
    """None when the fused kernel serves this (q, cache) slab layout; the
    codes are `backends.base.DECLINE_CODES["decode_attn"]` entries."""
    if q.shape[1] != 1:
        return "decode_q_tokens_gt_1"
    leaf = cache.get("k", cache.get("k_data"))
    if leaf is None:
        return "decode_no_kv_cache"
    if leaf.shape[1] == 0:
        return "decode_empty_cache"
    if "k" in cache and cache["k"].shape[-1] % 2 != 0:
        return "decode_head_dim_odd"
    return None


# --------------------------------------------------------------------------
# Plain version (the kernel's arithmetic, densely)
# --------------------------------------------------------------------------
def decode_attention_plain(q: torch.Tensor, cache, pos: torch.Tensor, *,
                           window: int = 0, ring: int = 0) -> torch.Tensor:
    """The kernel's function in torch ops: scores from the decoded codes
    times the K scale, mask, softmax with the -1e30 floor, probabilities
    times the V scale, then PV / max(l, 1e-30)."""
    b, _, h, d = q.shape
    packed = "k_data" in cache
    if packed:
        k, v = dequant_codes(cache["k_data"]), dequant_codes(cache["v_data"])
    else:
        k, v = cache["k"].to(torch.float32), cache["v"].to(torch.float32)
    s_len, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, d).to(torch.float32) / _qscale(d)
    s = torch.matmul(qf, k.permute(0, 2, 3, 1))              # (B,Hkv,G,S)
    if packed:
        s = s * cache["k_scl"].permute(0, 2, 1)[:, :, None, :]
    _, valid = slot_validity(pos, torch.arange(s_len, device=q.device),
                             window=window, ring=ring)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    if packed:
        p = p * cache["v_scl"].permute(0, 2, 1)[:, :, None, :]
    o = torch.matmul(p, v.permute(0, 2, 1, 3))               # (B,Hkv,G,D)
    out = o / torch.clamp(l_sum, min=1e-30)
    return out.reshape(b, 1, h, d).to(q.dtype)


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------
_SIGNATURE = {"decode_attn_launch": [ctypes.c_void_p] * 7
              + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]}


def _launch(q: torch.Tensor, cache, pos: torch.Tensor, *, window: int,
            ring: int) -> torch.Tensor:
    b, _, h, d = q.shape
    packed = "k_data" in cache
    kd = cache["k_data"] if packed else cache["k"]
    vd = cache["v_data"] if packed else cache["v"]
    s_len, hkv = kd.shape[1], kd.shape[2]
    g = h // hkv
    if g * hkv != h or g > _GMAX or d > _DMAX or d % 8:
        raise ValueError(f"decode_attn kernel needs H % Hkv == 0, "
                         f"G <= {_GMAX}, D <= {_DMAX} and D % 8 == 0; got "
                         f"H={h} Hkv={hkv} D={d}")
    if not packed and kd.dtype != torch.float32:
        raise TypeError(f"decode_attn kernel takes f32 fp caches, got "
                        f"{kd.dtype}")
    ks = cache["k_scl"] if packed else kd
    vs = cache["v_scl"] if packed else vd
    ops = [t.contiguous() for t in (q.to(torch.float32), kd, vd, ks, vs)]
    if any(t.device != q.device for t in ops):
        raise ValueError("decode_attn operands must share one device")
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attn", _SIGNATURE)
    err = lib.decode_attn_launch(
        *(t.data_ptr() for t in ops), pos32.data_ptr(), out.data_ptr(),
        b, s_len, hkv, g, d, int(packed), _qscale(d), int(window),
        int(ring), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attn")
    fused_decode_attention.launches += 1
    return out.to(q.dtype)


def fused_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                           window: int = 0, ring: int = 0) -> torch.Tensor:
    """Single-token attention over a slab cache, one kernel launch on
    CUDA; CPU tensors take `decode_attention_plain`."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache, pos, window=window,
                                      ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    return _launch(q, cache, pos, window=window, ring=ring)


fused_decode_attention.launches = 0
