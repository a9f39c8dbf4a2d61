"""K2 and K3: decode attention over slab and paged (optionally
OVP-packed) KV caches — hand-written CUDA kernels + plain version, and the
dense path.

K2 replaces the TPU kernel `repro/kernels/decode_attn.py:358`
(`_decode_attn_call`, bodies `_decode_attn_kernel_packed` :308 and
`_decode_attn_kernel_fp` :336) and K3 its paged twin
`_paged_decode_attn_call` :404, with their wrapper
`fused_decode_attention` :485. Single-token GQA attention: q (B, 1, H, D)
against a packed cache ({"k_data", "v_data"} (B, S, Hkv, D/2) uint8
nibbles + {"k_scl", "v_scl"} (B, S, Hkv) f32) or an fp cache ({"k",
"v"} (B, S, Hkv, D) in f32, bf16 or fp16), with length / ring /
sliding-window masking from
`pos` (B,). A paged cache holds the same leaves as `(P, page_size, …)`
pools plus a "block_table" (B, pages_per_row) int32 mapping logical page
j of row b to a physical page. The kernel source is `csrc/decode_attn.cu`
(one body for both layouts).

`fused_decode_attention` takes `decode_attention_plain` for CPU tensors
and launches K2 (slab) for CUDA tensors, or raises; paged caches go to
`fused_paged_decode_attention`, which launches K3. Each wrapper's
`.launches` counts its kernel's launches. `kernel_layout` is the
launch's layout check (any G, D % 8 == 0, tiles sized from (G, D) in
dynamic shared memory), pure so that it is testable without a card.
`xla_decode_attention` is the port of the reference's dense path (what
the `eager` backend serves): whole-cache dequantize, then einsum, in
bfloat16 for packed caches exactly as the reference rounds it; a paged
cache is gathered into a slab first (`gather_paged_cache`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ovp import ovp_decode_codes, unpack4

from . import _build

NEG_INF = -1e30
KV_NORMAL_DTYPE = "int4"


def dequant_codes(data: torch.Tensor) -> torch.Tensor:
    """Packed (…, D/2) nibbles -> (…, D) decoded f32 codes (unscaled)."""
    return ovp_decode_codes(unpack4(data, -1), KV_NORMAL_DTYPE, pair_axis=-1)


def dequant_kv(data: torch.Tensor, scl: torch.Tensor) -> torch.Tensor:
    """Packed (…, T, Hkv, D/2) nibbles + (…, T, Hkv) scales -> f32."""
    return dequant_codes(data) * scl[..., None]


_KV_KEYS = ("k", "v", "k_data", "v_data", "k_scl", "v_scl")


def gather_paged_cache(cache):
    """Materialize a paged cache into a `(B, pages_per_row * page_size,
    …)` slab dict through its block table (the dense path's view of the
    pool)."""
    bt = cache["block_table"].to(torch.int64)               # (B, n)
    b, n = bt.shape
    out = {}
    for key in _KV_KEYS:
        if key in cache:
            pool = cache[key]                               # (P, ps, …)
            flat = pool[bt.reshape(-1)]
            out[key] = flat.reshape((b, n * pool.shape[1]) + pool.shape[2:])
    return out


def _slab_view(cache, ring: int):
    """A paged cache as a slab dict, trimmed to the ring length (the pool
    rounds a ring up to whole pages and the modular slot arithmetic must
    never see the rounding tail); slab caches pass through."""
    if "block_table" not in cache:
        return cache
    slab = gather_paged_cache(cache)
    if ring:
        slab = {key: leaf[:, :ring] for key, leaf in slab.items()}
    return slab


def read_cache_dense(cache, dtype=None):
    """(k, v) dense views of a cache dict (paged caches materialize
    through the block table first). dtype=None keeps fp caches native and
    decodes packed caches to bfloat16 (the reference's `cache_read`
    contract)."""
    if "block_table" in cache:
        cache = gather_paged_cache(cache)
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
    caches) and products accumulate in f32, as the reference does. Paged
    caches gather into a slab (trimmed to the ring) first."""
    k, v = read_cache_dense(_slab_view(cache, ring))
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
    """None when a fused kernel (K2 slab, K3 paged) serves this (q,
    cache) layout; the codes are `backends.base.DECLINE_CODES
    ["decode_attn"]` entries, in the reference's order."""
    if q.shape[1] != 1:
        return "decode_q_tokens_gt_1"
    paged = "block_table" in cache
    leaf = cache.get("k", cache.get("k_data"))
    if leaf is None:
        return "paged_no_pool" if paged else "decode_no_kv_cache"
    if paged:
        bt = cache["block_table"]
        if bt.ndim != 2 or bt.dtype.is_floating_point \
                or bt.dtype.is_complex or bt.dtype == torch.bool:
            return "paged_table_rank"
        if leaf.shape[0] == 0 or bt.shape[1] == 0:
            return "decode_empty_cache"
        if leaf.shape[1] < 2 or leaf.shape[1] % 2 != 0:
            return "paged_page_misaligned"
    elif leaf.shape[1] == 0:
        return "decode_empty_cache"
    if "k" in cache and cache["k"].shape[-1] % 2 != 0:
        return "decode_head_dim_odd"
    return None


# --------------------------------------------------------------------------
# Plain version (the kernel's arithmetic, densely)
# --------------------------------------------------------------------------
def decode_attention_plain(q: torch.Tensor, cache, pos: torch.Tensor, *,
                           window: int = 0, ring: int = 0) -> torch.Tensor:
    """The kernels' function in torch ops: scores from the decoded codes
    times the K scale, mask, softmax with the -1e30 floor, probabilities
    times the V scale, then PV / max(l, 1e-30). A paged cache is gathered
    into a slab (trimmed to the ring) first, which is what K3 computes
    through its block table."""
    cache = _slab_view(cache, ring)
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
_SIGNATURE = {
    "decode_attn_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "paged_decode_attn_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

# the cache kinds of the C entries: OVP-packed, or fp in one of these
FP_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
SMEM_MAX = 232448     # 227 KB, a block's dynamic shared-memory cap
_TS = 32              # kv tokens per tile


@dataclasses.dataclass(frozen=True)
class KernelLayout:
    """One K2/K3 launch's layout: `g` query heads per kv head, head dim
    `d`, cache `kind` (0 packed, else `FP_KINDS`) and the block's dynamic
    shared bytes (csrc/decode_attn.cu's `smem_bytes`)."""
    g: int
    d: int
    kind: int
    smem: int


def kernel_layout(h: int, hkv: int, d: int,
                  fp_dtype: Optional[torch.dtype] = None) -> KernelLayout:
    """The K2/K3 layout of H query heads over Hkv kv heads of dim D, for
    a packed cache (`fp_dtype` None) or an fp cache of `fp_dtype`; raises
    ValueError / TypeError on what the kernel cannot take."""
    g = h // hkv if hkv > 0 else 0
    if hkv < 1 or g * hkv != h or d < 8 or d % 8:
        raise ValueError(f"decode_attn kernel needs H % Hkv == 0 and D % 8 "
                         f"== 0; got H={h} Hkv={hkv} D={d}")
    if fp_dtype is not None and fp_dtype not in FP_KINDS:
        raise TypeError(f"decode_attn kernel takes fp caches in "
                        f"{sorted(map(str, FP_KINDS))}, got {fp_dtype}")
    smem = 4 * (_TS * d + _TS * (d + 1) + 2 * g * d + g * _TS + 3 * g
                + 2 * _TS)
    if smem > SMEM_MAX:
        raise ValueError(f"decode_attn kernel: G={g}, D={d} needs {smem} "
                         f"bytes of shared memory, over {SMEM_MAX}")
    return KernelLayout(g, d, 0 if fp_dtype is None else FP_KINDS[fp_dtype],
                        smem)


def _launch(q: torch.Tensor, cache, pos: torch.Tensor, *, window: int,
            ring: int) -> torch.Tensor:
    b, _, h, d = q.shape
    packed = "k_data" in cache
    paged = "block_table" in cache
    kd = cache["k_data"] if packed else cache["k"]
    vd = cache["v_data"] if packed else cache["v"]
    hkv = kd.shape[2]
    lay = kernel_layout(h, hkv, d, None if packed else kd.dtype)
    if not packed and vd.dtype != kd.dtype:
        raise TypeError(f"decode_attn kernel: k cache {kd.dtype}, v cache "
                        f"{vd.dtype}")
    ks = cache["k_scl"] if packed else kd
    vs = cache["v_scl"] if packed else vd
    ops = [t.contiguous() for t in (q.to(torch.float32), kd, vd, ks, vs)]
    if any(t.device != q.device for t in ops):
        raise ValueError("decode_attn operands must share one device")
    pos32 = pos.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attn", _SIGNATURE)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if paged:
        bt = cache["block_table"].to(device=q.device,
                                     dtype=torch.int32).contiguous()
        n, ps, n_pool = bt.shape[1], kd.shape[1], kd.shape[0]
        s_len = ring if ring else n * ps
        if bt.shape[0] != b or s_len > n * ps:
            raise ValueError(f"paged decode_attn: block table "
                             f"{tuple(bt.shape)} for batch {b}, ring {ring} "
                             f"over {n} pages of {ps}")
        err = lib.paged_decode_attn_launch(
            *(t.data_ptr() for t in ops), pos32.data_ptr(), bt.data_ptr(),
            out.data_ptr(), b, s_len, hkv, lay.g, d, n, ps, n_pool, lay.kind,
            _qscale(d), int(window), int(ring), stream)
        _build.check(err, "paged_decode_attn")
        fused_paged_decode_attention.launches += 1
    else:
        err = lib.decode_attn_launch(
            *(t.data_ptr() for t in ops), pos32.data_ptr(), out.data_ptr(),
            b, kd.shape[1], hkv, lay.g, d, lay.kind, _qscale(d), int(window),
            int(ring), stream)
        _build.check(err, "decode_attn")
        fused_decode_attention.launches += 1
    return out.to(q.dtype)


def _run(q: torch.Tensor, cache, pos: torch.Tensor, window: int,
         ring: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache, pos, window=window,
                                      ring=ring)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    return _launch(q, cache, pos, window=window, ring=ring)


def fused_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                           window: int = 0, ring: int = 0) -> torch.Tensor:
    """Single-token attention over a KV cache, one kernel launch on CUDA
    (K2 for a slab cache; a paged cache goes to
    `fused_paged_decode_attention`); CPU tensors take
    `decode_attention_plain`."""
    if "block_table" in cache:
        return fused_paged_decode_attention(q, cache, pos, window=window,
                                            ring=ring)
    return _run(q, cache, pos, window, ring)


def fused_paged_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor,
                                 *, window: int = 0,
                                 ring: int = 0) -> torch.Tensor:
    """Single-token attention over a paged cache: one K3 launch on CUDA,
    reading K/V through the block table; CPU tensors take
    `decode_attention_plain`."""
    if "block_table" not in cache:
        raise ValueError("fused_paged_decode_attention needs a paged cache "
                         "(a block_table leaf)")
    return _run(q, cache, pos, window, ring)


fused_decode_attention.launches = 0          # K2 launches
fused_paged_decode_attention.launches = 0    # K3 launches
