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
`.launches` counts its kernel's launches, and its
`.cache_launches[dtype]` the same launches by cache dtype
(`CACHE_DTYPES`: "int4" for a packed cache; an encoder-decoder's fp32
cross caches sit beside its packed self caches). `decode_plan` is the
launch's layout check and geometry (the key split over a thread-block
cluster, the tiles a rank walks, tile buffers, shared bytes; any G, D %
8 == 0, tiles sized from (G, D) in dynamic shared memory), from shapes
alone, pure and memoized so that it is testable without a card and
costs a dictionary lookup a call; `live_tiles` is the kernel's
live-tile range, read from `pos` on the card.
`xla_decode_attention` is the port of the reference's dense path (what
the `eager` backend serves): whole-cache dequantize, then einsum, in
bfloat16 for packed caches exactly as the reference rounds it; a paged
cache is gathered into a slab first (`gather_paged_cache`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
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


@functools.lru_cache(maxsize=None)
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


def decode_attention_shape(q: torch.Tensor) -> torch.Tensor:
    """The plain version's output for a "meta" q: (B, 1, H, D) in q's
    dtype on "meta", no arithmetic."""
    return torch.empty(q.shape, dtype=q.dtype, device="meta")


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------
_SIGNATURE = {
    "decode_attn_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "paged_decode_attn_launch": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]}

# the cache kinds of the C entries: OVP-packed, or fp in one of these
FP_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
# the names of `.cache_launches`' keys: the packed cache's, then FP_KINDS'
CACHE_DTYPES = (KV_NORMAL_DTYPE,) + tuple(
    str(dt).removeprefix("torch.") for dt in FP_KINDS)
SMEM_MAX = 232448     # 227 KB, a block's dynamic shared-memory cap
_TS = 32              # kv tokens per tile
_MIN_BLOCKS = 132     # one wave: an H100 has 132 SMs
_TAB_COPIES = 16      # copies of the packed byte table (half2 entries)


def _geom(g: int, d: int):
    """(wpr, ks, ncol, tsp, vs): csrc/decode_attn.cu's `geom`, how a
    block's 4 warps share a tile (warps per query row, padded K row,
    float4 columns of a warp's PV, lanes splitting its tokens, padded V
    row)."""
    wpr = 4 if g == 1 else 2 if g == 2 else 1
    ncol = -(-(d // 4) // wpr)
    tsp = 1
    while tsp < 8 and 2 * tsp * ncol <= 32:
        tsp *= 2
    return wpr, d + 4 * wpr, ncol, tsp, d + (32 // tsp if tsp > 1 else 0)


def _smem(g: int, d: int, kind: int, nbuf: int) -> int:
    """A block's dynamic shared bytes (the C side's `smem_bytes`): nbuf
    raw tile buffers, the decoded f32 K/V tiles (not for f32 caches), the
    queries, the partial o, probabilities, scores, the packed byte table
    (packed caches), m and l."""
    wpr, ks, _, _, vs = _geom(g, d)
    raw = (_TS * d + 8 * _TS if kind == 0 else
           4 * _TS * (ks + vs) if kind == 1 else 4 * _TS * d)
    dec = 0 if kind == 1 else 4 * _TS * (ks + vs)
    tab = 4 * 256 * _TAB_COPIES if kind == 0 else 0
    return nbuf * raw + dec + tab + 4 * (2 * g * d + g * wpr * _TS
                                   + (g * _TS if wpr > 1 else 0)
                                   + 2 * g * wpr)


def live_tiles(pos: int, s: int, window: int = 0, ring: int = 0) -> range:
    """The 32-token tiles of an S-slot cache that can hold a valid slot
    at position `pos` (the kernel's `live_tiles`): 0 .. pos / 32, bounded
    below by a window, all of S under a ring once pos >= ring - 1 (or
    when the cache is longer than the ring). With no valid slot at all,
    every tile: the plain version then averages V over all S slots."""
    lo, hi = 0, min(pos, s - 1)
    if window:
        lo = max(pos - window + 1, 0)
    if ring and (pos >= ring - 1 or s > ring):
        lo, hi = 0, s - 1
    if lo > hi:
        lo, hi = 0, s - 1
    return range(lo // _TS, hi // _TS + 1)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """One K2/K3 launch (csrc/decode_attn.cu's header says why): `b` x
    `hkv` (row, kv head) pairs, each split over a cluster of `split`
    blocks of 128 threads; the `g` query heads of a kv head of dim `d`
    share each tile; an S-slot cache of `tiles` 32-token tiles, a rank
    walking at most `tpr` of them through `nbuf` raw tile buffers; `smem`
    dynamic shared bytes; `kind` the cache layout (0 packed, else
    `FP_KINDS`)."""
    b: int
    s: int
    g: int
    hkv: int
    d: int
    kind: int
    split: int
    tpr: int
    nbuf: int
    smem: int

    @property
    def tiles(self) -> int:
        return -(-self.s // _TS)

    def rank_tiles(self, pos: int, rank: int, window: int = 0,
                   ring: int = 0) -> range:
        """The tiles cluster rank `rank` walks for a row at `pos`: its
        contiguous share of the row's live tiles (empty for a rank past
        them)."""
        live = live_tiles(pos, self.s, window, ring)
        per = -(-len(live) // self.split)
        lo = min(live.start + rank * per, live.stop)
        return range(lo, min(lo + per, live.stop))


@functools.lru_cache(maxsize=None)
def decode_plan(b: int, s: int, h: int, hkv: int, d: int,
                fp_dtype: Optional[torch.dtype] = None) -> DecodePlan:
    """The K2/K3 launch of B rows of H query heads over Hkv kv heads of
    dim D against an S-slot cache (K3: s_len, the ring or n * page size),
    packed (`fp_dtype` None) or fp of `fp_dtype` (pure, memoized; from
    shapes alone, never from `pos`, so a CUDA graph can capture the
    call). Raises ValueError / TypeError on what the kernel cannot take.
    The key split: the smallest power of two (up to 8, and no more than
    the cache's tiles) that puts one wave of blocks on the card; two raw
    tile buffers where a rank can walk more than one tile and they fit."""
    g = h // hkv if hkv > 0 else 0
    if hkv < 1 or g * hkv != h or d < 8 or d % 8 or b < 1 or s < 1:
        raise ValueError(f"decode_attn kernel needs H % Hkv == 0 and D % 8 "
                         f"== 0; got B={b} S={s} H={h} Hkv={hkv} D={d}")
    if fp_dtype is not None and fp_dtype not in FP_KINDS:
        raise TypeError(f"decode_attn kernel takes fp caches in "
                        f"{sorted(map(str, FP_KINDS))}, got {fp_dtype}")
    kind = 0 if fp_dtype is None else FP_KINDS[fp_dtype]
    tiles = -(-s // _TS)
    split = 1
    while split < 8 and 2 * split <= tiles and b * hkv * split < _MIN_BLOCKS:
        split *= 2
    tpr = -(-tiles // split)
    nbuf = 2 if tpr > 1 and _smem(g, d, kind, 2) <= SMEM_MAX else 1
    smem = _smem(g, d, kind, nbuf)
    if smem > SMEM_MAX:
        raise ValueError(f"decode_attn kernel: G={g}, D={d} needs {smem} "
                         f"bytes of shared memory, over {SMEM_MAX}")
    return DecodePlan(b, s, g, hkv, d, kind, split, tpr, nbuf, smem)


def kernel_layout(h: int, hkv: int, d: int,
                  fp_dtype: Optional[torch.dtype] = None) -> DecodePlan:
    """The layout check alone: the plan of one row over one tile (split
    1, one buffer), the least any call of this (H, Hkv, D, cache) layout
    needs; raises as `decode_plan` does."""
    return decode_plan(1, _TS, h, hkv, d, fp_dtype)


def _operand(t: torch.Tensor, dev: int) -> torch.Tensor:
    """`t` on CUDA device `dev`, contiguous (no copy when it already is)."""
    if t.get_device() != dev:
        raise ValueError("decode_attn operands must share one device")
    return t if t.is_contiguous() else t.contiguous()


def _launch(q: torch.Tensor, cache, pos: torch.Tensor, *, window: int,
            ring: int, plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """One K2 or K3 launch. `plan` None is the served call; a plan made
    for this call with another split or buffer count (measurement,
    `dataclasses.replace`) forces it. The host cost is a few attribute
    reads, one memoized plan lookup and the output's allocation: no
    copy or cast of an operand that already is contiguous f32 (q),
    int32 (pos, the block table) on the card."""
    b, _, h, d = q.shape
    packed = "k_data" in cache
    paged = "block_table" in cache
    kd = cache["k_data"] if packed else cache["k"]
    vd = cache["v_data"] if packed else cache["v"]
    hkv = kd.shape[2]
    if paged:
        bt = cache["block_table"]
        n, ps, n_pool = bt.shape[1], kd.shape[1], kd.shape[0]
        s_len = ring if ring else n * ps
        if bt.shape[0] != b or s_len > n * ps:
            raise ValueError(f"paged decode_attn: block table "
                             f"{tuple(bt.shape)} for batch {b}, ring {ring} "
                             f"over {n} pages of {ps}")
    else:
        s_len = kd.shape[1]
    want = decode_plan(b, s_len, h, hkv, d, None if packed else kd.dtype)
    if plan is None:
        plan = want
    elif (plan.b, plan.s, plan.g, plan.hkv, plan.d, plan.kind) != \
            (want.b, want.s, want.g, want.hkv, want.d, want.kind):
        raise ValueError(f"decode_attn: {plan} was made for another call "
                         f"than {want}")
    if not packed and vd.dtype != kd.dtype:
        raise TypeError(f"decode_attn kernel: k cache {kd.dtype}, v cache "
                        f"{vd.dtype}")
    dev = q.get_device()
    qf = q if q.dtype == torch.float32 else q.to(torch.float32)
    ks = cache["k_scl"] if packed else kd
    vs = cache["v_scl"] if packed else vd
    ops = [_operand(t, dev) for t in (qf, kd, vd, ks, vs)]
    if pos.dtype != torch.int32 or pos.get_device() != dev:
        pos = pos.to(device=q.device, dtype=torch.int32)
    pos = _operand(pos, dev)
    out = torch.empty((b, 1, h, d), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attn", _SIGNATURE)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if paged:
        if bt.dtype != torch.int32 or bt.get_device() != dev:
            bt = bt.to(device=q.device, dtype=torch.int32)
        bt = _operand(bt, dev)
        err = lib.paged_decode_attn_launch(
            *(t.data_ptr() for t in ops), pos.data_ptr(), bt.data_ptr(),
            out.data_ptr(), b, s_len, hkv, plan.g, d, n, ps, n_pool,
            plan.kind, _qscale(d), int(window), int(ring), plan.split,
            plan.nbuf, plan.smem, stream)
        _build.check(err, "paged_decode_attn")
        counted = fused_paged_decode_attention
    else:
        err = lib.decode_attn_launch(
            *(t.data_ptr() for t in ops), pos.data_ptr(), out.data_ptr(),
            b, s_len, hkv, plan.g, d, plan.kind, _qscale(d), int(window),
            int(ring), plan.split, plan.nbuf, plan.smem, stream)
        _build.check(err, "decode_attn")
        counted = fused_decode_attention
    counted.launches += 1
    counted.cache_launches[CACHE_DTYPES[plan.kind]] += 1
    return out if q.dtype == torch.float32 else out.to(q.dtype)


def _run(q: torch.Tensor, cache, pos: torch.Tensor, window: int,
         ring: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache, pos, window=window,
                                      ring=ring)
    if q.device.type == "meta":
        return decode_attention_shape(q)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu, cuda or meta, not "
                         f"{q.device}")
    return _launch(q, cache, pos, window=window, ring=ring)


def fused_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                           window: int = 0, ring: int = 0) -> torch.Tensor:
    """Single-token attention over a KV cache, one kernel launch on CUDA
    (K2 for a slab cache; a paged cache goes to
    `fused_paged_decode_attention`); CPU tensors take
    `decode_attention_plain`, "meta" ones `decode_attention_shape`."""
    if "block_table" in cache:
        return fused_paged_decode_attention(q, cache, pos, window=window,
                                            ring=ring)
    return _run(q, cache, pos, window, ring)


def fused_paged_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor,
                                 *, window: int = 0,
                                 ring: int = 0) -> torch.Tensor:
    """Single-token attention over a paged cache: one K3 launch on CUDA,
    reading K/V through the block table; CPU tensors take
    `decode_attention_plain`, "meta" ones `decode_attention_shape`."""
    if "block_table" not in cache:
        raise ValueError("fused_paged_decode_attention needs a paged cache "
                         "(a block_table leaf)")
    return _run(q, cache, pos, window, ring)


fused_decode_attention.launches = 0          # K2 launches
fused_paged_decode_attention.launches = 0    # K3 launches
fused_decode_attention.cache_launches = dict.fromkeys(CACHE_DTYPES, 0)
fused_paged_decode_attention.cache_launches = dict.fromkeys(CACHE_DTYPES, 0)
