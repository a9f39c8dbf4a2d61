"""K4: fused cache-write prefill over a paged (optionally OVP-packed) KV
cache — hand-written CUDA kernel + plain version, and the dense twin.

Replaces the TPU kernel `repro/kernels/prefill_attn.py:170`
(`_prefill_call`, bodies `_prefill_kernel_packed` :142 and
`_prefill_kernel_fp` :155) and its wrapper `fused_prefill_attention`
:213. The paged engine hands one request's chunk to the kernel: q (1, C,
H, D) chunk queries, the request's raw K/V stage {"stage_k", "stage_v"}
(1, S, Hkv, D) f32 with the chunk already appended, its single-row
"block_table" (1, n >= S / page_size) and the shared page pools. One
launch both
  - quantizes every stage tile with `layers._quant_kv_token`'s arithmetic
    and writes it onto its physical page (fp caches copy the raw tile),
    in place — pages outside the table keep their bytes; and
  - attends the chunk causally over the RAW stage (query c at absolute
    position positions[0, 0] + c), so chunked prefill equals one-shot
    prefill and adds no quantization noise the slab path lacks.
The kernel source is `csrc/prefill_attn.cu`.

`fused_prefill_attention` takes `prefill_attention_plain` for CPU
tensors and launches the kernel for CUDA tensors (or raises);
`fused_prefill_attention.launches` counts kernel launches.
`prefill_plan` is the launch's layout check and geometry (query rows a
block, row tiles, the key split over a thread-block cluster, shared
bytes), pure so that it is testable without a card. The kernel takes
any G, D % 8 == 0 up to 256, and fp pools in f32, bf16 or fp16.
`xla_prefill_attention` is the port of the reference's dense twin (what
the `eager` backend serves): masked-einsum attention over the raw stage,
whole-stage quantize, page scatter.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from . import _build
from .decode_attn import FP_KINDS, NEG_INF, SMEM_MAX, _qscale

STAGE_KEYS = ("stage_k", "stage_v")


def is_paged_prefill(cache) -> bool:
    return cache is not None and "block_table" in cache \
        and "stage_k" in cache


def prefill_decline_reason(q: torch.Tensor, cache) -> Optional[str]:
    """None when the fused prefill kernel serves this (q, cache) layout;
    the codes are `backends.base.DECLINE_CODES` entries, in the
    reference's order (the fused path exists for PAGED caches only)."""
    if cache is None or "block_table" not in cache:
        return "prefill_not_paged"
    if "stage_k" not in cache or "stage_v" not in cache:
        return "prefill_no_stage"
    if q.shape[0] != 1:
        return "prefill_batch_gt_1"
    pool = cache.get("k", cache.get("k_data"))
    if pool is None:
        return "paged_no_pool"
    ps = pool.shape[1]
    if ps < 2 or ps % 2:
        return "paged_page_misaligned"
    s = cache["stage_k"].shape[1]
    if s % ps or cache["block_table"].shape[1] < s // ps:
        return "prefill_stage_misaligned"
    if "k" in cache and cache["k"].shape[-1] % 2:
        return "decode_head_dim_odd"
    return None


def _pool_keys(cache):
    return ("k_data", "v_data", "k_scl", "v_scl") if "k_data" in cache \
        else ("k", "v")


def _write_pages(cache, vals) -> None:
    """Scatter whole stage tiles onto the first S / ps pages of the
    single-row block table, in place. `vals` maps pool keys to
    (1, S, …) tensors."""
    pool0 = cache[_pool_keys(cache)[0]]
    ps = pool0.shape[1]
    n_tiles = next(iter(vals.values())).shape[1] // ps
    pages = cache["block_table"][0, :n_tiles].to(torch.int64)
    for key, val in vals.items():
        pool = cache[key]
        pool[pages] = val.reshape((n_tiles, ps) + val.shape[2:]).to(
            pool.dtype)


def _stage_values(cache):
    """{pool key: (1, S, …) values} the stage writes onto its pages."""
    from repro_torch.models.layers import _quant_kv_token
    stage_k, stage_v = cache["stage_k"], cache["stage_v"]
    if "k_data" in cache:
        kd, ks = _quant_kv_token(stage_k)
        vd, vs = _quant_kv_token(stage_v)
        return {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    return {"k": stage_k, "v": stage_v}


# --------------------------------------------------------------------------
# Dense twin (the eager backend's path)
# --------------------------------------------------------------------------
def xla_prefill_attention(q: torch.Tensor, cache,
                          positions: torch.Tensor):
    """Masked-einsum attention over the raw stage + whole-stage quantize
    + page scatter, as the reference's dense twin. Returns (out, cache);
    the pools are written in place."""
    b, c, h, d = q.shape
    stage_k, stage_v = cache["stage_k"], cache["stage_v"]
    s, hkv = stage_k.shape[1], stage_k.shape[2]
    g = h // hkv
    f32 = torch.float32
    k, v = stage_k.to(f32), stage_v.to(f32)
    qg = q.reshape(b, c, hkv, g, d).to(f32) / math.sqrt(d)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg, k)
    valid = torch.arange(s, device=q.device)[None, None, :] \
        <= positions[:, :, None]
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p_att = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p_att, v)
    _write_pages(cache, _stage_values(cache))
    return out.reshape(b, c, h, d).to(q.dtype), cache


# --------------------------------------------------------------------------
# Plain version (the kernel's arithmetic, densely)
# --------------------------------------------------------------------------
def prefill_attention_plain(q: torch.Tensor, cache,
                            positions: torch.Tensor):
    """The kernel's function in torch ops: quantize-and-write (or copy)
    every stage tile onto its page, in place; scores of the pre-scaled
    queries over the raw stage, causal on qpos = positions[0, 0] + row
    with the -1e30 floor, softmax, PV / max(l, 1e-30)."""
    b, c, h, d = q.shape
    stage_k, stage_v = cache["stage_k"], cache["stage_v"]
    s, hkv = stage_k.shape[1], stage_k.shape[2]
    g = h // hkv
    f32 = torch.float32
    _write_pages(cache, _stage_values(cache))
    qf = q.reshape(c, hkv, g, d).to(f32).permute(1, 2, 0, 3) / _qscale(d)
    k = stage_k[0].to(f32).permute(1, 2, 0)                  # (Hkv, D, S)
    v = stage_v[0].to(f32).permute(1, 0, 2)                  # (Hkv, S, D)
    sc = torch.matmul(qf, k[:, None])                        # (Hkv,G,C,S)
    qpos = positions[0, :1].to(torch.int64) \
        + torch.arange(c, device=q.device)
    kpos = torch.arange(s, device=q.device)
    sc = torch.where(kpos[None, :] <= qpos[:, None], sc, NEG_INF)
    m = torch.clamp(sc.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(sc - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v[:, None]) / torch.clamp(l_sum, min=1e-30)
    return o.permute(2, 0, 1, 3).reshape(b, c, h, d).to(q.dtype), cache


def prefill_attention_shape(q: torch.Tensor, cache):
    """The plain version's result for a "meta" q: ((1, C, H, D) in q's
    dtype on "meta", the cache as it is), no arithmetic and no write."""
    return torch.empty(q.shape, dtype=q.dtype, device="meta"), cache


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------
_SIGNATURE = {"prefill_attn_launch": [ctypes.c_void_p] * 10
              + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 7
              + [ctypes.c_void_p]}
_TK = 32              # keys per attention tile
_DMAX = 256           # float4 column groups a lane owns: at most 8
_MIN_BLOCKS = 132     # one wave: an H100 has 132 SMs


@dataclasses.dataclass(frozen=True)
class PrefillPlan:
    """One K4 launch (csrc/prefill_attn.cu's header says why): blocks of
    `warps` warps hold 4·warps query rows (row r = c·G + g of one kv
    head); a kv head's C·G rows take `n_rt` row tiles; the keys of a row
    tile split over a cluster of `split` blocks, rank j walking key tiles
    [j·tpr, (j+1)·tpr) of 32 keys (`nbuf` buffers); then the write
    blocks, one per (page tile, kv head), rounded up to whole clusters.
    `kind` is the pool layout (0 packed, else `FP_KINDS`)."""
    c: int
    g: int
    hkv: int
    d: int
    s: int
    ps: int
    kind: int
    warps: int
    n_rt: int
    split: int
    tpr: int
    nbuf: int
    smem: int

    @property
    def rows(self) -> int:
        return 4 * self.warps

    @property
    def n_attn(self) -> int:
        return self.hkv * self.n_rt * self.split

    @property
    def n_write(self) -> int:
        return -(-self.hkv * (self.s // self.ps) // self.split) * self.split

    def attention_block(self, x: int):
        """Attention block x's (kv head, query rows, key tiles as the
        rank's full share, before its causal limit)."""
        pair, rank = divmod(x, self.split)
        h, rt = divmod(pair, self.n_rt)
        r0 = rt * self.rows
        return (h, range(r0, min(r0 + self.rows, self.c * self.g)),
                range(rank * self.tpr, (rank + 1) * self.tpr))


def _smem(rows: int, d: int, nbuf: int, split: int) -> int:
    """An attention block's dynamic shared bytes (the C side's
    `smem_bytes`)."""
    return 4 * (rows * d + nbuf * _TK * (d + 4) + nbuf * _TK * d
                + rows * (_TK + 1) + 2 * rows + rows * (split + 1))


@functools.lru_cache(maxsize=None)
def prefill_plan(c: int, h: int, hkv: int, d: int, s: int, ps: int,
                 fp_dtype: Optional[torch.dtype] = None) -> PrefillPlan:
    """The K4 launch of a C-query chunk of H heads over Hkv kv heads of
    dim D against an S-token stage of pages of ps rows, for packed pools
    (`fp_dtype` None) or fp pools of `fp_dtype` (pure, memoized); raises
    ValueError / TypeError on what the kernel cannot take. Rows a block:
    4 per warp, up to 8 warps; the key split: the smallest power of two
    (up to 8, and no more than the stage's key tiles) that puts one wave
    of attention blocks on the card."""
    g = h // hkv if hkv > 0 else 0
    if hkv < 1 or g * hkv != h or d < 8 or d % 8 or d > _DMAX or c < 1 \
            or ps < 1 or s < ps or s % ps:
        raise ValueError(f"prefill_attn kernel needs H % Hkv == 0, D % 8 == "
                         f"0, D <= {_DMAX} and a stage of whole pages; got "
                         f"C={c} H={h} Hkv={hkv} D={d} S={s} page size {ps}")
    if fp_dtype is not None and fp_dtype not in FP_KINDS:
        raise TypeError(f"prefill_attn kernel takes fp pools in "
                        f"{sorted(map(str, FP_KINDS))}, got {fp_dtype}")
    rows = c * g
    warps = min(8, -(-rows // 4))
    n_rt = -(-rows // (4 * warps))
    tiles = -(-s // _TK)
    split = 1
    while split < 8 and 2 * split <= tiles \
            and hkv * n_rt * split < _MIN_BLOCKS:
        split *= 2
    tpr = -(-tiles // split)
    nbuf = 2 if tpr > 1 else 1
    smem = _smem(4 * warps, d, nbuf, split)
    if smem > SMEM_MAX:
        raise ValueError(f"prefill_attn kernel: D={d} needs {smem} bytes of "
                         f"shared memory, over {SMEM_MAX}")
    kind = 0 if fp_dtype is None else FP_KINDS[fp_dtype]
    return PrefillPlan(c, g, hkv, d, s, ps, kind, warps, n_rt, split, tpr,
                       nbuf, smem)


def _launch(q: torch.Tensor, cache, positions: torch.Tensor,
            halves: int = 3):
    """One K4 launch. `halves` 3 is the served call; 1 runs the attention
    blocks alone and 2 the page-write blocks alone (measurement)."""
    b, c, h, d = q.shape
    packed = "k_data" in cache
    keys = _pool_keys(cache)
    pools = [cache[key] for key in keys]
    stage_k, stage_v = cache["stage_k"], cache["stage_v"]
    s, hkv = stage_k.shape[1], stage_k.shape[2]
    n_pool, ps = pools[0].shape[:2]
    if b != 1:
        raise ValueError(f"prefill_attn kernel needs batch 1; got q "
                         f"{tuple(q.shape)}")
    plan = prefill_plan(c, h, hkv, d, s, ps,
                        None if packed else pools[0].dtype)
    if not packed and pools[1].dtype != pools[0].dtype:
        raise TypeError(f"prefill_attn kernel: k pool {pools[0].dtype}, v "
                        f"pool {pools[1].dtype}")
    if any(not p.is_contiguous() for p in pools):
        raise ValueError("prefill_attn writes the pools in place; they must "
                         "be contiguous")
    bt = cache["block_table"][0].to(device=q.device,
                                    dtype=torch.int32).contiguous()
    if bt.shape[0] < s // ps:
        raise ValueError(f"prefill_attn: block table backs {bt.shape[0]} "
                         f"pages, the stage needs {s // ps}")
    ops = [t.to(torch.float32).contiguous() for t in (q, stage_k, stage_v)]
    if any(t.device != q.device for t in ops + pools):
        raise ValueError("prefill_attn operands must share one device")
    pos32 = positions[0].to(device=q.device, dtype=torch.int32).contiguous()
    ks, vs = (pools[2], pools[3]) if packed else (pools[0], pools[1])
    out = torch.empty((1, c, h, d), dtype=torch.float32, device=q.device)
    lib = _build.load("prefill_attn", _SIGNATURE)
    err = lib.prefill_attn_launch(
        *(t.data_ptr() for t in ops), pos32.data_ptr(), bt.data_ptr(),
        pools[0].data_ptr(), pools[1].data_ptr(), ks.data_ptr(),
        vs.data_ptr(), out.data_ptr(), c, s, hkv, plan.g, d, ps, n_pool,
        plan.kind, _qscale(d), plan.warps, plan.n_rt, plan.split, plan.tpr,
        plan.nbuf, plan.smem, halves,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "prefill_attn")
    fused_prefill_attention.launches += 1
    return out.to(q.dtype), cache


def fused_prefill_attention(q: torch.Tensor, cache,
                            positions: torch.Tensor) -> Tuple[torch.Tensor,
                                                              dict]:
    """Causal attention of one chunk over the raw stage + quantize-and-
    write of every stage tile onto its page: one kernel launch on CUDA;
    CPU tensors take `prefill_attention_plain`, "meta" ones
    `prefill_attention_shape` (no write). Returns (out (1, C, H, D),
    cache) with the pool leaves written in place."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, cache, positions)
    if q.device.type == "meta":
        return prefill_attention_shape(q, cache)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attn runs on cpu, cuda or meta, not "
                         f"{q.device}")
    return _launch(q, cache, positions)


fused_prefill_attention.launches = 0
