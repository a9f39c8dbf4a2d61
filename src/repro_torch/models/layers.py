"""Model building blocks. Port of `repro/models/layers.py` (all but
`layer_norm`, which no block of the reference's models calls): RMSNorm,
RoPE, causal, sliding-window and non-causal (cross) prefill attention
(full attention with the reference's FlashAttention-2 backward under
autograd, `flash_attention`),
slab and paged KV caches (fp32 and OVP-packed; a local-attention cache
of `window` slots is a ring; a cross-attention cache records the rows
its encoder wrote in "src_len"), decode attention and paged cache-write
prefill through the backend registry, the attention layer (self and
cross), SwiGLU and the GELU MLP, the top-k token-choice MoE layer with
capacity-based
dispatch, whose expert einsums go through the registry (K6 on the card),
the Griffin recurrent block (the width-4 causal conv and the RG-LRU),
and the xLSTM blocks: the mLSTM (matrix memory; chunkwise-parallel
prefill, per-token decode) and the sLSTM (scalar memory with
block-diagonal recurrent weights).

Params are plain dicts of tensors. Unlike the reference, cache writes
and recurrent-state updates write the cache tensors in place (the
engine's caches are large, written every step and read by captured
steps); `attention_forward` and the recurrent forwards return the same
cache dict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import torch

from repro_torch import backends
from repro_torch.backends import sharded
from repro_torch.core import qlinear
from repro_torch.core.ovp import (MixedExpertQuant, QuantizedTensor,
                                  ovp_encode_codes, pack4)
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import prefill_attn
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import axes

NEG_INF = -1e30


def rps(policy: QuantPolicy, site: str, leaf: str = ""):
    """(resolved policy, full site address) for one weight site."""
    full = f"{site}/{leaf}" if (site and leaf) else (site or leaf)
    return policy.resolve(full), full


def rp(policy: QuantPolicy, site: str, leaf: str = "") -> QuantPolicy:
    return rps(policy, site, leaf)[0]


def rms_norm(x: torch.Tensor, p, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["gamma_scale"].to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: (B, T, H, D), positions: (B, T) absolute positions."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


ATTN_CHUNK = 512        # the reference's q_chunk = kv_chunk


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int = 0, causal: bool = True) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, S, Hkv, D) -> (B, T, H, D): the reference's
    online-softmax attention (`_flash_fwd_impl`) in blocks of
    `ATTN_CHUNK` queries x `ATTN_CHUNK` keys: scores scaled after the
    dot, -1e30 mask, each key block folded in by m' = max(m, max s),
    l' = l·exp(m - m') + Σ exp(s - m'), acc' = acc·exp(m - m') + p·v,
    and acc / max(l, 1e-30). A query block's first key block starts the
    running state (the reference's update from m = -1e30, l = acc = 0
    gives the same values), so a prompt of at most `ATTN_CHUNK` tokens is
    one block. Key blocks past a query block's diagonal hold no valid key
    and are skipped (the reference's update leaves its state unchanged
    there). Scores stay (B, Hkv, G, chunk, chunk) at any prompt length.

    `causal=False` (cross attention: S may differ from T) lets every
    query see every key; the reference pads the last key block to
    `ATTN_CHUNK` and masks the pad (`kp < s_len`), the port slices it
    short, which gives the same sums.

    `window` > 0 is sliding-window attention (the reference's
    `local_blockwise_attention`): query p sees keys (p - window, p].
    Key blocks wholly below every window of a query block are skipped
    too; a query row with no key in its block's first key block starts
    from garbage that the first block holding one of its keys scales to
    0 (exp(-1e30 - m) = 0), as the reference's online update does.

    When autograd records through q, k or v (training), full (window 0)
    attention runs as `flash_attention`, whose backward is the
    reference's FlashAttention-2 VJP; windowed attention differentiates
    through these torch ops, as the reference's does through its own."""
    if not window and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return flash_attention(q, k, v, causal=causal)
    return _online_softmax(q, k, v, window=window, causal=causal)


def _online_softmax(q, k, v, *, window: int = 0, causal: bool = True,
                    q_offset: int = 0, q_chunk: Optional[int] = None,
                    kv_chunk: Optional[int] = None, with_lse: bool = False):
    """`causal_attention`'s blocks at any chunk sizes (None:
    `ATTN_CHUNK`), with the queries at absolute positions q_offset..
    (the keys at 0..S-1). `with_lse`
    also returns the per-row log-sum-exp m + log l (B, Hkv, G, T, 1)
    f32, +inf on a row with no valid key (the backward's p is then
    0)."""
    q_chunk, kv_chunk = q_chunk or ATTN_CHUNK, kv_chunk or ATTN_CHUNK
    b, t, h, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, t, hkv, g, d).to(f32).permute(0, 2, 3, 1, 4)
    kt = k.to(f32).permute(0, 2, 3, 1)[:, :, None]          # (B,Hkv,1,D,S)
    vt = v.to(f32).permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,1,S,D)
    pos = torch.arange(max(t + q_offset, s_len), device=q.device)
    outs, lses = [], []
    for q0 in mesh_lib.loop(range(0, t, q_chunk), q):
        qpos = pos[q_offset + q0:q_offset + min(q0 + q_chunk, t)]
        lo = max(0, q_offset + q0 - window + 1) // kv_chunk * kv_chunk \
            if window else 0
        hi = min(q_offset + q0 + len(qpos), s_len) if causal else s_len
        for k0 in mesh_lib.loop(range(lo, hi, kv_chunk), q):
            s = torch.matmul(qg[..., q0:q0 + q_chunk, :],
                             kt[..., k0:k0 + kv_chunk]) \
                * (1.0 / math.sqrt(d))
            if causal:
                kpos = pos[k0:k0 + kv_chunk]
                valid = qpos[:, None] >= kpos[None, :]
                if window:
                    valid = valid & (kpos[None, :] > qpos[:, None] - window)
                s = torch.where(valid, s, NEG_INF)
            if k0 == lo:
                m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
                p = torch.exp(s - m)
                l_sum = p.sum(dim=-1, keepdim=True)
                acc = torch.matmul(p, vt[..., k0:k0 + kv_chunk, :])
                continue
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, vt[..., k0:k0 + kv_chunk, :])
            m = m_new
        outs.append(acc / torch.clamp(l_sum, min=1e-30))    # (B,Hkv,G,qc,D)
        if with_lse:
            lses.append(torch.where(
                l_sum > 0, m + torch.log(torch.clamp(l_sum, min=1e-30)),
                torch.inf))
    if sum(o.shape[-2] for o in outs) < t:
        # traced once on "meta" (`mesh_lib.loop`): every row's shape
        outs = [outs[0].new_empty(outs[0].shape[:-2] + (t, d))]
        lses = [x.new_empty(x.shape[:-2] + (t, 1)) for x in lses[:1]]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)
    if not with_lse:
        return out
    return out, lses[0] if len(lses) == 1 else torch.cat(lses, dim=-2)


def _flash_bwd(q, k, v, out, lse, do, causal: bool, q_offset: int,
               q_chunk: int, kv_chunk: int):
    """The reference's FlashAttention-2 backward (`_flash_bwd`): for each
    (query chunk, key chunk) pair the probabilities are recomputed from
    q, k and the saved log-sum-exp, p = exp(s - lse), so no (T, S) score
    tensor is ever held; with dp = dO·vᵀ and delta = rowsum(dO ∘ O),
    ds = p (dp - delta) / sqrt(D), dq += ds k, dk += dsᵀ q (summed over
    the G query heads of a kv head), dv += pᵀ dO. Key chunks past a
    query chunk's diagonal (all masked) are skipped. f32 throughout;
    the gradients come back in the inputs' dtypes."""
    b, t, h, d = q.shape
    s_len, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32 = torch.float32
    scale = 1.0 / math.sqrt(d)

    def heads(x):                                           # (B,Hkv,G,T,D)
        return x.reshape(b, t, hkv, g, d).to(f32).permute(0, 2, 3, 1, 4)

    qg, dog = heads(q), heads(do)
    delta = (dog * heads(out)).sum(dim=-1, keepdim=True)    # (B,Hkv,G,T,1)
    kf = k.to(f32).permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,1,S,D)
    vf = v.to(f32).permute(0, 2, 1, 3)[:, :, None]
    dq = torch.zeros_like(qg)
    dk = torch.zeros((b, hkv, s_len, d), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    pos = torch.arange(max(t + q_offset, s_len), device=q.device)
    for q0 in mesh_lib.loop(range(0, t, q_chunk), q):
        rows = slice(q0, min(q0 + q_chunk, t))
        qb, dob = qg[..., rows, :], dog[..., rows, :]
        lse_i, delta_i = lse[..., rows, :], delta[..., rows, :]
        qpos = pos[q_offset + rows.start:q_offset + rows.stop]
        hi = min(q_offset + rows.stop, s_len) if causal else s_len
        for k0 in mesh_lib.loop(range(0, hi, kv_chunk), q):
            cols = slice(k0, min(k0 + kv_chunk, s_len))
            kb, vb = kf[..., cols, :], vf[..., cols, :]
            p = torch.exp(torch.matmul(qb, kb.transpose(-1, -2)) * scale
                          - lse_i)
            if causal:
                valid = qpos[:, None] >= pos[cols][None, :]
                p = torch.where(valid, p, 0.0)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta_i) * scale
            dq[..., rows, :] += torch.matmul(ds, kb)
            dk[:, :, cols] += torch.matmul(ds.transpose(-1, -2), qb).sum(2)
            dv[:, :, cols] += torch.matmul(p.transpose(-1, -2), dob).sum(2)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Forward: `_online_softmax`, saving q, k, v, the output and the
    log-sum-exp (O(T·D) tensors); backward: `_flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, q_chunk, kv_chunk):
        out, lse = _online_softmax(q, k, v, causal=causal, q_offset=q_offset,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    q_chunk: Optional[int] = None,
                    kv_chunk: Optional[int] = None) -> torch.Tensor:
    """The reference's `blockwise_attention`: q (B, T, H, D), k/v (B, S,
    Hkv, D) -> (B, T, H, D), queries at positions q_offset.. (causal:
    query p sees keys <= p), with the FlashAttention-2 backward, so
    memory stays O(T·D + q_chunk·kv_chunk) in both directions (chunks
    of `ATTN_CHUNK` unless given)."""
    return _FlashAttention.apply(q, k, v, causal, int(q_offset),
                                 q_chunk or ATTN_CHUNK,
                                 kv_chunk or ATTN_CHUNK)


def make_kv_cache(batch: int, length: int, n_kv: int, head_dim: int, *,
                  kv_bits: int = 0, dtype=torch.float32, device="cuda",
                  track_len: bool = False):
    """Slab KV cache dict: fp ({"k", "v"}) or OVP-packed int4
    ({"k_data", "v_data"} nibbles + {"k_scl", "v_scl"} scales).
    `track_len` adds a per-row int32 "src_len" leaf, the rows that hold
    data (a cross-attention cache: the encoder output can be shorter
    than the cache, and its zero tail must get no softmax mass)."""
    if kv_bits == 4:
        if head_dim % 2:
            raise ValueError(f"OVP-packed KV cache needs an even head_dim; "
                             f"got {head_dim}")
        shape = (batch, length, n_kv, head_dim // 2)
        cache = {"k_data": torch.zeros(shape, dtype=torch.uint8,
                                       device=device),
                 "v_data": torch.zeros(shape, dtype=torch.uint8,
                                       device=device),
                 "k_scl": torch.ones(shape[:3], device=device),
                 "v_scl": torch.ones(shape[:3], device=device)}
    else:
        shape = (batch, length, n_kv, head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    if track_len:
        cache["src_len"] = torch.zeros((batch,), dtype=torch.int32,
                                       device=device)
    return cache


def make_paged_kv_cache(n_pages: int, page_size: int, batch_slots: int,
                        pages_per_row: int, n_kv: int, head_dim: int, *,
                        kv_bits: int = 0, dtype=torch.float32,
                        device="cuda"):
    """PAGED KV cache dict for one cache site: a pool of
    `(n_pages + 1, page_size, Hkv, …)` fixed-size pages plus a per-slot
    "block_table" `(batch_slots, pages_per_row)` int32 mapping logical
    page j of a slot to its physical page id (`serve/paging.py` owns the
    ids of pages 0..n_pages-1; unset entries default to page 0, harmless
    because every read masks by position).

    The extra last page is a SINK that no request owns: a write to a row
    past a slot's table capacity lands there instead of being dropped
    (the reference's scatter mode="drop"), so parked slots, whose table
    rows are all page 0, never overwrite a live request's page-0 rows,
    and no host sync is needed to filter them."""
    if page_size < 2 or page_size % 2:
        raise ValueError(
            f"page_size must be an even int >= 2 (OVP packs value pairs "
            f"2-per-byte along head_dim); got {page_size}")
    cache = make_kv_cache(n_pages + 1, page_size, n_kv, head_dim,
                          kv_bits=kv_bits, dtype=dtype, device=device)
    cache["block_table"] = torch.zeros((batch_slots, pages_per_row),
                                       dtype=torch.int32, device=device)
    return cache


def _kv_scale(xf: torch.Tensor) -> torch.Tensor:
    """(B, T, Hkv, D) f32 -> per-(token, head) 3σ scales (B, T, Hkv)
    (population std, as the reference)."""
    mu = xf.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((xf - mu) ** 2).mean(dim=-1))
    return torch.clamp(3.0 * std / 7.0, min=1e-6)


def _quant_kv_token(x: torch.Tensor):
    """x (B, T, Hkv, D) -> packed nibbles + per-(token, head) 3σ scales,
    in torch ops."""
    xf = x.to(torch.float32)
    s = _kv_scale(xf)
    codes = ovp_encode_codes(xf / s[..., None], "int4", pair_axis=-1)
    return pack4(codes, pair_axis=-1), s


def _quant_kv(x: torch.Tensor, policy: Optional[QuantPolicy]):
    """`_quant_kv_token`'s bytes and scales, the encode on the cache
    site's backend: `cuda` launches K7 once at the per-row scale."""
    s = _kv_scale(x.to(torch.float32))
    return backends.encode_kv(x, s, policy=policy), s


def cache_len(cache) -> int:
    """Slots a cache row holds (a paged cache: its table's logical
    capacity)."""
    if cache is None:
        return 0
    leaf = cache["k"] if "k" in cache else cache["k_data"]
    if "block_table" in cache:
        return cache["block_table"].shape[1] * leaf.shape[1]
    part = sharded.seq_part(cache)
    return leaf.shape[1] if part is None else part[2]


def cache_write(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor, policy: Optional[QuantPolicy] = None,
                ring: int = 0):
    """Write T tokens per row at positions pos[b] + t, in place; rows past
    the cache length drop (the reference's mode="drop"; a paged cache
    routes them to its sink page). `ring` > 0 wraps the slots modulo the
    ring size (a slab cache of `ring` slots, local attention): token t
    lands in slot (pos[b] + t) % ring, and of a write longer than the
    ring only its last `ring` tokens stay (a scatter's later writes
    win). `policy`, the cache site's resolved policy, picks the backend
    that packs a quantized cache's K and V (None: the torch ops). Leaves
    other than K/V (a cross cache's "src_len") are left as they are. A
    cache holding a part of its slots on a mesh (`sharded.seq_part`)
    writes only the slots it owns, through the same masked writes."""
    if ring and k_new.shape[1] > ring:
        drop = k_new.shape[1] - ring
        k_new, v_new, pos = k_new[:, drop:], v_new[:, drop:], pos + drop
    if "k" in cache:
        new = {"k": k_new.to(cache["k"].dtype),
               "v": v_new.to(cache["v"].dtype)}
    else:
        kd, ks = _quant_kv(k_new, policy)
        vd, vs = _quant_kv(v_new, policy)
        new = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    if "block_table" in cache:
        _paged_cache_write(cache, new, pos.to(torch.int64))
        return cache
    b, t = k_new.shape[:2]
    # a cache holding a part of its slots (a sequence split on a mesh)
    # writes only the slots it owns: slot j of its `count` is global
    # slot first + j of `length`
    part = sharded.seq_part(cache)
    count = cache[next(iter(new))].shape[1]
    first, length = (0, count) if part is None else (part[0], part[2])
    pos = pos.to(torch.int64)
    if t == 1:
        # one token per row: every target is distinct, so a dropped row
        # rewrites its clamped slot with the old value — no host sync
        if ring:
            pos = torch.remainder(pos, ring)
        keep = (pos < length) & (pos >= first) & (pos < first + count)
        idx = torch.clamp(pos - first, min=0, max=count - 1)
        bidx = torch.arange(b, device=pos.device)
        for key, val in new.items():
            old = cache[key][bidx, idx]
            mask = keep.reshape((b,) + (1,) * (old.ndim - 1))
            cache[key][bidx, idx] = torch.where(mask, val[:, 0], old)
        return cache
    # several tokens a row (a prefill): cache row j of row b takes token
    # j - pos[b] (mod the ring) where that lies in [0, T) and keeps its
    # value elsewhere. A gather and a select need no host sync (a
    # boolean-mask index sizes its result on the host, which a CUDA
    # graph capture refuses).
    off = torch.arange(first, first + count, device=pos.device)[None] \
        - pos[:, None]
    if ring:
        off = torch.remainder(off, ring)
    keep = (off >= 0) & (off < t)                           # (B, count)
    src = torch.clamp(off, 0, t - 1)
    for key, val in new.items():
        tail = (1,) * (val.ndim - 2)
        got = torch.gather(val, 1, src.reshape(b, count, *tail)
                           .expand(b, count, *val.shape[2:]))
        leaf = cache[key][:b]
        leaf.copy_(torch.where(keep.reshape(b, count, *tail), got, leaf))
    return cache


def _paged_cache_write(cache, new, pos: torch.Tensor) -> None:
    """Scatter token rows through the block table, in place: logical row
    idx = pos[b] + t of slot b lands in pool page block_table[b, idx //
    ps] at page row idx % ps. Rows outside [0, pages_per_row * ps) go to
    the sink page (the pool's last), which nothing reads, so the live
    targets are all distinct and no index_put ordering matters."""
    bt = cache["block_table"]                               # (B, n)
    pool = cache[next(iter(new))]
    ps, n, sink = pool.shape[1], bt.shape[1], pool.shape[0] - 1
    t = next(iter(new.values())).shape[1]
    idx = pos[:, None] + torch.arange(t, device=pos.device)  # (B, T)
    page = torch.gather(bt.to(torch.int64), 1,
                        torch.clamp(idx // ps, 0, n - 1))
    page = torch.where((idx >= 0) & (idx < n * ps), page, sink)
    row = torch.remainder(idx, ps)
    for key, val in new.items():
        cache[key][page, row] = val


def decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                     window: int = 0, ring: int = 0,
                     policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """Single-token attention over a slab or paged cache through the
    registry; `policy` is the resolved policy of the cache site
    (`<block>/attn/kv`) and its backend picks the kernel or the dense
    path. `window` masks keys at or below pos - window; `ring` is the
    slot count of a ring cache, whose slots' absolute positions are
    reconstructed from pos."""
    return backends.decode_attention(q, cache, pos, policy=policy,
                                     window=window, ring=ring)


def attention_forward(p, x: torch.Tensor, positions: torch.Tensor, cfg,
                      policy: QuantPolicy, *, window: int = 0, cache=None,
                      mode: str = "prefill", site: str = "attn"):
    """Self-attention in "prefill" (causal over the prompt at `positions`,
    cache written from positions[:, 0]; with no cache, an encoder's
    pass) or "decode" (one token at positions[:, 0]) mode. `window` > 0
    is local attention: each query sees the last `window` positions, and
    a cache of exactly `window` slots is a ring (a prefill writes only
    its last min(window, T) tokens). A paged cache that carries a
    request's raw "stage_k"/"stage_v" takes the paged prefill path: the
    chunk's K/V is appended to the stage at its positions, then one
    registry dispatch attends the chunk over the stage and writes every
    stage tile onto its pages. Under a mesh a cache may hold only this
    rank's KV heads, or only its slots (`backends/sharded.py`): q, k and
    v are computed whole, the cache writes and the stage take the heads
    the cache holds (a slot part writes only its own slots), and the
    attention call gets the whole q and returns every head. Returns
    (out, cache)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qlinear.linear(x, p["wq"], p.get("bq"), *rps(policy, site, "wq"))
    k = qlinear.linear(x, p["wk"], p.get("bk"), *rps(policy, site, "wk"))
    v = qlinear.linear(x, p["wv"], p.get("bv"), *rps(policy, site, "wv"))
    q = rope(q.reshape(b, t, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, t, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, nkv, hd)
    kv_policy = rp(policy, site, "kv")
    ring = window if window and cache_len(cache) == window else 0
    kc, vc = sharded.cache_rows(k, cache), sharded.cache_rows(v, cache)
    if mode == "decode":
        cache = cache_write(cache, kc, vc, positions[:, 0], kv_policy,
                            ring=ring)
        out = decode_attention(q, cache, positions[:, 0], window=window,
                               ring=ring, policy=kv_policy)
    elif mode == "prefill" and prefill_attn.is_paged_prefill(cache):
        rows = positions[0].to(torch.int64)
        cache["stage_k"][0].index_copy_(0, rows,
                                        kc[0].to(cache["stage_k"].dtype))
        cache["stage_v"][0].index_copy_(0, rows,
                                        vc[0].to(cache["stage_v"].dtype))
        out, cache = backends.prefill_attention(q, cache, positions,
                                                policy=kv_policy)
    elif mode == "prefill":
        out = causal_attention(q, k, v, window=window)
        if ring:
            keep = min(window, t)
            cache = cache_write(cache, kc[:, -keep:], vc[:, -keep:],
                                positions[:, -keep], kv_policy, ring=ring)
        elif cache is not None:
            cache = cache_write(cache, kc, vc, positions[:, 0], kv_policy)
    else:
        raise ValueError(f"mode {mode!r}: the port runs prefill and decode")
    out = qlinear.linear(out.reshape(b, t, nh * hd), p["wo"], None,
                         *rps(policy, site, "wo"))
    return out, cache


def cross_attention(p, x: torch.Tensor, enc_out: Optional[torch.Tensor],
                    cfg, policy: QuantPolicy, *, cache=None,
                    mode: str = "prefill", site: str = "xattn"):
    """The reference's cross-attention branches of `attention_forward`
    (`kv_x` given, `use_rope=False`, the decoder's `causal=False`):
    queries from x (B, T, d), no RoPE. "prefill": keys and values
    projected from the encoder output `enc_out` (B, S, d), every query
    attending every key, and with a cache, K/V written once at slot 0
    and its "src_len" set to min(S, cache length) for every row.
    "decode": only `wq` and `wo` run (`enc_out` is not read); the one
    query attends the cache (a `track_len` one) through the decode
    attention of the site `<site>/kv` at pos = src_len - 1, so the
    unwritten tail of a longer cache gets no softmax mass. Returns (out,
    cache)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qlinear.linear(x, p["wq"], p.get("bq"), *rps(policy, site, "wq"))
    q = q.reshape(b, t, nh, hd)
    kv_policy = rp(policy, site, "kv")
    if mode == "decode":
        out = decode_attention(q, cache, cache["src_len"] - 1,
                               policy=kv_policy)
    elif mode == "prefill":
        s_len = enc_out.shape[1]
        k = qlinear.linear(enc_out, p["wk"], p.get("bk"),
                           *rps(policy, site, "wk")).reshape(b, s_len, nkv,
                                                             hd)
        v = qlinear.linear(enc_out, p["wv"], p.get("bv"),
                           *rps(policy, site, "wv")).reshape(b, s_len, nkv,
                                                             hd)
        out = causal_attention(q, k, v, causal=False)
        if cache is not None:
            cache = cache_write(cache, sharded.cache_rows(k, cache),
                                sharded.cache_rows(v, cache), torch.zeros(
                (b,), dtype=torch.int64, device=x.device), kv_policy)
            if "src_len" in cache:
                cache["src_len"].fill_(min(s_len, cache_len(cache)))
    else:
        raise ValueError(f"mode {mode!r}: the port runs prefill and decode")
    out = qlinear.linear(out.reshape(b, t, nh * hd), p["wo"], None,
                         *rps(policy, site, "wo"))
    return out, cache


def swiglu(p, x: torch.Tensor, policy: QuantPolicy,
           site: str = "mlp") -> torch.Tensor:
    g = qlinear.linear(x, p["wg"], None, *rps(policy, site, "wg"))
    u = qlinear.linear(x, p["wu"], None, *rps(policy, site, "wu"))
    return qlinear.linear(torch.nn.functional.silu(g) * u, p["wd"], None,
                          *rps(policy, site, "wd"))


def gelu_mlp(p, x: torch.Tensor, policy: QuantPolicy,
             site: str = "mlp") -> torch.Tensor:
    """wi + bi, GELU (`jax.nn.gelu`'s default, the tanh approximation),
    then wd + bd."""
    h = qlinear.linear(x, p["wi"], p["bi"], *rps(policy, site, "wi"))
    return qlinear.linear(torch.nn.functional.gelu(h, approximate="tanh"),
                          p["wd"], p["bd"], *rps(policy, site, "wd"))


# --------------------------------------------------------------------------
# Mixture of experts (capacity-based sort dispatch, per batch row)
# --------------------------------------------------------------------------
_ROUTES: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def recording_routes():
    """Collect the routed expert indices (B, T, k) of every `moe_layer`
    call inside the block, in call order: a card-vs-CPU check compares
    routing first, so that a near-tie that picks another expert reads
    as what it is. The list is appended on the host, so only eager
    forward calls record: a replay of a captured engine step
    (`serve/capture.py`) appends nothing."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def moe_params(gen: torch.Generator, d_model: int, d_ff: int,
               n_experts: int, device) -> dict:
    """Router (d, E) and stacked experts wg, wu (E, d, F), wd (E, F, d),
    drawn in the reference's order and scales (normal / sqrt(fan_in))."""
    s = 1.0 / math.sqrt(d_model)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    return {"router": {"w_gate": normal((d_model, n_experts), s)},
            "experts": {"wg": normal((n_experts, d_model, d_ff), s),
                        "wu": normal((n_experts, d_model, d_ff), s),
                        "wd": normal((n_experts, d_ff, d_model),
                                     1.0 / math.sqrt(d_ff))}}


def route(p, x: torch.Tensor, cfg):
    """f32 router: softmax probabilities (B, T, E) and the top-k weights
    and expert indices (B, T, k), renormalised when `cfg.norm_topk`.
    Equal probabilities keep the lower expert first, as
    `jax.lax.top_k` does (a stable descending sort; `torch.topk` breaks
    ties in no fixed order)."""
    logits = x.to(torch.float32) @ p["router"]["w_gate"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :cfg.top_k], topi[..., :cfg.top_k]
    if cfg.norm_topk:
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    return probs, topw, topi


def _means_over_batch_ranks(me: torch.Tensor, ce: torch.Tensor):
    """The router's mean probability and load (E,) over every row of the
    batch, when a mesh (`axes.axis_rules`) splits the batch over ranks
    of equal row counts: the mean of the ranks' means, summed in rank
    order. aux = E * sum(me * ce) / k is not linear in the rows, so each
    rank's local means alone would give another loss. The value is the
    whole batch's; the gradient reaches this rank's `me` as 1 / n of
    the whole mean's (`ce` has none), so the ranks' gradients, summed
    over the batch axes as the sharded step sums them, are one
    device's."""
    cur = axes.current()
    split = () if cur is None else axes.batch_split(cur[1], cur[0])
    if not split:
        return me, ce
    mesh = cur[0]
    both = torch.stack([me.detach(), ce])
    n = 1
    for a in split:
        both = mesh_lib.rank_sum(both, mesh, a)
        n *= mesh.size(a)
    both = both / n
    return me / n + (both[0] - me.detach() / n), both[1]


def moe_layer(p, x: torch.Tensor, cfg, policy: QuantPolicy,
              capacity_factor: Optional[float] = None, site: str = "moe"):
    """Top-k token-choice MoE with the reference's semantics. Returns
    (y, aux): aux is the Switch load-balance loss (E · Σ me·ce / k).

    Dispatch is per batch row: each row's T·k assignments are sorted by
    expert with a STABLE sort (the rank of a token inside its expert
    decides which tokens exceed the capacity cap = max(int(cf·T·k/E), 4)
    and are dropped to the residual stream; `jnp.argsort` is stable too),
    kept assignments fill slot e·cap + rank of a (B, E, cap, d) tensor and
    dropped ones go to the scratch slot E·cap, so the filled slots of
    (b, e) are ranks 0..fill[b, e]-1 with fill = min(counts, cap). The
    expert einsums get that fill: the reference computes every slot, K6
    only the filled ones, and leaves the others unwritten (nothing reads
    them: the wd input's empty rows go unread, and the combine reads kept
    slots and the zero scratch row only). The combine gathers each token's
    kept slots and sums their weighted outputs in ascending expert order:
    deterministic (no atomics), and the order of the reference's
    sequential slot scatter-add."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    probs, topw, topi = route(p, x, cfg)
    if _ROUTES is not None:
        _ROUTES.append(topi)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(topi, e).to(torch.float32) \
        .sum(dim=2).mean(dim=(0, 1))
    me, ce = _means_over_batch_ranks(me, ce)
    aux = e * torch.sum(me * ce) / k

    cap = max(int(cf * t * k / e), 4)
    dev = x.device
    flat_e = topi.reshape(b, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    counts = torch.zeros((b, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(t * k, device=dev)[None] - torch.gather(starts, 1,
                                                                se)
    dest_sorted = torch.where(rank < cap, se * cap + rank, e * cap)
    dest = torch.empty_like(dest_sorted).scatter_(1, order, dest_sorted)
    # slots: token j // k of assignment j; only the scratch slot E·cap
    # can take several writes, and it is never read
    tok = torch.arange(t, device=dev).repeat_interleave(k)
    slots = x.new_zeros((b, e * cap + 1, d))
    slots.scatter_(1, dest[..., None].expand(b, t * k, d), x[:, tok])
    xg = slots[:, :e * cap].reshape(b, e, cap, d)

    fill = torch.clamp(counts, max=cap).to(torch.int32)   # (B, E)
    ew = p["experts"]
    h = _expert_ein(xg, ew["wg"], rp(policy, site, "experts/wg"), fill)
    u = _expert_ein(xg, ew["wu"], rp(policy, site, "experts/wu"), fill)
    yg = _expert_ein(torch.nn.functional.silu(h) * u, ew["wd"],
                     rp(policy, site, "experts/wd"), fill)  # (B, E, cap, d)

    yflat = torch.cat([yg.reshape(b, e * cap, d),
                       yg.new_zeros((b, 1, d))], dim=1)   # scratch reads 0
    keep = (dest < e * cap).reshape(b, t, k)
    w = (topw * keep).to(yg.dtype)
    by_expert = torch.argsort(topi, dim=-1)               # k distinct ids
    dest_e = torch.gather(dest.reshape(b, t, k), 2, by_expert)
    w_e = torch.gather(w, 2, by_expert)
    picked = torch.gather(
        yflat, 1, dest_e.reshape(b, t * k)[..., None].expand(b, t * k, d))
    picked = picked.reshape(b, t, k, d) * w_e[..., None]
    y = torch.zeros((b, t, d), dtype=yg.dtype, device=dev)
    for j in range(k):
        y = y + picked[:, :, j]
    return y.to(x.dtype), aux


def _expert_ein(xg: torch.Tensor, w, policy: QuantPolicy,
                fill: Optional[torch.Tensor] = None):
    """(B, E, C, K) x (E, K, F) -> (B, E, C, F). Quantized stacks go
    through the registry (the grouped kernel K6 on the `cuda` backend; a
    `MixedExpertQuant` group by group), weight-only: the reference forces
    `abits=0` here, since dispatched slots are capacity-padded and a 3σ
    activation scale would see the padding. `fill` (B, E): rows past it
    may come back unwritten; a raw stack computes them all."""
    if isinstance(w, (QuantizedTensor, MixedExpertQuant)):
        return backends.dispatch(xg, w, dataclasses.replace(policy, abits=0),
                                 fill=fill)
    cdt = backends.base.torch_dtype(policy.compute_dtype)
    if getattr(w, "placed", None) is not None:
        return sharded.raw_matmul(xg, w, cdt)
    return torch.matmul(xg.to(cdt), w.to(cdt))


# --------------------------------------------------------------------------
# Causal depthwise conv and the RG-LRU (Griffin / RecurrentGemma)
# --------------------------------------------------------------------------
CONV_WIDTH = 4          # the Griffin block's causal conv


def conv1d_params(gen: torch.Generator, d: int, device) -> dict:
    """Depthwise causal conv: kernel (CONV_WIDTH, d) ~ N(0, 1/width),
    zero bias."""
    return {"conv_kernel": torch.randn((CONV_WIDTH, d), generator=gen,
                                       device=device)
            / math.sqrt(CONV_WIDTH),
            "conv_bias": torch.zeros(d, device=device)}


def conv1d_causal(p, x: torch.Tensor, state: Optional[torch.Tensor] = None):
    """x (B, T, D); state (B, W-1, D), the trailing inputs of the calls
    before (None: zeros). y_t = sum_i k_i * x_{t-W+1+i} + bias, summed in
    the reference's order. Returns (y, the new state: the last W-1
    inputs, old state included)."""
    w = p["conv_kernel"].shape[0]
    t = x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, w - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = xp[:, 0:t] * p["conv_kernel"][0]
    for i in range(1, w):
        y = y + xp[:, i:i + t] * p["conv_kernel"][i]
    return y + p["conv_bias"], (xp[:, -(w - 1):] if w > 1 else None)


def _weight(gen: torch.Generator, k: int, n: int, device,
            scale: Optional[float] = None) -> torch.Tensor:
    """A (k, n) weight ~ N(0, scale²), scale 1/sqrt(k) unless given (the
    reference's `_init`)."""
    x = torch.randn((k, n), generator=gen, device=device)
    return x / math.sqrt(k) if scale is None else x * scale


def rglru_params(gen: torch.Generator, d_model: int, d_rnn: int,
                 device) -> dict:
    """The recurrent block's weights in the reference's order and scales
    (normal / sqrt(fan_in); the gate decay a_param = 2, so
    sigmoid(2)^8 is about 0.31)."""
    def w(k, n):
        return _weight(gen, k, n, device)

    return {"wx": w(d_model, d_rnn), "wgate": w(d_model, d_rnn),
            "wo": w(d_rnn, d_model),
            "conv": conv1d_params(gen, d_rnn, device),
            "w_inp_gate": w(d_rnn, d_rnn), "w_rec_gate": w(d_rnn, d_rnn),
            "a_param": torch.full((d_rnn,), 2.0, device=device)}


def rglru_init_state(batch: int, d_rnn: int, device="cuda") -> dict:
    """The recurrent cache of one site: h (B, d_rnn) and the conv's
    trailing inputs (B, CONV_WIDTH - 1, d_rnn), f32 zeros."""
    return {"h": torch.zeros((batch, d_rnn), device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, d_rnn),
                                device=device)}


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t (from h = 0) along
    dim 1, by `jax.lax.associative_scan`'s recursion: combine adjacent
    pairs, scan those, then fix up the even positions; about log2(T)
    levels of elementwise ops, in the reference's order of operations.
    Returns (the products of a, the scanned b)."""
    t = a.shape[1]
    if t < 2:
        return a, b
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = _linear_scan(a1 * a2, a2 * b1 + b2)
    if t % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    a3, b3 = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * a3], dim=1)
    even_b = torch.cat([b[:, :1], a3 * pb + b3], dim=1)
    out_a, out_b = a.new_empty(a.shape), b.new_empty(b.shape)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def _rglru_core(p, u: torch.Tensor, h0: torch.Tensor, policy: QuantPolicy,
                site: str = "rec") -> torch.Tensor:
    """u (B, T, Dr) inputs, h0 (B, Dr) -> h (B, T, Dr) f32: the gated
    diagonal recurrence h_t = a_t * h_{t-1} + b_t with
    a_t = exp(-8 softplus(a_param) r_t) and
    b_t = sqrt(max(1 - a_t^2, 1e-12)) * i_t * u_t."""
    f32 = torch.float32
    rt = torch.sigmoid(qlinear.linear(u, p["w_rec_gate"], None,
                                      *rps(policy, site, "w_rec_gate"))
                       .to(f32))
    it = torch.sigmoid(qlinear.linear(u, p["w_inp_gate"], None,
                                      *rps(policy, site, "w_inp_gate"))
                       .to(f32))
    a_param = p["a_param"].to(f32)
    softplus = torch.logaddexp(a_param, torch.zeros_like(a_param))
    log_a = -8.0 * softplus * rt                            # log a_t <= 0
    a = torch.exp(log_a)
    gated = it * u.to(f32)
    b_t = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                 min=1e-12)) * gated
    a_scan, b_scan = _linear_scan(a, b_t)
    return a_scan * h0[:, None, :] + b_scan


def rglru_forward(p, x: torch.Tensor, policy: QuantPolicy, *,
                  state=None, site: str = "rec"):
    """The Griffin recurrent block: y = wo(h * gelu(wgate x)) with h the
    RG-LRU over conv(wx x). `state` = {"h": (B, Dr), "conv": (B, 3, Dr)}
    carries a prefill into decode steps (a decode step is T = 1: h =
    a h0 + b); the new h and conv inputs are copied into its tensors in
    place (a captured step reads and writes the same buffers). The gelu
    is the tanh approximation, `jax.nn.gelu`'s default. Returns (y,
    state)."""
    b = x.shape[0]
    gate = torch.nn.functional.gelu(
        qlinear.linear(x, p["wgate"], None, *rps(policy, site, "wgate")),
        approximate="tanh")
    u = qlinear.linear(x, p["wx"], None, *rps(policy, site, "wx"))
    u, new_conv = conv1d_causal(p["conv"], u,
                                None if state is None else state["conv"])
    h0 = state["h"] if state is not None else torch.zeros(
        (b, u.shape[-1]), dtype=torch.float32, device=x.device)
    h = _rglru_core(p, u, h0, policy, site=site)
    y = qlinear.linear(h.to(x.dtype) * gate, p["wo"], None,
                       *rps(policy, site, "wo"))
    if state is not None:
        state["h"].copy_(h[:, -1])
        state["conv"].copy_(new_conv)
    return y, state


# --------------------------------------------------------------------------
# xLSTM: the mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# --------------------------------------------------------------------------
def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_sigmoid`: -softplus(-x), softplus = logaddexp(x, 0)."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


def mlstm_params(gen: torch.Generator, d_model: int, n_heads: int,
                 device) -> dict:
    """The mLSTM block's weights in the reference's order and scales
    (inner width 2 d_model; normal / sqrt(fan_in), the gate projections
    normal * 0.01; forget-gate bias 3, input-gate bias 0)."""
    d_inner = 2 * d_model

    def w(k, n, scale=None):
        return _weight(gen, k, n, device, scale)

    return {"w_up": w(d_model, 2 * d_inner),
            "conv": conv1d_params(gen, d_inner, device),
            "wq": w(d_inner, d_inner), "wk": w(d_inner, d_inner),
            "wv": w(d_inner, d_inner),
            "w_igate": w(d_inner, n_heads, 0.01),
            "w_fgate": w(d_inner, n_heads, 0.01),
            "fgate_bias": torch.full((n_heads,), 3.0, device=device),
            "igate_bias": torch.zeros(n_heads, device=device),
            "w_down": w(d_inner, d_model),
            "outnorm": {"gamma_scale": torch.ones(d_inner, device=device)}}


def mlstm_init_state(batch: int, d_model: int, n_heads: int,
                     device="cuda") -> dict:
    """One mLSTM site's state, f32 zeros: the matrix memory c (B, H, Dh,
    Dh), indexed (value, key), its normalizer n (B, H, Dh) and
    stabilizer m (B, H), Dh = 2 d_model / H; and the conv's trailing
    inputs (B, CONV_WIDTH - 1, 2 d_model)."""
    d_inner = 2 * d_model
    dh = d_inner // n_heads

    def z(*shape):
        return torch.zeros(shape, device=device)

    return {"mem": {"c": z(batch, n_heads, dh, dh), "n": z(batch, n_heads, dh),
                    "m": z(batch, n_heads)},
            "conv": z(batch, CONV_WIDTH - 1, d_inner)}


def _mlstm_core(q, k, v, i_pre, f_pre, state):
    """The per-token mLSTM recurrence. q, k, v (B, T, H, Dh); gate
    pre-activations (B, T, H), f_pre already a log-sigmoid; state {c,
    n, m}. Returns (h (B, T, H, Dh) f32, the new state)."""
    f32 = torch.float32
    kscale = 1.0 / math.sqrt(q.shape[-1])
    c, n, m = state["c"], state["n"], state["m"]
    hs = []
    for s in mesh_lib.loop(range(q.shape[1]), q):
        qt, vt = q[:, s].to(f32), v[:, s].to(f32)
        kt = k[:, s].to(f32) * kscale
        it, ft = i_pre[:, s], f_pre[:, s]
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_[..., None, None] * c \
            + i_[..., None, None] * (vt[..., :, None] * kt[..., None, :])
        n = f_[..., None] * n + i_[..., None] * kt
        num = torch.matmul(c, qt[..., None])[..., 0]
        den = torch.abs((n * qt).sum(dim=-1))
        hs.append(num / torch.maximum(den, torch.exp(-m_new))[..., None])
        m = m_new
    hs = mesh_lib.rest(hs, q.shape[1])
    h = hs[0][:, None] if len(hs) == 1 else torch.stack(hs, dim=1)
    return h, {"c": c, "n": n, "m": m}


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, state, chunk: int = 64):
    """The chunkwise-parallel mLSTM (the xLSTM paper's formulation), the
    same function as `_mlstm_core` with the state updated once a chunk
    of L = min(chunk, T) tokens: intra-chunk terms are (L x L) products.
    With a = cumsum(log f) and w = i - a over a chunk, u = cummax(w) and
    M = max(m_prev, u), every exponent is <= 0: intra weights exp(w_s -
    M_t), the carried state's exp(m_prev - M_t); position t's
    stabilizer is a_t + M_t. A ragged last chunk is padded with f = 0
    (decay 1) and i = NEG_INF (no contribution)."""
    f32 = torch.float32
    b, t, h, dh = q.shape
    kscale = 1.0 / math.sqrt(dh)
    L = min(chunk, t)
    nc = -(-t // L)
    pad = nc * L - t

    def pad_t(x, value=0.0):
        if not pad:
            return x
        return torch.cat([x, x.new_full((b, pad) + x.shape[2:], value)],
                         dim=1)

    qg, kg, vg = (pad_t(x).reshape(b, nc, L, h, dh) for x in (q, k, v))
    ig = pad_t(i_pre, NEG_INF).reshape(b, nc, L, h)
    fg = pad_t(f_pre).reshape(b, nc, L, h)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    c, n, m = state["c"], state["n"], state["m"]
    hs = []
    for j in mesh_lib.loop(range(nc), q):
        qc, vc = qg[:, j].to(f32), vg[:, j].to(f32)
        kc = kg[:, j].to(f32) * kscale
        a = torch.cumsum(fg[:, j], dim=1)                   # (B, L, H)
        w = ig[:, j] - a
        M = torch.maximum(m[:, None], torch.cummax(w, dim=1).values)
        inter = torch.exp(m[:, None] - M)
        # D[t, s] = exp(w_s - M_t), s <= t
        D = torch.where(causal, torch.exp(w[:, None] - M[:, :, None]), 0.0)
        S = torch.einsum("bthd,bshd->btsh", qc, kc) * D
        num = torch.einsum("btsh,bshd->bthd", S, vc) \
            + inter[..., None] * torch.einsum("bhde,bthe->bthd", c, qc)
        den = S.sum(dim=2) + inter * torch.einsum("bthd,bhd->bth", qc, n)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-(a + M)))[..., None])
        # the end-of-chunk state
        a_l, m_l = a[:, -1], M[:, -1]                       # (B, H)
        coef = torch.exp(w - m_l[:, None])                  # (B, L, H)
        decay = torch.exp(m - m_l)
        c = decay[..., None, None] * c \
            + torch.einsum("blhd,blhe->bhde", coef[..., None] * vc, kc)
        n = decay[..., None] * n + torch.einsum("blh,blhd->bhd", coef, kc)
        m = a_l + m_l
    hs = mesh_lib.rest(hs, nc)
    hout = hs[0] if nc == 1 else torch.cat(hs, dim=1)
    return hout[:, :t], {"c": c, "n": n, "m": m}


def mlstm_forward(p, x: torch.Tensor, cfg, policy: QuantPolicy, *,
                  state=None, site: str = "mlstm"):
    """The mLSTM block: up-projection to (xm, z); q, k and the gates from
    conv(silu(xm)), v from xm; the matrix-memory recurrence over 2
    d_model / H wide heads (chunkwise for a prompt of T > 1 tokens when
    `cfg.mlstm_chunk` > 1, per token otherwise), RMSNorm, the z gate
    and the down-projection. `state` = {"mem": {c, n, m}, "conv"}
    carries a prefill into decode steps; the new state is copied into
    its tensors in place. Returns (y, state)."""
    b, t, _ = x.shape
    nh = cfg.n_heads
    f32 = torch.float32
    silu = torch.nn.functional.silu
    up = qlinear.linear(x, p["w_up"], None, *rps(policy, site, "w_up"))
    xm, z = torch.chunk(up, 2, dim=-1)
    xc, new_conv = conv1d_causal(p["conv"], silu(xm),
                                 None if state is None else state["conv"])
    d_inner = xm.shape[-1]
    dh = d_inner // nh
    q = qlinear.linear(xc, p["wq"], None, *rps(policy, site, "wq"))
    k = qlinear.linear(xc, p["wk"], None, *rps(policy, site, "wk"))
    v = qlinear.linear(xm, p["wv"], None, *rps(policy, site, "wv"))
    q, k, v = (y.reshape(b, t, nh, dh) for y in (q, k, v))
    xf = xc.to(f32)
    i_pre = xf @ sharded.whole(p["w_igate"]).to(f32) + p["igate_bias"]
    f_pre = _log_sigmoid(xf @ sharded.whole(p["w_fgate"]).to(f32)
                         + p["fgate_bias"])
    st = state["mem"] if state is not None else \
        mlstm_init_state(b, d_inner // 2, nh, device=x.device)["mem"]
    if t > 1 and cfg.mlstm_chunk > 1:
        hout, new_mem = _mlstm_chunkwise(q, k, v, i_pre, f_pre, st,
                                         chunk=cfg.mlstm_chunk)
    else:
        hout, new_mem = _mlstm_core(q, k, v, i_pre, f_pre, st)
    hout = rms_norm(hout.reshape(b, t, d_inner).to(x.dtype), p["outnorm"])
    y = qlinear.linear(hout * silu(z), p["w_down"], None,
                       *rps(policy, site, "w_down"))
    if state is not None:
        for key, val in new_mem.items():
            state["mem"][key].copy_(val)
        state["conv"].copy_(new_conv)
    return y, state


def slstm_params(gen: torch.Generator, d_model: int, n_heads: int,
                 device) -> dict:
    """The sLSTM block's weights in the reference's order and scales:
    input projections (the gates' normal * 0.01), block-diagonal
    recurrent weights (H, Dh, Dh), forget-gate bias 3, and the
    post-projection MLP of width int(4 d / 3) rounded down to even."""
    dh = d_model // n_heads
    ff = int(4 * d_model / 3) // 2 * 2

    def w(k, n, scale=None):
        return _weight(gen, k, n, device, scale)

    def r(scale):
        return torch.randn((n_heads, dh, dh), generator=gen,
                           device=device) * scale

    return {"wz": w(d_model, d_model), "wi_gate": w(d_model, d_model, 0.01),
            "wf_gate": w(d_model, d_model, 0.01),
            "wo_gate": w(d_model, d_model, 0.01),
            "r_z": r(1.0 / math.sqrt(dh)), "r_i": r(0.01), "r_f": r(0.01),
            "fgate_bias": torch.full((d_model,), 3.0, device=device),
            "mlp": {"wu2": w(d_model, ff), "wd2": w(ff, d_model)}}


def slstm_init_state(batch: int, d_model: int, device="cuda") -> dict:
    """One sLSTM site's state (B, d) each, f32: c, m and h zeros, the
    normalizer n ones."""
    def z():
        return torch.zeros((batch, d_model), device=device)

    return {"mem": {"c": z(), "n": torch.ones((batch, d_model),
                                              device=device),
                    "m": z(), "h": z()}}


def _slstm_core(p, zi, ii, fi, oi, n_heads: int, state):
    """The sLSTM recurrence, a loop over T: h feeds back through the
    block-diagonal r_z, r_i, r_f (one batched product a step, the three
    concatenated). zi, ii, fi, oi (B, T, d) input-side pre-activations
    (fi with its bias). Returns (h (B, T, d) f32, the new state)."""
    f32 = torch.float32
    b, t, d = zi.shape
    dh = d // n_heads
    rcat = torch.cat([p[key].to(f32) for key in ("r_z", "r_i", "r_f")],
                     dim=-1)                                # (H, Dh, 3Dh)
    # (B, T, H, 3, Dh): the z, i and f inputs of each head side by side
    pre = torch.stack([zi, ii, fi], dim=2).to(f32) \
        .reshape(b, t, 3, n_heads, dh).transpose(2, 3)
    og = torch.sigmoid(oi.to(f32)).reshape(b, t, n_heads, dh)
    c, n, m, h = (state[key].reshape(b, n_heads, dh)
                  for key in ("c", "n", "m", "h"))
    hs = []
    for s in mesh_lib.loop(range(t), zi):
        rec = torch.matmul(h.transpose(0, 1), rcat).transpose(0, 1)
        g = pre[:, s] + rec.reshape(b, n_heads, 3, dh)
        ipre = g[:, :, 1]
        lf = _log_sigmoid(g[:, :, 2])
        m_new = torch.maximum(lf + m, ipre)
        i_ = torch.exp(ipre - m_new)
        f_ = torch.exp(lf + m - m_new)
        c = f_ * c + i_ * torch.tanh(g[:, :, 0])
        n = f_ * n + i_
        h = og[:, s] * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    hs = mesh_lib.rest(hs, t)
    hout = hs[0][:, None] if t == 1 else torch.stack(hs, dim=1)
    return hout.reshape(b, t, d), {key: val.reshape(b, d) for key, val in
                                   (("c", c), ("n", n), ("m", m), ("h", h))}


def slstm_forward(p, x: torch.Tensor, cfg, policy: QuantPolicy, *,
                  state=None, site: str = "slstm"):
    """The sLSTM block: four input projections, the scalar-memory
    recurrence (`_slstm_core`), then the post-projection MLP wd2(gelu(wu2
    h)), gelu in its tanh form (`jax.nn.gelu`'s default). `state` =
    {"mem": {c, n, m, h}} carries a prefill into decode steps; the new
    state is copied into its tensors in place. Returns (y, state)."""
    b, _, d = x.shape
    zi = qlinear.linear(x, p["wz"], None, *rps(policy, site, "wz"))
    ii = qlinear.linear(x, p["wi_gate"], None, *rps(policy, site, "wi_gate"))
    fi = qlinear.linear(x, p["wf_gate"], None,
                        *rps(policy, site, "wf_gate")) + p["fgate_bias"]
    oi = qlinear.linear(x, p["wo_gate"], None, *rps(policy, site, "wo_gate"))
    st = state["mem"] if state is not None else \
        slstm_init_state(b, d, device=x.device)["mem"]
    hs, new_mem = _slstm_core(p, zi, ii, fi, oi, cfg.n_heads, st)
    u = torch.nn.functional.gelu(
        qlinear.linear(hs.to(x.dtype), p["mlp"]["wu2"], None,
                       *rps(policy, site, "mlp/wu2")), approximate="tanh")
    y = qlinear.linear(u, p["mlp"]["wd2"], None,
                       *rps(policy, site, "mlp/wd2"))
    if state is not None:
        for key, val in new_mem.items():
            state["mem"][key].copy_(val)
    return y, state
