"""Decoder building blocks. Port of the dense and MoE subset of
`repro/models/layers.py`: RMSNorm, RoPE, causal prefill attention, slab
and paged KV caches (fp32 and OVP-packed), decode attention and paged
cache-write prefill through the backend registry, the attention layer,
SwiGLU, and the top-k token-choice MoE layer with capacity-based
dispatch, whose expert einsums go through the registry (K6 on the card).

Params are plain dicts of tensors. Unlike the reference, cache writes
update the cache tensors in place (the engine's caches are large and
written every step); `attention_forward` returns the same cache dict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional

import torch

from repro_torch import backends
from repro_torch.core import qlinear
from repro_torch.core.ovp import (MixedExpertQuant, QuantizedTensor,
                                  ovp_encode_codes, pack4)
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import prefill_attn

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


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, T, Hkv, D) -> (B, T, H, D): the reference's
    online-softmax attention (`_flash_fwd_impl`) in blocks of
    `ATTN_CHUNK` queries x `ATTN_CHUNK` keys: scores scaled after the
    dot, -1e30 mask, each key block folded in by m' = max(m, max s),
    l' = l·exp(m - m') + Σ exp(s - m'), acc' = acc·exp(m - m') + p·v,
    and acc / max(l, 1e-30). A query block's first key block starts the
    running state (the reference's update from m = -1e30, l = acc = 0
    gives the same values), so a prompt of at most `ATTN_CHUNK` tokens is
    one block. Key blocks past a query block's diagonal hold no valid key
    and are skipped (the reference's update leaves its state unchanged
    there). Scores stay (B, Hkv, G, chunk, chunk) at any prompt length."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, t, hkv, g, d).to(f32).permute(0, 2, 3, 1, 4)
    kt = k.to(f32).permute(0, 2, 3, 1)[:, :, None]          # (B,Hkv,1,D,T)
    vt = v.to(f32).permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,1,T,D)
    pos = torch.arange(t, device=q.device)
    chunk = ATTN_CHUNK
    outs = []
    for q0 in range(0, t, chunk):
        qpos = pos[q0:q0 + chunk]
        for k0 in range(0, q0 + len(qpos), chunk):
            kpos = pos[k0:k0 + chunk]
            s = torch.matmul(qg[..., q0:q0 + chunk, :],
                             kt[..., k0:k0 + chunk]) * (1.0 / math.sqrt(d))
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            if k0 == 0:
                m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
                p = torch.exp(s - m)
                l_sum = p.sum(dim=-1, keepdim=True)
                acc = torch.matmul(p, vt[..., k0:k0 + chunk, :])
                continue
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l_sum = l_sum * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.matmul(p, vt[..., k0:k0 + chunk, :])
            m = m_new
        outs.append(acc / torch.clamp(l_sum, min=1e-30))    # (B,Hkv,G,qc,D)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def make_kv_cache(batch: int, length: int, n_kv: int, head_dim: int, *,
                  kv_bits: int = 0, dtype=torch.float32, device="cuda"):
    """Slab KV cache dict: fp ({"k", "v"}) or OVP-packed int4
    ({"k_data", "v_data"} nibbles + {"k_scl", "v_scl"} scales)."""
    if kv_bits == 4:
        if head_dim % 2:
            raise ValueError(f"OVP-packed KV cache needs an even head_dim; "
                             f"got {head_dim}")
        shape = (batch, length, n_kv, head_dim // 2)
        return {"k_data": torch.zeros(shape, dtype=torch.uint8,
                                      device=device),
                "v_data": torch.zeros(shape, dtype=torch.uint8,
                                      device=device),
                "k_scl": torch.ones(shape[:3], device=device),
                "v_scl": torch.ones(shape[:3], device=device)}
    shape = (batch, length, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def cache_write(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor, policy: Optional[QuantPolicy] = None):
    """Write T tokens per row at positions pos[b] + t, in place; rows past
    the cache length drop (the reference's mode="drop"; a paged cache
    routes them to its sink page). `policy`, the cache site's resolved
    policy, picks the backend that packs a quantized cache's K and V
    (None: the torch ops)."""
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
    length = cache[next(iter(new))].shape[1]
    pos = pos.to(torch.int64)
    if t == 1:
        # one token per row: every target is distinct, so a dropped row
        # rewrites its clamped slot with the old value — no host sync
        idx = torch.clamp(pos, max=length - 1)
        bidx = torch.arange(b, device=pos.device)
        keep = pos < length
        for key, val in new.items():
            old = cache[key][bidx, idx]
            mask = keep.reshape((b,) + (1,) * (old.ndim - 1))
            cache[key][bidx, idx] = torch.where(mask, val[:, 0], old)
        return cache
    # several tokens a row (a prefill): cache row j of row b takes token
    # j - pos[b] where that lies in [0, T) and keeps its value elsewhere.
    # A gather and a select need no host sync (a boolean-mask index sizes
    # its result on the host, which a CUDA graph capture refuses).
    off = torch.arange(length, device=pos.device)[None] - pos[:, None]
    keep = (off >= 0) & (off < t)                           # (B, L)
    src = torch.clamp(off, 0, t - 1)
    for key, val in new.items():
        tail = (1,) * (val.ndim - 2)
        got = torch.gather(val, 1, src.reshape(b, length, *tail)
                           .expand(b, length, *val.shape[2:]))
        leaf = cache[key][:b]
        leaf.copy_(torch.where(keep.reshape(b, length, *tail), got, leaf))
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
                     policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """Single-token attention over a slab or paged cache through the
    registry; `policy` is the resolved policy of the cache site
    (`<block>/attn/kv`) and its backend picks the kernel or the dense
    path."""
    return backends.decode_attention(q, cache, pos, policy=policy)


def attention_forward(p, x: torch.Tensor, positions: torch.Tensor, cfg,
                      policy: QuantPolicy, *, cache=None,
                      mode: str = "prefill", site: str = "attn"):
    """Self-attention in "prefill" (causal over the prompt at `positions`,
    cache written from positions[:, 0]) or "decode" (one token at
    positions[:, 0]) mode. A paged cache that carries a request's raw
    "stage_k"/"stage_v" takes the paged prefill path: the chunk's K/V is
    appended to the stage at its positions, then one registry dispatch
    attends the chunk over the stage and writes every stage tile onto its
    pages. Returns (out, cache)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qlinear.linear(x, p["wq"], p.get("bq"), *rps(policy, site, "wq"))
    k = qlinear.linear(x, p["wk"], p.get("bk"), *rps(policy, site, "wk"))
    v = qlinear.linear(x, p["wv"], p.get("bv"), *rps(policy, site, "wv"))
    q = rope(q.reshape(b, t, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, t, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, nkv, hd)
    kv_policy = rp(policy, site, "kv")
    if mode == "decode":
        cache = cache_write(cache, k, v, positions[:, 0], kv_policy)
        out = decode_attention(q, cache, positions[:, 0], policy=kv_policy)
    elif mode == "prefill" and prefill_attn.is_paged_prefill(cache):
        rows = positions[0].to(torch.int64)
        cache["stage_k"][0].index_copy_(0, rows,
                                        k[0].to(cache["stage_k"].dtype))
        cache["stage_v"][0].index_copy_(0, rows,
                                        v[0].to(cache["stage_v"].dtype))
        out, cache = backends.prefill_attention(q, cache, positions,
                                                policy=kv_policy)
    elif mode == "prefill":
        out = causal_attention(q, k, v)
        if cache is not None:
            cache = cache_write(cache, k, v, positions[:, 0], kv_policy)
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
    return torch.matmul(xg.to(cdt), w.to(cdt))
