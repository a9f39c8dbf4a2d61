"""Dense decoder building blocks. Port of the dense subset of
`repro/models/layers.py`: RMSNorm, RoPE, causal prefill attention, slab
KV caches (fp32 and OVP-packed), decode attention through the backend
registry, the attention layer and SwiGLU.

Params are plain dicts of tensors. Unlike the reference, cache writes
update the cache tensors in place (the engine's caches are large and
written every step); `attention_forward` returns the same cache dict.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import backends
from repro_torch.core import qlinear
from repro_torch.core.ovp import ovp_encode_codes, pack4
from repro_torch.core.policy import QuantPolicy

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


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, T, Hkv, D) -> (B, T, H, D): one block of
    the reference's online-softmax attention (`_flash_fwd_impl` at prompt
    lengths under its 512-token chunk): scores scaled after the dot,
    -1e30 mask, exp(s - max), acc / max(l, 1e-30)."""
    b, t, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    f32 = torch.float32
    qg = q.reshape(b, t, hkv, g, d).to(f32).permute(0, 2, 3, 1, 4)
    kt = k.to(f32).permute(0, 2, 3, 1)[:, :, None]          # (B,Hkv,1,D,T)
    s = torch.matmul(qg, kt) * (1.0 / math.sqrt(d))        # (B,Hkv,G,T,T)
    pos = torch.arange(t, device=q.device)
    s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p, v.to(f32).permute(0, 2, 1, 3)[:, :, None])
    out = acc / torch.clamp(l_sum, min=1e-30)               # (B,Hkv,G,T,D)
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


def _quant_kv_token(x: torch.Tensor):
    """x (B, T, Hkv, D) -> packed nibbles + per-(token, head) 3σ scales
    (population std, as the reference)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((xf - mu) ** 2).mean(dim=-1))
    s = torch.clamp(3.0 * std / 7.0, min=1e-6)                # (B,T,Hkv)
    codes = ovp_encode_codes(xf / s[..., None], "int4", pair_axis=-1)
    return pack4(codes, pair_axis=-1), s


def cache_write(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: torch.Tensor):
    """Write T tokens per row at positions pos[b] + t, in place; rows past
    the cache length drop (the reference's mode="drop")."""
    if "k" in cache:
        new = {"k": k_new.to(cache["k"].dtype),
               "v": v_new.to(cache["v"].dtype)}
    else:
        kd, ks = _quant_kv_token(k_new)
        vd, vs = _quant_kv_token(v_new)
        new = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
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
    idx = pos[:, None] + torch.arange(t, device=pos.device)
    bidx = torch.arange(b, device=pos.device)[:, None].expand(b, t)
    keep = idx < length
    for key, val in new.items():
        cache[key][bidx[keep], idx[keep]] = val[keep]
    return cache


def decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                     policy: Optional[QuantPolicy] = None) -> torch.Tensor:
    """Single-token attention over a slab cache through the registry;
    `policy` is the resolved policy of the cache site (`<block>/attn/kv`)
    and its backend picks the kernel or the dense path."""
    return backends.decode_attention(q, cache, pos, policy=policy)


def attention_forward(p, x: torch.Tensor, positions: torch.Tensor, cfg,
                      policy: QuantPolicy, *, cache=None,
                      mode: str = "prefill", site: str = "attn"):
    """Self-attention in "prefill" (causal over the prompt, cache written
    from position 0) or "decode" (one token at positions[:, 0]) mode.
    Returns (out, cache)."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qlinear.linear(x, p["wq"], p.get("bq"), *rps(policy, site, "wq"))
    k = qlinear.linear(x, p["wk"], p.get("bk"), *rps(policy, site, "wk"))
    v = qlinear.linear(x, p["wv"], p.get("bv"), *rps(policy, site, "wv"))
    q = rope(q.reshape(b, t, nh, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(b, t, nkv, hd), positions, cfg.rope_theta)
    v = v.reshape(b, t, nkv, hd)
    if mode == "decode":
        cache = cache_write(cache, k, v, positions[:, 0])
        out = decode_attention(q, cache, positions[:, 0],
                               policy=rp(policy, site, "kv"))
    elif mode == "prefill":
        out = causal_attention(q, k, v)
        if cache is not None:
            cache = cache_write(cache, k, v, positions[:, 0])
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
