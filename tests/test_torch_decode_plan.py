"""K2/K3's launch plan and the arithmetic of their cluster split.

- `decode_plan`'s geometry at the served shapes (Qwen1.5-0.5B: Hkv 16,
  G 1, D 64; Qwen3-30B-A3B and Yi-6B: Hkv 4, G 8, D 128; Qwen2-7B: Hkv
  4, G 7, D 128; Minitron-8B: Hkv 8, G 4, D 128; B 4, S 256; packed and
  fp32 caches) and G 16 / D 256: the key split (the cluster
  size), the tiles a rank walks, the tile buffers and the shared bytes,
  which must match `csrc/decode_attn.cu`'s `smem_bytes` formula; the
  refusal past 227 KB; K3's plan depends on the logical length only.
- The live-tile range the kernel reads from `pos`, and each rank's
  share of it: every live tile walked by exactly one rank, no rank past
  the row's last live tile, all of S for a row with no valid slot.
- A torch emulation of the kernel's arithmetic (each rank's online
  softmax over its 32-token tiles into a partial (m, l, o), then the
  rank-order combine M = max m_r, L = sum l_r exp(m_r - M), o = sum o_r
  exp(m_r - M), out = o / max(L, 1e-30); o / max(l, 1e-30) from rank 0
  alone where it holds every live tile) at every split the plan can
  pick, held against `decode_attention_plain` and against the
  reference's `fused_decode_attention(..., interpret=True)` on
  numpy-seeded inputs: atol 1e-5, since only the fp32 summation order,
  the tile-wise rescaling and the combine differ from one dense softmax.
  Cases: mixed positions, a window, a ring, a parked paged row, ranks
  with no live tile, and rows with every slot masked (the plain version
  then averages V uniformly).
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's layers first: its kernels package imports cleanly only
# once repro.core has loaded
from repro.models import layers as jlayers
from repro.kernels import decode_attn as jda
from repro_torch.kernels import decode_attn as tda

from _torch_dist import one_torch_thread  # noqa: F401

NEG_INF = -1e30
TS = 32


# --------------------------------------------------------------------------
# The plan
# --------------------------------------------------------------------------
# (B, S, H, Hkv, D, fp dtype) -> (split, tiles a rank walks, buffers)
SERVED = [((4, 256, 16, 16, 64, None), (4, 2, 2)),
          ((4, 256, 16, 16, 64, torch.float32), (4, 2, 2)),
          ((4, 256, 32, 4, 128, None), (8, 1, 1)),
          ((4, 256, 32, 4, 128, torch.bfloat16), (8, 1, 1)),
          ((4, 256, 16, 1, 256, None), (8, 1, 1)),
          ((4, 256, 16, 1, 256, torch.bfloat16), (8, 1, 1)),
          ((4, 256, 28, 4, 128, None), (8, 1, 1)),
          ((4, 256, 28, 4, 128, torch.float32), (8, 1, 1)),
          ((4, 256, 32, 8, 128, None), (8, 1, 1)),
          ((4, 256, 32, 8, 128, torch.float32), (8, 1, 1)),
          ((4, 2048, 16, 1, 256, torch.float32), (8, 8, 2)),
          ((64, 256, 16, 16, 64, None), (1, 8, 2)),
          ((4, 48, 16, 16, 64, None), (2, 1, 1)),
          ((1, 20, 8, 2, 8, torch.float16), (1, 1, 1))]


@pytest.mark.parametrize("args,want", SERVED)
def test_plan_geometry(args, want):
    b, s, h, hkv, d, dt = args
    plan = tda.decode_plan(*args)
    assert (plan.split, plan.tpr, plan.nbuf) == want   # split: cluster size
    assert plan.tiles == -(-s // TS) and plan.tpr == -(-plan.tiles
                                                       // plan.split)
    assert plan.split <= 8 and plan.split & (plan.split - 1) == 0
    # the split stops at the first power of two with a wave of blocks
    assert plan.split == 1 or b * hkv * plan.split // 2 < 132
    assert plan.g == h // hkv and 0 < plan.smem <= tda.SMEM_MAX
    assert tda.decode_plan(*args) is plan          # memoized


def _c_smem(g, d, kind, nbuf):
    """csrc/decode_attn.cu's `geom` + `smem_bytes`, from its source
    text's constants: a second reading of the same formula."""
    src = (Path(tda.__file__).resolve().parent.parent / "csrc"
           / "decode_attn.cu").read_text()
    assert "g.wpr = G == 1 ? 4 : (G == 2 ? 2 : 1);" in src
    assert "g.vs = D + (g.tsp > 1 ? 32 / g.tsp : 0);" in src
    assert re.search(r"if \(kind == KV_PACKED\) return TS \* D \+ 8 \* TS;",
                     src)
    assert "constexpr int TAB_COPIES = 16;" in src
    wpr = 4 if g == 1 else 2 if g == 2 else 1
    ncol = (d // 4 + wpr - 1) // wpr
    tsp = 1
    while tsp < 8 and 2 * tsp * ncol <= 32:
        tsp *= 2
    ks, vs = d + 4 * wpr, d + (32 // tsp if tsp > 1 else 0)
    raw = {0: TS * d + 8 * TS, 1: 4 * TS * (ks + vs)}.get(kind, 4 * TS * d)
    dec = 0 if kind == 1 else 4 * TS * (ks + vs)
    tab = 4 * 256 * 16 if kind == 0 else 0
    return nbuf * raw + dec + tab + 4 * (2 * g * d + g * wpr * TS
                                   + (g * TS if wpr > 1 else 0)
                                   + 2 * g * wpr)


@pytest.mark.parametrize("args,_", SERVED)
def test_plan_shared_bytes_match_the_kernel(args, _):
    plan = tda.decode_plan(*args)
    assert plan.smem == _c_smem(plan.g, plan.d, plan.kind, plan.nbuf)
    # float4 tiles: every segment of the layout stays 16-byte aligned
    wpr, ks, _, tsp, vs = tda._geom(plan.g, plan.d)
    assert ks % 4 == 0 and vs % 4 == 0 and (plan.d * 4) % 16 == 0


def test_plan_refuses_past_the_shared_memory_cap():
    # G 32 at D 512 over an f32 cache: one buffer and the queries and
    # partials alone are 257 KB
    with pytest.raises(ValueError, match="shared memory"):
        tda.decode_plan(4, 256, 32, 1, 512, torch.float32)
    # where two buffers would not fit, one is used
    plan = tda.decode_plan(4, 4096, 8, 1, 448, torch.float32)
    assert plan.tpr > 1 and plan.nbuf == 1
    assert tda._smem(8, 448, 1, 2) > tda.SMEM_MAX >= plan.smem
    with pytest.raises(ValueError):
        tda.decode_plan(4, 0, 16, 16, 64)
    with pytest.raises(TypeError):
        tda.decode_plan(4, 256, 16, 16, 64, torch.float64)


@pytest.mark.parametrize("fp_dtype,name", [(None, "int4"),
                                            (torch.float32, "float32"),
                                            (torch.bfloat16, "bfloat16"),
                                            (torch.float16, "float16")])
def test_cache_launch_counter_names_the_cache_dtype(fp_dtype, name):
    """K2 and K3 count each launch under `CACHE_DTYPES[plan.kind]` too:
    the cache's dtype, int4 for a packed cache."""
    plan = tda.decode_plan(4, 256, 16, 16, 64, fp_dtype)
    assert tda.CACHE_DTYPES[plan.kind] == name
    for fn in (tda.fused_decode_attention, tda.fused_paged_decode_attention):
        assert set(fn.cache_launches) == set(tda.CACHE_DTYPES)


def test_paged_plan_is_the_slab_plan_of_the_logical_length():
    """K3 is bit-identical to K2 only if both run the same split and live
    range: the wrapper plans a pool's call from s_len (ring or n * ps),
    never from the pool size or the page size."""
    a = tda.decode_plan(4, 256, 16, 16, 64)
    for n, ps in ((16, 16), (8, 32), (32, 8)):
        assert tda.decode_plan(4, n * ps, 16, 16, 64) == a


# --------------------------------------------------------------------------
# Live tiles and each rank's share
# --------------------------------------------------------------------------
# (pos, S, window, ring) -> live tiles
LIVE = [((0, 256, 0, 0), range(0, 1)), ((17, 256, 0, 0), range(0, 1)),
        ((46, 256, 0, 0), range(0, 2)), ((255, 256, 0, 0), range(0, 8)),
        ((256, 256, 0, 0), range(0, 8)),          # a parked paged row
        ((900, 256, 0, 0), range(0, 8)),
        ((200, 256, 40, 0), range(5, 7)),         # slots 161..200
        ((255, 256, 1, 0), range(7, 8)),
        ((10, 64, 0, 64), range(0, 1)),           # ring, first lap
        ((63, 64, 0, 64), range(0, 2)),           # ring full
        ((70, 64, 16, 64), range(0, 2)),          # ring + window: all
        ((-1, 256, 0, 0), range(0, 8)),           # nothing valid: all
        ((256, 256, 1, 0), range(0, 8)),          # parked + window 1
        ((10, 100, 0, 0), range(0, 1)), ((99, 100, 0, 0), range(0, 4))]


@pytest.mark.parametrize("args,want", LIVE)
def test_live_tiles(args, want):
    pos, s, window, ring = args
    assert tda.live_tiles(pos, s, window, ring) == want
    # a live tile is exactly one that holds a valid slot, unless none does
    slots = torch.arange(s)
    _, valid = tda.slot_validity(torch.tensor([pos]), slots, window=window,
                                 ring=ring)
    valid = valid[0] & (slots < s)
    holds = {int(x) // TS for x in torch.nonzero(valid).flatten()}
    if holds:
        assert holds <= set(want) and min(holds) == want.start \
            and max(holds) == want.stop - 1
    else:
        assert want == range(0, -(-s // TS))


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("args", [a for a, _ in LIVE])
def test_rank_shares_cover_the_live_tiles_once(split, args):
    pos, s, window, ring = args
    plan = dataclasses.replace(tda.decode_plan(4, s, 16, 16, 64),
                               split=split)
    shares = [plan.rank_tiles(pos, r, window, ring) for r in range(split)]
    walked = [t for share in shares for t in share]
    assert walked == list(tda.live_tiles(pos, s, window, ring))
    assert all(len(x) <= -(-len(walked) // split) for x in shares)


# --------------------------------------------------------------------------
# The kernel's arithmetic, emulated
# --------------------------------------------------------------------------
def emulate(q, cache, pos, plan, *, window=0, ring=0):
    """K2/K3's arithmetic in torch: per (row, kv head), each cluster rank
    walks its share of the live tiles with the online softmax (slots past
    S get p = 0), then the ranks combine in rank order (rank 0 alone
    where the others hold no tile)."""
    slab = tda._slab_view(cache, ring)
    packed = "k_data" in slab
    if packed:
        k = tda.dequant_codes(slab["k_data"])
        v = tda.dequant_codes(slab["v_data"])
        ks, vs = slab["k_scl"], slab["v_scl"]
    else:
        k, v = slab["k"].float(), slab["v"].float()
        ks = vs = torch.ones(k.shape[:3])
    b, s, hkv, d = k.shape
    assert s == plan.s
    pad = plan.tiles * TS - s
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) for x in (k, v))
    ks, vs = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (ks, vs))
    g = q.shape[2] // hkv
    qf = q.reshape(b, hkv, g, d).float() / tda._qscale(d)
    out = torch.zeros(b, hkv, g, d)
    ranks_without_tiles = 0
    for bi in range(b):
        p_cur = int(pos[bi])
        for h in range(hkv):
            parts = []
            for rank in range(plan.split):
                m = torch.full((g,), NEG_INF)
                l_sum = torch.zeros(g)
                o = torch.zeros(g, d)
                tiles = plan.rank_tiles(p_cur, rank, window, ring)
                ranks_without_tiles += not tiles
                for t in tiles:
                    sl = slice(t * TS, (t + 1) * TS)
                    slots = torch.arange(t * TS, (t + 1) * TS)
                    sc = (qf[bi, h] @ k[bi, sl, h].T) * ks[bi, sl, h]
                    _, valid = tda.slot_validity(pos[bi:bi + 1], slots,
                                                 window=window, ring=ring)
                    sc = torch.where(valid[0] & (slots < s), sc, NEG_INF)
                    m_new = torch.maximum(m, sc.amax(-1))
                    p = torch.exp(sc - m_new[:, None]) * (slots < s)
                    corr = torch.exp(m - m_new)
                    l_sum = l_sum * corr + p.sum(-1)
                    m = m_new
                    o = o * corr[:, None] + (p * vs[bi, sl, h]) @ v[bi, sl, h]
                parts.append((m, l_sum, o))
            if not any(plan.rank_tiles(p_cur, r, window, ring)
                       for r in range(1, plan.split)):
                # every live tile on rank 0: it writes the row alone
                m, l_sum, o = parts[0]
                out[bi, h] = o / torch.clamp(l_sum, min=1e-30)[:, None]
                continue
            big_m = parts[0][0]
            for m_r, _, _ in parts[1:]:
                big_m = torch.maximum(big_m, m_r)
            big_l, acc = torch.zeros(g), torch.zeros(g, d)
            for m_r, l_r, o_r in parts:
                f = torch.exp(m_r - big_m)
                big_l = big_l + l_r * f
                acc = acc + o_r * f[:, None]
            out[bi, h] = acc / torch.clamp(big_l, min=1e-30)[:, None]
    return out.reshape(q.shape), ranks_without_tiles


def _slab_case(b, s, hkv, g, d, packed, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, _cache(k, v, packed)


def _cache(k, v, packed):
    if packed:
        kd, ks = jlayers._quant_kv_token(jnp.asarray(k))
        vd, vs = jlayers._quant_kv_token(jnp.asarray(v))
        return {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
    return {"k": jnp.asarray(k), "v": jnp.asarray(v)}


def _paged_case(packed, seed, *, b=3, n=4, ps=16, hkv=2, g=2, d=16,
                n_pool=16):
    """A shuffled pool; the last row parked (all-zero table row at pos
    = n * ps), as the engine parks an idle slot."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((n_pool, ps, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_pool, ps, hkv, d)).astype(np.float32)
    cache = _cache(k, v, packed)
    bt = rng.permutation(n_pool)[:b * n].reshape(b, n).astype(np.int32)
    bt[-1] = 0
    cache["block_table"] = jnp.asarray(bt)
    return q, cache


def _torch(cache):
    return {key: torch.from_numpy(np.asarray(val).copy())
            for key, val in cache.items()}


# (name, slab (B, S, Hkv, G, D) or "paged", packed, window, ring, pos)
CASES = [
    ("mixed", (4, 128, 2, 1, 16), True, 0, 0, [0, 17, 127, 40]),
    ("mixed fp", (4, 128, 1, 8, 16), False, 0, 0, [5, 33, 100, 127]),
    ("window", (3, 96, 2, 2, 16), True, 24, 0, [5, 60, 95]),
    ("ring", (2, 64, 2, 1, 16), True, 0, 64, [3 * 64 + 5, 3 * 64 + 40]),
    ("ring window", (2, 64, 1, 4, 16), False, 16, 64, [70, 30]),
    ("parked", "paged", True, 0, 0, [0, 33, 64]),
    ("parked fp window", "paged", False, 12, 0, [9, 40, 64]),
    ("all masked", (3, 64, 2, 2, 16), True, 0, 0, [-1, 30, -1]),
    ("all masked window", "paged", True, 1, 0, [63, 5, 64]),
]


@pytest.mark.parametrize("name,shape,packed,window,ring,pos", CASES,
                         ids=[c[0] for c in CASES])
def test_split_arithmetic_matches_plain_and_reference(name, shape, packed,
                                                      window, ring, pos):
    seed = len(name) + window
    if shape == "paged":
        q, cache = _paged_case(packed, seed)
    else:
        q, cache = _slab_case(*shape, packed, seed)
    pos = np.asarray(pos, np.int32)
    ref = np.asarray(jda.fused_decode_attention(
        jnp.asarray(q), cache, jnp.asarray(pos), window=window, ring=ring,
        interpret=True))
    tq, tc, tp = torch.from_numpy(q), _torch(cache), torch.from_numpy(pos)
    plain = tda.decode_attention_plain(tq, tc, tp, window=window, ring=ring)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-5)
    b, _, h, d = q.shape
    kd = tc["k_data" if packed else "k"]
    hkv = kd.shape[2]
    s_len = ring or (tc["block_table"].shape[1] * kd.shape[1]
                     if "block_table" in tc else kd.shape[1])
    base = tda.decode_plan(b, s_len, h, hkv, d,
                           None if packed else kd.dtype)
    empty = 0
    for split in (1, 2, 4, 8):
        plan = dataclasses.replace(base, split=split)
        got, n_empty = emulate(tq, tc, tp, plan, window=window, ring=ring)
        empty += n_empty
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # at split 8 at least one rank of a short row has no live tile
    if name in ("mixed", "window", "parked"):
        assert empty > 0


def test_all_masked_row_is_the_uniform_average_of_v():
    """pos -1: no slot is valid; the plain version (and so the kernel,
    which walks all of S then) averages the V scale-weighted codes
    uniformly over the S slots."""
    q, cache = _slab_case(1, 64, 1, 2, 16, True, seed=3)
    tc = _torch(cache)
    tp = torch.tensor([-1], dtype=torch.int32)
    got = tda.decode_attention_plain(torch.from_numpy(q), tc, tp)
    v = tda.dequant_kv(tc["v_data"], tc["v_scl"])          # (1, S, 1, D)
    want = v.mean(dim=1)[:, None].expand(1, 1, 2, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    plan = tda.decode_plan(1, 64, 2, 1, 16)
    emu, _ = emulate(torch.from_numpy(q), tc, tp, plan)
    np.testing.assert_allclose(emu.numpy(), got.numpy(), rtol=0, atol=1e-5)
