"""The layouts K2, K3 and K4 take: every layout the reference's Pallas
kernels serve (any G with H % Hkv == 0, head dims up to 256, fp caches
and pools in f32, bf16 or fp16).

- The launch checks, pure functions the CPU can call
  (`decode_attn.kernel_layout`, `prefill_attn.prefill_plan`): they
  accept G 7, G 16, D 256 and bf16 / fp16 fp caches and pools, and still
  refuse what the kernels cannot take (H % Hkv != 0, D % 8 != 0, D above
  K4's 256, a stage of partial pages, another fp dtype).
- K4's launch geometry: every query row of every kv head is attended
  once per key split rank, the ranks' key tiles cover the stage once,
  the write blocks cover every (page tile, kv head), and the shared
  memory fits a block.
- The plain versions at G 16 / D 256 and over bf16 caches and pools
  against the reference's kernels run with `interpret=True`: outputs
  atol 1e-5 (fp32 summation order and the tile-wise softmax rescaling,
  as in the other attention tests); page codes equal, scales within 1e-6
  relative, bf16 pages equal.
- The ctypes signatures of the two attention sources match their C
  entries.
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's layers first: its kernels package imports cleanly only
# once repro.core has loaded
from repro.models import layers as jlayers
from repro.kernels import decode_attn as jda
from repro.kernels.prefill_attn import fused_prefill_attention
from repro_torch.kernels import decode_attn as tda
from repro_torch.kernels import prefill_attn as tpa

from _torch_dist import one_torch_thread  # noqa: F401

_J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
            "float16": jnp.float16}


# (H, Hkv, D, fp dtype or None for packed)
ACCEPTED = [(28, 4, 128, None), (16, 1, 256, None), (32, 2, 256, "bfloat16"),
            (32, 4, 128, "bfloat16"), (32, 4, 128, "float16"),
            (16, 16, 64, None), (14, 2, 64, "float32"), (64, 4, 8, None)]


@pytest.mark.parametrize("h,hkv,d,dt", ACCEPTED)
def test_decode_layout_accepts_the_reference_layouts(h, hkv, d, dt):
    lay = tda.kernel_layout(h, hkv, d, dt and getattr(torch, dt))
    assert (lay.g, lay.d) == (h // hkv, d)
    assert lay.kind == (0 if dt is None else
                        tda.FP_KINDS[getattr(torch, dt)])
    assert 0 < lay.smem <= tda.SMEM_MAX


@pytest.mark.parametrize("h,hkv,d,dt", ACCEPTED)
def test_prefill_plan_accepts_the_reference_layouts(h, hkv, d, dt):
    for c in (1, 16, 64):
        plan = tpa.prefill_plan(c, h, hkv, d, 256, 16,
                                dt and getattr(torch, dt))
        assert plan.g == h // hkv and 0 < plan.smem <= tpa.SMEM_MAX


# (H, Hkv, D, fp dtype, exception)
REFUSED = [(12, 5, 64, None, ValueError), (16, 4, 60, None, ValueError),
           (8, 2, 4, None, ValueError), (16, 0, 64, None, ValueError),
           (16, 4, 64, "float64", TypeError), (16, 4, 64, "int8", TypeError)]


@pytest.mark.parametrize("h,hkv,d,dt,exc", REFUSED)
def test_layout_checks_refuse_what_the_kernels_cannot_take(h, hkv, d, dt,
                                                           exc):
    fp = dt and getattr(torch, dt)
    with pytest.raises(exc):
        tda.kernel_layout(h, hkv, d, fp)
    with pytest.raises(exc):
        tpa.prefill_plan(16, h, hkv, d, 256, 16, fp)


def test_prefill_plan_refuses_wide_heads_and_partial_pages():
    with pytest.raises(ValueError, match="D <= 256"):
        tpa.prefill_plan(16, 8, 2, 264, 256, 16)
    with pytest.raises(ValueError, match="whole pages"):
        tpa.prefill_plan(16, 8, 2, 64, 250, 16)


# (C, H, Hkv, D, S, ps): the serving paths (Qwen1.5-0.5B, Qwen3-30B-A3B at
# C 16 and 64), the widened layouts, ragged rows and stages
PLANS = [(16, 16, 16, 64, 256, 16), (16, 32, 4, 128, 256, 16),
         (64, 32, 4, 128, 256, 16), (16, 16, 1, 256, 256, 16),
         (16, 28, 4, 128, 256, 16), (5, 12, 3, 40, 48, 8),
         (64, 8, 8, 64, 2048, 16), (1, 16, 1, 256, 16, 16)]


@pytest.mark.parametrize("c,h,hkv,d,s,ps", PLANS)
def test_prefill_geometry_covers_rows_keys_and_pages_once(c, h, hkv, d, s,
                                                          ps):
    plan = tpa.prefill_plan(c, h, hkv, d, s, ps)
    g, tiles = h // hkv, -(-s // 32)
    assert 1 <= plan.warps <= 8 and plan.split in (1, 2, 4, 8)
    assert plan.nbuf == (2 if plan.tpr > 1 else 1)
    assert plan.smem == tpa._smem(plan.rows, d, plan.nbuf, plan.split)
    rows = np.zeros((hkv, c * g), np.int64)
    keys = np.zeros((hkv, c * g, tiles), np.int64)
    for x in range(plan.n_attn):
        head, rr, kk = plan.attention_block(x)
        for r in rr:
            rows[head, r] += 1
            for t in kk:
                if t < tiles:
                    keys[head, r, t] += 1
        assert len(rr) > 0
    assert (rows == plan.split).all()      # once per key split rank
    assert (keys == 1).all()               # every key tile exactly once
    assert plan.n_write >= hkv * (s // ps) and plan.n_write % plan.split == 0
    # the card is filled where the keys allow: one wave, or every tile
    # its own rank
    assert plan.n_attn >= 132 or plan.split == 8 \
        or 2 * plan.split > tiles


def test_prefill_geometry_on_the_serving_paths_is_the_documented_one():
    q15 = tpa.prefill_plan(16, 16, 16, 64, 256, 16)
    assert (q15.warps, q15.n_rt, q15.split, q15.n_attn, q15.n_write) == \
        (4, 1, 8, 128, 256)
    q3 = tpa.prefill_plan(16, 32, 4, 128, 256, 16)
    assert (q3.warps, q3.n_rt, q3.split, q3.n_attn, q3.n_write) == \
        (8, 4, 8, 128, 64)


def _decode_case(b, s_len, hkv, g, d, cache_dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_len, hkv, d)).astype(np.float32)
    pos = np.array([0, s_len - 1, s_len // 2][:b], np.int32)
    if cache_dtype is None:
        quant = jax.jit(jlayers._quant_kv_token)
        kd, ks = quant(jnp.asarray(k))
        vd, vs = quant(jnp.asarray(v))
        jc = {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}
        tc = {key: torch.from_numpy(np.array(val)) for key, val in
              jc.items()}
    else:
        jc = {"k": jnp.asarray(k).astype(_J_DTYPE[cache_dtype]),
              "v": jnp.asarray(v).astype(_J_DTYPE[cache_dtype])}
        tc = {"k": torch.from_numpy(k).to(getattr(torch, cache_dtype)),
              "v": torch.from_numpy(v).to(getattr(torch, cache_dtype))}
    return q, jc, tc, pos


# (B, S, Hkv, G, D, cache dtype or None for packed)
DECODE = [(3, 32, 1, 16, 256, None), (3, 32, 1, 16, 256, "bfloat16"),
          (2, 40, 2, 7, 32, "bfloat16"), (2, 24, 2, 2, 16, "float16")]


@pytest.mark.parametrize("b,s_len,hkv,g,d,dt", DECODE)
def test_decode_plain_matches_pallas_interpret_on_wide_layouts(b, s_len, hkv,
                                                               g, d, dt):
    q, jc, tc, pos = _decode_case(b, s_len, hkv, g, d, dt, seed=g + d)
    ref = np.asarray(jda.fused_decode_attention(
        jnp.asarray(q), jc, jnp.asarray(pos), interpret=True))
    got = tda.fused_decode_attention(torch.from_numpy(q), tc,
                                     torch.from_numpy(pos))
    assert got.shape == ref.shape == (b, 1, hkv * g, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", [None, "bfloat16"])
def test_paged_plain_matches_pallas_interpret_at_g16_d256(dt):
    """K3's plain version over a shuffled pool of 8-row pages at G 16,
    D 256, packed and bf16."""
    b, n, ps, hkv, g, d, n_pool = 2, 3, 8, 1, 16, 256, 8
    q, jc, tc, pos = _decode_case(n_pool, ps, hkv, g, d, dt, seed=5)
    q = q[:b]
    bt = np.random.default_rng(6).permutation(n_pool)[:b * n] \
        .reshape(b, n).astype(np.int32)
    jc["block_table"] = jnp.asarray(bt)
    tc["block_table"] = torch.from_numpy(bt)
    pos = np.array([3, n * ps - 1], np.int32)
    ref = np.asarray(jda.fused_decode_attention(
        jnp.asarray(q), jc, jnp.asarray(pos), interpret=True))
    got = tda.fused_paged_decode_attention(torch.from_numpy(q), tc,
                                           torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


# (Hkv, G, D, pool dtype or None for packed)
PREFILL = [(1, 16, 256, None), (1, 16, 256, "bfloat16"),
           (2, 7, 32, "float16")]


@pytest.mark.parametrize("hkv,g,d,dt", PREFILL)
def test_prefill_plain_matches_pallas_interpret_on_wide_layouts(hkv, g, d,
                                                                dt):
    """Two chunks of 8 over a 16-row stage of 8-row pages: outputs, the
    written pages (codes equal and scales within 1e-6 relative; fp pools
    equal) and the untouched pages."""
    rng = np.random.default_rng(d + g)
    ps, n_pages, s, c = 8, 6, 16, 8
    bt_row = [4, 1]
    if dt is None:
        pools = {"k_data": rng.integers(0, 255, (n_pages, ps, hkv, d // 2),
                                        dtype=np.uint8),
                 "v_data": rng.integers(0, 255, (n_pages, ps, hkv, d // 2),
                                        dtype=np.uint8),
                 "k_scl": rng.random((n_pages, ps, hkv), np.float32),
                 "v_scl": rng.random((n_pages, ps, hkv), np.float32)}
        jpools = {key: jnp.asarray(val) for key, val in pools.items()}
        tpools = {key: torch.from_numpy(val.copy())
                  for key, val in pools.items()}
    else:
        raw = {key: rng.standard_normal((n_pages, ps, hkv, d))
               .astype(np.float32) for key in ("k", "v")}
        jpools = {key: jnp.asarray(val).astype(_J_DTYPE[dt])
                  for key, val in raw.items()}
        tpools = {key: torch.from_numpy(val).to(getattr(torch, dt))
                  for key, val in raw.items()}
    before = {key: val.clone() for key, val in tpools.items()}
    k_all = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    v_all = rng.standard_normal((1, s, hkv, d)).astype(np.float32)
    q_all = rng.standard_normal((1, s, hkv * g, d)).astype(np.float32)
    table = np.asarray([bt_row], np.int32)
    jc = dict(jpools, stage_k=jnp.zeros((1, s, hkv, d)),
              stage_v=jnp.zeros((1, s, hkv, d)),
              block_table=jnp.asarray(table))
    tc = dict(tpools, stage_k=torch.zeros((1, s, hkv, d)),
              stage_v=torch.zeros((1, s, hkv, d)),
              block_table=torch.from_numpy(table))
    for lo in range(0, s, c):
        hi = lo + c
        jc["stage_k"] = jc["stage_k"].at[:, lo:hi].set(k_all[:, lo:hi])
        jc["stage_v"] = jc["stage_v"].at[:, lo:hi].set(v_all[:, lo:hi])
        tc["stage_k"][:, lo:hi] = torch.from_numpy(k_all[:, lo:hi])
        tc["stage_v"][:, lo:hi] = torch.from_numpy(v_all[:, lo:hi])
        positions = np.arange(lo, hi, dtype=np.int32)[None]
        ref, jc = fused_prefill_attention(
            jnp.asarray(q_all[:, lo:hi]), jc, jnp.asarray(positions),
            interpret=True)
        got, _ = tpa.fused_prefill_attention(
            torch.from_numpy(q_all[:, lo:hi]), tc,
            torch.from_numpy(positions))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)
        for key in tpools:
            x = tc[key]
            y = np.asarray(jc[key].astype(jnp.float32)) \
                if x.dtype in (torch.bfloat16, torch.float16) \
                else np.asarray(jc[key])
            x = x.float().numpy() if x.is_floating_point() else x.numpy()
            if key.endswith("_scl"):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(x, y)
            for p in range(n_pages):
                if p not in bt_row:
                    assert torch.equal(tc[key][p], before[key][p])


_CTYPE = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("module,entry", [
    (tda, "decode_attn_launch"), (tda, "paged_decode_attn_launch"),
    (tpa, "prefill_attn_launch")])
def test_ctypes_signature_matches_the_c_entry(module, entry):
    """A wrong argtypes silently cuts a pointer or shifts every later
    argument: each C entry's parameters, in order, match `_SIGNATURE`."""
    name = "decode_attn" if module is tda else "prefill_attn"
    src = (Path(module.__file__).resolve().parent.parent / "csrc"
           / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    assert [_CTYPE[p] for p in params] == module._SIGNATURE[entry]
