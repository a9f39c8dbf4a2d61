"""K6, the grouped per-expert OVP matmul: the port's plain version (what
`kernels.ops.grouped_ovp_matmul` runs for CPU tensors) against the
reference's `grouped_ovp_matmul_kernel` run with `interpret=True` through
its host wrapper `ops.grouped_ovp_matmul`, in every activation mode (fp,
quantize, static, codes4, codes8) for int4, flint4 and int8 stacks, on
ragged shapes that the reference wrapper pads (capacity rows past its
block, K pairs past its 128-pair block, N past its 128-column block, lead
dims folded into the batch); plus the stacked scale layouts, per-slot
scales, and the `cuda` backend's grouped decline codes against the
reference `pallas` backend's.

Tolerance: rtol 1e-5 and atol 1e-5 * max|ref|, K1's. Decoded weights,
decoded codes and in-prologue quantized activations are exact on both
sides; only the fp32 summation order of the K reduction differs.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as jbackends
from repro.core import ovp as jovp
from repro.core import policy as jpol
from repro.core import quantizer as jquant
from repro.kernels import ops as jops
from repro_torch import backends as tbackends
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovp_matmul as tmm

from _torch_dist import on_other_device, one_torch_thread  # noqa: F401


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _port_qt(qj):
    return QuantizedTensor(data=torch.from_numpy(np.asarray(qj.data).copy()),
                           scale=torch.from_numpy(
                               np.asarray(qj.scale).copy()),
                           normal_dtype=qj.normal_dtype,
                           pair_axis=qj.pair_axis, orig_dim=qj.orig_dim)


def _stack(e, k, n, w_dtype, seed, granularity="channel"):
    """A heavy-tailed (E, K, N) expert stack quantized along K by the
    reference at per-expert channel (E, 1, N) or tensor (E, 1, 1)
    scales."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(3, size=(e, k, n)) * 0.05).astype(np.float32)
    axes = (1,) if granularity == "channel" else (1, 2)
    scale = (np.abs(w).max(axis=axes, keepdims=True) / 20.0) \
        .astype(np.float32)
    qj = jovp.ovp_quantize(jnp.asarray(w), jnp.asarray(scale),
                           normal_dtype=w_dtype, pair_axis=-2)
    return qj, _port_qt(qj)


def _acts(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::13] *= 25.0                    # activation outliers
    return x


def _sigma(x, nd):
    return float(jax.jit(jquant.sigma_init_scale, static_argnums=1)(
        jnp.asarray(x), nd))


# (lhs shape (…, E, C, K), N, weight dtype, activation mode)
CASES = [((4, 6, 64), 48, "int4", "fp"),
         ((2, 4, 5, 272), 40, "int4", "quantize"),
         ((2, 4, 5, 272), 40, "int4", "static"),
         ((4, 8, 64), 24, "int4", "codes4"),
         ((3, 6, 96), 136, "flint4", "fp"),
         ((2, 3, 4, 64), 32, "flint4", "quantize"),
         ((3, 4, 64), 32, "flint4", "static"),
         ((3, 4, 64), 32, "flint4", "codes4"),
         ((4, 6, 80), 32, "int8", "fp"),
         ((2, 3, 5, 144), 40, "int8", "quantize"),
         ((3, 5, 144), 40, "int8", "static"),
         ((3, 4, 64), 24, "int8", "codes8"),
         ((2, 2, 3, 4, 64), 16, "int4", "fp")]


@pytest.mark.parametrize("lhs_shape,n,w_dtype,mode", CASES)
def test_plain_matches_pallas_interpret(lhs_shape, n, w_dtype, mode):
    e, k = lhs_shape[-3], lhs_shape[-1]
    qj, qt = _stack(e, k, n, w_dtype, seed=sum(lhs_shape) + n)
    x = _acts(lhs_shape, seed=n)
    if mode == "fp":
        ref = jops.grouped_ovp_matmul(jnp.asarray(x), qj, interpret=True)
        got = tops.grouped_ovp_matmul(torch.from_numpy(x), qt)
    elif mode in ("quantize", "static"):
        s = _sigma(x, w_dtype)
        kw = ({"act_scale": s} if mode == "quantize"
              else {"static_act_scale": s})
        ref = jops.grouped_ovp_matmul(jnp.asarray(x), qj, a_dtype=w_dtype,
                                      interpret=True,
                                      **{key: (jnp.float32(v)
                                               if key == "act_scale" else v)
                                         for key, v in kw.items()})
        got = tops.grouped_ovp_matmul(
            torch.from_numpy(x), qt, a_dtype=w_dtype,
            **{key: (torch.tensor(v) if key == "act_scale" else v)
               for key, v in kw.items()})
    else:
        s = _sigma(x, w_dtype)
        xj = jovp.ovp_quantize(jnp.asarray(x), jnp.float32(s),
                               normal_dtype=w_dtype, pair_axis=-1)
        ref = jops.grouped_ovp_matmul(xj, qj, interpret=True)
        got = tops.grouped_ovp_matmul(_port_qt(xj), qt)
    assert got.shape == lhs_shape[:-1] + (n,)
    _close(got.numpy(), ref)


def test_per_slot_scales_and_tensor_granularity():
    """Per-slot activation scales shaped like the lhs without K, and
    per-expert tensor-granularity weight scales (E, 1, 1), broadcast as
    the reference broadcasts them; quantize mode really quantizes."""
    qj, qt = _stack(4, 64, 40, "int4", seed=5, granularity="tensor")
    x = _acts((2, 4, 6, 64), seed=6)
    slots = (np.abs(x).max(axis=-1) / 7.0).astype(np.float32)
    ref = jops.grouped_ovp_matmul(jnp.asarray(x), qj, a_dtype="int4",
                                  act_scale=jnp.asarray(slots),
                                  interpret=True)
    got = tops.grouped_ovp_matmul(torch.from_numpy(x), qt, a_dtype="int4",
                                  act_scale=torch.from_numpy(slots))
    _close(got.numpy(), ref)
    fp = tops.grouped_ovp_matmul(torch.from_numpy(x), qt).numpy()
    assert np.abs(fp - got.numpy()).max() > 1e-3 * np.abs(fp).max()


def test_cpu_tensors_never_launch_and_other_devices_raise():
    _, qt = _stack(2, 64, 16, "int4", seed=3)
    x = torch.from_numpy(_acts((2, 3, 64), seed=3))
    before = sum(tmm.grouped_ovp_matmul.mode_launches.values())
    tops.grouped_ovp_matmul(x, qt)
    assert sum(tmm.grouped_ovp_matmul.mode_launches.values()) == before
    meta = dataclasses.replace(qt, data=qt.data.to("meta"),
                               scale=qt.scale.to("meta"))
    want = tops.grouped_ovp_matmul(x, qt)
    before = dict(tmm.grouped_ovp_matmul.mode_launches)
    got = tops.grouped_ovp_matmul(x.to("meta"), meta)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert tmm.grouped_ovp_matmul.mode_launches == before
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tops.grouped_ovp_matmul(on_other_device(x), qt)


@pytest.mark.parametrize("lhs_shape", [(6, 64), (3, 6, 64), (2, 4, 6, 64),
                                       (2, 3, 6, 64)])
def test_grouped_decline_codes_match_reference(lhs_shape):
    """The cuda backend declines (or serves) a stacked weight exactly as
    the reference's pallas backend does; a served call records
    `cuda[stacked]` and equals the eager backend's broadcast matmul."""
    qj, qt = _stack(4, 64, 16, "int4", seed=9)
    pj = dataclasses.replace(jpol.OLIVE_W4, compute_dtype="float32",
                             backend="pallas_interpret")
    pt = dataclasses.replace(tpol.OLIVE_W4, compute_dtype="float32")
    x = _acts(lhs_shape, seed=2)
    jbackends.reset_dispatch_stats()
    tbackends.reset_dispatch_stats()
    j_reason = jbackends.get_backend("pallas").decline_reason(
        jnp.asarray(x), qj, pj)
    t_reason = tbackends.get_backend("cuda").decline_reason(
        torch.from_numpy(x), qt, pt)
    assert t_reason == j_reason
    assert (t_reason is None) == (lhs_shape == (2, 4, 6, 64))
    if t_reason is None:
        got = tbackends.dispatch(torch.from_numpy(x), qt, pt)
        want = tbackends.dispatch(torch.from_numpy(x), qt,
                                  pt.with_backend("eager"))
        _close(got.numpy(), want.numpy())
        assert tbackends.dispatch_stats() == {"cuda[stacked]": 1,
                                              "eager[stacked]": 1}


def _fill(b, e, c, seed):
    """A (B, E) fill in [0, C] with some experts empty in every row."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, c + 1, size=(b, e))
    f[:, rng.permutation(e)[:max(1, e // 3)]] = 0
    return f


# (lhs shape (…, E, C, K), N, weight dtype, activation mode)
FILL_CASES = [((4, 6, 4, 64), 48, "int4", "fp"),
              ((2, 4, 5, 272), 40, "flint4", "quantize"),
              ((3, 4, 3, 64), 24, "int4", "codes4"),
              ((3, 5, 2, 144), 40, "int8", "static"),
              ((2, 2, 3, 4, 64), 16, "int4", "fp")]


@pytest.mark.parametrize("lhs_shape,n,w_dtype,mode", FILL_CASES)
def test_fill_equals_every_row_when_rows_past_it_are_zero(lhs_shape, n,
                                                          w_dtype, mode):
    """The plain version with `fill` (zeros past it) is bit for bit the
    all-rows product on an lhs whose rows past the fill are zero, as
    `moe_layer`'s slots are; without zeroed rows it still zeroes them."""
    e, c, k = lhs_shape[-3:]
    qj, qt = _stack(e, k, n, w_dtype, seed=k + n)
    x = _acts(lhs_shape, seed=c)
    lead = lhs_shape[:-3]
    fill = _fill(int(np.prod(lead)), e, c, seed=n).reshape(lead + (e,))
    live = np.arange(c) < fill[..., None]
    xz = np.where(live[..., None], x, 0.0).astype(np.float32)
    kw = {}
    if mode in ("quantize", "static"):
        s = _sigma(x, w_dtype)
        kw = {"a_dtype": w_dtype, **({"act_scale": torch.tensor(s)}
                                     if mode == "quantize"
                                     else {"static_act_scale": s})}
    if mode.startswith("codes"):
        s = _sigma(x, w_dtype)
        xz = _port_qt(jovp.ovp_quantize(jnp.asarray(xz), jnp.float32(s),
                                        normal_dtype=w_dtype, pair_axis=-1))
    else:
        xz = torch.from_numpy(xz)
    tfill = torch.from_numpy(fill)
    got = tops.grouped_ovp_matmul(xz, qt, fill=tfill, **kw)
    want = tops.grouped_ovp_matmul(xz, qt, **kw)
    assert torch.equal(got, want)
    assert not torch.equal(got, torch.zeros_like(got))
    # unzeroed rows past the fill: the plain version writes zeros there
    if not mode.startswith("codes"):
        raw = tops.grouped_ovp_matmul(torch.from_numpy(x), qt, fill=tfill,
                                      **kw)
        assert torch.equal(raw[torch.from_numpy(~live)],
                           torch.zeros_like(raw[torch.from_numpy(~live)]))
        assert torch.equal(raw[torch.from_numpy(live)],
                           got[torch.from_numpy(live)])


def test_fill_reaches_k6_through_dispatch_and_mixed_groups():
    """`backends.dispatch(..., fill=)` hands the fill to K6's wrapper on
    the cuda backend, gathered down to each group of a per-expert mixed
    W4/W8 stack, and the eager backend computes every row (the filled
    rows agree)."""
    from repro_torch.core.qlinear import quantize_params
    rng = np.random.default_rng(4)
    e, c, k, n = 4, 3, 64, 32
    w = torch.from_numpy((rng.standard_normal((e, k, n)) * 0.1)
                         .astype(np.float32))
    w4 = dataclasses.replace(tpol.OLIVE_W4, compute_dtype="float32")
    w8 = dataclasses.replace(tpol.OLIVE_W8A8, compute_dtype="float32",
                             abits=0)
    prog = tpol.PolicyProgram(rules=(("experts/*/1", w8),), default=w4)
    mixed = quantize_params({"experts": {"wg": w}}, prog)["experts"]["wg"]
    x = torch.from_numpy(_acts((2, e, c, k), seed=5))
    fill = torch.from_numpy(_fill(2, e, c, seed=6))
    seen = []
    real = tmm.run_grouped

    def spy(*args, fill=None, **kw):
        seen.append(None if fill is None else fill.clone())
        return real(*args, fill=fill, **kw)

    tmm.run_grouped = spy
    try:
        got = tbackends.dispatch(x, mixed, w4, fill=fill)
    finally:
        tmm.run_grouped = real
    ids = [list(g) for g in mixed.expert_ids]
    assert [s.tolist() for s in seen] == [fill[:, g].tolist() for g in ids]
    want = tbackends.dispatch(x, mixed, w4.with_backend("eager"), fill=fill)
    live = torch.arange(c) < fill[..., None]
    _close(got[live].numpy(), want[live].numpy())


# (B, E, C, K, N, weight dtype, activation mode): decode wg / wd and a
# prefill chunk of Qwen3-30B-A3B, the API's shapes, ragged ones
GROUPED_PLANS = [(4, 128, 4, 2048, 768, "int4", "fp"),
                 (4, 128, 4, 768, 2048, "int4", "fp"),
                 (1, 128, 4, 2048, 768, "int4", "fp"),
                 (1, 8, 32, 1024, 1024, "int4", "quantize"),
                 (1, 8, 32, 1024, 1024, "int8", "codes8"),
                 (3, 5, 7, 272, 40, "flint4", "static"),
                 (2, 6, 1, 64, 24, "int4", "fp")]


@pytest.mark.parametrize("b,e,c,k,n,w_dtype,a_mode", GROUPED_PLANS)
def test_grouped_plan_covers_filled_rows_once_and_skips_empty_experts(
        b, e, c, k, n, w_dtype, a_mode):
    """K6's persistent geometry (`GroupedPlan.items`, the kernel's work
    list): every filled (b, e, c) slot row x every column gets all K
    pairs exactly once, from one writer (rank 0 of its cluster); no slot
    past the fill is touched; an expert with no filled row has no work,
    so no block reads its weights; without a fill every row is done (the
    decode body forced where the plan picks the FMA body)."""
    for filled in (True, False):
        plan = tmm.grouped_launch_plan(b, e, c, k, n, w_dtype, a_mode,
                                       body="decode", filled=filled)
        assert plan == tmm.grouped_launch_plan(b, e, c, k, n, w_dtype,
                                               a_mode, filled=filled) \
            or (not filled and b * c > 8)
        assert plan.body == "decode"
        k2, n_pad = k // 2, -(-n // 64) * 64     # 64-column work items
        assert plan.n == n_pad
        assert plan.row_tile == min(4, b * c)
        assert plan.split * plan.share <= 8 and plan.split in (1, 2, 4, 8)
        assert (n_pad // 64) % plan.share == 0
        assert plan.smem <= tmm.SMEM_MAX
        fill = _fill(b, e, c, seed=b + e + c) if filled else None
        live = (np.arange(c) < fill[..., None]) if filled \
            else np.ones((b, e, c), bool)
        pairs = np.zeros((b * e * c, n_pad), np.int64)
        writers = np.zeros((b * e * c, n_pad), np.int64)
        touched = set()
        for ex, rows, cols, krange in plan.items(fill):
            assert 1 <= len(rows) <= plan.row_tile
            touched.add(ex)
            for r in rows:
                assert (r // c) % e == ex              # the expert's slot
                pairs[r, cols.start:cols.stop] += len(krange)
                if krange.start == 0:
                    writers[r, cols.start:cols.stop] += 1
        want = np.where(live.reshape(-1)[:, None], k2, 0)
        assert (pairs == want).all()
        assert (writers == (want > 0)).all()
        assert touched == {ex for ex in range(e) if live[:, ex].any()}


@pytest.mark.parametrize("b,e,c,k,n,w_dtype,a_mode", GROUPED_PLANS)
def test_grouped_plan_picks_the_fma_body_without_fill_above_8_rows(
        b, e, c, k, n, w_dtype, a_mode):
    """With a fill the plan runs the decode body (the served path: only
    routed experts are read); without one, the FMA body above 8 rows an
    expert (its 16-row tiles decode each weight once for 16 rows), over
    every row of every expert in 16-column tiles, with no K split."""
    assert tmm.grouped_launch_plan(b, e, c, k, n, w_dtype, a_mode,
                                   filled=True).body == "decode"
    plan = tmm.grouped_launch_plan(b, e, c, k, n, w_dtype, a_mode)
    if b * c <= 8:
        assert plan.body == "decode"
        return
    assert plan.body == "fma"
    assert (plan.n, plan.row_tile) == (-(-n // 16) * 16, 16)
    assert (plan.split, plan.share, plan.slice, plan.smem) == (1, 1, k // 2,
                                                               0)


@pytest.mark.parametrize("body", tmm.BODIES)
def test_forced_grouped_plans_are_checked_against_the_call(body):
    """`run_grouped(plan=)` takes a forced plan of either body for its own
    shape and refuses one made for another call."""
    b, e, c, k, n = 4, 128, 4, 2048, 712
    plan = tmm.grouped_launch_plan(b, e, c, k, n, "int4", body=body,
                                   filled=True)
    assert tmm.check_grouped_plan(plan, b, e, c, k, n) is plan
    for other in ((b + 1, e, c, k, n), (b, e, c + 1, k, n),
                  (b, e, c, k + 2, n), (b, e, c, k, n + 64)):
        with pytest.raises(ValueError, match="is not a plan"):
            tmm.check_grouped_plan(plan, *other)
