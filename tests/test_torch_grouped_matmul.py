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
    with pytest.raises(ValueError, match="cpu or cuda"):
        tops.grouped_ovp_matmul(x.to("meta"), meta)


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
