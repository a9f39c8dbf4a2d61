"""K5, the static-scale fused matmul, through its plain version (what
the wrapper runs for CPU tensors): `kernels.ovp_matmul.fused_ovp_matmul
(..., static_act_scale=s)` against the JAX package's
`ops.fused_ovp_matmul(..., static_act_scale=s, interpret=True)`; the
eager backend's static path against the reference's xla backend (both
divide by the scale); and the cuda backend's routing of calibrated
sites.

Matmul tolerance: rtol 1e-5 and atol 1e-5 * max|ref|, K1's. Decoded
codes and quantized activations are exact on both sides (the static
prologue multiplies by the same float32 reciprocal, as the Pallas body
does); only the fp32 summation order of the K reduction differs.
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.kernels import ovp_matmul as tmm

from _torch_dist import one_torch_thread  # noqa: F401


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def _port_qt(qj):
    return QuantizedTensor(data=torch.from_numpy(np.asarray(qj.data).copy()),
                           scale=torch.from_numpy(
                               np.asarray(qj.scale).copy()),
                           normal_dtype=qj.normal_dtype,
                           pair_axis=qj.pair_axis, orig_dim=qj.orig_dim)


def _weight(k, n, w_dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(3, size=(k, n)) * 0.05).astype(np.float32)
    scale = (np.abs(w).max(axis=0, keepdims=True) / 20.0).astype(np.float32)
    qj = jovp.ovp_quantize(jnp.asarray(w), jnp.asarray(scale),
                           normal_dtype=w_dtype, pair_axis=-2)
    return qj, _port_qt(qj)


def _acts(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[::13] *= 25.0                    # activation outliers
    return x


# (rows, K, N, weight dtype, activation dtype): rows 4 and 32 of the
# serving path; K and N past the reference wrapper's 128 blocks and off
# the port kernel's 16-column tile, so both sides pad
STATIC_CASES = [(4, 272, 40, "int4", "int4"),
                (32, 96, 136, "int4", "int4"),
                (4, 144, 24, "flint4", "int4"),
                (32, 272, 40, "flint4", "flint4"),
                (4, 80, 32, "int8", "int8"),
                (32, 144, 136, "int8", "int8")]


@pytest.mark.parametrize("rows,k,n,w_dtype,a_dtype", STATIC_CASES)
def test_static_plain_matches_pallas_interpret(rows, k, n, w_dtype, a_dtype):
    qj, qt = _weight(k, n, w_dtype, seed=rows + k + n)
    x = _acts((rows, k), seed=n)
    s = float(jquant.sigma_init_scale(jnp.asarray(x), a_dtype))
    ref = jops.fused_ovp_matmul(jnp.asarray(x), qj, a_dtype=a_dtype,
                                static_act_scale=s, interpret=True)
    got = tmm.fused_ovp_matmul(torch.from_numpy(x), qt, a_dtype=a_dtype,
                               static_act_scale=s)
    assert got.shape == (rows, n)
    _close(got, ref)


def test_static_scale_rounds_to_float32_and_takes_3d_lhs():
    """A Python float that float32 cannot hold is rounded once on both
    sides; a 3-D lhs folds its lead dims; static differs from fp."""
    qj, qt = _weight(64, 48, "int4", seed=1)
    x = _acts((2, 3, 64), seed=2)
    s = 0.123456789123
    ref = jops.fused_ovp_matmul(jnp.asarray(x), qj, a_dtype="int4",
                                static_act_scale=s, interpret=True)
    got = tmm.fused_ovp_matmul(torch.from_numpy(x), qt, a_dtype="int4",
                               static_act_scale=s)
    assert got.shape == (2, 3, 48)
    _close(got, ref)
    fp = tmm.fused_ovp_matmul(torch.from_numpy(x), qt).numpy()
    assert np.abs(fp - got.numpy()).max() > 1e-3 * np.abs(fp).max()


@pytest.mark.parametrize("wbits", [4, 8])
def test_eager_static_matches_xla_static(wbits):
    """The eager backend's static path (materialized OVP round trip at
    x / s) against the reference's xla backend at the same scale; both
    record one static resolution and no dynamic one."""
    w_dtype = "int4" if wbits == 4 else "int8"
    qj, qt = _weight(144, 40, w_dtype, seed=wbits)
    x = _acts((2, 5, 144), seed=wbits + 1)
    kw = dict(method="olive", wbits=wbits, abits=wbits,
              w_normal_dtype=w_dtype, a_normal_dtype=w_dtype,
              act_scale_mode="static", static_act_scale=0.37,
              compute_dtype="float32")
    jp = jpol.QuantPolicy(backend="xla", **kw)
    tp = tpol.QuantPolicy(backend="eager", **kw)
    jbackends.reset_act_scale_stats()
    tbackends.reset_act_scale_stats()
    ref = jbackends.get_backend("xla").matmul(jnp.asarray(x), qj, jp)
    got = tbackends.get_backend("eager").matmul(torch.from_numpy(x), qt, tp)
    _close(got, ref)
    assert tbackends.act_scale_stats() == jbackends.act_scale_stats() \
        == {"static": 1}


def test_cuda_backend_routes_static_sites_to_k5():
    """The cuda backend hands a calibrated scalar to the static mode
    (its plain version here) and records it as static; a dynamic policy
    still runs the 3σ rule."""
    qj, qt = _weight(64, 32, "int4", seed=9)
    x = torch.from_numpy(_acts((4, 64), seed=9))
    static = tpol.QuantPolicy(method="olive", abits=4,
                              act_scale_mode="static", static_act_scale=0.5,
                              compute_dtype="float32")
    tbackends.reset_act_scale_stats()
    got = tbackends.get_backend("cuda").matmul(x, qt, static)
    want = tmm.fused_ovp_matmul(x, qt, a_dtype="int4", static_act_scale=0.5)
    assert torch.equal(got, want)
    tbackends.get_backend("cuda").matmul(
        x, qt, dataclasses.replace(static, act_scale_mode="dynamic"))
    assert tbackends.act_scale_stats() == {"static": 1, "dynamic": 1}
