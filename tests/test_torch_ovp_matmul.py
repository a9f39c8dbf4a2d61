"""K1, the fused OVP matmul: the port's plain version (what the wrapper
runs for CPU tensors) against the reference Pallas kernel run with
`interpret=True` through its host wrapper `ops.fused_ovp_matmul`.

Tolerance: rtol 1e-5 and atol 1e-5 * max|ref|. Decoded weights and the
in-prologue quantized activations are exact on both sides; only the
fp32 summation order of the K reduction differs (the Pallas kernel sums
256-wide K tiles, the plain version one whole-K product per plane).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ovp as jovp
from repro.core import quantizer as jquant
from repro.kernels import ops
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.kernels import ovp_matmul as tmm

from _torch_dist import on_other_device, one_torch_thread  # noqa: F401

# (lhs shape, N, weight dtype, activation dtype or None for fp). Shapes
# cover 2-D and 3-D lhs and the reference wrapper's padding: rows past
# its 128 block, K pairs past its 128-pair block, N past its 128 block.
CASES = [((5, 64), 48, "int4", None),
         ((2, 3, 272), 40, "int4", "int4"),
         ((130, 96), 136, "flint4", None),
         ((4, 2, 64), 24, "flint4", "flint4"),
         ((6, 80), 32, "int8", None),
         ((3, 144), 40, "int8", "int8")]


def _operands(lhs_shape, n, w_dtype, seed):
    rng = np.random.default_rng(seed)
    k = lhs_shape[-1]
    x = rng.standard_normal(lhs_shape).astype(np.float32)
    x.reshape(-1)[::13] *= 25.0                    # activation outliers
    w = (rng.standard_t(3, size=(k, n)) * 0.05).astype(np.float32)
    scale = (np.abs(w).max(axis=0, keepdims=True) / 20.0).astype(np.float32)
    qj = jax.jit(jovp.ovp_quantize, static_argnames=("normal_dtype",
                                                     "pair_axis"))(
        jnp.asarray(w), jnp.asarray(scale), normal_dtype=w_dtype,
        pair_axis=-2)
    qt = QuantizedTensor(data=torch.from_numpy(np.asarray(qj.data).copy()),
                         scale=torch.from_numpy(scale), normal_dtype=w_dtype,
                         pair_axis=qj.pair_axis, orig_dim=qj.orig_dim)
    return x, qj, qt


@pytest.mark.parametrize("lhs_shape,n,w_dtype,a_dtype", CASES)
def test_plain_matches_pallas_interpret(lhs_shape, n, w_dtype, a_dtype):
    x, qj, qt = _operands(lhs_shape, n, w_dtype, seed=len(lhs_shape) + n)
    scale = None
    if a_dtype is not None:
        # the backend's dynamic rule: one population-std scalar per tensor
        scale = np.asarray(jax.jit(jquant.sigma_init_scale, static_argnums=1)(
            jnp.asarray(x), a_dtype))
    ref = np.asarray(ops.fused_ovp_matmul(
        jnp.asarray(x), qj, a_dtype=a_dtype,
        act_scale=None if scale is None else jnp.asarray(scale),
        interpret=True))
    got = tmm.fused_ovp_matmul(
        torch.from_numpy(x), qt, a_dtype=a_dtype,
        act_scale=None if scale is None else torch.from_numpy(scale))
    assert got.shape == ref.shape == lhs_shape[:-1] + (n,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_per_row_scales_and_quantize_prologue():
    """Per-row activation scales take the same prologue as a scalar, and
    quantize mode really quantizes (it differs from fp mode)."""
    x, qj, qt = _operands((4, 64), 32, "int4", seed=7)
    rows = (np.abs(x).max(axis=-1) / 7.0).astype(np.float32)
    ref = np.asarray(ops.fused_ovp_matmul(jnp.asarray(x), qj, a_dtype="int4",
                                          act_scale=jnp.asarray(rows),
                                          interpret=True))
    got = tmm.fused_ovp_matmul(torch.from_numpy(x), qt, a_dtype="int4",
                               act_scale=torch.from_numpy(rows)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    fp = tmm.fused_ovp_matmul(torch.from_numpy(x), qt).numpy()
    assert np.abs(fp - got).max() > 1e-3 * np.abs(fp).max()


def test_cpu_tensors_never_launch():
    x, _, qt = _operands((2, 64), 16, "int4", seed=3)
    before = sum(tmm.fused_ovp_matmul.mode_launches.values())
    tmm.fused_ovp_matmul(torch.from_numpy(x), qt)
    assert sum(tmm.fused_ovp_matmul.mode_launches.values()) == before


def test_other_devices_raise():
    """cpu (plain version), cuda (kernel) and meta (the plain version's
    shape, no launch) are served; any other device raises."""
    x, _, qt = _operands((2, 64), 16, "int4", seed=3)
    meta = QuantizedTensor(data=qt.data.to("meta"),
                           scale=qt.scale.to("meta"), normal_dtype="int4",
                           pair_axis=-2, orig_dim=64)
    want = tmm.fused_ovp_matmul(torch.from_numpy(x), qt)
    before = dict(tmm.fused_ovp_matmul.mode_launches)
    got = tmm.fused_ovp_matmul(torch.from_numpy(x).to("meta"), meta)
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert tmm.fused_ovp_matmul.mode_launches == before
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tmm.fused_ovp_matmul(on_other_device(torch.from_numpy(x)), qt)
