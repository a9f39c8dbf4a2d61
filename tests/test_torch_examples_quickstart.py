"""`examples_torch/quickstart.py` against the reference's library on the
same numpy inputs (`quickstart.inputs()`), on the CPU, where the fused
matmul runs its plain version and the reference's Pallas kernel runs
`interpret=True`, as its example does.

Tolerances: the pair statistics within rtol 1e-6; packed bytes equal;
SQNR within 1e-3 dB; the three outliers after OVP and after int4 within
rtol 1e-5; the first victim's code pair and the abfloat magnitudes
identical; each package's kernel-vs-oracle error under 1e-4.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from examples_torch import quickstart
from repro.core import baselines
from repro.core.datatypes import ABFLOAT_FOR_NORMAL
from repro.core.ovp import (ovp_dequantize, ovp_quantize, pair_statistics,
                            unpack4)
from repro.core.quantizer import QuantSpec, quantization_error, quantize
from repro.kernels import ops, ref

from _torch_dist import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def both():
    x_np, a_np = quickstart.inputs()
    x, a = jnp.asarray(x_np), jnp.asarray(a_np)
    want = {"stats": {k: float(v) for k, v in
                      pair_statistics(x.reshape(-1)).items()}}
    qt = quantize(x, QuantSpec(normal_dtype="int4", granularity="tensor"))
    want["packed_bytes"], want["fp32_bytes"] = qt.nbytes(), x.size * 4
    want["sqnr_db"] = float(quantization_error(
        x, QuantSpec(normal_dtype="int4"))["sqnr_db"])
    xh = ovp_dequantize(qt)
    xi4 = baselines.uniform_int_fake_quant(x, 4)
    want["outliers"] = [(i, j, float(x[i, j]), float(xh[i, j]),
                         float(xi4[i, j]))
                        for i, j, _ in quickstart.OUTLIERS]
    codes = unpack4(qt.data, qt.pair_axis)
    vi, vj = map(int, jnp.argwhere(codes == 0x8)[0])
    pj = vj + 1 if vj % 2 == 0 else vj - 1
    want["victim"] = (vi, vj, pj, int(codes[vi, vj]), int(codes[vi, pj]))
    spec = ABFLOAT_FOR_NORMAL["int4"]
    want["abfloat"] = (spec.bias, [float(m) for m in
                                   spec.magnitudes().tolist()])
    wq = ovp_quantize(x, jnp.std(x) * 3 / 7, "int4", pair_axis=0)
    got = ops.matmul_w4a16(a, wq.data, jnp.asarray(wq.scale),
                           interpret=True)
    oracle = ref.ovp_matmul_w4a16_ref(a, wq.data) * wq.scale
    want["kernel_err"] = float(jnp.max(jnp.abs(got - oracle)))
    return want, quickstart.report(x_np, a_np, device="cpu")


def test_pair_statistics(both):
    want, got = both
    assert got["stats"].keys() == want["stats"].keys()
    for k, v in want["stats"].items():
        assert got["stats"][k] == pytest.approx(v, rel=1e-6), k


def test_packed_bytes_and_sqnr(both):
    want, got = both
    assert (got["packed_bytes"], got["fp32_bytes"]) == \
        (want["packed_bytes"], want["fp32_bytes"])
    assert abs(got["sqnr_db"] - want["sqnr_db"]) <= 1e-3


@pytest.mark.parametrize("which", range(3))
def test_outliers_after_ovp_and_int4(both, which):
    want, got = both
    w, g = want["outliers"][which], got["outliers"][which]
    assert g[:3] == w[:3]
    np.testing.assert_allclose(g[3:], w[3:], rtol=1e-5)


def test_first_victim_pair_and_abfloat(both):
    want, got = both
    assert got["victim"] == want["victim"]
    assert got["victim"][3] == 0x8
    assert got["abfloat"] == want["abfloat"]


def test_kernel_against_its_oracle(both):
    want, got = both
    assert want["kernel_err"] < 1e-4
    assert got["kernel_err"] < 1e-4
    assert got["kernel"] == "plain PyTorch version, CPU"


def test_main_prints_the_reference_sections(capsys):
    assert quickstart.main([], device="cpu") == 0
    out = capsys.readouterr().out
    for line in ("== pair statistics (paper Table 2) ==",
                 "== OliVe PTQ (scale search + OVP encode + pack) ==",
                 "== the byte IS the pair: inspect one OV pair ==",
                 "== fused OVP-decode matmul (plain PyTorch version, "
                 "CPU) ==", "done."):
        assert line in out
