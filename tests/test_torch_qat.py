"""QAT's fake-quant in the port (`core/ovp.py::ovp_fake_quant`,
`core/quantizer.py::fake_quant_ste`), on the CPU:

- `ovp_fake_quant`, computed on values, equals the code path it stands
  for, `ovp_decode_codes(ovp_encode_codes(x / s)) * s`, bit for bit,
  for int4 and int8 normals, pairs along
  either axis, at scales 1 and 0.73, on seeded normals of six spreads
  and on the values where the codes change: every half-integer and its
  neighbouring floats (rounding ties), powers of two and their
  neighbours (the abfloat exponent), the outlier threshold and the
  abfloat range's ends;
- `fake_quant_ste` returns those values and its gradient is the
  identity (none reaches the scale).

The QAT branch of `qmatmul` is held to the reference through the loss
and every gradient of a QAT model (`test_torch_train_step.py`).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.datatypes import ABFLOAT_FOR_NORMAL, NORMAL_MAX
from repro_torch.core.ovp import (ovp_decode_codes, ovp_encode_codes,
                                  ovp_fake_quant)
from repro_torch.core.quantizer import fake_quant_ste, sigma_init_scale

from _torch_dist import one_torch_thread  # noqa: F401


def _edges(normal_dtype: str) -> np.ndarray:
    spec = ABFLOAT_FOR_NORMAL[normal_dtype]
    t = NORMAL_MAX[normal_dtype]
    halves = np.arange(-2 * t - 1, 2 * t + 2, dtype=np.float32) / 2
    pows = np.float32(2.0) ** np.arange(-6, 16, dtype=np.float32)
    marks = np.concatenate([halves, pows, -pows, np.float32(
        [t, t + 0.5, spec.min_mag, spec.max_mag, 1 << 15])])
    near = [np.nextafter(marks, np.float32(np.inf)),
            np.nextafter(marks, np.float32(-np.inf))]
    vals = np.concatenate([marks] + near).astype(np.float32)
    vals = np.concatenate([vals, -vals])
    # pair every value with a small, a normal and a larger neighbour
    mates = np.float32([0.25, 3.0, 1e3])
    left = np.repeat(vals, len(mates))
    right = np.tile(mates, len(vals))
    both = np.stack([np.stack([left, right], -1),
                     np.stack([right, left], -1)]).reshape(-1)
    return both[: both.size // 64 * 64].reshape(-1, 64)


@pytest.mark.parametrize("normal_dtype", ["int4", "int8"])
@pytest.mark.parametrize("pair_axis", [-1, -2])
def test_values_equal_the_code_path_bit_for_bit(normal_dtype, pair_axis):
    rng = np.random.default_rng(0)
    inputs = [_edges(normal_dtype)] + [
        (rng.standard_normal((32, 128)) * spread).astype(np.float32)
        for spread in (1, 3, 10, 30, 300, 1e4)]
    for x in inputs:
        x = torch.from_numpy(x if pair_axis == -1 else x.T.copy())
        for scale in (1.0, 0.73):
            codes = ovp_encode_codes(x / scale, normal_dtype,
                                     pair_axis=pair_axis)
            want = ovp_decode_codes(codes, normal_dtype,
                                    pair_axis=pair_axis) * scale
            got = ovp_fake_quant(x, scale, normal_dtype,
                                 pair_axis=pair_axis)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32))


def test_ste_forward_and_gradient():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((16, 64)) * 2)
                         .astype(np.float32)).requires_grad_()
    s = sigma_init_scale(x.detach(), "int4")
    y = fake_quant_ste(x, s, "int4", pair_axis=-2)
    want = ovp_fake_quant(x.detach(), s, "int4", pair_axis=-2)
    assert torch.equal(y.detach(), x.detach() + (want - x.detach()))
    tangent = torch.from_numpy(rng.standard_normal((16, 64))
                               .astype(np.float32))
    (y * tangent).sum().backward()
    assert torch.equal(x.grad, tangent)
