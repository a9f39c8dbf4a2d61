"""OVP codecs of the port (repro_torch.core) against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages. The
tolerance is zero: codes, packed bytes and decoded values must be equal
byte for byte, because both sides run the same integer/rounding rules
(round half to even, the left outlier winning ties, abfloat clipping at
2^15, the disabled e=0/m=0 code).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datatypes as jdt
from repro.core import ovp as jovp
from repro_torch.core import datatypes as tdt
from repro_torch.core import ovp as tovp

from _torch_dist import one_torch_thread  # noqa: F401

DTYPES = ("int4", "flint4", "int8")

# whole-function jit: one XLA compile per shape instead of one per op
_STATIC = ("normal_dtype", "pair_axis")
j_encode = jax.jit(jovp.ovp_encode_codes, static_argnames=_STATIC)
j_decode = jax.jit(jovp.ovp_decode_codes, static_argnames=_STATIC)
j_pack = jax.jit(jovp.pack4, static_argnames=("pair_axis",))
j_unpack = jax.jit(jovp.unpack4, static_argnames=("pair_axis",))


def _edge_values(normal_dtype: str) -> np.ndarray:
    """Ties at .5, flint4 midpoints, the outlier threshold, magnitudes at
    and just below powers of two, and values above 2^15."""
    spec = jdt.ABFLOAT_FOR_NORMAL[normal_dtype]
    pows = np.array([2.0 ** k for k in range(0, 17)], np.float32)
    vals = [np.arange(-8.5, 9.0, 0.5, dtype=np.float32),
            np.array([1.5, 2.5, 3.5, 5.0, 7.0, 12.0], np.float32),
            pows, np.nextafter(pows, np.float32(0)), -pows,
            np.array([spec.min_mag, spec.max_mag, 2.0 ** 15 + 1, 1e5, 1e9,
                      -3e4, 127.5, 126.5], np.float32)]
    v = np.concatenate(vals)
    return v[: len(v) // 2 * 2]


def _inputs(normal_dtype: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    scale = 40.0 if normal_dtype == "int8" else 6.0
    u = (rng.standard_normal((48, 64)) * scale).astype(np.float32)
    u[0, :16] = np.tile(np.float32([50.0, -50.0]), 8)   # equal outlier pairs
    u[1, :16] = np.tile(np.float32([-300.0, 300.0]), 8)
    edge = _edge_values(normal_dtype)
    flat = u.reshape(-1)
    flat[64: 64 + len(edge)] = edge
    # the same edges as right-hand pair mates
    flat[64 + len(edge) + 1: 64 + 2 * len(edge) + 1] = edge
    return u


@pytest.mark.parametrize("normal_dtype", DTYPES)
def test_encode_decode_byte_equal(normal_dtype):
    u = _inputs(normal_dtype)
    cj = np.asarray(j_encode(jnp.asarray(u), normal_dtype=normal_dtype))
    ct = tovp.ovp_encode_codes(torch.from_numpy(u), normal_dtype).numpy()
    np.testing.assert_array_equal(ct, cj)
    dj = np.asarray(j_decode(jnp.asarray(cj), normal_dtype=normal_dtype))
    dt = tovp.ovp_decode_codes(torch.from_numpy(cj.copy()),
                               normal_dtype).numpy()
    np.testing.assert_array_equal(dt, dj)


@pytest.mark.parametrize("normal_dtype", DTYPES)
def test_encode_along_axis0(normal_dtype):
    """Weights pair along K (axis -2)."""
    u = _inputs(normal_dtype, seed=1).T.copy()
    cj = np.asarray(j_encode(jnp.asarray(u), normal_dtype=normal_dtype,
                             pair_axis=-2))
    ct = tovp.ovp_encode_codes(torch.from_numpy(u), normal_dtype,
                               pair_axis=-2).numpy()
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("normal_dtype", ("int4", "flint4"))
@pytest.mark.parametrize("pair_axis", (-1, -2))
def test_pack_unpack_byte_equal(normal_dtype, pair_axis):
    u = _inputs(normal_dtype, seed=2)
    codes = np.asarray(j_encode(jnp.asarray(u), normal_dtype=normal_dtype,
                                pair_axis=pair_axis))
    pj = np.asarray(j_pack(jnp.asarray(codes), pair_axis=pair_axis))
    pt = tovp.pack4(torch.from_numpy(codes.copy()), pair_axis).numpy()
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(
        tovp.unpack4(torch.from_numpy(pj.copy()), pair_axis).numpy(),
        np.asarray(j_unpack(jnp.asarray(pj), pair_axis=pair_axis)))


@pytest.mark.parametrize("normal_dtype", DTYPES)
def test_abfloat_codes_byte_equal(normal_dtype):
    """The outlier encoder alone, over the whole clip range."""
    spec = jdt.ABFLOAT_FOR_NORMAL[normal_dtype]
    mags = np.geomspace(1.0, 2.0 ** 17, 4001).astype(np.float32)
    u = np.concatenate([mags, np.nextafter(mags, np.float32(0)), -mags])
    cj = np.asarray(jax.jit(jdt.abfloat_encode, static_argnums=1)(
        jnp.asarray(u), spec))
    ct = tdt.abfloat_encode(torch.from_numpy(u),
                            tdt.ABFLOAT_FOR_NORMAL[normal_dtype]).numpy()
    np.testing.assert_array_equal(ct, cj)
    assert not np.any((ct & ((1 << (spec.ebits + spec.mb)) - 1)) == 0)


@pytest.mark.parametrize("normal_dtype", DTYPES)
def test_quantize_dequantize_match(normal_dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_t(3, size=(32, 24)).astype(np.float32)
    qj = jax.jit(lambda v: jovp.ovp_quantize(v, 0.05, normal_dtype,
                                             pair_axis=-2))(jnp.asarray(x))
    qt = tovp.ovp_quantize(torch.from_numpy(x), 0.05, normal_dtype,
                           pair_axis=-2)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data))
    assert (qt.pair_axis, qt.orig_dim, qt.shape) == (qj.pair_axis,
                                                     qj.orig_dim, qj.shape)
    np.testing.assert_array_equal(
        tovp.ovp_dequantize(qt).numpy(),
        np.asarray(jax.jit(jovp.ovp_dequantize)(qj)))
    fq = jax.jit(lambda v: jovp.ovp_fake_quant(v, 0.05, normal_dtype))
    np.testing.assert_array_equal(
        tovp.ovp_fake_quant(torch.from_numpy(x), 0.05, normal_dtype).numpy(),
        np.asarray(fq(jnp.asarray(x))))
