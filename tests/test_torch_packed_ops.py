"""K1's packed-operand modes and K7, through their plain versions (what
the wrappers run for CPU tensors), against the JAX package's Pallas
kernels run with `interpret=True`:

- `codes4` / `codes8`: `kernels.ops.ovp_matmul`, `matmul_w4a4` and
  `matmul_w8a8` (and `matmul_w4a16`) against the reference's;
- K7, the OVP encoder: `kernels.ops.ovp_encode` byte for byte against
  the reference's, and against `ovp_encode_codes` + `pack4`;
- the served 4-bit KV-cache write on the `cuda` backend, slab and paged:
  greedy tokens equal to the reference's `pallas_interpret` engine, and
  the backend's KV encode (K7 on the card) called twice per layer per
  forward call that writes the cache through `cache_write`.

Matmul tolerance: rtol 1e-5 and atol 1e-5 * max|ref|, K1's. Decoded
codes are exact on both sides; only the fp32 summation order of the K
reduction differs.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common
from repro.core import ovp as jovp
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.kernels import ops as jops
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro.serve import paging as jpg
from repro_torch.backends import CudaBackend
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import ovp as tovp
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovp_encode as tenc
from repro_torch.kernels import ovp_matmul as tmm
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import engine as teng
from repro_torch.serve import paging as tpg

from _torch_dist import on_other_device, one_torch_thread  # noqa: F401


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


# (lhs shape, K-pairs, weight dtype): 2-D and 3-D pre-quantized lhs,
# per-tensor and per-row activation scales
CODES_CASES = [((5, 272), 40, "int4", "tensor"),
               ((2, 3, 96), 136, "int4", "row"),
               ((4, 144), 24, "flint4", "row"),
               ((32, 80), 32, "int8", "tensor"),
               ((3, 2, 144), 40, "int8", "row")]


@pytest.mark.parametrize("lhs_shape,n,dtype,granularity", CODES_CASES)
def test_codes_modes_match_pallas_interpret(lhs_shape, n, dtype,
                                            granularity):
    """ovp_matmul with a pre-quantized lhs (codes4 for 4-bit, codes8 for
    int8), and the shape-level matmul_w4a4 / matmul_w8a8 on its 2-D
    rows."""
    k = lhs_shape[-1]
    qj, qt = _weight(k, n, dtype, seed=k + n)
    x = _acts(lhs_shape, seed=n)
    nmax = 127.0 if dtype == "int8" else 7.0
    s = (np.abs(x).max(axis=-1, keepdims=True) / (2 * nmax)
         if granularity == "row" else np.float32(np.abs(x).std() / 2))
    s = np.asarray(s, np.float32)
    xj = jovp.ovp_quantize(jnp.asarray(x), jnp.asarray(s),
                           normal_dtype=dtype, pair_axis=-1)
    ref = jops.ovp_matmul(xj, qj, interpret=True)
    got = tops.ovp_matmul(_port_qt(xj), qt)
    assert got.shape == lhs_shape[:-1] + (n,)
    _close(got, ref)
    a2 = np.asarray(xj.data).reshape(-1, np.asarray(xj.data).shape[-1])
    s2 = np.broadcast_to(s, lhs_shape[:-1] + (1,)).reshape(-1, 1)
    if dtype == "int8":
        ref2 = jops.matmul_w8a8(jnp.asarray(a2), jnp.asarray(s2), qj.data,
                                qj.scale, interpret=True)
        got2 = tops.matmul_w8a8(torch.from_numpy(a2.copy()),
                                torch.from_numpy(s2.copy()), qt.data,
                                qt.scale)
    else:
        ref2 = jops.matmul_w4a4(jnp.asarray(a2), jnp.asarray(s2), qj.data,
                                qj.scale, normal_dtype=dtype,
                                interpret=True)
        got2 = tops.matmul_w4a4(torch.from_numpy(a2.copy()),
                                torch.from_numpy(s2.copy()), qt.data,
                                qt.scale, normal_dtype=dtype)
    _close(got2, ref2)


def test_matmul_w4a16_matches_pallas_interpret():
    qj, qt = _weight(272, 40, "int4", seed=4)
    x = _acts((4, 272), seed=4)
    ref = jops.matmul_w4a16(jnp.asarray(x), qj.data, qj.scale,
                            interpret=True)
    _close(tops.matmul_w4a16(torch.from_numpy(x), qt.data, qt.scale), ref)


def _edge_values():
    """Values at and around the int4 rounding and outlier edges (±7.5),
    every power of two up to 2^16 and its neighbours one float32 step
    away, and zeros."""
    vals = [0.0, 0.5, 1.5, 2.5, 6.5, 6.9999995, 7.0, 7.0000005, 7.4999995,
            7.5, 7.5000005, 11.999999, 12.0, 95.99999, 96.0, 1e6]
    for e in range(17):
        p = np.float32(2.0 ** e)
        vals += [float(np.nextafter(p, np.float32(0))), float(p),
                 float(np.nextafter(p, np.float32(np.inf)))]
    vals = np.asarray(vals, np.float32)
    return np.concatenate([vals, -vals])


@pytest.mark.parametrize("case", ["random", "edges", "outlier_pairs"])
def test_encode_plain_byte_equal(case):
    """K7's plain version, through `ops.ovp_encode`, against the
    reference's Pallas encoder and against the codec + pack4."""
    rng = np.random.default_rng(11)
    if case == "random":
        x = (rng.standard_normal((37, 272)) * 3).astype(np.float32)
        x.reshape(-1)[::7] *= 12.0
        scale = np.float32(0.7)
    elif case == "edges":
        v = _edge_values()
        x = np.stack(np.meshgrid(v, v, indexing="ij"), -1).reshape(v.size,
                                                                    -1)
        scale = np.float32(1.0)
    else:                       # both values of every pair outliers
        mag = rng.uniform(7.5, 200.0, size=(16, 256)).astype(np.float32)
        sign = rng.choice([-1.0, 1.0], size=mag.shape).astype(np.float32)
        x = mag * sign
        x[:, 1::2][::2] = x[:, 0::2][::2]        # equal-magnitude ties
        x[:, 1::2][1::4] = -x[:, 0::2][1::4]
        scale = np.float32(1.0)
    ref = np.asarray(jops.ovp_encode(jnp.asarray(x), jnp.asarray(scale),
                                     interpret=True))
    got = tops.ovp_encode(torch.from_numpy(x), float(scale)).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    codec = tovp.pack4(tovp.ovp_encode_codes(torch.from_numpy(x / scale),
                                             "int4")).numpy()
    assert np.array_equal(got, codec)


def test_encode_rejects_other_dtypes_and_devices():
    u = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="int4"):
        tenc.fused_ovp_encode(u, "flint4")
    before = tenc.fused_ovp_encode.launches
    want = tenc.fused_ovp_encode(u)
    got = tenc.fused_ovp_encode(u.to("meta"))
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert tenc.fused_ovp_encode.launches == before
    with pytest.raises(ValueError, match="cpu, cuda or meta"):
        tenc.fused_ovp_encode(on_other_device(u))


def test_cpu_tensors_launch_no_kernel():
    qj, qt = _weight(64, 32, "int4", seed=3)
    x = torch.from_numpy(_acts((4, 64), seed=3))
    before = dict(tmm.fused_ovp_matmul.mode_launches)
    tmm.fused_ovp_matmul(x, qt, a_dtype="int4", static_act_scale=0.5)
    tops.ovp_matmul(tovp.ovp_quantize(x, 0.5, "int4"), qt)
    tops.ovp_encode(x, 0.5)
    assert tmm.fused_ovp_matmul.mode_launches == before
    assert tenc.fused_ovp_encode.launches == 0


# --------------------------------------------------------------------------
# The served KV-cache write through K7's route
# --------------------------------------------------------------------------
def _engine_inputs():
    """(reference cfg and W4 params, port cfg and params, prompts) of the
    committed `bench_lm_30.npz` fixture (4 layers, GQA 4/2, head_dim 32):
    six requests, prompts of 4-24 tokens and one of 40."""
    jcfg = common._lm_cfg()
    _, params, _ = common.trained_lm(steps=30)
    qparams = jax.jit(j_quantize_params, static_argnums=1)(
        params, dataclasses.replace(jpol.OLIVE_W4, kv_bits=0,
                                    compute_dtype="float32"))
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    tcfg = ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                         if k in fields})
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=int(rng.integers(4, 25)))
               .astype(np.int32) for _ in range(5)]
    prompts.insert(2, rng.integers(0, jcfg.vocab, size=40).astype(np.int32))
    return jcfg, qparams, tcfg, tparams, prompts


def _drain(eng, prompts):
    for p in prompts:
        eng.submit(p, max_new_tokens=6)
    return {r.uid: list(r.out_tokens) for r in eng.run_until_drained()}


@pytest.mark.parametrize("paged", [False, True])
def test_served_kv4_write_encodes_through_the_backend(paged, monkeypatch):
    """W4 + a 4-bit OVP KV cache served on the `cuda` backend (plain
    versions on the CPU), slab and paged with 16-token prefill chunks:
    greedy tokens equal the reference's on its `pallas_interpret` backend
    (fp32 attention, as K2-K4's), and the backend's KV encode (K7 on the
    card) ran once for K and once for V per layer per forward call that
    wrote the cache through `cache_write`: every decode step and every
    slab prefill; paged prefill chunks write their pages in K4."""
    jcfg, qparams, tcfg, tparams, prompts = _engine_inputs()
    cfg = dict(batch_slots=4, max_len=64)
    if paged:
        cfg.update(prefill_chunk=16)
    jp = dataclasses.replace(jpol.OLIVE_W4, kv_bits=4,
                             compute_dtype="float32")
    ref = _drain(jeng.ServingEngine(
        j_build_model(jcfg, jp, remat=False), qparams, jeng.EngineCfg(
            backend="pallas_interpret",
            page_pool=jpg.PagePoolCfg(16) if paged else None, **cfg)),
        prompts)
    calls = []
    orig = CudaBackend.encode_kv
    monkeypatch.setattr(CudaBackend, "encode_kv",
                        lambda self, x, s: calls.append(x.shape)
                        or orig(self, x, s))
    tp = dataclasses.replace(tpol.OLIVE_W4, kv_bits=4,
                             compute_dtype="float32")
    eng = teng.ServingEngine(t_build_model(tcfg, tp), tparams,
                             teng.EngineCfg(
                                 backend="cuda",
                                 page_pool=tpg.PagePoolCfg(16) if paged
                                 else None, **cfg), device="cpu")
    assert _drain(eng, prompts) == ref
    st = eng.stats()
    assert (st["prefill_chunks_run"] > 0) == paged
    assert len(calls) == 2 * tcfg.n_layers * (st["decodes_run"]
                                              + st["prefills_run"]) > 0
    assert tenc.fused_ovp_encode.launches == 0
