"""The port's sensitivity pass, `reference` backend, kernel oracles and
core helpers against the JAX package, on the CPU: the same weights
(carried over with `convert.params_from_numpy`) and seeded numpy inputs
through both.

Tolerances: the weight tape's samples, `auto_mixed`'s program, the
encode oracle, decoded codes, dequantized values and the helpers'
counts are exact; per-channel PTQ scales within rtol 1e-6;
`site_sensitivity` within 1e-3 dB (both search the same samples on the
same grid, the fp32 MSE sums differ in order); matmuls within rtol 1e-6
and 1e-6 · max|ref| (fp32 sums in another order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as jbackends
from repro.configs import get_config as j_get_config
from repro.core import calibration as jcal
from repro.core import datatypes as jdt
from repro.core import ovp as jovp
from repro.core import policy as jpol
from repro.core import quantizer as jq
from repro.kernels import ref as jref
from repro.models.model import build_model as j_build_model
from repro.models.model import unroll_params
from repro_torch import backends as tbackends
from repro_torch import core as tcore
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.core.qlinear import quantize_params, quantize_weight
from repro_torch.kernels import ref as tref
from repro_torch.models.model import build_model

from _torch_dist import one_torch_thread  # noqa: F401

ARCHS = ("qwen1.5-0.5b-smoke", "qwen3-moe-30b-a3b-smoke")
CAP = 2000      # below the smoke weights' sizes, so the tape draws


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small torch ops, whose intra-op threads only
    contend with the suite's other workers: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both_trees(arch: str):
    """The reference's unrolled tree (as numpy) and the port's copy."""
    cfg = j_get_config(arch)
    jparams = j_build_model(cfg, jpol.QuantPolicy(), remat=False).init(
        jax.random.PRNGKey(0))
    jtree = jax.tree_util.tree_map(np.asarray, unroll_params(cfg, jparams))
    return jtree, params_from_numpy(jtree, device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def tapes(request):
    """Weight tapes of one arch: the reference's on its unrolled tree,
    the port's on the whole tree, and the port's fed one piece at a time
    in the draw order (embedding and head first, then each layer),
    planned over the whole tree."""
    jtree, ttree = _both_trees(request.param)
    jt = jcal.record_weights(jtree, jcal.ActTape(max_per_site=CAP))
    whole = tcal.record_weights(ttree, tcal.ActTape(max_per_site=CAP))
    meta = build_model(get_config(request.param)).init(None, device="meta")
    streamed = tcal.ActTape(max_per_site=CAP).plan(
        tcal.record_weights(meta, tcal.SizeTape()).records)
    tcal.record_weights({k: v for k, v in ttree.items() if k != "layers"},
                        streamed)
    for i, layer in enumerate(ttree["layers"]):
        tcal.record_weights(layer, streamed, prefix=f"layers/{i}")
    return jt, whole, streamed


def test_record_weights_samples_and_order(tapes):
    jt, whole, streamed = tapes
    assert list(whole.samples) == list(jt.samples)
    assert sorted(streamed.samples) == sorted(jt.samples)
    assert any(s.startswith("layers/1/") for s in jt.samples)
    for site, want in jt.samples.items():
        assert np.array_equal(whole.samples[site], want), site
        assert np.array_equal(streamed.samples[site], want), site


def test_site_sensitivity_within_1e3_db(tapes):
    jt, whole, _ = tapes
    want = jcal.site_sensitivity(jt)
    got = tcal.site_sensitivity(whole)
    assert list(got) == list(want)
    bad = {k: (got[k], want[k]) for k in want
           if abs(got[k] - want[k]) > 1e-3}
    assert not bad, f"SQNR off by more than 1e-3 dB: {bad}"


def _fields(pol):
    """The port's QuantPolicy fields of either package's policy (the
    default backend names differ by design)."""
    return {f.name: getattr(pol, f.name)
            for f in dataclasses.fields(tpol.QuantPolicy)
            if f.name != "backend"}


def _rules(prog):
    return [(r.pattern, _fields(r.policy), r.origin) for r in prog.rules]


@pytest.mark.parametrize("budget", [4.0, 4.5, 6.0, 8.0])
def test_auto_mixed_on_the_reference_sensitivity(tapes, budget):
    jt, _, _ = tapes
    sens = jcal.site_sensitivity(jt)
    want = jcal.auto_mixed(sens, budget_bits=budget)
    got = tcal.auto_mixed(sens, budget_bits=budget)
    assert _rules(got) == _rules(want)
    assert (got.name, _fields(got.default)) == \
        (want.name, _fields(want.default))
    n_high = sum(r.policy.wbits == 8 for r in got.rules
                 if r.origin != "compat")
    assert n_high == int((budget - 4) / 4 * sum(
        tpol.PolicyProgram.from_policy(tpol.OLIVE_W4A4).resolve(k).enabled
        for k in sens))


# ---------------------------------------------------------------- backend
def _to_jax(qt):
    """A port QuantizedTensor as the reference's."""
    return jovp.QuantizedTensor(
        data=jnp.asarray(qt.data.numpy()), scale=jnp.asarray(qt.scale.numpy()),
        normal_dtype=qt.normal_dtype, pair_axis=qt.pair_axis,
        orig_dim=qt.orig_dim)


def _weight(dtype: str, shape, seed: int):
    """An OVP weight (heavy-tailed, so outliers pair up; a 3-D shape is
    an expert stack) for the reference and the port."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(3, shape) * 0.05).astype(np.float32)
    tw = quantize_weight(torch.from_numpy(w), tpol.QuantPolicy(
        method="olive", wbits=8 if dtype == "int8" else 4,
        w_normal_dtype=dtype))
    return _to_jax(tw), tw


MODES = {"fp": dict(abits=0),
         "dynamic": dict(act_scale_mode="dynamic"),
         "static": dict(act_scale_mode="static", static_act_scale=0.0625)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", ["int4", "flint4", "int8"])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "experts"])
def test_reference_backend_matches_the_reference(dtype, mode, stacked):
    bits = 8 if dtype == "int8" else 4
    kw = dict(method="olive", wbits=bits, abits=bits, w_normal_dtype=dtype,
              a_normal_dtype="int8" if bits == 8 else dtype,
              compute_dtype="float32")
    kw.update(MODES[mode])
    jpolicy = jpol.QuantPolicy(backend="reference", **kw)
    tpolicy = tpol.QuantPolicy(backend="reference", **kw)
    shape, xshape = ((4, 64, 48), (2, 4, 3, 64)) if stacked \
        else ((64, 48), (2, 5, 64))
    jw, tw = _weight(dtype, shape, seed=bits + len(shape))
    x = (np.random.default_rng(1).standard_normal(xshape) * 0.3) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jbackends.dispatch(v, jw, jpolicy))(
        jnp.asarray(x)))
    tbackends.reset_dispatch_stats()
    tbackends.reset_act_scale_stats()
    got = tbackends.dispatch(torch.from_numpy(x), tw, tpolicy)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert tbackends.dispatch_stats() == {
        "reference" + ("[stacked]" if stacked else ""): 1}
    assert tbackends.act_scale_stats() == (
        {} if mode == "fp" else {mode: 1})


def test_reference_backend_is_registered_and_never_declines():
    backend = tbackends.get_backend("reference")
    assert "reference" in tbackends.available()
    assert backend.dispatches_per_matmul == 3
    _, tw = _weight("int4", (4, 64, 48), seed=0)
    # an lhs without the stack's expert dim: cuda declines, reference not
    x = torch.zeros((2, 64))
    pol = tpol.QuantPolicy(method="olive")
    assert tbackends.get_backend("cuda").decline_reason(x, tw, pol)
    assert backend.decline_reason(x, tw, pol) is None


# ---------------------------------------------------------------- oracles
@pytest.mark.parametrize("dtype", ["int4", "flint4", "int8"])
def test_kernel_oracles_match_the_reference(dtype):
    rng = np.random.default_rng(4)
    u = (rng.standard_t(2, (6, 32)) * 4).astype(np.float32)
    a = rng.standard_normal((6, 32)).astype(np.float32)
    _, tw = _weight(dtype, (32, 24), seed=5)
    w = tw.data.numpy()
    packed = dtype != "int8"
    if packed:
        enc = tref.ovp_encode_ref(torch.from_numpy(u), dtype)
        assert np.array_equal(enc.numpy(), np.asarray(jax.jit(
            jref.ovp_encode_ref, static_argnums=1)(u, dtype)))
        a_codes = enc
    else:
        a_codes = tcore.ovp_encode_codes(torch.from_numpy(u), "int8")
    assert np.array_equal(
        tref.decode_packed(torch.from_numpy(w), dtype, 0).numpy(),
        np.asarray(jax.jit(jref.decode_packed, static_argnums=(1, 2))(
            jnp.asarray(w), dtype, 0)))
    w4a16 = jax.jit(jref.ovp_matmul_w4a16_ref, static_argnums=2)
    w4a4 = jax.jit(jref.ovp_matmul_w4a4_ref, static_argnums=2)
    pairs = [(tref.ovp_matmul_w4a16_ref(torch.from_numpy(a),
                                        torch.from_numpy(w), dtype),
              w4a16(jnp.asarray(a), jnp.asarray(w), dtype)),
             (tref.ovp_matmul_w4a4_ref(a_codes, torch.from_numpy(w), dtype),
              w4a4(jnp.asarray(a_codes.numpy()), jnp.asarray(w), dtype)),
             (tref.matmul_ref(torch.from_numpy(a), torch.from_numpy(a.T)),
              jref.matmul_ref(jnp.asarray(a), jnp.asarray(a.T)))]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------- helpers
def test_abfloat_helpers_match_the_reference():
    for name in ("E2M1_INT4", "E2M1_FLINT4", "E4M3_INT8"):
        assert dataclasses.astuple(getattr(tcore, name)) == \
            dataclasses.astuple(getattr(jdt, name))
    for dtype in ("int4", "flint4", "int8"):
        for ebits, mb in ((None, None), (3, None), (None, 2), (3, 0)):
            t = tcore.abfloat_spec_for(dtype, ebits, mb)
            j = jdt.abfloat_spec_for(dtype, ebits, mb)
            assert dataclasses.astuple(t) == dataclasses.astuple(j)
            assert t.bits == j.bits
            assert np.array_equal(t.magnitudes(), j.magnitudes())
            u = np.random.default_rng(mb or 0).standard_t(
                1, 4000).astype(np.float32) * 60
            assert np.array_equal(
                tcore.abfloat_nearest(torch.from_numpy(u), t).numpy(),
                np.asarray(jdt.abfloat_nearest(jnp.asarray(u), j)))


@pytest.mark.parametrize("pair_axis", [-1, 0])
def test_pair_statistics_match_the_reference(pair_axis):
    x = (np.random.default_rng(6).standard_t(3, (64, 96))).astype(np.float32)
    got = tcore.pair_statistics(torch.from_numpy(x), 2.5, pair_axis)
    want = jovp.pair_statistics(jnp.asarray(x), 2.5, pair_axis)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["int4", "flint4", "int8"])
def test_dequantize_nbytes_and_quantization_error(dtype):
    x = (np.random.default_rng(7).standard_t(3, (48, 32)) * 0.1) \
        .astype(np.float32)
    spec = dict(normal_dtype=dtype, granularity="channel", channel_axis=-1,
                pair_axis=-2)
    jqt = jq.quantize(jnp.asarray(x), jq.QuantSpec(**spec))
    tqt = tcore.quantize(torch.from_numpy(x), tcore.QuantSpec(**spec))
    assert tcore.QuantSpec(**spec).bits == jq.QuantSpec(**spec).bits
    assert np.array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    carried = params_from_numpy({"w": jqt}, device="cpu")["w"]
    assert np.array_equal(tcore.dequantize(carried).numpy(),
                          np.asarray(jq.dequantize(jqt)))
    assert tqt.nbytes() == carried.nbytes() == jqt.nbytes()
    mixed = quantize_params(
        {"experts": {"wg": torch.from_numpy(np.stack([x, -x, x]))}},
        tpol.PolicyProgram.from_policy(tpol.OLIVE_W4A4).with_rules(
            [("*experts/wg/1", tpol.FP)]), min_size=0)["experts"]["wg"]
    jmixed = jovp.MixedExpertQuant(
        groups=tuple(_to_jax(g) if isinstance(g, tcore.QuantizedTensor)
                     else jnp.asarray(g.numpy()) for g in mixed.groups),
        expert_ids=mixed.expert_ids, n_experts=mixed.n_experts)
    assert mixed.expert_ids == ((0, 2), (1,))
    assert mixed.nbytes() == jmixed.nbytes()
    got = tcore.quantization_error(torch.from_numpy(x),
                                   tcore.QuantSpec(**spec))
    want = jq.quantization_error(jnp.asarray(x), jq.QuantSpec(**spec))
    assert list(got) == list(want)
    assert (got["bytes"], got["fp32_bytes"]) == \
        (want["bytes"], want["fp32_bytes"])
    # the per-channel searches may pick scales an ulp apart (their 3σ
    # seeds sum in another order)
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=1e-6)
    for key in ("mse", "sqnr_db"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
