"""Static serving in the port against the JAX package: the static
W4A4 + KV4 engine on the committed `bench_lm_30.npz` fixture with the
reference's calibration artifact loaded from its JSON, and the engine's
up-front static-scale validation.

Both engines serve the same quantized weights (the reference's PTQ of
the unrolled tree, carried across). xla (reference) against eager
(port): greedy tokens must be identical, as for the dynamic engines.
pallas_interpret (reference) against cuda (port, plain versions on the
CPU): prefill and one decode step's logits within atol 1e-4, the
tolerance of tests/test_torch_model.py: fp32 summation order through
every layer, with the inputs of every rounding decision agreeing to
~1e-7 relative at identical static scales.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common
from repro.core import calibration as jcal
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro.serve import engine as jeng
from repro_torch import backends as tbackends
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.models.model import build_model as t_build_model
from repro_torch.serve import engine as teng

from _torch_dist import one_torch_thread  # noqa: F401

SLOTS, MAX_LEN, N_REQ, MAX_NEW = 4, 64, 6, 8
STATIC = dict(compute_dtype="float32", act_scale_mode="static")


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                         if k in fields})


@functools.lru_cache(maxsize=None)
def _fixture(tmp_dir):
    """bench-lm: the reference's artifact saved to JSON, its static
    W4A4 + KV4 program, unrolled model and quantized tree."""
    jcfg = common._lm_cfg()
    _, params, _ = common.trained_lm(steps=30)
    batch = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 64)) \
        .astype(np.int32)
    jfp = j_build_model(jcfg, jpol.QuantPolicy(compute_dtype="float32"),
                        remat=False)
    path = jcal.calibrate_model(jfp, params, [{"tokens": jnp.asarray(batch)}]
                                ).save(f"{tmp_dir}/bench_lm_calib.json")
    jflat = dataclasses.replace(jpol.OLIVE_SERVE, **STATIC)
    jprog = jcal.apply_calibration(jflat, jcal.CalibrationArtifact.load(path))
    jmodel = j_build_model(jcfg, jprog, remat=False)
    qparams = jax.jit(j_quantize_params, static_argnums=1)(
        jmodel.adapt_params(params), dataclasses.replace(jflat, kv_bits=0))
    return jcfg, path, jprog, jmodel, qparams


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    return _fixture(str(tmp_path_factory.mktemp("calib")))


def _port_engine(jcfg, qparams, path, backend):
    tflat = dataclasses.replace(tpol.OLIVE_SERVE, **STATIC)
    return teng.ServingEngine(
        t_build_model(_port_cfg(jcfg), tflat),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                          device="cpu"),
        teng.EngineCfg(batch_slots=SLOTS, max_len=MAX_LEN, backend=backend,
                       calibration=tcal.CalibrationArtifact.load(path)),
        device="cpu")


def _serve(eng, vocab):
    rng = np.random.default_rng(0)
    for _ in range(N_REQ):
        eng.submit(rng.integers(0, vocab, size=int(rng.integers(4, 25)))
                   .astype(np.int32), max_new_tokens=MAX_NEW)
    return {r.uid: (list(r.out_tokens), r.finish_reason)
            for r in eng.run_until_drained()}


def test_static_engine_tokens_identical_xla_eager(fixture):
    """The reference's xla engine and the port's eager engine on the same
    artifact give the same greedy tokens; the port resolves every
    activation scale statically."""
    jcfg, path, _, jmodel, qparams = fixture
    ref = _serve(jeng.ServingEngine(jmodel, qparams, jeng.EngineCfg(
        batch_slots=SLOTS, max_len=MAX_LEN)), jcfg.vocab)
    tbackends.reset_act_scale_stats()
    got = _serve(_port_engine(jcfg, qparams, path, "eager"), jcfg.vocab)
    assert got == ref
    assert all(len(toks) == MAX_NEW for toks, _ in got.values())
    stats = tbackends.act_scale_stats()
    assert stats.get("dynamic", 0) == 0 and stats["static"] > 0


def test_static_logits_cuda_plain_vs_pallas_interpret(fixture):
    """Prefill and one greedy decode step of the static program: the
    port's cuda backend (K5's plain version) against the reference's
    pallas_interpret backend (its static kernel)."""
    jcfg, path, jprog, _, qparams = fixture
    jm = j_build_model(jcfg, jprog.with_backend("pallas_interpret"),
                       remat=False)
    tprog = tcal.apply_calibration(
        dataclasses.replace(tpol.OLIVE_SERVE, **STATIC),
        tcal.CalibrationArtifact.load(path))
    tm = t_build_model(_port_cfg(jcfg), tprog)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                                device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, size=(2, 8)) \
        .astype(np.int32)
    prefill = jax.jit(lambda p, c, t: jm.forward(
        p, {"tokens": t}, mode="prefill", caches=c)[:2])
    decode = jax.jit(lambda p, c, t, pos: jm.forward(
        p, {"tokens": t, "pos": pos}, mode="decode", caches=c)[:2])
    jlog, jc = prefill(qparams, jm.init_caches(2, 16, dtype=jnp.float32),
                       jnp.asarray(toks))
    tlog, tc = tm.forward(tparams, {"tokens": torch.from_numpy(toks).long()},
                          mode="prefill",
                          caches=tm.init_caches(2, 16, device="cpu"))
    np.testing.assert_allclose(tlog[:, -1].numpy(), np.asarray(jlog[:, -1]),
                               rtol=0, atol=1e-4)
    nxt = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    jlog, _ = decode(qparams, jc, jnp.asarray(nxt), jnp.full((2,), 8,
                                                             jnp.int32))
    tlog, _ = tm.forward(tparams, {"tokens": torch.from_numpy(nxt).long(),
                                   "pos": torch.full((2,), 8)},
                         mode="decode", caches=tc)
    np.testing.assert_allclose(tlog[:, 0].numpy(), np.asarray(jlog[:, 0]),
                               rtol=0, atol=1e-4)


def test_engine_lists_every_missing_site(fixture):
    """An artifact without layer 1's scales fails at
    engine construction, listing every missing site as the reference's
    `static_scale_misses` does, in the reference's message format."""
    jcfg, path, _, _, qparams = fixture
    full = tcal.CalibrationArtifact.load(path)
    part = tcal.CalibrationArtifact(
        scales=tuple((k, v) for k, v in full.scales
                     if not k.startswith("layers/1/")))
    jpart = jcal.CalibrationArtifact(scales=part.scales)
    jflat = dataclasses.replace(jpol.OLIVE_SERVE, **STATIC)
    want = jcal.static_scale_misses(
        qparams, jcal.apply_calibration(jflat, jpart))
    assert len(want) == 7
    tflat = dataclasses.replace(tpol.OLIVE_SERVE, **STATIC)
    with pytest.raises(tcal.MissingStaticScaleError) as err:
        teng.ServingEngine(
            t_build_model(_port_cfg(jcfg), tflat),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, qparams),
                              device="cpu"),
            teng.EngineCfg(batch_slots=SLOTS, max_len=MAX_LEN,
                           calibration=part), device="cpu")
    assert err.value.sites == sorted(want)
    assert str(err.value) == f"missing_static_scale sites={sorted(want)}"
