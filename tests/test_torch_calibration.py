"""Static calibration in the port against the JAX package: the activation
tape, the artifact's JSON both ways, glob resolution, the calibrated
program's per-site policies, and `calibrate_model`'s scales.

Scales are compared at rtol 1e-5: both sides tape the same tensors in the
same order with the same numpy generator, so they search the same
samples up to the fp32 rounding of the forward pass (~1e-7 relative); a
larger difference can only be a different MSE argmin, which the test
prints (the two candidates' MSEs) before it fails.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import calibration as jcal
from repro.core import policy as jpol
from repro.models.model import build_model as j_build_model
from repro_torch.configs.base import ArchConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import ovp_fake_quant
from repro_torch.models.model import build_model as t_build_model

from _torch_dist import one_torch_thread  # noqa: F401

TINY = JArchConfig(name="cal-tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                   head_dim=16, block_pattern=("attn",))


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                         if k in fields})


def test_tape_samples_identical():
    """The same arrays recorded in the same order give identical samples;
    sizes above `max_per_site` draw from the shared generator, and a
    repeated site concatenates then redraws."""
    rng = np.random.default_rng(5)
    seq = [("a", (3, 100)), ("b", (2, 700)), ("a", (900,)), ("c", (4, 4)),
           ("b", (1500,)), ("a", (10,))]
    jt, tt = jcal.ActTape(max_per_site=1000, seed=3), \
        tcal.ActTape(max_per_site=1000, seed=3)
    for name, shape in seq:
        x = rng.standard_normal(shape).astype(np.float32)
        jt.record(name, jnp.asarray(x))
        tt.record(name, torch.from_numpy(x))
    assert list(tt.samples) == list(jt.samples)
    for name in jt.samples:
        assert np.array_equal(tt.samples[name], np.asarray(jt.samples[name]))
    assert tt.samples["b"].size == 1000


def test_run_calibration_matches_reference():
    """The callback form: the activations an `apply_collect` returns are
    taped and searched as in the reference."""
    rng = np.random.default_rng(8)
    batches = [{"a": rng.standard_normal((3, 40)).astype(np.float32),
                "b": (rng.standard_t(2, (5, 16)) * 2).astype(np.float32)}
               for _ in range(2)]

    def collect(conv):
        return lambda params, batch: (None, {k: conv(v)
                                             for k, v in batch.items()})

    want = jcal.run_calibration(collect(jnp.asarray), None, batches,
                                max_per_site=100)
    got = tcal.run_calibration(collect(torch.from_numpy), None, batches,
                               max_per_site=100)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


ARTIFACT_SCALES = {"layers/0/attn/wq": 0.25, "layers/*/mlp/w*": 0.5,
                   "layers/1/*": 0.125, "*": 1.5,
                   "lm_head/w_out": 0.0078125}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_artifact_json_interchangeable(direction, tmp_path):
    kw = dict(normal_dtype="int4", program="QuantPolicy", n_batches=1,
              max_per_site=65536)
    jart = jcal.CalibrationArtifact.from_scales(ARTIFACT_SCALES, **kw)
    tart = tcal.CalibrationArtifact.from_scales(ARTIFACT_SCALES, **kw)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jart.save(jpath)
    tart.save(tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()          # byte-compatible files
    if direction == "jax_to_port":
        got, want = tcal.CalibrationArtifact.load(jpath), jart
    else:
        got, want = jcal.CalibrationArtifact.load(tpath), tart
    assert got.as_dict() == want.as_dict()
    assert list(got.as_dict()) == list(ARTIFACT_SCALES)   # author order
    assert (got.normal_dtype, got.program, got.meta) == \
        (want.normal_dtype, want.program, want.meta)


def test_artifact_load_rejects_non_artifact(tmp_path):
    p = tmp_path / "x.json"
    p.write_text('{"scales": {"a": 1.0}}')
    with pytest.raises(ValueError, match="not a calibration artifact"):
        tcal.CalibrationArtifact.load(str(p))


SITES = ["layers/0/attn/wq", "layers/0/attn/wk", "layers/1/attn/wq",
         "layers/3/mlp/wd", "layers/1/mlp/wg", "LAYERS/0/MLP/WU",
         "lm_head/w_out", "embed/table", "layers/7/attn/kv"]


def test_resolve_exact_glob_and_overlap():
    """Exact keys, glob keys and overlapping globs (first match wins)
    resolve as in the reference, on a full artifact and on one without
    the catch-all."""
    for scales in (ARTIFACT_SCALES,
                   {k: v for k, v in ARTIFACT_SCALES.items() if k != "*"}):
        jart = jcal.CalibrationArtifact.from_scales(scales)
        tart = tcal.CalibrationArtifact.from_scales(scales)
        assert [tart.resolve(s) for s in SITES] == \
            [jart.resolve(s) for s in SITES]
    assert tart.resolve("layers/1/mlp/wg") == 0.5      # earlier glob wins
    assert tart.resolve("embed/table") is None


def _fields(pol):
    """The port's QuantPolicy fields, read from either package's policy
    (the default backend names differ by design)."""
    return {f.name: getattr(pol, f.name)
            for f in dataclasses.fields(tpol.QuantPolicy)
            if f.name != "backend"}


def test_apply_calibration_resolves_like_reference():
    """Per-site policies of the calibrated program (one artifact, then a
    second stacked in front) carry the reference's fields."""
    kw = dict(method="olive", wbits=4, abits=4, act_scale_mode="static",
              compute_dtype="float32")
    jp, tp = jpol.QuantPolicy(**kw), tpol.QuantPolicy(**kw)
    art2 = {"layers/0/*": 2.0}
    jprog = jcal.apply_calibration(jp, jcal.CalibrationArtifact.from_scales(
        {k: v for k, v in ARTIFACT_SCALES.items() if k != "*"}))
    tprog = tcal.apply_calibration(tp, tcal.CalibrationArtifact.from_scales(
        {k: v for k, v in ARTIFACT_SCALES.items() if k != "*"}))
    for jprog_, tprog_ in ((jprog, tprog),
                           (jcal.apply_calibration(
                               jprog,
                               jcal.CalibrationArtifact.from_scales(art2)),
                            tcal.apply_calibration(
                                tprog,
                                tcal.CalibrationArtifact.from_scales(art2)))):
        for site in SITES:
            assert _fields(tprog_.resolve(site)) == \
                _fields(jprog_.resolve(site)), site
    # the overlay survives the engine's backend override
    assert tprog.with_backend("eager").resolve(
        "layers/0/attn/wq").static_act_scale == 0.25
    assert tcal.uses_static_scales(tprog)
    assert not tcal.uses_static_scales(tpol.OLIVE_W4A4)


def _mse(sample, scale):
    x = torch.as_tensor(sample[: sample.size - sample.size % 2])
    return float(((ovp_fake_quant(x, scale, "int4") - x) ** 2).mean())


def _assert_scales_match(tart, jart, tape):
    assert tart.sites() == jart.sites()
    bad = []
    for site in jart.sites():
        want, got = jart.resolve(site), tart.resolve(site)
        if abs(got - want) > 1e-5 * abs(want):
            bad.append(site)
            print(f"{site}: port {got!r} (MSE {_mse(tape[site], got):.9e}) "
                  f"vs reference {want!r} (MSE "
                  f"{_mse(tape[site], want):.9e})")
    assert not bad, f"scales outside rtol 1e-5 at {bad}"


def _calibrate_both(jcfg, jparams, batch_np, **kw):
    """calibrate_model on both packages from the same weights and batch;
    returns (port artifact, reference artifact, port tape samples)."""
    jmodel = j_build_model(jcfg, jpol.QuantPolicy(compute_dtype="float32"),
                           remat=False)
    jart = jcal.calibrate_model(jmodel, jparams,
                                [{"tokens": jnp.asarray(batch_np)}], **kw)
    tmodel = t_build_model(_port_cfg(jcfg),
                           tpol.QuantPolicy(compute_dtype="float32"))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tape = tcal.ActTape(max_per_site=kw.get("max_per_site", 65536))
    with tcal.collecting_activations(tape):
        tmodel.forward(tparams, {"tokens": torch.from_numpy(batch_np)})
    tart = tcal.calibrate_model(tmodel, tparams,
                                [{"tokens": torch.from_numpy(batch_np)}],
                                **kw)
    return tart, jart, tape.samples


def test_calibrate_model_tiny_matches_reference():
    """TINY, with a sample cap below the sites' sizes so the shared
    generator draws: same sites in the same order, scales within rtol
    1e-5, same provenance."""
    jmodel = j_build_model(TINY, jpol.QuantPolicy(compute_dtype="float32"),
                           remat=False)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = np.random.default_rng(0).integers(0, TINY.vocab, size=(2, 16)) \
        .astype(np.int32)
    tart, jart, tape = _calibrate_both(TINY, jparams, batch,
                                       max_per_site=1024)
    _assert_scales_match(tart, jart, tape)
    assert (tart.normal_dtype, tart.program, tart.meta) == \
        (jart.normal_dtype, jart.program, jart.meta)
    assert "lm_head/w_out" in tart.sites()        # the head is taped too


def test_calibrate_model_bench_lm_matches_reference():
    """The committed bench-lm fixture (4 layers, GQA 4/2), one (2, 64)
    batch drawn as the launcher draws it, the launcher's defaults."""
    _, params, _ = common.trained_lm(steps=30)
    cfg = common._lm_cfg()
    batch = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 64)) \
        .astype(np.int32)
    tart, jart, tape = _calibrate_both(cfg, params, batch)
    assert len(tart.sites()) == 4 * 7 + 1
    _assert_scales_match(tart, jart, tape)
