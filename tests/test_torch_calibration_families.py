"""Static calibration (`calibrate_model`, `calibrate_streamed`) beyond the
dense decoder, against the reference, on shared smoke weights
(`_torch_parity.shared_weights`) and a sample cap of 1024 values a site,
below the sites' sizes, so the tape's shared generator draws:

- `recurrentgemma-9b-smoke` and `xlstm-350m-smoke` through
  `test_torch_calibration.py`'s `_calibrate_both`: the same sites in the
  same order, every scale within rtol 1e-5;
- `seamless-m4t-large-v2-smoke` (2 x 16 tokens and 12 frames): the
  reference scans its encoder (`jax.lax.scan`), so no `enc_blocks/`
  site reaches its tape, while the frontend projection (run before the
  scan), the decoder and the head do. The port's `calibrate_model`
  gives the reference's sites in its order and every scale within rtol
  1e-5; `calibrate_streamed`, drawing the same weights from the same
  seed one piece at a time (the encoder as one), gives that artifact's
  JSON byte for byte. Under `apply_calibration` an encoder site keeps
  the base policy.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import calibration as jcal
from repro.core import policy as jpol
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import calibration as tcal
from repro_torch.core import policy as tpol
from repro_torch.core.qlinear import quantize_params
from repro_torch.models.model import build_model as t_build_model

from _torch_parity import shared_weights
from test_torch_calibration import _assert_scales_match, _calibrate_both

from _torch_dist import one_torch_thread  # noqa: F401

CAP = 1024
ENCDEC = "seamless-m4t-large-v2-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b-smoke",
                                  "xlstm-350m-smoke"])
def test_calibrate_model_matches_reference(arch):
    jcfg = j_get_config(arch)
    batch = np.random.default_rng(0).integers(0, jcfg.vocab, size=(2, 16)) \
        .astype(np.int32)
    tart, jart, tape = _calibrate_both(
        jcfg, shared_weights(t_get_config(arch))[1], batch,
        max_per_site=CAP)
    _assert_scales_match(tart, jart, tape)


def test_encoder_decoder_calibration_matches_reference(tmp_path):
    cfg = t_get_config(ENCDEC)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    frames = rng.standard_normal((2, 12, cfg.frontend_dim)) \
        .astype(np.float32)
    tparams, jparams = shared_weights(cfg)
    jmodel = j_build_model(j_get_config(ENCDEC),
                           jpol.QuantPolicy(compute_dtype="float32"),
                           remat=False)
    jart = jcal.calibrate_model(jmodel, jparams, [
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}],
        max_per_site=CAP)
    policy = tpol.QuantPolicy(compute_dtype="float32")
    tmodel = t_build_model(cfg, policy)
    batch = {"tokens": torch.from_numpy(toks).to(torch.int64),
             "frames": torch.from_numpy(frames)}
    tape = tcal.ActTape(max_per_site=CAP)
    with tcal.collecting_activations(tape):
        tmodel.forward(tparams, batch)
    tart = tcal.calibrate_model(tmodel, tparams, [batch], max_per_site=CAP)
    _assert_scales_match(tart, jart, tape.samples)
    assert not [s for s in tart.sites() if s.startswith("enc_blocks/")]
    assert tart.sites()[0] == "frontend_proj/w_in"
    assert "layers/1/xattn/wq" in tart.sites()
    # streamed: the same weights drawn from the same seed, piece by piece
    _, sart = tcal.calibrate_streamed(
        tmodel, torch.Generator().manual_seed(0), [batch], "cpu",
        lambda tree, prefix: quantize_params(tree, policy, prefix=prefix),
        max_per_site=CAP)
    paths = [tmp_path / "whole.json", tmp_path / "streamed.json"]
    tart.save(str(paths[0]))
    sart.save(str(paths[1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    # the encoder keeps the base policy under the artifact
    served = tcal.apply_calibration(tpol.OLIVE_W4A4, tart)
    assert served.resolve("enc_blocks/attn/wq") == \
        tpol.OLIVE_W4A4.resolve("enc_blocks/attn/wq")
    assert served.resolve("layers/0/attn/wq").act_scale_mode == "static"
