"""`examples_torch/ptq_calibrate.py`'s calibration and PTQ rows against
the reference example's steps, on the bench-lm fixture (the port's
weights bit-equal to the reference's), the reference's batches fed to
both, on the CPU.

Tolerances: the calibrated static scales within rtol 1e-5; the fp32
perplexity within rtol 1e-5; the quantized rows (W4A4 with dynamic
scales, W4, the int4 baseline) within rtol 1e-3; the same OK/DEGRADED
verdict (DEGRADED in both on the committed 30-step weights). The
reference's W4A4 row serves its W4 PTQ's weights, which `abits` does not
change, so one PTQ serves both rows.
"""
from __future__ import annotations

import jax
import pytest

from benchmarks import common
from examples_torch import ptq_calibrate
from repro.core.calibration import ActTape, calibrate_activation_scales
from repro.core.policy import QuantPolicy
from repro.core.qlinear import quantize_params
from repro.models.model import build_model

from _torch_dist import one_torch_thread  # noqa: F401
from _torch_examples import RefBatches, fixtures

J_POLICIES = {
    "olive_w4a4_dyn": QuantPolicy(method="olive", wbits=4, abits=4,
                                  compute_dtype="float32"),
    "olive_w4": QuantPolicy(method="olive", wbits=4, abits=0,
                            compute_dtype="float32"),
    "int4_w4": QuantPolicy(method="int", wbits=4, abits=0,
                           compute_dtype="float32"),
}


@pytest.fixture(scope="module")
def both():
    (jmodel, jparams, jloader), (model, params, _) = fixtures()
    tape = ActTape(max_per_site=32768)
    batch = jloader.batch_at(0)
    logits, _, _ = jmodel.forward(jparams, batch, mode="train")
    tape.record("embed_out", jparams["embed"]["table"][batch["tokens"]])
    tape.record("head_in", logits[..., :64])
    scales = {k: float(v) for k, v in
              calibrate_activation_scales(tape, "int4").items()}
    rows = {"fp32": common.eval_ppl(jmodel, jparams, jloader)}
    quant = jax.jit(quantize_params, static_argnums=1)
    w4 = quant(jparams, J_POLICIES["olive_w4"])
    for tag, pol in J_POLICIES.items():
        # W4A4's weights are the W4 PTQ's (abits leaves the weights be)
        qp = w4 if pol.method == "olive" else quant(jparams, pol)
        rows[tag] = common.eval_ppl(build_model(jmodel.cfg, pol,
                                                remat=False), qp, jloader)
    loader = RefBatches(jloader)
    got = (ptq_calibrate.calibrate(model, params, loader),
           ptq_calibrate.quantized_rows(model, params, loader))
    return (scales, rows), got


def test_policies_are_the_reference_examples():
    assert [t for t, _ in ptq_calibrate.POLICIES] == list(J_POLICIES)
    for tag, pol in ptq_calibrate.POLICIES:
        want = J_POLICIES[tag]
        assert (pol.method, pol.wbits, pol.abits, pol.w_normal_dtype,
                pol.compute_dtype) == (want.method, want.wbits, want.abits,
                                       want.w_normal_dtype,
                                       want.compute_dtype)


def test_calibrated_scales(both):
    (want, _), (got, _) = both
    assert list(got) == list(want) == ["embed_out", "head_in"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("tag", ["fp32", *J_POLICIES])
def test_perplexity_rows(both, tag):
    (_, want), (_, got) = both
    rtol = 1e-5 if tag == "fp32" else 1e-3
    assert got[tag] == pytest.approx(want[tag], rel=rtol)


def test_same_verdict(both):
    (_, want), (_, got) = both
    ok = want["olive_w4a4_dyn"] < want["int4_w4"] * 1.02 \
        and want["olive_w4"] / want["fp32"] < 1.05
    assert ptq_calibrate.verdict(got) == ok
