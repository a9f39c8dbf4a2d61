"""`examples_torch/ptq_calibrate.py`'s sensitivity pass and `auto_mixed`
row against the reference example's, on the bench-lm fixture (the
port's weights bit-equal to the reference's), the reference's eval
batches fed to both, on the CPU.

The reference ranks the sites of its scanned tree (`blocks/0/<leaf>`,
each a stack of the four layers) and serves the program on that tree;
the port ranks the same stacks and gives a promoted stack's rule to
each of its layers (`ptq_calibrate.unrolled_program`).

Tolerances: each site's W4 SQNR within 1e-3 dB; the three most
sensitive sites and the sites `auto_mixed` promotes identical; the
`olive_auto_w48` perplexity within rtol 1e-3.
"""
from __future__ import annotations

import jax
import pytest

from benchmarks import common
from examples_torch import fixture, ptq_calibrate
from repro.core.calibration import (auto_mixed, record_weights,
                                    site_sensitivity)
from repro.core.policy import QuantPolicy
from repro.core.qlinear import quantize_params
from repro.models.model import build_model
from repro_torch.core.qlinear import quantize_params as t_quantize_params
from repro_torch.models.model import build_model as t_build_model

from _torch_dist import one_torch_thread  # noqa: F401
from _torch_examples import RefBatches, fixtures


@pytest.fixture(scope="module")
def both():
    (jmodel, jparams, jloader), (model, params, _) = fixtures()
    w4 = QuantPolicy(method="olive", wbits=4, abits=0,
                     compute_dtype="float32")
    w8 = QuantPolicy(method="olive", wbits=8, abits=0,
                     w_normal_dtype="int8", compute_dtype="float32")
    sens = site_sensitivity(record_weights(jparams), "int4", n_grid=8)
    prog = auto_mixed(sens, budget_bits=5.0, low=w4, high=w8)
    model_am = build_model(jmodel.cfg, prog, remat=False)
    qp = jax.jit(quantize_params, static_argnums=1)(
        model_am.adapt_params(jparams), prog)
    want = {"sens": sens, "worst": sorted(sens, key=lambda k: sens[k])[:3],
            "promoted": [r.pattern for r in prog.rules
                         if r.origin != "compat"],
            "ppl": common.eval_ppl(model_am, qp, jloader)}
    got_sens, worst, promoted, tprog = ptq_calibrate.sensitivity(model,
                                                                 params)
    ppl = fixture.eval_ppl(t_build_model(model.cfg, tprog, remat=False),
                           t_quantize_params(params, tprog),
                           RefBatches(jloader))
    return want, {"sens": got_sens, "worst": worst, "promoted": promoted,
                  "ppl": ppl, "prog": tprog}


def test_site_sensitivity(both):
    want, got = both
    assert list(got["sens"]) == list(want["sens"])
    for site, db in want["sens"].items():
        assert abs(got["sens"][site] - db) <= 1e-3, site


def test_most_sensitive_sites_and_promoted_set(both):
    want, got = both
    assert got["worst"] == want["worst"]
    assert got["promoted"] == want["promoted"]
    assert got["promoted"]


def test_promoted_stack_reaches_every_layer(both):
    _, got = both
    prog, cfg = got["prog"], fixture._lm_cfg()
    for site in got["promoted"]:
        leaf = site.split("/", 2)[2]
        for i in range(cfg.n_layers):
            assert prog.resolve(f"layers/{i}/{leaf}") == ptq_calibrate.W8
    assert prog.resolve("layers/0/attn/wv") == ptq_calibrate.W4 or \
        "blocks/0/attn/wv" in got["promoted"]


def test_unrolled_program_maps_tail_and_period():
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.policy import PolicyProgram
    cfg = ArchConfig(name="t", family="hybrid", n_layers=5, d_model=8,
                     n_heads=1, n_kv_heads=1, d_ff=8, vocab=8, head_dim=8,
                     block_pattern=("attn", "rglru"))
    prog = PolicyProgram.from_policy(ptq_calibrate.W4).with_rules(
        [("blocks/1/rec/wx", ptq_calibrate.W8),
         ("tail/0/attn/wq", ptq_calibrate.W8)])
    pats = [r.pattern for r in ptq_calibrate.unrolled_program(prog, cfg)
            .rules if r.policy == ptq_calibrate.W8]
    assert pats == ["layers/1/rec/wx", "layers/3/rec/wx",
                    "layers/4/attn/wq"]


def test_auto_mixed_perplexity(both):
    want, got = both
    assert got["ppl"] == pytest.approx(want["ppl"], rel=1e-3)
