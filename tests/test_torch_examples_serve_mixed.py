"""`examples_torch/serve_quantized.py` in `--mixed` mode against the
reference example's engines on the bench-lm fixture (the port's weights
bit-equal to the reference's; each package quantizes them under the
mode's policy), on the CPU, cut to `SERVE_REQUESTS` requests of
`SERVE_NEW` new tokens (the example serves 12 of 24).

Tolerance: none. The port's greedy tokens equal the reference's request
for request, as `tests/test_torch_engine.py` holds on this fixture; so
do the agreement rate and the verdict computed from them.
"""
from __future__ import annotations

import pytest

from _torch_dist import one_torch_thread  # noqa: F401
from _torch_examples import SERVE_NEW, SERVE_REQUESTS, agreement, ref_serve

MODES = ['mixed']


@pytest.fixture(scope="module")
def runs():
    return {mode: ref_serve(mode, with_fp=False) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_quantized_engine_tokens_identical(runs, mode):
    (_, want_q), got = runs[mode]
    assert got["outs_q"] == want_q
    assert len(got["outs_q"]) == SERVE_REQUESTS
    assert all(len(t) == SERVE_NEW for t in got["outs_q"].values())


@pytest.mark.parametrize("mode", MODES)
def test_agreement_and_verdict(runs, mode):
    (_, want_q), got = runs[mode]
    want = agreement(got["outs_fp"], want_q)
    assert got["agree"] == want
    assert got["ok"] == (want > 0.85)
