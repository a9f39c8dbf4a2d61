"""Training on a mesh of 2 gloo ranks on the CPU
(`train_step.make_sharded_train_step` over `sharding/state.py`'s
placement), against the port's one-device step and the reference's
`make_train_step` on the same weights, with the tolerances of
`_torch_train_cases.py`:

- dense `qwen1.5-0.5b-smoke`, dp_only (FSDP over both ranks) on (1, 2);
- xLSTM `xlstm-350m-smoke` on (1, 2): the TP rules (its sLSTM blocks
  keep them), weights over "model" and the batch replicated, so the
  gradients are not summed;
- the dense arch under W4A4 QAT (`olive_w4a4`, STE fake-quant of every
  linear's weight and activation), dp_only on (1, 2): an activation's
  per-tensor 3σ scale is the whole batch's (`qlinear._act_scale` sums
  over the batch ranks), as one device computes it.

Measured on this tree: step-1 loss within 1e-7 relative, the worst
gradient leaf one bf16 step of the top binade (0.00775 of its max; 0
for the xLSTM, whose ranks compute the same rows), losses and norms
within 9e-6 relative over 3 steps (1e-3 allowed); under W4A4 QAT the
grad norms within 3.6e-3 (1e-2 allowed). Every rank reports the same numbers and holds its part
of the state (`check_ranks`). 4 ranks: `test_torch_sharded_train4.py`.
"""
from __future__ import annotations

import pytest

import _torch_train_cases as tc
from _torch_dist import one_torch_thread  # noqa: F401

CASES = {"dense_fsdp": (tc.DENSE, (1, 2), True, 1, False, None),
         "xlstm_tp": (tc.XLSTM, (1, 2), False, 1, False, None),
         "dense_qat_w4a4_fsdp": (tc.DENSE, (1, 2), True, 1, False,
                                 "olive_w4a4")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tc.run_cases(2, CASES, tmp_path_factory.mktemp("train2"))


def _key(name):
    arch, _, _, nm, mask, quant = CASES[name]
    return arch, nm, mask, quant


@pytest.mark.parametrize("name", list(CASES))
def test_first_step_loss_matches_one_device(ranks, name):
    tc.check_first_step(ranks[0][name], *_key(name))


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_within_one_bf16_step(ranks, name):
    tc.check_gradients(ranks[0][name], *_key(name))


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_one_device_and_the_reference(ranks, name):
    tc.check_three_steps(ranks[0][name], *_key(name))


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree_and_hold_their_parts(ranks, name):
    tc.check_ranks([r[name] for r in ranks], CASES[name][0],
                   CASES[name][2])
