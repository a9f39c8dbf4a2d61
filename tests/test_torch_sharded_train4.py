"""Training on a (2, 2) mesh of 4 gloo ranks on the CPU
(`train_step.make_sharded_train_step`), against the port's one-device
step and the reference's `make_train_step` on the same weights, with
the tolerances of `_torch_train_cases.py`:

- dense `qwen1.5-0.5b-smoke`, dp_only (FSDP over all four ranks);
- the same under the TP rules (`make_rules` without a global batch:
  the batch over "data", weights over "model" and "data"), two
  microbatches (each rank takes its rows of each global microbatch)
  and a `loss_mask` (each rank divides by the whole microbatch's mask
  sum);
- MoE `qwen3-moe-30b-a3b-smoke` (8 experts top-2), dp_only: the
  load-balance loss takes its means over the whole batch
  (`layers._means_over_batch_ranks`), and capacity is per row, so the
  split drops the same tokens.

Measured on this tree: step-1 loss within 1.5e-7 relative, the worst
gradient leaf one bf16 step of the top binade (0.0078 of its max),
losses and norms within 8e-5 relative over 3 steps (1e-3 allowed).
"""
from __future__ import annotations

import pytest

import _torch_train_cases as tc
from _torch_dist import one_torch_thread  # noqa: F401

CASES = {"dense_fsdp": (tc.DENSE, (2, 2), True, 1, False, None),
         "dense_tp_mb2_mask": (tc.DENSE, (2, 2), False, 2, True, None),
         "moe_fsdp": (tc.MOE, (2, 2), True, 1, False, None)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tc.run_cases(4, CASES, tmp_path_factory.mktemp("train4"))


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
