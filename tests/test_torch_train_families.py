"""The port's train-mode forward (`Model.forward(mode="train")`, via
`train_step.value_and_grad`) on the families beyond the dense decoder,
against `jax.value_and_grad` of the reference's `lm_loss` on shared
smoke weights (`_torch_parity.shared_weights`), fp32 compute, on the CPU, one
parametrized test over the MoE (`qwen3-moe-30b-a3b-smoke`: the Switch
load-balance loss of every block summed into `aux`, weighted 0.01 into
the loss), the hybrid (`recurrentgemma-9b-smoke`: RG-LRU and local
attention, differentiated through their torch ops), xLSTM
(`xlstm-350m-smoke`: the chunkwise mLSTM and the sLSTM loop), the VLM
(`internvl2-1b-smoke`, 5 patch embeddings in front of the tokens,
excluded from the loss) and the encoder-decoder
(`seamless-m4t-large-v2-smoke`, 12 frames through the encoder, cross
attention in every decoder block), split over two files for time:
`FAMILIES` holds the recurrent ones, `test_torch_train_archs.py` the
others. The loss, CE and aux to rtol 1e-6 (aux > 0 on the MoE only), and every gradient leaf at the tolerance of
`test_torch_train_step.py` (3e-5 of the leaf's largest gradient plus
1e-6 of the tree's).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config

from test_torch_train_step import _batch, check_loss_and_gradients

from _torch_dist import one_torch_thread  # noqa: F401

FAMILIES = ("recurrentgemma-9b-smoke", "xlstm-350m-smoke")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_family(arch):
    cfg = j_get_config(arch)
    batch = _batch(cfg.vocab)
    rng = np.random.default_rng(2)
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (2, 12, cfg.frontend_dim)).astype(np.float32)
    if cfg.frontend == "vit":
        batch["patch_embeds"] = rng.standard_normal(
            (2, 5, cfg.frontend_dim)).astype(np.float32)
    parts = check_loss_and_gradients(arch, "fp", batch)
    assert (float(parts["aux"]) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_forward_matches_reference(arch):
    check_family(arch)
