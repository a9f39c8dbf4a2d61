"""The train-mode forward of `test_torch_train_families.py` (which says
what is held and at what tolerance) on the MoE, the VLM and the
encoder-decoder smoke configs."""
from __future__ import annotations

import pytest
import torch

from test_torch_train_families import check_family

from _torch_dist import one_torch_thread  # noqa: F401

ARCHS = ("qwen3-moe-30b-a3b-smoke", "internvl2-1b-smoke",
         "seamless-m4t-large-v2-smoke")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_reference(arch):
    check_family(arch)
