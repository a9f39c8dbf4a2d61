"""The baseline presets on the MoE stack (`qwen3-moe-30b-a3b-smoke`, 8
experts top-2), the pattern of `test_torch_baselines.py`: the
launcher's rewrite (fp32 compute, `abits=0`), the reference's smoke
weights carried by `convert`, on the CPU.

- `int8` and `int4`: every leaf of the reference's PTQ of the whole
  tree (op by op, as its launcher runs it) bit for bit, each expert
  stack fake-quantized over its stack of layers at one scale; then
  prefill + 3 greedy decode steps, logits within atol 1e-5 through
  `_torch_parity`'s shared loop (measured 2.8e-06 before this test was
  written).
- `ant4`: the expert stacks bit for bit against the reference's
  `ant_fake_quant` of its stacked leaves (the tree walk is `int4`'s).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tpol
from repro_torch.core import qlinear as tq
from repro_torch.models.model import build_model as t_build_model

from _torch_parity import jax_greedy, port_forced
from test_torch_baselines_families import (_assert_leaves_equal, _policy,
                                           _reference_raw, _to_port)

from _torch_dist import one_torch_thread  # noqa: F401

MOE = "qwen3-moe-30b-a3b-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("quant", ("int8", "int4"))
def test_moe_presets_match_reference(quant):
    jcfg, raw = _reference_raw(MOE, 0)
    jp, tp = _policy(jpol, quant), _policy(tpol, quant)
    jq = j_quantize_params(raw, jp)
    got = tq.quantize_params(_to_port(raw), tp)
    _assert_leaves_equal(got, _to_port(jq))
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(2, 8)).astype(np.int32)
    want, fed = jax_greedy(j_build_model(jcfg, jp, remat=False), jq, toks,
                           32, 3)
    out = port_forced(t_build_model(t_get_config(MOE), tp), got, toks, fed,
                      32)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


def test_moe_ant4_expert_stacks_match_reference():
    _, raw = _reference_raw(MOE, 0)
    got = tq.quantize_params(_to_port(raw), _policy(tpol, "ant4"))
    for leaf in ("wg", "wu", "wd"):
        want = np.asarray(jb.ant_fake_quant(
            raw["blocks"]["0"]["moe"]["experts"][leaf]))
        for i, layer in enumerate(got["layers"]):
            np.testing.assert_array_equal(
                layer["moe"]["experts"][leaf].numpy(), want[i],
                err_msg=f"layers/{i}/moe/experts/{leaf}")
