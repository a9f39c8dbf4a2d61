"""The baseline presets (`--quant int8`, `int4`, `ant4`) on mixed block
patterns, against the reference, on the CPU: the hybrid
(`recurrentgemma-9b-smoke` cut to 8 layers: 2 periods of (rglru,
rglru, local_attn) and a `tail` of 2) and xLSTM (`xlstm-350m-smoke`: 2
periods of (mlstm, slstm)). The reference fake-quantizes each
`blocks/<j>` site over its stack of periods at one scale and each
`tail` layer alone. The port's `quantize_params(...,
period=len(block_pattern))` of the unrolled tree gives:

- under `int4`, every leaf of the reference's PTQ of the whole tree bit
  for bit (run op by op, as its launcher runs it);
- under `int8` and `ant4`, whose searches cost most op by op, the
  leaves of one period-position stack and of one tail layer bit for bit
  against the reference's fake-quant (`uniform_int_fake_quant` at 8
  bits, `ant_fake_quant`) of its stacked leaf and of its tail leaf (the
  tree walk is `int4`'s; the baselines themselves are held bit for bit
  in `test_torch_baselines.py`).

A baseline over a period of the wrong length raises, naming the period.
The MoE presets are `test_torch_baselines_moe.py`'s.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import baselines as jb
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import qlinear as tq

from _torch_parity import shared_weights
from _torch_dist import one_torch_thread  # noqa: F401

CUTS = [("recurrentgemma-9b-smoke", 8), ("xlstm-350m-smoke", 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(mod, quant):
    """The launcher's rewrite of a flat preset."""
    return mod.get_policy(quant).replace_all(compute_dtype="float32",
                                             abits=0)


def _cut(cfg, n_layers):
    return dataclasses.replace(cfg, n_layers=n_layers) if n_layers else cfg


@functools.lru_cache(maxsize=None)
def _reference_raw(arch, n_layers):
    """(reference config, raw weights in its scanned layout), the
    weights the port draws (`_torch_parity.shared_weights`)."""
    jcfg = _cut(j_get_config(arch), n_layers)
    assert not j_build_model(jcfg, _policy(jpol, "int4"),
                             remat=False).unrolled
    return jcfg, shared_weights(_cut(t_get_config(arch), n_layers))[1]


def _to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _assert_leaves_equal(got, ref):
    got, ref = dict(tq.tree_paths(got)), dict(tq.tree_paths(ref))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        np.testing.assert_array_equal(got[path].numpy(), leaf.numpy(),
                                      err_msg=path)


@pytest.mark.parametrize("arch,n_layers", CUTS, ids=["rg-8-tail", "xlstm-4"])
def test_mixed_pattern_leaves_match_reference(arch, n_layers):
    jcfg, raw = _reference_raw(arch, n_layers)
    jq = j_quantize_params(raw, _policy(jpol, "int4"))
    tp = _policy(tpol, "int4")
    assert tq.stacks_layers(tp, jcfg.n_layers)
    got = tq.quantize_params(_to_port(raw), tp,
                             period=len(jcfg.block_pattern))
    _assert_leaves_equal(got, _to_port(jq))
    n_fake = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(
        tq.tree_paths(got), tq.tree_paths(_to_port(raw))))
    assert n_fake >= 5 * jcfg.n_layers


FAKE_QUANT = {"int8": lambda w: jb.uniform_int_fake_quant(w, 8),
              "ant4": jb.ant_fake_quant}


@pytest.mark.parametrize("quant", ("int8", "ant4"))
@pytest.mark.parametrize("arch,n_layers,stack_leaf,tail_leaf", [
    ("recurrentgemma-9b-smoke", 8, "2/attn/wq", "1/rec/w_rec_gate"),
    ("xlstm-350m-smoke", 0, "1/slstm/wz", None)], ids=["rg-8-tail",
                                                    "xlstm-4"])
def test_stacks_match_reference(arch, n_layers, stack_leaf, tail_leaf,
                                quant):
    jcfg, raw = _reference_raw(arch, n_layers)
    period = len(jcfg.block_pattern)
    got = tq.quantize_params(_to_port(raw), _policy(tpol, quant),
                             period=period)
    fake = FAKE_QUANT[quant]
    j, rel = stack_leaf.split("/", 1)
    want = fake(tq._leaf(raw["blocks"][j], rel))
    for g in range(want.shape[0]):
        np.testing.assert_array_equal(
            tq._leaf(got["layers"][g * period + int(j)], rel).numpy(),
            np.asarray(want[g]))
    if tail_leaf:
        j, rel = tail_leaf.split("/", 1)
        np.testing.assert_array_equal(
            tq._leaf(got["layers"][len(raw["blocks"]["0"]["ln1"]
                                       ["gamma_scale"]) * period + int(j)],
                     rel).numpy(),
            np.asarray(fake(tq._leaf(raw["tail"][int(j)], rel))))


def test_wrong_period_raises():
    _, raw = _reference_raw("xlstm-350m-smoke", 0)
    with pytest.raises(ValueError, match="period"):
        tq.quantize_params(_to_port(raw), _policy(tpol, "int4"), period=1)
