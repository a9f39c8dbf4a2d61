"""The port's xLSTM model (xLSTM-350M: alternating mLSTM and sLSTM blocks,
recurrent state only, no KV cache) against the JAX package, with the
reference's random init (`PRNGKey(0)`) and PTQ carried across
(`convert.params_from_numpy` unstacks the period-2 `blocks/<j>` stacks,
the 4-D stacked `r_z`, `r_i`, `r_f` among them, and the `tail` in the
reference's layer order).

- `xlstm-350m-smoke` (4 layers, two periods) and a 5-layer variant whose
  fifth layer, an mlstm, sits in the reference's `tail`, under
  `olive_serve` (W4 on every quantized linear; its KV4 has no cache to
  act on) and unquantized: the reference's `xla` backend against the
  port's `eager`, prefill of a 70-token prompt (one whole 64-token
  chunk and a ragged one of 6) + 13 decode steps fed the reference's
  greedy tokens (`_torch_parity`); atol 1e-4, the model tests'
  tolerance.
- The caches by block type: the nested mLSTM state ({mem: {c, n, m},
  conv}) and the sLSTM's ({mem: {c, n, m, h}}), `n` = 1 in a fresh
  sLSTM site, and no KV site under `kv_bits=4`.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jpol
from repro.core.qlinear import quantize_params as j_quantize_params
from repro.models.model import build_model as j_build_model
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.ovp import QuantizedTensor
from repro_torch.models import model as tmodel

from _torch_parity import jax_greedy, port_forced
from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "xlstm-350m-smoke"
B, T, MAX_LEN, STEPS = 2, 70, 96, 13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small torch ops: one intra-op thread (the suite's workers
    share the cores), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policies(quant: bool):
    if quant:       # the launcher's olive_serve: W4 + KV4
        jp = dataclasses.replace(jpol.OLIVE_SERVE, abits=0)
        tp = tpol.OLIVE_SERVE.replace_all(abits=0)
    else:
        jp, tp = jpol.QuantPolicy(), tpol.QuantPolicy()
    return (dataclasses.replace(jp, compute_dtype="float32", backend="xla"),
            dataclasses.replace(tp, compute_dtype="float32",
                                backend="eager"))


@functools.lru_cache(maxsize=None)
def _reference(n_layers: int, quant: bool):
    """The reference's smoke model at `n_layers`, its weights and (under
    olive_serve) its W4 PTQ."""
    jcfg = dataclasses.replace(j_get_config(ARCH), n_layers=n_layers)
    jp, _ = _policies(quant)
    model = j_build_model(jcfg, jp, remat=False)
    params = model.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant:
        params = jax.jit(j_quantize_params, static_argnums=1)(
            params, dataclasses.replace(jp, kv_bits=0))
    return jcfg, model, params


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _types(n_layers):
    return ["mlstm" if i % 2 == 0 else "slstm" for i in range(n_layers)]


@pytest.mark.parametrize("quant", [True, False], ids=["olive_serve", "fp32"])
@pytest.mark.parametrize("n_layers", [4, 5], ids=["smoke", "tail"])
def test_model_logits_match_reference(n_layers, quant):
    jcfg, model, params = _reference(n_layers, quant)
    assert bool(params["tail"]) == (n_layers == 5)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(B, T)).astype(np.int32)
    ref, fed = jax_greedy(model, params, toks, MAX_LEN, STEPS)
    _, tp = _policies(quant)
    tcfg = dataclasses.replace(t_get_config(ARCH), n_layers=n_layers)
    tparams = _port(params)
    layers = tparams["layers"]
    assert [sorted(layer) for layer in layers] == \
        [sorted(("ln1", btype)) for btype in _types(n_layers)]
    # the stacked (G, H, Dh, Dh) recurrent weights unstack to (H, Dh, Dh)
    for layer in layers[1::2]:
        assert layer["slstm"]["r_z"].shape == (4, 16, 16)
        assert isinstance(layer["slstm"]["mlp"]["wu2"], QuantizedTensor) \
            == quant
    for layer in layers[0::2]:
        assert isinstance(layer["mlstm"]["w_up"], QuantizedTensor) == quant
        assert not isinstance(layer["mlstm"]["w_igate"], QuantizedTensor)
    got = port_forced(tmodel.build_model(tcfg, tp), tparams, toks, fed,
                      MAX_LEN)
    assert got.shape == ref.shape == (B, STEPS + 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_caches_by_block_type():
    cfg = t_get_config(ARCH)
    model = tmodel.build_model(cfg, tpol.OLIVE_SERVE)
    assert model.policy.resolve("layers/0/attn/kv").kv_bits == 4
    layers = model.init_caches(2, 64, device="cpu")["layers"]
    assert [sorted(c) for c in layers] == [["mlstm"], ["slstm"]] * 2
    ml, sl = layers[0]["mlstm"], layers[1]["slstm"]
    assert sorted(ml) == ["conv", "mem"] and sorted(sl) == ["mem"]
    assert {k: tuple(v.shape) for k, v in ml["mem"].items()} == \
        {"c": (2, 4, 32, 32), "n": (2, 4, 32), "m": (2, 4)}
    assert ml["conv"].shape == (2, 3, 128)
    assert {k: tuple(v.shape) for k, v in sl["mem"].items()} == \
        dict.fromkeys("cnmh", (2, 64))
    assert torch.equal(sl["mem"]["n"], torch.ones(2, 64))
    assert all(float(v.abs().sum()) == 0 for k, v in sl["mem"].items()
               if k != "n")
    assert all(float(v.abs().sum()) == 0 for v in ml["mem"].values())
    # the reference's caches, leaf for leaf
    jcfg = j_get_config(ARCH)
    jm = j_build_model(jcfg, dataclasses.replace(jpol.OLIVE_SERVE,
                                                 backend="xla"))
    jc = jm.init_caches(2, 64, dtype=jnp.float32)
    ref = jax.tree_util.tree_map(np.asarray, jc)
    for i, layer in enumerate(layers):
        g, j = divmod(i, 2)
        site = jax.tree_util.tree_map(lambda x: x[g], ref["blocks"][str(j)])
        assert jax.tree_util.tree_structure(site) == \
            jax.tree_util.tree_structure(
                jax.tree_util.tree_map(lambda x: 0, layer))
        for a, b in zip(jax.tree_util.tree_leaves(layer),
                        jax.tree_util.tree_leaves(site)):
            np.testing.assert_array_equal(a.numpy(), b)
