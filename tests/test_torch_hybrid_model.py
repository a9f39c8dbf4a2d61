"""The port's hybrid model (RecurrentGemma: RG-LRU blocks and local
attention over a ring KV cache) against the JAX package, with the
reference's random init (`PRNGKey(0)`) and PTQ carried across
(`convert.params_from_numpy` unstacks the period-3 `blocks/<j>` stacks
and the `tail` in the reference's layer order).

- `recurrentgemma-9b-smoke` (6 layers, two periods, window 8) and a
  5-layer variant whose 2 rglru layers past one period sit in the
  reference's `tail`, under `olive_serve` (W4 + KV4, fp32 compute) and
  unquantized: the reference's `xla` backend against the port's `eager`,
  prefill of an 11-token prompt (past the 8-slot ring) + 13 decode steps
  fed the reference's greedy tokens (`_torch_parity`), so the ring wraps
  again; atol 1e-4, the model tests' tolerance.
- The caches by block type: the recurrent state of an rglru site, and a
  local-attention KV cache of min(window, max_len) slots.
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
from repro_torch.models import model as tmodel

from _torch_parity import jax_greedy, port_forced
from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-9b-smoke"
B, T, MAX_LEN, STEPS = 2, 11, 32, 13


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


@pytest.mark.parametrize("quant", [True, False], ids=["olive_serve", "fp32"])
@pytest.mark.parametrize("n_layers", [6, 5], ids=["smoke", "tail"])
def test_model_logits_match_reference(n_layers, quant):
    jcfg, model, params = _reference(n_layers, quant)
    assert bool(params["tail"]) == (n_layers == 5)
    toks = np.random.default_rng(7).integers(
        0, jcfg.vocab, size=(B, T)).astype(np.int32)
    ref, fed = jax_greedy(model, params, toks, MAX_LEN, STEPS)
    _, tp = _policies(quant)
    tcfg = dataclasses.replace(t_get_config(ARCH), n_layers=n_layers)
    tparams = _port(params)
    types = [sorted(layer) for layer in tparams["layers"]]
    assert types == [sorted(("ln1", "rec" if i % 3 < 2 else "attn", "ln2",
                             "mlp")) for i in range(n_layers)]
    got = port_forced(tmodel.build_model(tcfg, tp), tparams, toks, fed,
                      MAX_LEN)
    assert got.shape == ref.shape == (B, STEPS + 1, jcfg.padded_vocab)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_caches_by_block_type():
    cfg = t_get_config(ARCH)
    model = tmodel.build_model(cfg, tpol.OLIVE_SERVE)
    layers = model.init_caches(2, 64, device="cpu")["layers"]
    assert [sorted(c) for c in layers] == [["rec"], ["rec"], ["kv"]] * 2
    assert layers[0]["rec"]["h"].shape == (2, 64)
    assert layers[0]["rec"]["conv"].shape == (2, 3, 64)
    assert layers[2]["kv"]["k_data"].shape == (2, 8, 1, 8)     # the ring
    short = model.init_caches(1, 6, device="cpu")["layers"][2]["kv"]
    assert short["k_data"].shape[1] == 6                      # no ring
