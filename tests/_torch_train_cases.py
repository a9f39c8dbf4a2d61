"""The cases the sharded-training tests share (`test_torch_sharded_train
*.py`): each case's batch, the port's one-device step and the
reference's `make_train_step` on the same weights
(`_torch_parity.shared_weights`: drawn by the port, fp32 compute, AdamW
lr 1e-3 with fp32 moments), and the checks that hold a mesh's results
(`_torch_dist.train_sharded`, rank 0's) to them. Tolerances:

- step-1 loss, rtol 1e-5;
- every gradient leaf, gathered whole, max |difference| <= 2^-7 of the
  leaf's max |g| against one device's gradient cast to bf16 (a rank
  casts its part to bf16 before the rank-order sum, one device casts
  the whole sum once: one bf16 step of the top binade at most);
- loss and grad norm over 3 steps, rtol 1e-3; under W4A4 QAT the grad
  norm rtol 1e-2.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.core.policy import get_policy as j_get_policy
from repro.models.model import build_model as j_build_model
from repro.optim.adamw import AdamW as JAdamW
from repro.train import train_step as jts
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.roofline.step_stats import tree_bytes
from repro_torch.sharding import state as placement
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          value_and_grad)

from _torch_dist import spawn, train_policy
from _torch_parity import shared_weights

DENSE = "qwen1.5-0.5b-smoke"
MOE = "qwen3-moe-30b-a3b-smoke"
XLSTM = "xlstm-350m-smoke"
ROWS, SEQ, STEPS = 4, 16, 3


def batch(arch, mask=False, seed=0):
    cfg = get_config(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (ROWS, SEQ)),
           "labels": rng.integers(0, cfg.vocab, (ROWS, SEQ))}
    if mask:
        out["loss_mask"] = (rng.random((ROWS, SEQ)) < 0.7).astype(
            np.float32)
    return out


def run_cases(world, cases, tmp):
    """cases: {name: (arch, mesh shape, dp_only, microbatches,
    loss_mask, QAT preset or None)} -> each rank's {name:
    train_sharded's result}; a case that raised in a rank fails."""
    got = spawn(world, [(name, "train_sharded",
                         dict(arch=arch, batch=batch(arch, mask),
                              dp_only=dp, steps=STEPS, shape=shape,
                              n_microbatches=nm, quant=quant))
                        for name, (arch, shape, dp, nm, mask, quant)
                        in cases.items()], tmp)
    for r, res in enumerate(got):
        for name, value in res.items():
            if isinstance(value, str) and value.startswith("ERROR"):
                raise AssertionError(f"rank {r} case {name}: {value}")
    return got


@functools.lru_cache(maxsize=None)
def one_device(arch, nm, mask, quant=None):
    """The port's one-device step: the whole batch's loss and bf16
    gradients, then STEPS steps' losses and grad norms."""
    cfg = get_config(arch)
    model = build_model(cfg, train_policy(quant), remat=True)
    params, _ = shared_weights(cfg)
    b = {k: torch.as_tensor(v) for k, v in batch(arch, mask).items()}
    loss, _, grads = value_and_grad(model, params, b)
    g = {p: x.to(torch.bfloat16).float().numpy()
         for p, x in placement.paths(grads)}
    opt = AdamW(lr=1e-3)
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt, n_microbatches=nm)
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return float(loss), g, losses, gnorms


@functools.lru_cache(maxsize=None)
def reference(arch, nm, mask, quant=None):
    """The reference's `make_train_step` (jit) on the same weights:
    STEPS steps' losses and grad norms."""
    policy = JQuantPolicy(compute_dtype="float32") if quant is None else \
        dataclasses.replace(j_get_policy(quant), qat=True,
                            compute_dtype="float32")
    model = j_build_model(j_get_config(arch), policy, remat=True)
    _, jparams = shared_weights(get_config(arch))
    opt = JAdamW(lr=1e-3)
    state = jts.TrainState(jparams, opt.init(jparams))
    step = jax.jit(jts.make_train_step(model, opt, n_microbatches=nm))
    b = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
         for k, v in batch(arch, mask).items()}
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms


def check_first_step(got, *key):
    loss1, _, losses, _ = one_device(*key)
    np.testing.assert_allclose(got["loss1"], loss1, rtol=1e-5)
    # the step's loss (the microbatches' mean) against both packages'
    np.testing.assert_allclose(got["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(got["losses"][0], reference(*key)[0][0],
                               rtol=1e-5)


def check_gradients(got, *key):
    want = one_device(*key)[1]
    got = got["grads"]
    assert sorted(got) == sorted(want)
    for path, g in want.items():
        top = float(np.abs(g).max())
        err = float(np.abs(got[path] - g).max())
        assert err <= 2.0 ** -7 * top, (path, err, top)


def check_three_steps(got, *key):
    _, _, losses, gnorms = one_device(*key)
    # W4A4 QAT: a bf16 step of a gradient moves a weight across a 4-bit
    # activation code's edge, which moves whole gradient rows, so its
    # norms are held to 1e-2 (phase M's W4A4 tolerance on the card)
    gnorm_rtol = 1e-2 if key[-1] == "olive_w4a4" else 1e-3
    for want_l, want_g in ((losses, gnorms), reference(*key)):
        np.testing.assert_allclose(got["losses"], want_l, rtol=1e-3)
        np.testing.assert_allclose(got["gnorms"], want_g, rtol=gnorm_rtol)


def check_ranks(recs, arch, dp_only):
    """Every rank's losses and norms equal; a dp_only rank holds about
    1 / n of the params (the few rank-1 leaves whole), the TP rules
    less than the whole; fp32 moments twice the params' parts."""
    world = len(recs)
    assert all(r["losses"] == recs[0]["losses"] for r in recs)
    assert all(r["gnorms"] == recs[0]["gnorms"] for r in recs)
    params, _ = shared_weights(get_config(arch))
    whole = tree_bytes(params)
    for r in recs:
        if dp_only:
            assert whole / world <= r["param_bytes"] < 1.1 * whole / world
        else:
            assert r["param_bytes"] < whole
        assert r["moment_bytes"] == 2 * r["param_bytes"]
    coll = recs[0]["collectives"]
    assert coll["all_gather"] > 0 and coll["sum"] > 0
