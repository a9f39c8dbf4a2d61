"""The port's training step (`repro_torch.train.train_step`,
`repro_torch.optim.adamw`) against the reference's
(`repro.train.train_step`, `repro.optim.adamw`), on the reference's
shared smoke weights (drawn by the port, carried into the reference's
scanned layout by `convert`), on the CPU:

- `lm_loss` and every gradient leaf of `value_and_grad` against
  `jax.value_and_grad` of the reference's `lm_loss`: `qwen1.5-0.5b-smoke`
  under QAT (`olive_w4a4` with `qat`: STE fake-quant of every raw
  linear weight and activation) and in fp, fp32 compute (the MoE and
  the other families: `test_torch_train_families.py`). Tolerances: the
  loss to
  rtol 1e-6 (both sides run the same f32 ops up to summation order); a
  gradient leaf to 3e-5 of its own largest magnitude plus 1e-6 of the
  largest gradient of the tree (gradients that are 0 in exact
  arithmetic, such as a key bias's under softmax, hold noise of that
  size);
- one `AdamW.update` with bf16 moments and the global-norm clip active:
  params within rtol 1e-6, moments within one bf16 step (the fp32 value
  they round may differ in its last bit), the norm and the learning
  rate within rtol 1e-6;
- `cosine_schedule` over warm-up, decay and past the end, rtol 1e-6;
- one `make_train_step` step with `n_microbatches=2` against the
  reference's scanned accumulation (bf16 gradients): loss and CE rtol
  1e-6, the gradient norm rtol 1e-4 (bf16 gradients, summed over leaves
  in another order), new params within 2e-5 (after one step a param
  moves by lr times about sign(g), which bf16 rounding does not
  change), moments within two bf16 steps plus 2^-6 of the leaf's
  largest moment: each microbatch's gradient is rounded to bf16 before
  the two are summed, so where they cancel the sum keeps an error of a
  bf16 step of the larger one, which a last-bit f32 difference can
  flip.
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
from repro.models.model import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.configs import get_config as t_get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.qlinear import tree_paths
from repro_torch.models.model import build_model as t_build_model
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tts

from _torch_parity import shared_weights
from _torch_dist import one_torch_thread  # noqa: F401

ARCH = "qwen1.5-0.5b-smoke"
B, T = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(mod, quant):
    if quant == "fp":
        return mod.QuantPolicy(compute_dtype="float32")
    return dataclasses.replace(mod.get_policy(quant), qat=True,
                               compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference(arch, quant):
    """The reference's model and the shared weights in its layout (drawn
    by the port, `_torch_parity.shared_weights`)."""
    model = j_build_model(j_get_config(arch), _policy(jpol, quant),
                          remat=False)
    return model, shared_weights(t_get_config(arch))[1]


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _batch(vocab, b=B, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=(b, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).to(torch.int64)
            if v.dtype.kind == "i" else torch.from_numpy(v)
            for k, v in batch.items()}


def assert_grads_match(got, want_tree):
    """Port gradient tree vs the reference's (carried by `convert`)."""
    want = dict(tree_paths(_port(want_tree)))
    got = dict(tree_paths(got))
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for path, w in want.items():
        w = w.numpy()
        err = np.abs(got[path].numpy() - w).max()
        assert err <= 3e-5 * np.abs(w).max() + 1e-6 * top, \
            (path, err, np.abs(w).max())


def check_loss_and_gradients(arch, quant, batch):
    """`lm_loss` and its gradients on both packages from the reference's
    weights; numpy `batch` (int32 tokens and labels, float inputs).
    Returns the port's {"ce", "aux"}."""
    jmodel, params = _reference(arch, quant)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jts.lm_loss(jmodel, p, b), has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = t_build_model(t_get_config(arch), _policy(tpol, quant))
    tl, tparts, tg = tts.value_and_grad(tmodel, _port(params),
                                        _torch_batch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(tparts[key]), float(jparts[key]),
                                   rtol=1e-6)
    assert_grads_match(tg, jg)
    return tparts


@pytest.mark.parametrize("quant", ["olive_w4a4", "fp"],
                         ids=["qat-w4a4", "fp"])
def test_loss_and_gradients_match_reference(quant):
    cfg = j_get_config(ARCH)
    parts = check_loss_and_gradients(ARCH, quant, _batch(cfg.vocab))
    assert float(parts["aux"]) == 0.0


def _bf16_step(x):
    """One bf16 step at each value of x (f32): 2^(e - 7)."""
    x = np.abs(np.asarray(x, dtype=np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


def _adamw_case():
    rng = np.random.default_rng(11)
    shapes = {"w": (64, 48), "b": (48,), "blocks": {"0": {"v": (3, 16)}}}

    def draw(scale=1.0):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    return draw(), draw(0.3), draw(0.01), \
        jax.tree_util.tree_map(np.abs, draw(0.01))


def test_adamw_update_matches_reference():
    params, grads, mu, nu = _adamw_case()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=0.5)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 5, 40),
                        moment_dtype=jnp.bfloat16, **kw)
    topt = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-3, 5, 40),
                        moment_dtype=torch.bfloat16, **kw)
    to_j = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    jstate = jadamw.AdamWState(
        step=jnp.int32(7),
        mu=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), nu))
    jp, jst, jm = jax.jit(jopt.update)(to_j(grads), jstate, to_j(params))
    tstate = tadamw.AdamWState(
        step=torch.tensor(7, dtype=torch.int32),
        mu=_port(jstate.mu), nu=_port(jstate.nu))
    tp, tst, tm = topt.update(_port(grads), tstate, _port(params))
    assert float(jm["grad_norm"]) > kw["clip_norm"]          # clip active
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tst.step) == int(jst.step) == 8
    for got, want, what in ((tp, jp, "params"), (tst.mu, jst.mu, "mu"),
                            (tst.nu, jst.nu, "nu")):
        want = dict(tree_paths(_port(want)))
        for path, g in tree_paths(got):
            w = want[path].to(torch.float32).numpy()
            g = g.to(torch.float32).numpy()
            tol = 1e-6 * np.abs(w) if what == "params" else _bf16_step(w)
            assert np.all(np.abs(g - w) <= tol), (what, path)
        assert all(g.dtype == (torch.float32 if what == "params"
                               else torch.bfloat16)
                   for _, g in tree_paths(got))


def test_cosine_schedule_matches_reference():
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jadamw.cosine_schedule(3e-4, 20, 100)(
        jnp.asarray(steps)))
    got = tadamw.cosine_schedule(3e-4, 20, 100)(
        torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_microbatches_match_reference():
    jmodel, params = _reference(ARCH, "fp")
    batch = _batch(jmodel.cfg.vocab, b=4, seed=5)
    jopt = jadamw.AdamW(lr=1e-3, moment_dtype=jnp.bfloat16)
    jstep = jax.jit(jts.make_train_step(jmodel, jopt, n_microbatches=2))
    jnew, jm = jstep(jts.TrainState(params, jopt.init(params)),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = t_build_model(t_get_config(ARCH), _policy(tpol, "fp"))
    topt = tadamw.AdamW(lr=1e-3, moment_dtype=torch.bfloat16)
    tparams = _port(params)
    tstep = tts.make_train_step(tmodel, topt, n_microbatches=2)
    tnew, tm = tstep(tts.TrainState(tparams, topt.init(tparams)),
                     _torch_batch(batch))
    for key in ("loss", "ce"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    want = dict(tree_paths(_port(jnew.params)))
    for path, g in tree_paths(tnew.params):
        np.testing.assert_allclose(g.numpy(), want[path].numpy(), rtol=0,
                                   atol=2e-5, err_msg=path)
    for got, ref in ((tnew.opt.mu, jnew.opt.mu), (tnew.opt.nu, jnew.opt.nu)):
        ref = dict(tree_paths(_port(ref)))
        for path, g in tree_paths(got):
            w = ref[path].to(torch.float32).numpy()
            assert np.all(np.abs(g.to(torch.float32).numpy() - w)
                          <= 2 * _bf16_step(w) + 2 ** -6 * np.abs(w).max()), \
                path
