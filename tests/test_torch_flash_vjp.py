"""The port's flash attention (`models.layers.flash_attention`: the
online-softmax forward saving the output and log-sum-exp, and the
FlashAttention-2 backward, `_flash_bwd`) against the reference's
`blockwise_attention` and `jax.grad` through its custom VJP, on
`tests/test_flash_vjp.py`'s five cases (causal and not, GQA 4/2, a
query offset, a ragged length, chunks of 4-16 and one 512 chunk) and
the same inputs, on the CPU: the output and the q, k and v gradients
of sum(out * tangent) within atol 1e-5 and rtol 1e-5 (both sides
accumulate in f32 in other orders). Also: with grad disabled,
`causal_attention` returns the serving path's values bit for bit
whatever the flash path would give, and under autograd it takes the
flash path (its backward runs `_flash_bwd`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import blockwise_attention
from repro_torch.models import layers as tl

from test_flash_vjp import CASES, _qkv

from _torch_dist import one_torch_thread  # noqa: F401


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x)).requires_grad_() for x in xs]


@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{'causal' if c['causal'] else 'full'}-off{c['q_offset']}-t{c['t']}"
    f"-s{c['s']}-qc{c['qc']}-kc{c['kc']}"))
def test_forward_and_gradients_match_reference(case):
    q, k, v = _qkv(jax.random.PRNGKey(1), t=case["t"], s=case["s"])
    tangent = jax.random.normal(jax.random.PRNGKey(2), (2, case["t"], 4, 8))
    kw = dict(causal=case["causal"], q_offset=case["q_offset"],
              q_chunk=case["qc"], kv_chunk=case["kc"])

    def loss(q, k, v):
        out = blockwise_attention(q, k, v, **kw)
        return jnp.sum(out * tangent), out

    (_, want), gwant = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = _torch(q, k, v)
    out = tl.flash_attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    (out * torch.from_numpy(np.asarray(tangent))).sum().backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), gwant, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


def test_causal_attention_routes_by_autograd(monkeypatch):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 20, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 2, 8)).astype(np.float32)
            for _ in range(2))
    with torch.no_grad():
        serve = tl.causal_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_array_equal(
        serve.numpy(), tl._online_softmax(*map(torch.from_numpy,
                                               (q, k, v))).numpy())
    calls = []
    real = tl._flash_bwd
    monkeypatch.setattr(tl, "_flash_bwd",
                        lambda *a: calls.append(1) or real(*a))
    tq, tk, tv = _torch(q, k, v)
    out = tl.causal_attention(tq, tk, tv)
    np.testing.assert_allclose(out.detach().numpy(), serve.numpy(),
                               rtol=1e-6, atol=1e-6)
    out.sum().backward()
    assert calls == [1] and tq.grad is not None
    # windowed attention differentiates through its torch ops
    calls.clear()
    tq, tk, tv = _torch(q, k, v)
    tl.causal_attention(tq, tk, tv, window=5).sum().backward()
    assert calls == [] and tk.grad is not None
