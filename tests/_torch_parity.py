"""The parity loop the port's model tests share: a JAX model's prefill and
greedy decode steps, then the port's model on the same prompt with the
same tokens fed, on the CPU. Each returns the last-position logits of
every forward call, (B, steps + 1, V)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_greedy(model, params, toks, max_len: int, steps: int):
    """Prefill of `toks` (B, T) int32 + `steps` greedy decode steps under
    one jit each; returns the logits and the tokens fed ((B, 1) each)."""
    b, t = toks.shape
    caches = model.init_caches(b, max_len, dtype=jnp.float32)
    prefill = jax.jit(lambda p, c, x: model.forward(
        p, {"tokens": x}, mode="prefill", caches=c)[:2])
    decode = jax.jit(lambda p, c, x, pos: model.forward(
        p, {"tokens": x, "pos": pos}, mode="decode", caches=c)[:2])
    logits, caches = prefill(params, caches, jnp.asarray(toks))
    out, fed = [np.asarray(logits[:, -1])], []
    for i in range(steps):
        nxt = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, caches = decode(params, caches, jnp.asarray(nxt),
                                jnp.full((b,), t + i, jnp.int32))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1), fed


def port_forced(model, params, toks, fed, max_len: int):
    """The port's model on the CPU: prefill of `toks` (B, T), then one
    decode step for each of `fed`."""
    b, t = toks.shape
    caches = model.init_caches(b, max_len, device="cpu")
    logits, caches = model.forward(
        params, {"tokens": torch.from_numpy(toks).to(torch.int64)},
        mode="prefill", caches=caches)
    out = [logits[:, -1].numpy()]
    for i, nxt in enumerate(fed):
        logits, caches = model.forward(
            params, {"tokens": torch.from_numpy(nxt).to(torch.int64),
                     "pos": torch.full((b,), t + i, dtype=torch.int64)},
            mode="decode", caches=caches)
        out.append(logits[:, 0].numpy())
    return np.stack(out, 1)
