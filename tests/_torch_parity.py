"""The parity loop the port's model tests share: a JAX model's prefill and
greedy decode steps, then the port's model on the same prompt with the
same tokens fed, on the CPU. Each returns the last-position logits of
every forward call, (B, steps + 1, V).

Keyword-only extras: `inputs`, numpy arrays the prefill batch also takes
(an encoder's "frames", a ViT frontend's "patch_embeds"); `enc_len`, the
slots of an encoder-decoder's cross caches; `offset`, the positions in
front of the prompt (a ViT frontend's patches), so decode step i runs at
position offset + T + i."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_greedy(model, params, toks, max_len: int, steps: int, *,
               inputs=None, enc_len: int = 0, offset: int = 0):
    """Prefill of `toks` (B, T) int32 + `steps` greedy decode steps under
    one jit each; returns the logits and the tokens fed ((B, 1) each)."""
    b, t = toks.shape
    caches = model.init_caches(b, max_len, enc_len=enc_len,
                               dtype=jnp.float32)
    prefill = jax.jit(lambda p, c, x: model.forward(
        p, x, mode="prefill", caches=c)[:2])
    decode = jax.jit(lambda p, c, x, pos: model.forward(
        p, {"tokens": x, "pos": pos}, mode="decode", caches=c)[:2])
    batch = {key: jnp.asarray(val) for key, val in (inputs or {}).items()}
    logits, caches = prefill(params, caches,
                             dict(batch, tokens=jnp.asarray(toks)))
    out, fed = [np.asarray(logits[:, -1])], []
    for i in range(steps):
        nxt = np.argmax(out[-1], axis=-1).astype(np.int32)[:, None]
        fed.append(nxt)
        logits, caches = decode(params, caches, jnp.asarray(nxt),
                                jnp.full((b,), offset + t + i, jnp.int32))
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out, 1), fed


def port_forced(model, params, toks, fed, max_len: int, *, inputs=None,
                enc_len: int = 0, offset: int = 0):
    """The port's model on the CPU: prefill of `toks` (B, T), then one
    decode step for each of `fed`."""
    b, t = toks.shape
    caches = model.init_caches(b, max_len, enc_len=enc_len, device="cpu")
    batch = {key: torch.from_numpy(val) for key, val in (inputs or {}).items()}
    logits, caches = model.forward(
        params, dict(batch, tokens=torch.from_numpy(toks).to(torch.int64)),
        mode="prefill", caches=caches)
    out = [logits[:, -1].numpy()]
    for i, nxt in enumerate(fed):
        logits, caches = model.forward(
            params, {"tokens": torch.from_numpy(nxt).to(torch.int64),
                     "pos": torch.full((b,), offset + t + i,
                                       dtype=torch.int64)},
            mode="decode", caches=caches)
        out.append(logits[:, 0].numpy())
    return np.stack(out, 1)


def shared_weights(cfg, seed: int = 0):
    """Raw fp32 weights drawn on the CPU by the port's `Model.init` for
    `cfg` (a port ArchConfig), and the same values in the reference's
    scanned layout (`convert.params_to_reference`) as JAX arrays: the
    two packages' shared weights, with no JAX init to run."""
    from repro_torch.convert import params_to_reference
    from repro_torch.models.model import build_model
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   device="cpu")
    ref = params_to_reference(params, cfg)

    def to_jax(x):
        if isinstance(x, dict):
            return {k: to_jax(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_jax(v) for v in x]
        return jnp.asarray(x.numpy())

    return params, to_jax(ref)
