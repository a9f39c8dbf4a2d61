"""The training step: LM loss, gradient accumulation over microbatches,
bf16 gradient compression, the AdamW update. Port of
`repro/train/train_step.py`.

Gradients come from `torch.autograd.grad` over detached leaves of the
param tree that require grad (the tree itself is never marked), so the
step is a function of (state, batch) as the reference's is; the AdamW
update then writes the new params and moments in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamW, AdamWState, tree_leaves,
                                     tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def lm_loss(model: Model, params, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01):
    """Next-token CE on fp32 logits over the last T = labels' length
    positions (a VLM's patch positions are excluded), masked and
    averaged over `loss_mask` when the batch has one, plus
    `aux_weight` times the MoE load-balance loss. Returns (loss,
    {"ce", "aux"})."""
    logits, _, aux = model.forward(params, batch, mode="train")
    labels = batch["labels"]
    t = labels.shape[1]
    ll = torch.log_softmax(logits[:, -t:].to(torch.float32), dim=-1)
    nll = -torch.gather(ll, -1, labels[..., None].to(torch.int64))[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = nll.numel()
    loss = torch.sum(nll) / denom
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def value_and_grad(model: Model, params, batch: Dict[str, torch.Tensor],
                   aux_weight: float = 0.01):
    """(loss, {"ce", "aux"}, grads): `lm_loss` and its gradient with
    respect to every leaf of `params`, as a tree like it (the reference's
    `jax.value_and_grad`). Leaves no loss reaches (a tied model's
    `lm_head`) get zeros, as JAX gives them."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss, parts = lm_loss(model, tree_unflatten(params, live), batch,
                          aux_weight)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
        tree_unflatten(params, grads)


def make_train_step(model: Model, optimizer: AdamW, *,
                    n_microbatches: int = 1,
                    grad_dtype: torch.dtype = torch.bfloat16):
    """Returns train_step(state, batch) -> (state, metrics).

    The gradients are cast to `grad_dtype`. With n_microbatches > 1 the
    batch is split on axis 0 into that many equal microbatches, whose
    gradients accumulate in `grad_dtype` and are then scaled by 1/n in
    fp32 (the reference's scan): activation memory scales with the
    microbatch."""

    def grads_of(params, batch):
        loss, parts, grads = value_and_grad(model, params, batch)
        return loss, parts, [g.to(grad_dtype) for g in tree_leaves(grads)]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if n_microbatches == 1:
            loss, parts, grads = grads_of(state.params, batch)
        else:
            mb = next(iter(batch.values())).shape[0] // n_microbatches
            grads, loss = None, 0.0
            parts = {"ce": 0.0, "aux": 0.0}
            for i in range(n_microbatches):
                loss_i, parts_i, g_i = grads_of(
                    state.params, {k: v[i * mb:(i + 1) * mb]
                                   for k, v in batch.items()})
                grads = g_i if grads is None else \
                    [a + b for a, b in zip(grads, g_i)]
                loss = loss + loss_i
                parts = {k: parts[k] + parts_i[k] for k in parts}
            inv = 1.0 / n_microbatches
            grads = [(g.to(torch.float32) * inv).to(grad_dtype)
                     for g in grads]
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}
        params, opt, opt_metrics = optimizer.update(
            tree_unflatten(state.params, grads), state.opt, state.params)
        return TrainState(params, opt), {"loss": loss, **parts,
                                         **opt_metrics}

    return train_step


def init_state(model: Model, optimizer: AdamW, generator: torch.Generator,
               device="cuda") -> TrainState:
    """Fresh fp32 params drawn by `model.init` from `generator` and a
    zero optimizer state."""
    params = model.init(generator, device=device)
    return TrainState(params=params, opt=optimizer.init(params))
