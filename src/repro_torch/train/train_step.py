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

from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import Model
from repro_torch.optim.adamw import (AdamW, AdamWState, tree_leaves,
                                     tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def lm_loss(model: Model, params, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01, *, denom=None, view=None):
    """Next-token CE on fp32 logits over the last T = labels' length
    positions (a VLM's patch positions are excluded), masked and
    averaged over `loss_mask` when the batch has one, plus
    `aux_weight` times the MoE load-balance loss. Returns (loss,
    {"ce", "aux"}). `denom` replaces the count the CE sum is divided
    by (the sharded step's: the whole batch's, of which this is a
    part); `view` is `Model.forward`'s."""
    logits, _, aux = model.forward(params, batch, mode="train", view=view)
    labels = batch["labels"]
    t = labels.shape[1]
    ll = torch.log_softmax(logits[:, -t:].to(torch.float32), dim=-1)
    nll = -torch.gather(ll, -1, labels[..., None].to(torch.int64))[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
    if denom is None:
        denom = torch.clamp(torch.sum(mask), min=1.0) \
            if mask is not None else nll.numel()
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
            for i in mesh_lib.loop(range(n_microbatches),
                                   next(iter(batch.values()))):
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


def make_sharded_train_step(model: Model, optimizer: AdamW, mesh,
                            specs, *, rules, n_microbatches: int = 1,
                            grad_dtype: torch.dtype = torch.bfloat16,
                            aux_weight: float = 0.01):
    """train_step(state, batch) -> (state, metrics) over a mesh: the
    counterpart of the reference's `jax.jit(make_train_step(...),
    in_shardings=..., out_shardings=...)`.

    `state` holds this rank's part of every parameter and AdamW moment
    under `specs` ({param path: Spec}, `sharding/state.py::
    param_specs`), the step counter whole. `batch` is the loader's
    global batch: split into `n_microbatches` global microbatches in
    order, each split over the axes `rules["batch"]` names (every axis
    under dp_only), and this rank takes its rows of each, so the mesh
    sees the tokens one device sees.

    Each leaf is gathered whole (`state.GatherLeaf`, an all-gather along
    each split dim) where the model reads it: a layer's weights inside
    its remat boundary, so the step holds one layer's whole weights at a
    time and the backward pass gathers them again. The gather's backward
    casts the gradient to `grad_dtype`, sums it in rank order over the
    axes whose ranks saw different rows (not over a "model" axis that
    replicates the batch) and keeps this rank's part. The CE of each
    rank is divided by the whole microbatch's token count (or
    `loss_mask` sum), the MoE load-balance loss takes its means over
    the whole batch (`layers._means_over_batch_ranks`), and the clip's
    global norm counts each element once over the mesh
    (`state.grad_sq_sum`), so the summed gradients, the loss and the
    update are one device's up to the sum order.

    Design choice: every rank of a "model" group gathers a layer's
    weights and computes the layer whole. The reference's GSPMD splits a
    tensor-parallel layer's compute over the group instead. The state's
    placement and per-rank bytes are the reference's; the per-rank
    compute of a tensor-parallel layer and the gathers' bytes are not
    (splitting the compute, and a reduce-scatter in place of the
    gradient's sum-then-slice, are later performance work).

    `train_step.value_and_grad(params, batch)` is the whole-batch
    (one-microbatch) half alone: (global loss, {"ce", "aux"}, this
    rank's gradient parts in `grad_dtype`); `train_step.evaluate(params,
    batch)` the global CE without gradients.
    """
    from repro_torch.sharding import axes
    from repro_torch.sharding import state as placement

    split = axes.batch_split(rules, mesh)
    n_split = 1
    for a in split:
        n_split *= mesh.size(a)
    # a tied model's head reads the embedding table, never `lm_head`
    unread = {"lm_head"} if model.cfg.tie_embeddings else set()

    def view(tree, prefix):
        if prefix in unread:
            return tree
        return placement._rebuild(tree, {
            p: placement.GatherLeaf.apply(x, specs[p], mesh, split,
                                          grad_dtype)
            for p, x in placement.paths(tree, prefix)}, prefix)

    def rows(batch, i: int, nm: int):
        """This rank's rows of global microbatch i of nm."""
        out = {}
        for k, v in batch.items():
            mb = v.shape[0] // nm
            out[k] = placement.local_part(
                v[i * mb:(i + 1) * mb],
                (rules["batch"],) + (None,) * (v.ndim - 1), mesh)
        return out

    def over_batch(x: torch.Tensor) -> torch.Tensor:
        for a in split:
            x = mesh_lib.rank_sum(x, mesh, a)
        return x

    def denom_of(mb):
        mask = mb.get("loss_mask")
        if mask is not None:
            return torch.clamp(over_batch(torch.sum(mask).to(
                torch.float32)), min=1.0)
        return mb["labels"].numel() * n_split

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_() for p in leaves]
        with axes.axis_rules(mesh, rules):
            axes.logical(mb["tokens"], "batch", "seq")
            loss, parts = lm_loss(model, tree_unflatten(params, live), mb,
                                  aux_weight, denom=denom_of(mb), view=view)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros(p.shape, dtype=grad_dtype, device=p.device)
                 if g is None else g.to(grad_dtype)
                 for p, g in zip(leaves, grads)]
        ce = over_batch(parts["ce"].detach())
        aux = parts["aux"].detach()
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}, grads

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        nm = n_microbatches
        grads, loss, parts = None, 0.0, {"ce": 0.0, "aux": 0.0}
        for i in mesh_lib.loop(range(nm), next(iter(batch.values()))):
            loss_i, parts_i, g_i = grads_of(state.params, rows(batch, i, nm))
            grads = g_i if grads is None else \
                [a + b for a, b in zip(grads, g_i)]
            loss = loss + loss_i
            parts = {k: parts[k] + parts_i[k] for k in parts}
        if nm > 1:
            inv = 1.0 / nm
            grads = [(g.to(torch.float32) * inv).to(grad_dtype)
                     for g in grads]
            loss = loss * inv
            parts = {k: v * inv for k, v in parts.items()}
        params, opt, opt_metrics = optimizer.update(
            tree_unflatten(state.params, grads), state.opt, state.params,
            sq_sum=lambda g: placement.grad_sq_sum(g, specs, mesh))
        return TrainState(params, opt), {"loss": loss, **parts,
                                         **opt_metrics}

    def value_and_grad_(params, batch):
        loss, parts, grads = grads_of(params, rows(batch, 0, 1))
        return loss, parts, tree_unflatten(params, grads)

    @torch.no_grad()
    def evaluate(params, batch):
        mb = rows(batch, 0, 1)
        with axes.axis_rules(mesh, rules):
            parts = lm_loss(model, params, mb, aux_weight,
                            denom=denom_of(mb), view=view)[1]
        return over_batch(parts["ce"])

    train_step.value_and_grad = value_and_grad_
    train_step.evaluate = evaluate
    return train_step
