"""AdamW over the port's parameter trees. Port of `repro/optim/adamw.py`:
moments stored in `moment_dtype` (bf16 halves the optimizer's memory),
a global-norm clip computed in fp32, bias correction at fp32 step
counts, decoupled weight decay, and params kept in their own dtype.

The update is functional over the tree, as the reference's, so it can be
held against it leaf by leaf; it writes the new values into the param
and moment tensors in place (under `torch.no_grad()`), so a full-width
step allocates only fp32 temporaries one leaf at a time, and returns the
same trees in the new state.

Trees are nested dicts and lists of tensors (`tree_leaves` walks them in
insertion order); `tree_map` and `tree_unflatten` rebuild that
structure.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Union

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple tree, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like `like` holding `leaves` in `tree_leaves`'
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree) -> Any:
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the params' device
    mu: Any                 # first moment (a tree like the params)
    nu: Any                 # second moment


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # bf16 at scale

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)

        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)

        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=leaves[0].device),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def _lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params,
               sq_sum: Optional[Callable[[Any], torch.Tensor]] = None):
        """One step: (params, new state, {"grad_norm", "lr"}), the
        params and moments updated in place. `sq_sum(grads)` replaces
        the sum of squares the clip's global norm is taken of (a
        sharded state's: over every rank's part, `sharding/state.py::
        grad_sq_sum`)."""
        step = state.step + 1
        flat_g = tree_leaves(grads)
        if self.clip_norm:
            gsq = sq_sum(grads) if sq_sum is not None else sum(
                torch.sum(torch.square(g.to(torch.float32)))
                for g in flat_g)
            gnorm = torch.sqrt(gsq)
            scale = torch.clamp(self.clip_norm
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            gnorm = torch.zeros((), device=step.device)
            scale = torch.ones((), device=step.device)
        b1, b2 = self.b1, self.b2
        fstep = step.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, fstep)
        c2 = 1.0 - torch.pow(b2, fstep)
        lr = self._lr_at(step)
        for g, m, v, p in zip(flat_g, tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g32 = g.to(torch.float32) * scale
            m32 = m.to(torch.float32) * b1 + (1 - b1) * g32
            v32 = v.to(torch.float32) * b2 + (1 - b2) * g32 * g32
            delta = (m32 / c1) / (torch.sqrt(v32 / c2) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
            m.copy_(m32)
            v.copy_(v32)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
            {"grad_norm": gnorm, "lr": lr}


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warm-up to `peak_lr` over `warmup` steps, then a cosine
    decay to `floor`·peak at `total`: lr(step) on a step tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr
