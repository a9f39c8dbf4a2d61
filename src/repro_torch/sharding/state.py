"""The training state on a mesh: each rank holds its shard of every
parameter and AdamW moment, as the reference's `jax.jit(...,
in_shardings=params_pspecs(...))` places them.

The specs are the reference's. The port's params are unrolled (a
`layers` list) where the reference stacks layer groups (`blocks/<j>`
with a leading group dim, `tail`, the encoder's `enc_blocks`), and
`rules.param_spec` decides by rank and shape, so `param_specs` asks it
about the reference's layout (`convert.params_to_reference` on "meta")
and takes each stack's spec without its leading dim. Every rank then
holds the bytes a reference device holds.

A dim split over a tuple of axes (a1, a2) is cut into n1 * n2 parts,
part c1 * n2 + c2 on the rank at (c1, c2), as a `PartitionSpec` cuts
it. `local_part` takes this rank's part; `gather` puts the whole tensor
back together with `mesh.all_gather` (the minor axis first).
`GatherLeaf` is that gather under autograd: its backward casts the
gradient to the step's gradient dtype, sums it over the axes whose
ranks saw different rows (`mesh.rank_sum`, in rank order, in fp32) and
returns this rank's part.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch import mesh as mesh_lib

from .rules import Spec, params_pspecs


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _part(entry, mesh) -> Tuple[int, int]:
    """(this rank's part, the number of parts) of a dim split by
    `entry`."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * mesh.size(a) + mesh.coord(a)
        n *= mesh.size(a)
    return idx, n


def local_part(x: torch.Tensor, spec: Sequence, mesh,
               only: Optional[Callable[[object], bool]] = None
               ) -> torch.Tensor:
    """This rank's part of the whole tensor `x` under `spec` (a view);
    with `only`, just the dims whose entry it accepts are cut."""
    for dim, entry in enumerate(spec):
        if only is not None and not only(entry):
            continue
        idx, n = _part(entry, mesh)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {n} parts ({spec})")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def local_shape(shape: Sequence[int], spec: Sequence, mesh
                ) -> Tuple[int, ...]:
    return tuple(s // _part(e, mesh)[1] for s, e in zip(shape, spec))


def gather(x: torch.Tensor, spec: Sequence, mesh,
           only: Optional[Callable[[object], bool]] = None) -> torch.Tensor:
    """The whole tensor from every rank's part `x` under `spec`; with
    `only`, just the dims whose entry it accepts are gathered."""
    for dim, entry in enumerate(spec):
        if only is not None and not only(entry):
            continue
        for a in reversed(_axes(entry)):
            x = mesh_lib.all_gather(x, dim, mesh, a)
    return x


class GatherLeaf(torch.autograd.Function):
    """gather(local) forward; backward: the gradient in `grad_dtype`,
    summed over `sum_axes` (dims split only over other axes are cut
    first, since every rank of a sum group cuts them alike), then this
    rank's part."""

    @staticmethod
    def forward(ctx, local, spec, mesh, sum_axes, grad_dtype):
        ctx.spec, ctx.mesh = spec, mesh
        ctx.sum_axes, ctx.grad_dtype = sum_axes, grad_dtype
        return gather(local, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        spec, mesh, sums = ctx.spec, ctx.mesh, ctx.sum_axes

        def summed(entry):
            return any(a in sums for a in _axes(entry))

        g = local_part(g.to(ctx.grad_dtype), spec, mesh,
                       only=lambda e: not summed(e))
        for a in sums:
            g = mesh_lib.rank_sum(g.contiguous(), mesh, a,
                                  acc_dtype=torch.float32).to(ctx.grad_dtype)
        return local_part(g, spec, mesh, only=summed), None, None, None, None


# ------------------------------------------------------------------ trees
def paths(tree, prefix: str = ""):
    """(path, leaf) of every tensor of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unstacked(spec: Spec, where: str) -> Spec:
    if spec[0] is not None:
        raise ValueError(f"{where}: the reference splits its layer stack "
                         f"dim over {spec[0]!r}, which the port's "
                         f"unrolled layers cannot take")
    return Spec(*spec[1:])


def param_specs(params, cfg, mesh, dp_only: bool = False
                ) -> Dict[str, Spec]:
    """{path: Spec} of the port's (raw, unrolled) params: the
    reference's `params_pspecs` on its own layout, each layer stack's
    spec without the group dim."""
    from repro_torch.convert import params_to_reference
    from repro_torch.core.qlinear import ENCODER
    meta = [(p, torch.empty(x.shape, dtype=x.dtype, device="meta"))
            for p, x in paths(params)]
    tree = _rebuild(params, dict(meta))
    ref = params_to_reference(tree, cfg)
    rspecs = dict(_spec_paths(params_pspecs(ref, cfg, mesh, dp_only)))
    period = len(cfg.block_pattern)
    n_full = len(params["layers"]) // period * period
    out = {}
    for path, _ in meta:
        head, _, rest = path.partition("/")
        if head == "layers":
            i, _, leaf = rest.partition("/")
            i = int(i)
            if i < n_full:
                where = f"blocks/{i % period}/{leaf}"
                out[path] = _unstacked(rspecs[where], where)
            else:
                out[path] = rspecs[f"tail/{i - n_full}/{leaf}"]
        elif head == ENCODER:
            leaf = rest.partition("/")[2]
            where = f"{ENCODER}/{leaf}"
            out[path] = _unstacked(rspecs[where], where)
        else:
            out[path] = rspecs[path]
    return out


def _spec_paths(tree, prefix: str = ""):
    """(path, Spec) of a spec tree (a Spec is a tuple: not walked)."""
    if isinstance(tree, Spec):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = enumerate(tree)
    out = []
    for k, v in items:
        out.extend(_spec_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _rebuild(like, by_path: Dict, prefix: str = ""):
    """A tree shaped like `like` with the leaf at each path from
    `by_path`."""
    if isinstance(like, dict):
        return {k: _rebuild(v, by_path, f"{prefix}/{k}" if prefix else k)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, by_path,
                                   f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(like))
    return by_path[prefix]


def gather_tree(tree, specs: Dict[str, Spec], mesh, device=None):
    """The whole tree from every rank's parts, leaf by leaf (each
    gathered leaf moved to `device` before the next, e.g. the host)."""
    out = {}
    for p, x in paths(tree):
        full = gather(x, specs[p], mesh)
        out[p] = full if device is None else full.to(device)
    return _rebuild(tree, out)


def norm_owner(spec: Spec, mesh) -> bool:
    """Whether this rank counts a leaf in a global sum over ranks: the
    leaf is whole or replicated along every axis its spec does not
    split, and only the rank at coordinate 0 of those axes counts it."""
    split = {a for e in spec for a in _axes(e)}
    return all(mesh.coord(a) == 0 for a in mesh.axis_names
               if a not in split)


def grad_sq_sum(grads, specs: Dict[str, Spec], mesh) -> torch.Tensor:
    """The squared global norm of gradients held as local parts: each
    element counted once over the mesh (fp32, summed in rank order over
    every axis)."""
    tot = None
    for p, g in paths(grads):
        s = torch.sum(torch.square(g.to(torch.float32)))
        if not norm_owner(specs[p], mesh):
            s = torch.zeros_like(s)
        tot = s if tot is None else tot + s
    for a in mesh.axis_names:
        tot = mesh_lib.rank_sum(tot, mesh, a)
    return tot


class Placement:
    """A train state's layout on a mesh: the params' `specs` (the
    moments take the same), the step counter whole."""

    def __init__(self, mesh, specs: Dict[str, Spec]):
        self.mesh, self.specs = mesh, specs

    @property
    def writer(self) -> bool:
        """Whether this rank writes checkpoints (rank 0)."""
        return self.mesh.rank == 0

    def _map(self, state, fn):
        from repro_torch.optim.adamw import AdamWState
        opt = state.opt
        return type(state)(fn(state.params),
                           AdamWState(step=opt.step, mu=fn(opt.mu),
                                      nu=fn(opt.nu)))

    def local(self, state, device=None):
        """This rank's parts of a whole state (on `device` when given)."""
        def cut(tree):
            return _rebuild(tree, {
                p: local_part(x, self.specs[p], self.mesh).to(
                    device or x.device, copy=True)
                for p, x in paths(tree)})
        out = self._map(state, cut)
        return type(out)(out.params, out.opt._replace(
            step=out.opt.step.to(device or out.opt.step.device)))

    def whole(self, state, device=None):
        """The whole state from every rank's parts: a collective every
        rank calls; each gathered leaf lands on `device` (e.g. "cpu")
        before the next is gathered."""
        return self._map(state, lambda t: gather_tree(t, self.specs,
                                                      self.mesh, device))

    def init(self, model, optimizer, generator, device):
        """Fresh params drawn as `Model.init` draws them, one piece at a
        time, each cut to this rank's parts before the next is drawn,
        and zero moments of the parts' shapes."""
        from repro_torch.core.qlinear import ENCODER
        from repro_torch.train.train_step import TrainState
        params, layers = {}, []
        for prefix, piece in model.init_stream(generator, device):
            part = _rebuild(piece, {
                p: local_part(x, self.specs[p], self.mesh).clone()
                for p, x in paths(piece, prefix)}, prefix)
            if prefix == "":
                params.update(part)
            elif prefix == ENCODER:
                params[ENCODER] = part
            else:
                layers.append(part)
            del piece
        params["layers"] = layers
        return TrainState(params=params, opt=optimizer.init(params))
