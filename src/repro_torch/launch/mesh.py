"""Device meshes over `torch.distributed`: one process per rank, named
axes as process groups. Port of `repro/launch/mesh.py`.

Functions only, never module-level meshes, as in the reference:
`make_mesh(shape, axes)` builds a `Mesh` over the ranks of the running
process group (row-major: rank r sits at `np.unravel_index(r, shape)`,
and the group of an axis holds the ranks that differ only along it);
`make_production_mesh(multi_pod=)` is the (16, 16) pod or the (2, 16,
16) two-pod mesh, which builds only where that many ranks run
(`production_plan` is its shape alone); `batch_axes(mesh)` names the
data-parallel axes.

`init_distributed` starts the process group from `torchrun`'s
environment (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR/PORT) or from explicit arguments (a `file://` rendezvous,
as the tests and `chip_smoke.py` use). The collective backend is a rule,
`collective_backend`: NCCL when every rank of the node has a card of
its own, gloo otherwise (the CPU, or ranks sharing one card).

The serving path's two collectives run on the "model" group:
`all_gather(x, dim)` and `rank_sum(x)`, a sum written as an all-gather
followed by an addition in rank order, so every rank gets the same
bytes whatever the backend's reduction algorithm and the order of the
sum is fixed. `collective_stats()` counts both, with the bytes each
rank receives. A gloo group takes CUDA tensors as they are (it copies
them through the host itself).

`loop(items, like)` is how a loop of equal iterations runs: every item,
or, on "meta" (a dry run's trace), the first alone, its collectives
counted once for each iteration (`LOOPS_ONCE`; `rest` fills in the
outputs of the iterations skipped).
"""
from __future__ import annotations

import collections
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime.elastic import MeshPlan


def production_plan(*, multi_pod: bool = False) -> MeshPlan:
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods)."""
    if multi_pod:
        return MeshPlan((2, 16, 16), ("pod", "data", "model"), 0)
    return MeshPlan((16, 16), ("data", "model"), 0)


def collective_backend(device_type: str, local_ranks: int,
                       local_cards: int) -> str:
    """"nccl" when the ranks run on CUDA and every rank of the node has a
    card of its own; "gloo" otherwise: on the CPU, or where ranks share
    a card (NCCL refuses two ranks on one device)."""
    if device_type == "cuda" and local_ranks <= local_cards:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device a rank runs on: on CUDA, card local_rank modulo the
    node's cards (ranks beyond the card count share)."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", local_rank % max(torch.cuda.device_count(),
                                                 1))


def init_distributed(device_type: str = "cuda", *,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     local_world_size: Optional[int] = None,
                     init_method: Optional[str] = None,
                     verbose: bool = True) -> torch.device:
    """Start the default process group, once, and return this rank's
    device. Unset arguments come from `torchrun`'s environment (with
    `init_method` "env://"). The backend follows `collective_backend`
    and is printed by rank 0."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None \
        else local_rank
    if local_world_size is None:
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    backend = collective_backend(device_type, local_world_size, cards)
    device = rank_device(device_type, local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend=backend,
                                init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    if verbose and rank == 0:
        print(f"[mesh] {world_size} ranks, {local_world_size} on this node "
              f"with {cards} card(s): collective backend {backend}")
    return device


class Mesh:
    """Named axes over the ranks of the default process group. `shape`
    maps axis name -> size (in axis order), `coords` this rank's index
    along each axis, `groups` the process group of this rank along each
    axis of size > 1. A mesh of one rank needs no process group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} does not match axes "
                             f"{axes}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh sizes must be positive, got {shape}")
        n = int(np.prod(shape))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            raise ValueError(
                f"a {'x'.join(map(str, shape))} mesh needs {n} ranks, the "
                f"process group has {world}: launch with `torchrun "
                f"--nproc-per-node {n}`")
        self.axis_names = axes
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        here = np.unravel_index(self.rank, shape)
        self.coords: Dict[str, int] = {a: int(c) for a, c in
                                       zip(axes, here)}
        self.backend = dist.get_backend() if dist.is_initialized() \
            else None
        self.groups: Dict[str, object] = {}
        grid = np.arange(n).reshape(shape)
        for i, a in enumerate(axes):
            if shape[i] == 1:
                continue
            # every rank creates every group of the axis, in one order
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[a] = g

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def __repr__(self):
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}; rank {self.rank})"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """Any mesh over the running ranks (the tests use (1, 2) and
    (2, 2))."""
    return Mesh(shape, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    plan = production_plan(multi_pod=multi_pod)
    return Mesh(plan.shape, plan.axis_names)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# ------------------------------------------------------------ collectives
_STATS: collections.Counter = collections.Counter()


def collective_stats() -> Dict[str, int]:
    """Counts since the last reset: "all_gather" and "sum" calls,
    "bytes" each rank received (the whole gathered tensor, its own
    shard included), and those bytes by kind ("all_gather_bytes",
    "sum_bytes")."""
    return dict(_STATS)


def reset_collective_stats() -> None:
    _STATS.clear()


def _count(kind: str, n_bytes: int) -> None:
    _STATS[kind] += 1
    _STATS["bytes"] += n_bytes
    _STATS[f"{kind}_bytes"] += n_bytes


def _gather_list(x: torch.Tensor, mesh: "Mesh", axis: str):
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    dist.all_gather(outs, x, group=mesh.groups[axis])
    return outs


def all_gather(x: torch.Tensor, dim: int, mesh: Mesh,
               axis: str = "model") -> torch.Tensor:
    """Concatenate every rank's `x` along `dim`, in rank order along
    `axis`."""
    n = mesh.size(axis)
    if n == 1:
        return x
    outs = _gather_list(x, mesh, axis)
    _count("all_gather", x.numel() * x.element_size() * n)
    return torch.cat(outs, dim=dim)


def rank_sum(x: torch.Tensor, mesh: Mesh, axis: str = "model",
             acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of every rank's `x` over `axis`, added in rank order, so
    every rank holds the same bytes. `acc_dtype` adds in that dtype and
    returns it (a bf16 gradient moves as bf16 and sums in fp32)."""
    n = mesh.size(axis)
    if n == 1:
        return x if acc_dtype is None else x.to(acc_dtype)
    outs = _gather_list(x, mesh, axis)
    _count("sum", x.numel() * x.element_size() * n)
    acc = outs[0] if acc_dtype is None else outs[0].to(acc_dtype)
    for part in outs[1:]:
        acc = acc + part
    return acc


# ------------------------------------------------------- loops on "meta"
# trace a loop of equal iterations once on "meta" (tests switch it off to
# hold the shortcut to the loop traced whole)
LOOPS_ONCE = True


def loop(items, like: torch.Tensor):
    """The iterations of a loop whose iterations have equal shapes: all
    of `items`, or, when `like` is a "meta" tensor (a dry run's trace)
    and `LOOPS_ONCE` is on, the first alone, the shapes of the rest
    being its shapes (the counterpart of the reference's HLO walker,
    which counts a loop body once times its trip count). The
    collectives counted inside that one iteration are multiplied by
    the trip count when the loop asks for its next item; the caller
    takes the rest of its outputs from the first (`rest`)."""
    items = list(items)
    if not (LOOPS_ONCE and like.device.type == "meta") or len(items) < 2:
        yield from items
        return
    before = dict(_STATS)
    yield items[0]
    for key, val in list(_STATS.items()):
        _STATS[key] = before.get(key, 0) + (val - before.get(key, 0)) \
            * len(items)


def rest(outs: list, n: int) -> list:
    """A loop's `n` outputs from the ones it ran: as they are, or the
    first one's shape for every iteration `loop` skipped."""
    return outs if len(outs) == n else outs + [outs[0]] * (n - len(outs))

