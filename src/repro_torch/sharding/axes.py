"""Logical-axis sharding annotations. Port of `repro/sharding/axes.py`.

Code names the *logical* axes of a tensor ("batch", "seq", "embed",
...); a rules table (`sharding/rules.py::make_rules`) maps each name to
mesh axes. Outside a mesh context the annotations are no-ops, so the
same model code runs on one device and on a mesh:

    with axis_rules(mesh, rules):
        x = logical(x, "batch", "seq", "embed")

The reference's `logical` constrains GSPMD's layout of the array. The
port places every tensor explicitly (each rank holds its shard and the
train step gathers weights itself, `sharding/state.py`), so there is
nothing to constrain: inside a mesh `logical` checks the tensor's rank
against the names, as the reference does, and returns it. The context
is also what the MoE load-balance loss reads to combine its means over
the ranks that hold different rows (`models/layers.py::moe_layer`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

from .rules import Spec

AxisVal = Union[None, str, Tuple[str, ...]]

_ctx = threading.local()


def current():
    """(mesh, rules) of the innermost `axis_rules`, or None."""
    return getattr(_ctx, "stack", [None])[-1]


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, AxisVal]):
    if not hasattr(_ctx, "stack"):
        _ctx.stack = [None]
    _ctx.stack.append((mesh, dict(rules)))
    try:
        yield
    finally:
        _ctx.stack.pop()


def reentered(cur):
    """`axis_rules` over what `current()` returned (a no-op for None):
    code that autograd runs again in the backward pass (a layer under
    activation checkpointing, maybe on another thread) re-enters the
    context it ran in."""
    if cur is None:
        return contextlib.nullcontext()
    return axis_rules(*cur)


def batch_split(rules: Dict[str, AxisVal], mesh) -> Tuple[str, ...]:
    """The mesh axes, of size > 1, that `rules["batch"]` splits the batch
    over: ranks along them hold different rows."""
    return tuple(a for a in _names(rules.get("batch"))
                 if mesh.size(a) > 1)


def _names(v: AxisVal) -> Tuple[str, ...]:
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def resolve(names: Tuple[Optional[str], ...],
            rules: Dict[str, AxisVal]) -> Spec:
    """Logical names -> Spec under `rules` (unknown -> replicated).

    A mesh axis may split only one dimension of a tensor: later uses of
    an axis already taken degrade to replicated.
    """
    used = set()
    parts = []
    for n in names:
        v = rules.get(n) if n is not None else None
        if v is None:
            parts.append(None)
            continue
        vt = (v,) if isinstance(v, str) else tuple(v)
        vt = tuple(a for a in vt if a not in used)
        if not vt:
            parts.append(None)
            continue
        used.update(vt)
        parts.append(vt if len(vt) > 1 else vt[0])
    return Spec(*parts)


def logical(x, *names: Optional[str]):
    """Annotate a tensor with logical axes: a no-op without a mesh; in a
    mesh context the names must match the tensor's rank."""
    if current() is None:
        return x
    if len(names) != x.ndim:
        raise ValueError(f"{len(names)} names for rank-{x.ndim} array")
    return x


def logical_sharding(mesh, rules: Dict[str, AxisVal],
                     *names: Optional[str]) -> Spec:
    """The Spec of a tensor with these logical axes (the reference
    returns a NamedSharding of it on `mesh`)."""
    return resolve(tuple(names), rules)
