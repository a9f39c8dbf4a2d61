"""Carry a reference parameter tree across into the port's layout.

`params_from_numpy(tree, device)` takes the JAX tree as nested
dicts/lists of numpy arrays (`jax.tree_util.tree_map(np.asarray,
params)`), raw or already quantized. Quantized leaves arrive as dicts
`{data, scale, normal_dtype, pair_axis, orig_dim}` or any object with
those attributes. The scanned `blocks/<j>` stacks (leading group axis)
unstack into the port's unrolled `layers` list, layer i = g * period + j,
followed by the `tail` entries; a tree the reference already unrolled
(`unroll_params`) keeps its `layers` list.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.ovp import QuantizedTensor

_QT_FIELDS = ("data", "scale", "normal_dtype", "pair_axis", "orig_dim")


def _qt_fields(x):
    if isinstance(x, dict) and set(_QT_FIELDS) <= set(x):
        return x
    if all(hasattr(x, f) for f in _QT_FIELDS):
        return {f: getattr(x, f) for f in _QT_FIELDS}
    return None


def _convert(x, device) -> Any:
    q = _qt_fields(x)
    if q is not None:
        return QuantizedTensor(
            data=torch.as_tensor(np.ascontiguousarray(q["data"]),
                                 device=device),
            scale=torch.as_tensor(np.ascontiguousarray(q["scale"]),
                                  dtype=torch.float32, device=device),
            normal_dtype=str(q["normal_dtype"]),
            pair_axis=int(q["pair_axis"]), orig_dim=int(q["orig_dim"]))
    if isinstance(x, dict):
        return {k: _convert(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_convert(v, device) for v in x]
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _slice(x, g: int):
    """Group g of a stacked subtree (a quantized leaf slices data and
    scale; its negative pair_axis stays valid)."""
    q = _qt_fields(x)
    if q is not None:
        return dict(q, data=q["data"][g], scale=q["scale"][g])
    if isinstance(x, dict):
        return {k: _slice(v, g) for k, v in x.items()}
    return np.asarray(x)[g]


def _n_groups(x) -> int:
    q = _qt_fields(x)
    if q is not None:
        return np.shape(q["data"])[0]
    if isinstance(x, dict):
        return _n_groups(next(iter(x.values())))
    return np.shape(x)[0]


def params_from_numpy(tree, device="cuda"):
    """Reference tree (numpy leaves) -> port params on `device`."""
    out = {k: v for k, v in tree.items() if k not in ("blocks", "tail")}
    layers = list(tree.get("layers") or [])
    blocks = tree.get("blocks") or {}
    if blocks:
        period = len(blocks)
        for g in range(_n_groups(blocks["0"])):
            layers.extend(_slice(blocks[str(j)], g) for j in range(period))
    layers.extend(tree.get("tail") or [])
    out["layers"] = layers
    return _convert(out, device)
