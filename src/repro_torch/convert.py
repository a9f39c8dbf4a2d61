"""Carry a reference parameter tree across into the port's layout.

`params_from_numpy(tree, device)` takes the JAX tree as nested
dicts/lists of numpy arrays (`jax.tree_util.tree_map(np.asarray,
params)`), raw or already quantized. Quantized leaves arrive as dicts
`{data, scale, normal_dtype, pair_axis, orig_dim}` or any object with
those attributes; stacked expert leaves are the same with an expert dim
(`moe/experts/wg`: data (E, K/2, N), scale (E, 1, N), with a leading
group axis in a scanned tree); per-expert mixed stacks arrive as
`{groups, expert_ids, n_experts}` (or a `MixedExpertQuant`) and become
the port's `MixedExpertQuant`. The scanned `blocks/<j>` stacks (leading
group axis)
unstack into the port's unrolled `layers` list, layer i = g * period + j,
followed by the `tail` entries; a tree the reference already unrolled
(`unroll_params`) keeps its `layers` list. An encoder-decoder's vmapped
`enc_blocks` (leading axis n_enc_layers) unstacks into the port's list
of encoder layers; `enc_norm` and `frontend_proj` carry over as they
are. Leaves may also be torch tensors (a checkpoint the port restored
in the reference's layout), and bfloat16 arrays (`ml_dtypes`) become
bfloat16 tensors bit for bit.

The other direction, `params_to_reference(params, cfg)`, stacks the
port's raw layers back into the scanned layout (`blocks/<j>` over the
n_layers // period full periods, the rest in `tail`, the encoder's list
into one stack). `state_from_reference` and `state_to_reference` carry
a whole training state, the AdamW moments in the params' layout and
the step, both ways: with them a checkpoint written by either package
restores in the other.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.optim.adamw import AdamWState

_QT_FIELDS = ("data", "scale", "normal_dtype", "pair_axis", "orig_dim")
_MIXED_FIELDS = ("groups", "expert_ids", "n_experts")


def _fields(x, names):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return None
    if isinstance(x, dict) and set(names) <= set(x):
        return x
    if all(hasattr(x, f) for f in names):
        return {f: getattr(x, f) for f in names}
    return None


def _qt_fields(x):
    return _fields(x, _QT_FIELDS)


def _convert(x, device) -> Any:
    m = _fields(x, _MIXED_FIELDS)
    if m is not None:
        return MixedExpertQuant(
            groups=tuple(_convert(g, device) for g in m["groups"]),
            expert_ids=tuple(tuple(int(i) for i in ids)
                             for ids in m["expert_ids"]),
            n_experts=int(m["n_experts"]))
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
    return _tensor(x, device)


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if not (x.flags.c_contiguous and x.flags.writeable):
        # a read-only view of another array's buffer (a JAX array's) is
        # copied, since the port updates params and moments in place
        x = np.array(x, order="C")
    if x.dtype.name == "bfloat16":                      # ml_dtypes
        return torch.from_numpy(x.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(x, device=device)


def _slice(x, g: int):
    """Group g of a stacked subtree (a quantized leaf slices data and
    scale; its negative pair_axis stays valid)."""
    q = _qt_fields(x)
    if q is not None:
        return dict(q, data=q["data"][g], scale=q["scale"][g])
    if isinstance(x, dict):
        return {k: _slice(v, g) for k, v in x.items()}
    return x[g] if isinstance(x, torch.Tensor) else np.asarray(x)[g]


def _n_groups(x) -> int:
    q = _qt_fields(x)
    if q is not None:
        return np.shape(q["data"])[0]
    if isinstance(x, dict):
        return _n_groups(next(iter(x.values())))
    return x.shape[0]


def params_from_numpy(tree, device="cuda", mesh=None):
    """Reference tree (numpy leaves) -> port params on `device`. With a
    `launch.mesh.Mesh`, each piece (the top-level leaves, then each
    layer) is converted and cut to this rank's shards
    (`backends.sharded.place_params`) before the next one, so a
    reference tree serves sharded on `cuda_sharded`."""
    out = {k: v for k, v in tree.items() if k not in ("blocks", "tail")}
    if "enc_blocks" in tree:
        enc = tree["enc_blocks"]
        out["enc_blocks"] = [_slice(enc, i) for i in range(_n_groups(enc))]
    layers = list(tree.get("layers") or [])
    blocks = tree.get("blocks") or {}
    if blocks:
        period = len(blocks)
        for g in range(_n_groups(blocks["0"])):
            layers.extend(_slice(blocks[str(j)], g) for j in range(period))
    layers.extend(tree.get("tail") or [])
    if mesh is None:
        out["layers"] = layers
        return _convert(out, device)
    from repro_torch.backends.sharded import place_params
    placed = {k: place_params(_convert(v, device), k, mesh)
              for k, v in out.items()}
    placed["layers"] = [place_params(_convert(layer, device),
                                     f"layers/{i}", mesh)
                        for i, layer in enumerate(layers)]
    return placed


def _stack(trees):
    """Raw layer trees of one structure -> one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def params_to_reference(params, cfg):
    """Port params (raw tensors, unrolled) -> the reference's scanned
    tree: `blocks` {str(j): layers j, j + period, ... stacked} over the
    n_layers // period full periods, `tail` the layers after them, and
    an encoder's layers stacked into `enc_blocks`."""
    from repro_torch.core.qlinear import ENCODER
    period = len(cfg.block_pattern)
    layers = params["layers"]
    n_groups = len(layers) // period
    out = {k: v for k, v in params.items() if k not in ("layers", ENCODER)}
    out["blocks"] = {str(j): _stack(layers[j:n_groups * period:period])
                     for j in range(period)} if n_groups else {}
    out["tail"] = list(layers[n_groups * period:])
    if ENCODER in params:
        out[ENCODER] = _stack(params[ENCODER])
    return out


def state_to_reference(state, cfg):
    """A port `TrainState` -> the same NamedTuples with params and
    moments in the reference's scanned layout (`params_to_reference`)."""
    opt = state.opt
    return type(state)(
        params_to_reference(state.params, cfg),
        AdamWState(step=opt.step, mu=params_to_reference(opt.mu, cfg),
                   nu=params_to_reference(opt.nu, cfg)))


def state_from_reference(state, device="cuda"):
    """A reference training state (its `TrainState` with numpy leaves,
    or one `state_to_reference` shaped, with tensors) -> the port's
    `TrainState` on `device`: params and moments unrolled, the step an
    int32 scalar."""
    from repro_torch.train.train_step import TrainState
    opt = state.opt
    return TrainState(
        params=params_from_numpy(state.params, device),
        opt=AdamWState(step=_tensor(opt.step, device).to(torch.int32),
                       mu=params_from_numpy(opt.mu, device),
                       nu=params_from_numpy(opt.nu, device)))
