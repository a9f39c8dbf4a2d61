"""Checkpoints: npz per step plus a JSON manifest, an async save thread,
restore into a template. Port of `repro/checkpoint/ckpt.py`, with the
same files, so either package restores the other's checkpoints.

Layout:
  <dir>/step_<N>/arrays.npz     flat {path: ndarray}
  <dir>/step_<N>/manifest.json  step, names, dtypes, shapes

A path is the reference's: dict keys and list indices joined by "/",
a NamedTuple field as ".<name>" (`state/.params/embed/table`,
`state/.opt/.mu/...`). bfloat16 has no numpy dtype: it is stored as its
uint16 bits, with "bfloat16" in the manifest. A save is only valid once
its directory is published by an atomic rename, with `manifest.json` in
it, so a preemption mid-write never leaves a checkpoint that restores
garbage; `.tmp_` leftovers are ignored, and only the newest `keep`
steps are kept. The host snapshot is taken before the write thread
starts, so the caller may update the tensors in place at once.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    if hasattr(tree, "_fields"):                        # NamedTuple
        return ((f".{f}", getattr(tree, f)) for f in tree._fields)
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} in the reference's path grammar."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_host(x):
    """(npz-safe array, true dtype name) of one leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":                      # ml_dtypes
        return x.view(np.uint16), "bfloat16"
    return x, str(x.dtype)


def save(ckpt_dir: str, step: int, tree: Any, blocking: bool = True,
         keep: int = 3) -> Optional[threading.Thread]:
    """Save `tree` (nested dicts, lists and NamedTuples of tensors or
    arrays) at `step`; returns the write thread when not blocking."""
    host = {k: _to_host(v) for k, v in flatten(tree).items()}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in host.items()})
        manifest = {"step": step,
                    "names": sorted(host),
                    "shapes": {k: list(a.shape) for k, (a, _) in host.items()},
                    "dtypes": {k: dt for k, (_, dt) in host.items()}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        _gc(ckpt_dir, keep)

    os.makedirs(ckpt_dir, exist_ok=True)
    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")):
            best = max(best or -1, int(d.split("_")[1]))
    return best


def _from_host(arr: np.ndarray, want: torch.dtype, device) -> torch.Tensor:
    if want == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device=device, dtype=want)


def restore(ckpt_dir: str, step: int, template: Any, device=None) -> Any:
    """Restore into the structure of `template` (tensors; their dtypes
    are the restored ones): each leaf reads its path and lands on the
    template leaf's device, or on `device` when given (a template on
    `device="meta"` costs nothing)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as data:

        def build(node, prefix):
            items = _items(node)
            if items is None:
                return _from_host(data[prefix], node.dtype,
                                  device if device is not None
                                  else node.device)
            kids = [(k, build(v, f"{prefix}/{k}" if prefix else str(k)))
                    for k, v in items]
            if isinstance(node, dict):
                return dict(kids)
            if hasattr(node, "_fields"):
                return type(node)(*(v for _, v in kids))
            return type(node)(v for _, v in kids)

        return build(template, "")
