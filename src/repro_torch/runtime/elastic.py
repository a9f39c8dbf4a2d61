"""Elastic scaling: re-plan the mesh when the healthy device count
changes. Port of `repro/runtime/elastic.py` (pure Python).

Checkpoints are mesh-agnostic (host arrays, with the layout re-derived
from the ArchConfig), so elasticity is: pick a new mesh shape, then
restore with the new placement. This module owns the shape-picking
policy; `launch/mesh.py` builds process groups for a plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped_devices: int

    @property
    def n_devices(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, prefer_model: int = 16,
              multi_pod_at: int = 512,
              global_batch: int = 256) -> MeshPlan:
    """Choose (pod, data, model) for the devices we actually have.

    Policy: keep TP ("model") at the largest power of two <= prefer_model
    that divides the device count; DP absorbs the rest; a "pod" axis
    appears when the fleet spans several 256-device pods. Devices that
    do not fit the factorisation are dropped (reported), so an elastic
    restart can go on with a ragged fleet.
    """
    if n_devices < 1:
        raise ValueError("no devices")
    model = 1
    while model * 2 <= prefer_model and n_devices % (model * 2) == 0:
        model *= 2
    rest = n_devices // model
    if n_devices >= multi_pod_at and rest % 2 == 0:
        pod = n_devices // 256 if n_devices % 256 == 0 else 2
        data = rest // pod
        if pod * data * model == n_devices and data >= 1:
            return MeshPlan((pod, data, model), ("pod", "data", "model"), 0)
    # single pod (or ragged): the largest usable count, with DP capped
    # so that the global batch still divides
    dropped = n_devices - rest * model
    data = rest
    while data > 1 and global_batch % data != 0:
        data -= 1
        dropped = n_devices - data * model
    return MeshPlan((data, model), ("data", "model"), dropped)


def resize_plan(old: MeshPlan, new_n_devices: int,
                global_batch: int = 256) -> Dict:
    """What changes when going from `old` to a new device count."""
    new = plan_mesh(new_n_devices, prefer_model=old.shape[-1],
                    global_batch=global_batch)
    return {
        "new_plan": new,
        "tp_changed": new.shape[-1] != old.shape[-1],
        "needs_reshard": new.shape != old.shape,
        "dp_ratio": (new.n_devices / new.shape[-1]) /
                    max(old.n_devices / old.shape[-1], 1),
    }
