"""Per-architecture sharding rules and parameter spec derivation. Port
of `repro/sharding/rules.py`.

Physical mesh axes: ("pod", "data", "model") multi-pod, ("data",
"model") single pod. The mapping:

  DP    batch                    -> ("pod", "data")
  TP    heads / ffn / vocab dims -> "model" (divisibility-aware fallback)
  EP    MoE expert dim           -> "model" (fallback: TP inside the expert)
  SP    long-context KV seq dim  -> "data" (batch=1 cells)
  FSDP  weight reduction dims + optimizer state -> "data"

A spec is a `Spec`: a tuple with one entry per dimension, each an axis
name, a tuple of axis names, or None (replicated), as a JAX
`PartitionSpec` is. Every decision is a static function of (ArchConfig,
mesh axis sizes, leaf path and shape), so a placement and a dry run
derive identical layouts. The serving path holds every leaf as its
`param_spec` part (`backends/sharded.py::local_shard`) and every cache
as its `cache_pspecs` part (`make_kv_site`); the training mesh places
its state by `param_spec` too (`sharding/state.py`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ArchConfig

# weight-name classes: first of a pair (column-parallel: out dim -> TP)
# and second of a pair (row-parallel: in dim -> TP)
COL_PARALLEL = {"wq", "wk", "wv", "wg", "wu", "wi", "wz", "wi_gate",
                "wf_gate", "wo_gate", "wu2", "wx", "wgate", "w_up"}
ROW_PARALLEL = {"wo", "wd", "w_down", "wd2"}
REPLICATED_NAMES = {"gamma_scale", "beta_shift", "a_param", "fgate_bias",
                    "igate_bias", "conv_bias", "conv_kernel", "b_in", "bq",
                    "bk", "bv", "bi", "bd", "r_z", "r_i", "r_f", "w_gate",
                    "w_inp_gate", "w_rec_gate"}

SMALL_MODEL_PARAMS = int(2e9)   # below this, TP hurts: go pure DP/FSDP

Axis = Union[None, str, Tuple[str, ...]]


class Spec(tuple):
    """One leaf's layout: an entry per dimension (axis name, tuple of
    axis names, or None). `Spec(None, "model")` == (None, "model")."""

    def __new__(cls, *parts: Axis):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _replicated(rank: int) -> Spec:
    return Spec(*([None] * rank))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size for a name -> size dict, the port's `Mesh`
    (`launch/mesh.py`, whose `.shape` is such a dict) and a `MeshPlan`
    (whose `.shape` is a size tuple zipped against `.axis_names`). Only
    the tuple-shaped case is translated: an object with no `.shape` or
    `.axis_names`, or with mismatched lengths, raises instead of being
    treated as unsharded."""
    if isinstance(mesh, dict):
        return {str(k): int(v) for k, v in mesh.items()}
    shape = mesh.shape
    try:
        return dict(shape)
    except (TypeError, ValueError):
        pass                      # a plain size tuple
    names = tuple(mesh.axis_names)
    sizes = tuple(shape)
    if len(names) != len(sizes):
        raise ValueError(f"mesh axis_names {names!r} do not match mesh "
                         f"shape {sizes!r}")
    return dict(zip(names, sizes))


def use_dp_only(cfg: ArchConfig, mesh, global_batch: Optional[int]) -> bool:
    """Small models on big meshes: per-layer TP all-reduces dominate the
    step. When the global batch divides the WHOLE mesh, run pure
    data-parallel with FSDP-sharded weights instead. An sLSTM model keeps
    TP (its per-token recurrence closes replicated weights over a long
    scan, whose gradient a DP layout would reduce every step)."""
    if global_batch is None:
        return False
    if "slstm" in cfg.block_pattern:
        return False
    total = 1
    for v in mesh_axis_sizes(mesh).values():
        total *= v
    return (cfg.active_param_count() <= SMALL_MODEL_PARAMS
            and global_batch % total == 0)


def make_rules(cfg: ArchConfig, mesh, long_context: bool = False,
               global_batch: Optional[int] = None) -> Dict[str, Any]:
    """Logical-axis -> mesh-axis rules for activations and caches."""
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if use_dp_only(cfg, mesh, global_batch):
        return {"batch": tuple(sizes), "seq": None, "embed": None,
                "heads": None, "kv_heads": None, "ffn": None,
                "expert": None, "expert_cap": None, "vocab": None}

    def div(n):
        return n and n % tp == 0

    rules = {
        # long-context cells run batch=1: batch replicates and the
        # sequence/KV dim takes every data-parallel axis (SP)
        "batch": None if long_context else (batch_axes or None),
        "seq": (batch_axes or None) if long_context else None,
        "embed": None,
        "heads": "model" if div(cfg.n_heads) else None,
        "kv_heads": "model" if div(cfg.n_kv_heads) else None,
        "ffn": "model" if div(cfg.d_ff) else None,
        "expert": "model" if (cfg.n_experts and div(cfg.n_experts))
        else None,
        # MoE slot/capacity dim over "data", so few-expert MoEs (E < tp)
        # still keep their dispatched tokens distributed
        "expert_cap": "data" if "data" in sizes else None,
        "vocab": "model" if div(cfg.padded_vocab) else None,
    }
    for k in ("batch", "seq"):
        if isinstance(rules[k], tuple) and len(rules[k]) == 1:
            rules[k] = rules[k][0]
    return rules


def _parts(path) -> Tuple[str, ...]:
    """A leaf path as strings: a "/"-joined address, or a sequence of
    keys (strings, indices, or key objects with `.key` / `.idx`)."""
    if isinstance(path, str):
        return tuple(p for p in path.split("/") if p)
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _leaf_name(parts: Sequence[str]) -> str:
    # a quantized leaf ends in data / scale: classify by its parent
    if parts and parts[-1] in ("data", "scale"):
        return parts[-2] if len(parts) > 1 else parts[-1]
    return parts[-1] if parts else ""


def _is_scale(parts: Sequence[str]) -> bool:
    return bool(parts) and parts[-1] == "scale"


def param_spec(path, shape: Tuple[int, ...], cfg: ArchConfig,
               sizes: Dict[str, int], dp_only: bool = False) -> Spec:
    """The spec of one parameter leaf.

    2-D core weights: TP on the hidden dim, FSDP ("data") on the other.
    Stacked leading dims (layer groups, experts) are handled by
    position. dp_only: FSDP-shard the largest weight dim over every mesh
    axis, no tensor parallelism (recurrent weights are sharded too: a
    replicated weight closed over a scan would have its gradient reduced
    every step).
    """
    tp = sizes.get("model", 1)
    dp = sizes.get("data", 1)
    parts_of_path = _parts(path)
    name = _leaf_name(parts_of_path)
    pstr = "/".join(parts_of_path)
    rank = len(shape)

    if dp_only:
        if rank <= 1 or _is_scale(parts_of_path):
            return _replicated(rank)
        axes = tuple(sizes)
        full = 1
        for v in sizes.values():
            full *= v
        parts = [None] * rank
        every = axes if len(axes) > 1 else axes[0]
        if shape[-1] % full == 0:
            parts[-1] = every
        elif shape[-2] % full == 0:
            parts[-2] = every
        elif shape[-1] % dp == 0:
            parts[-1] = "data"
        elif shape[-2] % dp == 0:
            parts[-2] = "data"
        return Spec(*parts)

    def tp_ok(n):
        return n % tp == 0

    def dp_ok(n):
        return n % dp == 0

    if rank <= 1 or name in REPLICATED_NAMES:
        return _replicated(rank)

    if _is_scale(parts_of_path):
        # (..., 1, N) per-channel scales: shard N like the weight's out dim
        parts = [None] * rank
        if name in COL_PARALLEL and tp_ok(shape[-1]):
            parts[-1] = "model"
        return Spec(*parts)

    lead = [None] * (rank - 2)
    if name == "table":                         # embeddings
        v, d = shape[-2], shape[-1]
        if tp_ok(v):
            return Spec(*lead, "model", "data" if dp_ok(d) else None)
        return Spec(*lead, "data" if dp_ok(v) else None,
                    "model" if tp_ok(d) else None)
    if name == "w_out":
        d, v = shape[-2], shape[-1]
        return Spec(*lead, "data" if dp_ok(d) else None,
                    "model" if tp_ok(v) else None)
    if name == "w_in":                          # frontend projector
        return _replicated(rank)

    # MoE experts (..., E, K, N): EP on E when divisible, else TP inside
    if "experts" in pstr:
        e_idx = rank - 3
        parts = [None] * rank
        if tp_ok(shape[e_idx]):
            parts[e_idx] = "model"
            if dp_ok(shape[-2]):                # FSDP the larger dim
                parts[-2] = "data"
            elif dp_ok(shape[-1]):
                parts[-1] = "data"
        elif name in ROW_PARALLEL:
            if tp_ok(shape[-2]):
                parts[-2] = "model"
            if dp_ok(shape[-1]):
                parts[-1] = "data"
        else:
            if tp_ok(shape[-1]):
                parts[-1] = "model"
            if dp_ok(shape[-2]):
                parts[-2] = "data"
        return Spec(*parts)

    parts = [None] * rank
    if name in ROW_PARALLEL:
        if tp_ok(shape[-2]):
            parts[-2] = "model"
        if dp_ok(shape[-1]):
            parts[-1] = "data"
        return Spec(*parts)
    if name in COL_PARALLEL or name.startswith("w"):
        if tp_ok(shape[-1]):
            parts[-1] = "model"
        if dp_ok(shape[-2]):
            parts[-2] = "data"
        return Spec(*parts)
    return _replicated(rank)


def _map_leaves(tree, fn, path=()):
    """The tree's structure with fn(path, leaf) at each leaf: dicts,
    lists and tuples are walked, a quantized tensor becomes {"data",
    "scale"} (the reference's pytree children), anything with `.shape`
    is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    if hasattr(tree, "data") and hasattr(tree, "scale") \
            and hasattr(tree, "normal_dtype"):
        return {"data": fn(path + ("data",), tree.data),
                "scale": fn(path + ("scale",), tree.scale)}
    return fn(path, tree)


def params_pspecs(params, cfg: ArchConfig, mesh, dp_only: bool = False):
    """Specs in the structure of `params` (tensors, "meta" tensors or
    anything with a `.shape`)."""
    sizes = mesh_axis_sizes(mesh)
    return _map_leaves(params, lambda p, leaf: param_spec(
        p, tuple(leaf.shape), cfg, sizes, dp_only))


def cache_pspecs(caches, cfg: ArchConfig, mesh, long_context: bool = False):
    """KV-cache and recurrent-state specs.

    k/v (G?, B, S, H, D): batch over the DP axes (or seq over "data" for
    long-context SP), heads over "model" when divisible; when the KV
    heads do not divide, the KV seq dim shards over "model" instead
    (flash-decoding style). Recurrent states (G?, B, ...) shard their
    batch dim.
    """
    sizes = mesh_axis_sizes(mesh)
    tp = sizes.get("model", 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    if long_context:
        b_rule = None                     # batch=1: replicated
        s_rule = batch_axes or None       # SP over every DP axis
        if isinstance(s_rule, tuple) and len(s_rule) == 1:
            s_rule = s_rule[0]
    else:
        b_rule = batch_axes or None
        s_rule = None
    if isinstance(b_rule, tuple) and len(b_rule) == 1:
        b_rule = b_rule[0]

    def spec_for(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        rank = len(shape)
        if name in ("k", "v", "k_data", "v_data"):
            lead = [None] * (rank - 4) if rank >= 4 else []
            h, s = shape[-2], shape[-3]
            h_rule = "model" if h % tp == 0 else None
            kv_s_rule = s_rule
            if h_rule is None and s_rule is None and s % tp == 0:
                kv_s_rule = "model"
            return Spec(*lead, b_rule, kv_s_rule, h_rule, None)
        if name in ("k_scl", "v_scl"):
            lead = [None] * (rank - 3)
            h, s = shape[-1], shape[-2]
            kv_s_rule = s_rule
            if (h % tp) and s_rule is None and s % tp == 0:
                kv_s_rule = "model"
            return Spec(*lead, b_rule, kv_s_rule, None)
        # recurrent states: (G, B, ...) inside layer-group stacks, else
        # (B, ...)
        parts = [None] * rank
        idx = 1 if rank >= 2 and "blocks" in "/".join(path) else 0
        parts[idx] = b_rule if not long_context else None
        return Spec(*parts)

    return _map_leaves(caches, spec_for)
