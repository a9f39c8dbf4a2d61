"""Sharded CUDA backend: the hand-written kernels, one shard a rank, on
the "model" axis of a mesh of `torch.distributed` ranks. Port of
`repro/backends/sharded.py` (`pallas_sharded`; on CPU tensors the plain
versions, its `pallas_sharded_interpret`).

The reference wraps its kernels in `shard_map`; here every rank runs
the same program (SPMD) and the semantics are `shard_map`'s: the input
is replicated, each rank takes its local slice and runs the unmodified
single-device kernel on its local shard, and the output is the full
tensor on every rank:

- **TP, column-parallel** (sites whose leaf is not in
  `sharding/rules.py::ROW_PARALLEL`: `wq`, `wu`, `w_out`, ...): the packed
  weight `(K/2, N)` and its per-channel scale split N; the rank's
  output columns are all-gathered along N. Bit-identical to one device.
- **TP, row-parallel** (`wo`, `wd`, ...): the lhs and the packed weight
  split K in whole outlier-victim pairs (one packed row is a pair; int8
  codes need an even row count a shard), scales replicate, and the
  partial products are summed in rank order
  (`launch/mesh.py::rank_sum`). Equal to one device up to the fp32
  reassociation of the K sum.
- **EP** (grouped stacks `(E, K/2, N)`): E splits; each rank owns whole
  expert stacks and their `(E, ...)` scales, the lhs `(..., E, C, K)` and
  the fill `(..., E)` take the rank's experts, and the outputs are
  all-gathered along E. Bit-identical.
- **KV heads** (decode and paged prefill attention, slab and paged):
  every cache leaf carries Hkv at axis 2 (pool bytes, per-(token, head)
  scales, the raw prefill stage), so a rank's cache holds Hkv/tp heads
  (`make_kv_site` where the model allocates it); q
  arrives whole and the rank takes its H/tp query heads (the contiguous
  `h = kv * G + g` grouping keeps each query head with its KV head), and
  the output is all-gathered along H. Block tables and positions
  replicate. Bit-identical, every written pool byte included.

The activation scale of a W4A4/W4A8 call resolves on the full
replicated lhs before any slicing, so every rank quantizes at the scale
one device would, and OVP pair selection is pairwise-local: an even K
split reproduces the single-device codes.

Placement is the only way a weight or a cache reaches its shard.
`local_shard(w, site, mesh)` turns a `QuantizedTensor` into a
`QuantShard`, which records its layout ("col", "row" or "expert", read
off the site's leaf name): this rank's slice wherever the backend
serves it, and the whole weight, with the `shard_*` code it declines
by, wherever `shard_decline` would decline it, so the declined call's
fallback has the whole operand. The launcher applies it to each layer
as it is drawn (`place_params`). The cache makers allocate a site
through `make_kv_site`, which gives it this rank's KV heads wherever
the attention calls would serve a part (`local_kv_cache` cuts a whole
one the same way). A whole `QuantizedTensor`, or a whole cache the
backend would split, that reaches a call on a "model" axis > 1 was
never placed, and raises; so does a part of a cache that a kernel
declines, since no fallback serves a part of the heads.

Layouts the backend cannot shard decline with the `shard_*` codes of
`backends/base.py::DECLINE_CODES` and fall back one hop (to `eager`,
the reference's `xla`). Per-expert `MixedExpertQuant` stacks decline
whole (`shard_mixed_expert_group`). With no mesh installed every call
declines with `shard_no_mesh`; a "model" axis of 1 serves exactly as
`cuda`.

`shard_launches()` counts the K1 and K6 launches of the sharded calls
by layout ("ovp_matmul[fp]@col", "grouped[fp]@expert", ...): the
growth of each wrapper's own launch counter across the call.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.ovp import QuantizedTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import decode_attn, ovp_matmul
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime.elastic import MeshPlan
from repro_torch.sharding.rules import ROW_PARALLEL

from .base import decline, resolve_act_scale, torch_dtype
from .cuda import CudaBackend

# ---------------------------------------------------------------- mesh state
_MESH: Optional[mesh_lib.Mesh] = None

# the leaves of a cache site that carry Hkv at axis 2
KV_HEAD_KEYS = ("k", "v", "k_data", "v_data", "k_scl", "v_scl", "stage_k",
                "stage_v")

# K1/K6 launches of the sharded calls, "<counter>[<mode>]@<layout>"
_SHARD_LAUNCHES: collections.Counter = collections.Counter()


def shard_launches() -> Dict[str, int]:
    return dict(_SHARD_LAUNCHES)


def reset_shard_launches() -> None:
    _SHARD_LAUNCHES.clear()


def configure_mesh(plan=None) -> Optional[mesh_lib.Mesh]:
    """Install the mesh the sharded backend runs on (module-level state,
    as the registry itself). `plan` is a `runtime/elastic.py::MeshPlan`
    (built over the running process group), a ready `launch/mesh.py::
    Mesh`, or None to clear. Returns the installed mesh."""
    global _MESH
    if plan is None or isinstance(plan, mesh_lib.Mesh):
        _MESH = plan
        return plan
    if not isinstance(plan, MeshPlan):
        raise TypeError(f"configure_mesh takes a MeshPlan or a Mesh, got "
                        f"{type(plan).__name__}")
    _MESH = mesh_lib.make_mesh(plan.shape, plan.axis_names)
    return _MESH


def current_mesh() -> Optional[mesh_lib.Mesh]:
    return _MESH


def _model_axis() -> int:
    """Size of the "model" mesh axis; 0 = no mesh installed."""
    if _MESH is None:
        return 0
    return _MESH.size("model")


def _site_leaf(site: str) -> str:
    return site.rsplit("/", 1)[-1]


def row_shard_pair_aligned(k_rows: int, tp: int, packed: bool) -> bool:
    """Does a row-parallel K split over `tp` shards land every shard on
    whole outlier-victim pairs?

    `k_rows` is the K extent of the STORED code array (`w.data.shape[0]`):
    a packed row carries two 4-bit codes, one whole pair, so any even
    split of rows keeps pairs; int8 codes are one value a row, so each
    shard also needs an even row count. The pure predicate behind
    `shard_k_indivisible`; `repro_torch.analysis` sweeps it against the
    OVP pairing ground truth (a pair is 2 adjacent K values).
    """
    if k_rows % tp != 0:
        return False                     # ragged shards: K must divide
    values_per_row = 2 if packed else 1
    return (k_rows // tp) * values_per_row % 2 == 0


@dataclasses.dataclass
class QuantShard(QuantizedTensor):
    """A placed weight: one rank's shard of a `QuantizedTensor`, one of
    `parts`, in layout `mode`: "col" (N split), "row" (K split,
    `orig_dim` is the local K) or "expert" (E split). A weight placement
    keeps whole has `parts` 1 and `declined`, the `shard_*` code its
    calls decline by."""
    mode: str = "col"
    parts: int = 1
    declined: Optional[str] = None


def _layout(w: QuantizedTensor, site: str) -> str:
    if w.data.ndim == 3:
        return "expert"
    return "row" if _site_leaf(site) in ROW_PARALLEL else "col"


def shard_decline(w: QuantizedTensor, site: str, tp: int) -> Optional[str]:
    """The placement predicate of a whole weight over `tp` shards: None
    when the backend serves it sharded, else its `shard_*` code."""
    mode = _layout(w, site)
    if mode == "expert":
        if w.data.shape[0] % tp != 0:
            return decline("shard_expert_indivisible")
    elif mode == "row":
        if not row_shard_pair_aligned(w.data.shape[0], tp, w.is_packed):
            return decline("shard_k_indivisible")
    elif w.data.shape[-1] % tp != 0:
        return decline("shard_n_indivisible")
    return None


def local_shard(w, site: str, mesh: Optional[mesh_lib.Mesh] = None):
    """This rank's placed weight `w` at `site`: a `QuantShard` with the
    packed data (and per-channel or per-expert scales) sliced, or whole
    with its decline code where `shard_decline` declines it. Raw
    tensors (the embedding, an fp32 head, norms, biases, the router),
    per-expert `MixedExpertQuant` stacks and every weight on a "model"
    axis of 1 (or with no mesh) come back as they are."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or type(w) is not QuantizedTensor:
        return w
    tp = mesh.size("model")
    if tp == 1:
        return w
    mode = _layout(w, site)
    fields = dict(normal_dtype=w.normal_dtype, pair_axis=w.pair_axis,
                  mode=mode)
    code = shard_decline(w, site, tp)
    if code is not None:
        return QuantShard(data=w.data, scale=w.scale, orig_dim=w.orig_dim,
                          declined=code, **fields)
    r = mesh.coord("model")
    data, scale, orig_dim = w.data, w.scale, w.orig_dim

    def part(t, dim):
        n = t.shape[dim] // tp
        return t.narrow(dim, r * n, n).clone()

    if mode == "col":
        n = data.shape[-1]
        data = part(data, -1)
        if scale.ndim and scale.shape[-1] == n:
            scale = part(scale, -1)
    elif mode == "row":
        data = part(data, 0)
        orig_dim = orig_dim // tp
    else:
        e = data.shape[0]
        data = part(data, 0)
        if scale.ndim == data.ndim and scale.shape[0] == e:
            scale = part(scale, 0)
    return QuantShard(data=data, scale=scale, orig_dim=orig_dim, parts=tp,
                      **fields)


def place_params(tree, prefix: str = "", mesh=None):
    """`local_shard` over a parameter tree (dicts and lists), each leaf at
    its site address under `prefix`. Used on each layer as it is drawn,
    so a rank holds at most one whole layer beside its shards."""
    if isinstance(tree, dict):
        return {k: place_params(v, f"{prefix}/{k}" if prefix else str(k),
                                mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_params(v, f"{prefix}/{i}" if prefix else str(i), mesh)
                for i, v in enumerate(tree)]
    return local_shard(tree, prefix, mesh)


# --------------------------------------------------------------- KV heads
def _hkv_split_decline(hkv: int, tp: int) -> Optional[str]:
    if hkv < tp:
        return decline("shard_hkv_lt_axis")
    if hkv % tp != 0:
        return decline("shard_hkv_indivisible")
    return None


def mark_kv(cache, heads: Tuple[int, int], n_kv: int):
    """Record on a cache site's K leaf that it holds KV heads
    [heads[0], heads[0] + heads[1]) of `n_kv`. Returns the cache."""
    leaf = cache["k"] if "k" in cache else cache["k_data"]
    leaf.kv_heads = (heads[0], heads[1], n_kv)
    return cache


def cache_part(cache) -> Optional[Tuple[int, int, int]]:
    """(first head, count, whole Hkv) of a cache that holds a part of
    its heads, else None."""
    if cache is None:
        return None
    leaf = cache.get("k", cache.get("k_data"))
    return getattr(leaf, "kv_heads", None)


def cache_rows(x: torch.Tensor, cache) -> torch.Tensor:
    """The heads (axis 2) of new K or V rows x (B, T, Hkv, D) that
    `cache` holds: all of them for a whole cache."""
    part = cache_part(cache)
    return x if part is None else x.narrow(2, part[0], part[1])


def make_kv_site(make: Callable[[int], dict], n_kv: int, backend: str):
    """A KV cache site of `n_kv` heads, from `make(heads)`, for calls on
    `backend`: this rank's heads where the sharded backend on a "model"
    axis > 1 serves a part of them (the heads split evenly and the
    attention kernels take the part's layout: its head dim, page size
    and length), else the whole cache, whose calls then decline with the
    same code and fall back whole."""
    from repro_torch import backends
    tp = _model_axis()
    if tp <= 1 or not backend or not isinstance(
            backends.get_backend(backend), ShardedCudaBackend) \
            or _hkv_split_decline(n_kv, tp) is not None:
        return make(n_kv)
    n = n_kv // tp
    cache = mark_kv(make(n), (_MESH.coord("model") * n, n), n_kv)
    one_token = torch.empty((1, 1), device="meta")
    if decode_attn.decline_reason(one_token, cache) is not None:
        return make(n_kv)
    return cache


def local_kv_cache(cache, mesh=None):
    """This rank's part of a whole cache site (a copy): every Hkv-carrying
    leaf sliced at axis 2, the rest (block table, src_len) shared;
    marked for the attention calls. A cache the backend would decline
    (or a "model" axis of 1) comes back as it is."""
    mesh = mesh if mesh is not None else _MESH
    tp = mesh.size("model") if mesh is not None else 1
    leaf = cache.get("k", cache.get("k_data"))
    hkv = int(leaf.shape[2])
    if tp == 1 or _hkv_split_decline(hkv, tp) is not None:
        return cache
    n = hkv // tp
    h0 = mesh.coord("model") * n
    specs = ShardedCudaBackend._cache_specs(cache)
    out = {key: (val.narrow(2, h0, n).clone() if specs[key] is not None
                 else val) for key, val in cache.items()}
    return mark_kv(out, (h0, n), hkv)


class ShardedCudaBackend(CudaBackend):
    name = "cuda_sharded"

    # -- quantized matmul --------------------------------------------------
    @staticmethod
    def _experts(w) -> int:
        if isinstance(w, QuantShard) and w.mode == "expert":
            return w.data.shape[0] * w.parts
        return w.data.shape[0]

    def decline_reason(self, x, w: QuantizedTensor,
                       policy: QuantPolicy) -> Optional[str]:
        tp = _model_axis()
        if isinstance(w, QuantShard) and w.parts not in (1, tp):
            raise ValueError(f"a shard of {w.parts} parts reached "
                             f"cuda_sharded on a \"model\" axis of {tp}")
        reason = super().decline_reason(x, w, policy)
        if reason is not None:
            return reason
        if tp == 0:
            return decline("shard_no_mesh")
        if tp == 1:
            return None
        if not isinstance(w, QuantShard):
            raise ValueError(
                f"a whole QuantizedTensor {tuple(w.data.shape)} reached "
                f"cuda_sharded on a \"model\" axis of {tp}: place the "
                f"weights first (backends.sharded.place_params)")
        return decline(w.declined)

    def mixed_expert_decline_reason(self, x, w, policy) -> Optional[str]:
        # ragged static expert groups: splitting E would unbalance shards
        return decline("shard_mixed_expert_group")

    @staticmethod
    def _counted(fn, name: str, layout: str, *args, **kw):
        """fn(*args, **kw), adding the growth of its launch counter to
        `_SHARD_LAUNCHES` under its layout."""
        before = dict(fn.mode_launches)
        out = fn(*args, **kw)
        for mode, n in fn.mode_launches.items():
            if n != before.get(mode, 0):
                _SHARD_LAUNCHES[f"{name}[{mode}]@{layout}"] += \
                    n - before.get(mode, 0)
        return out

    def matmul(self, x: torch.Tensor, w: QuantizedTensor,
               policy: QuantPolicy,
               act_scale: Optional[torch.Tensor] = None,
               fill: Optional[torch.Tensor] = None) -> torch.Tensor:
        tp = _model_axis()
        if tp <= 1:
            return super().matmul(x, w, policy, act_scale=act_scale,
                                  fill=fill)
        # the A-side scale resolves on the full lhs, before any slicing
        a_dtype = scale = static = None
        if policy.abits:
            scale, a_dtype = resolve_act_scale(x, policy, act_scale)
            if isinstance(scale, float):
                static, scale = scale, None
        cdt = torch_dtype(policy.compute_dtype)
        r = _MESH.coord("model")
        kw = dict(a_dtype=a_dtype, act_scale=scale, static_act_scale=static)
        if w.mode == "expert":
            e = w.data.shape[0]
            xl = x.narrow(x.ndim - 3, r * e, e)
            if isinstance(scale, torch.Tensor) and scale.ndim >= 2:
                if scale.shape[-2:] == x.shape[-3:-1]:
                    kw["act_scale"] = scale.narrow(scale.ndim - 2, r * e, e)
                elif scale.ndim >= 3 and scale.shape[-1] == 1 \
                        and scale.shape[-3:-1] == x.shape[-3:-1]:
                    kw["act_scale"] = scale.narrow(scale.ndim - 3, r * e, e)
            fl = None if fill is None else fill.narrow(fill.ndim - 1,
                                                       r * e, e)
            out = self._counted(ovp_matmul.grouped_ovp_matmul, "grouped",
                                "expert", xl, w, fill=fl, **kw)
            return mesh_lib.all_gather(out.to(cdt), x.ndim - 3, _MESH)
        if w.mode == "row":
            k = w.orig_dim
            part = self._counted(ovp_matmul.fused_ovp_matmul, "ovp_matmul",
                                 "row", x.narrow(x.ndim - 1, r * k, k), w,
                                 **kw)
            return mesh_lib.rank_sum(part.to(cdt), _MESH)
        out = self._counted(ovp_matmul.fused_ovp_matmul, "ovp_matmul", "col",
                            x, w, **kw)
        return mesh_lib.all_gather(out.to(cdt), x.ndim - 1, _MESH)

    # -- decode / prefill attention over Hkv-split caches ------------------
    def _hkv_decline(self, reason: Optional[str], cache) -> Optional[str]:
        """The sharded decline of a (q, cache) call the parent's
        predicate answered with `reason`."""
        tp = _model_axis()
        part = cache_part(cache)
        if part is not None:
            if reason is None and tp != part[2] // part[1]:
                reason = "a \"model\" axis of " + str(tp)
            if reason is not None:
                raise ValueError(
                    f"a cache holding KV heads {part[0]}..{part[0] + part[1]}"
                    f" of {part[2]} cannot be served ({reason}): no "
                    f"fallback serves a part of the heads")
            return None
        if reason is not None:
            return reason
        if tp == 0:
            return decline("shard_no_mesh")
        leaf = cache.get("k", cache.get("k_data")) if cache else None
        if tp == 1 or leaf is None:
            return None          # the parent's codes already cover it
        hkv = int(leaf.shape[2])
        code = _hkv_split_decline(hkv, tp)
        if code is None:
            raise ValueError(
                f"a whole cache of {hkv} KV heads reached cuda_sharded on a "
                f"\"model\" axis of {tp}: allocate it split "
                f"(backends.sharded.make_kv_site) or place it "
                f"(local_kv_cache)")
        return code

    @staticmethod
    def _cache_specs(cache):
        """Which leaves split: every K/V leaf (pool bytes, scales, the
        staged prefill K/V) carries Hkv at axis 2 and splits there; the
        block table, src_len and any other bookkeeping replicate. A spec
        per leaf: the split axis, or None."""
        return {name: (2 if name in KV_HEAD_KEYS else None)
                for name in cache}

    @staticmethod
    def _local_q(q: torch.Tensor, cache) -> torch.Tensor:
        """The query heads of the KV heads a placed cache holds (the
        contiguous h = kv * G + g grouping)."""
        first, count, hkv = cache_part(cache)
        g = q.shape[2] // hkv
        return q.narrow(2, first * g, count * g)

    def decode_attn_decline_reason(self, q, cache) -> Optional[str]:
        return self._hkv_decline(super().decode_attn_decline_reason(q, cache),
                                 cache)

    def decode_attention(self, q: torch.Tensor, cache, pos: torch.Tensor,
                         *, window: int = 0, ring: int = 0) -> torch.Tensor:
        if cache_part(cache) is None:
            return super().decode_attention(q, cache, pos, window=window,
                                            ring=ring)
        out = super().decode_attention(self._local_q(q, cache), cache, pos,
                                       window=window, ring=ring)
        return mesh_lib.all_gather(out, 2, _MESH)

    def prefill_attn_decline_reason(self, q, cache) -> Optional[str]:
        return self._hkv_decline(
            super().prefill_attn_decline_reason(q, cache), cache)

    def prefill_attention(self, q: torch.Tensor, cache,
                          positions: torch.Tensor):
        if cache_part(cache) is None:
            return super().prefill_attention(q, cache, positions)
        out, cache = super().prefill_attention(self._local_q(q, cache),
                                               cache, positions)
        return mesh_lib.all_gather(out, 2, _MESH), cache
