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
- **KV slots** (slab and ring caches whose KV heads do not divide
  "model"; in a long-context cell, every slab over the batch axes): the
  reference's `cache_pspecs` splits the sequence instead, flash-decoding
  style, so a rank holds slots [r·S/n, (r+1)·S/n) (`make_kv_site`,
  `kv_seq_axes`). The KV write is masked to the slot's owner
  (`layers.cache_write`); K2 declines the part with the reference's
  `shard_hkv_lt_axis` / `shard_hkv_indivisible`, and
  `seq_decode_attention` computes each rank's partial (m, l, acc) over
  its slots and combines the gathered parts in rank order, the combine
  GSPMD inserts for the reference. Paged pools keep the heads split (or
  whole).

The activation scale of a W4A4/W4A8 call resolves on the full
replicated lhs before any slicing, so every rank quantizes at the scale
one device would, and OVP pair selection is pairwise-local: an even K
split reproduces the single-device codes.

Placement is the only way a weight or a cache reaches its part, and it
is the reference's: every leaf is held as the part its
`sharding/rules.py::param_spec` gives it (`local_shard`, `place_params`,
applied by the launcher to each layer as it is drawn). A
`QuantizedTensor` becomes a `QuantShard`: "model" on the dim its layout
computes ("col", "row" or "expert", read off the site's leaf name),
"data" (FSDP) on the other, gathered over the batch axes when its layer
runs (`gathered`, in `backends.dispatch`). A weight the spec does not
split over "model" computes whole on every rank ("whole"); one whose
split `shard_decline` declines is held whole along "model" with its
code, so the declined call's fallback has the whole operand; an expert
stack whose E does not divide is split inside each expert as the spec
says, and its declined calls compute that split on the fallback
(`declined_split_matmul`). Raw leaves (linears under `--quant none` or
a baseline, the embedding, an fp32 head, an mLSTM's gate projections)
are held as their parts with the spec as `.placed`: `raw_matmul` runs
the same column / row / expert logic through `torch.matmul`,
`embed_lookup` looks up a vocab-split table (masked rows, a rank-order
sum), and a tied head computes its vocab columns and gathers them. A
whole `QuantizedTensor`, or a whole cache the backend would split, that
reaches a call on a "model" axis > 1 was never placed, and raises; so
does a part of a cache's heads that a kernel declines, since no
fallback serves a part of the heads.

Layouts the backend cannot shard decline with the `shard_*` codes of
`backends/base.py::DECLINE_CODES` and fall back one hop (to `eager`,
the reference's `xla`). Per-expert `MixedExpertQuant` stacks decline
whole (`shard_mixed_expert_group`): their groups are held as their
parts and gathered whole for the call. With no mesh installed every
call declines with `shard_no_mesh`; a "model" axis of 1 serves exactly
as `cuda`.

`shard_launches()` counts the K1 and K6 launches of the sharded calls
by layout ("ovp_matmul[fp]@col", "grouped[fp]@expert", ...): the
growth of each wrapper's own launch counter across the call.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.ovp import MixedExpertQuant, QuantizedTensor
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import decode_attn, ovp_matmul
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime.elastic import MeshPlan
from repro_torch.sharding import state as placement
from repro_torch.sharding.rules import (ROW_PARALLEL, Spec, mesh_axis_sizes,
                                        param_spec)

from .base import decline, resolve_act_scale, torch_dtype
from .cuda import CudaBackend

# ---------------------------------------------------------------- mesh state
_MESH: Optional[mesh_lib.Mesh] = None
# a long-context cell's caches split their slots over the batch axes
_LONG_CONTEXT = False

BATCH_AXES = ("pod", "data")
NEG_INF = -1e30

# the leaves of a cache site that carry Hkv at axis 2
KV_HEAD_KEYS = ("k", "v", "k_data", "v_data", "k_scl", "v_scl", "stage_k",
                "stage_v")

# K1/K6 launches of the sharded calls, "<counter>[<mode>]@<layout>"
_SHARD_LAUNCHES: collections.Counter = collections.Counter()


def shard_launches() -> Dict[str, int]:
    return dict(_SHARD_LAUNCHES)


def reset_shard_launches() -> None:
    _SHARD_LAUNCHES.clear()


def configure_mesh(plan=None, long_context: bool = False
                   ) -> Optional[mesh_lib.Mesh]:
    """Install the mesh the sharded backend runs on (module-level state,
    as the registry itself). `plan` is a `runtime/elastic.py::MeshPlan`
    (built over the running process group), a ready `launch/mesh.py::
    Mesh`, or None to clear. `long_context`: the caches made under it
    split their slots over the batch axes (a long-context cell, batch
    1). Returns the installed mesh."""
    global _MESH, _LONG_CONTEXT
    _LONG_CONTEXT = bool(long_context)
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


def long_context() -> bool:
    return _LONG_CONTEXT


def _ranks(mesh) -> int:
    n = 1
    for a in mesh.axis_names:
        n *= mesh.size(a)
    return n


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
    """A placed weight: one rank's part of a `QuantizedTensor` under its
    `param_spec`. `spec` / `scale_spec` are the held layouts of `data` /
    `scale` (None: whole); a dim split over the batch axes ("data",
    "pod", FSDP) is gathered when the layer runs (`gathered`). `mode`
    is the layout the "model" part computes in: "col" (N split), "row"
    (K split, `orig_dim` is the local K), "expert" (E split), or
    "whole" (no "model" split: computed whole on every rank, on the
    kernel); `parts` the "model" parts. A weight whose "model" split
    the backend cannot compute is held whole along it, with
    `declined`, the `shard_*` code its calls decline by."""
    mode: str = "col"
    parts: int = 1
    declined: Optional[str] = None
    spec: Optional[Spec] = None
    scale_spec: Optional[Spec] = None


def _layout(w: QuantizedTensor, site: str) -> str:
    if w.data.ndim == 3:
        return "expert"
    return "row" if _site_leaf(site) in ROW_PARALLEL else "col"


# the dim of a weight's data that the "model" axis splits, by layout
_MODEL_DIM = {"col": -1, "row": -2, "expert": -3}


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


# ------------------------------------------------------------ placement
def _batch_entry(entry) -> bool:
    """Whether a spec entry splits over batch axes only (FSDP)."""
    axes = placement._axes(entry)
    return bool(axes) and all(a in BATCH_AXES for a in axes)


def _drop_model(spec: Spec) -> Spec:
    """`spec` with "model" taken off every dim."""
    return Spec(*(None if "model" in placement._axes(e) else e for e in spec))


def leaf_spec(site: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The reference's `param_spec` of the leaf at `site` (a "/"-joined
    address ending in "data" / "scale" for a quantized weight's fields)
    on `mesh`, as the serving cell asks it (no dp_only)."""
    return param_spec(site, tuple(shape), None, mesh_axis_sizes(mesh))


def _cut(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    return placement.local_part(x, spec, mesh).clone()


def _place_quantized(w: QuantizedTensor, site: str, mesh) -> QuantShard:
    tp = mesh.size("model")
    spec = leaf_spec(f"{site}/data", w.data.shape, mesh)
    mode = _layout(w, site)
    code = shard_decline(w, site, tp) if tp > 1 else None
    split_declined = False
    if mode == "expert" and code is not None and "model" in spec[1:]:
        # E does not divide: the reference's rule splits each expert's
        # N (wg, wu) or K (wd) instead. K6 declines such a part, as the
        # reference's kernel does, and its fallback computes it column-
        # or row-parallel (`declined_split_matmul`)
        mode = "col" if spec[-1] == "model" else "row"
        split_declined = mode == "col" or row_shard_pair_aligned(
            w.data.shape[-2], tp, w.is_packed)
    dim = _MODEL_DIM[mode] % w.data.ndim
    if spec[dim] != "model" or tp == 1 or (code is not None
                                           and not split_declined):
        # no "model" split the backend computes: whole along "model"
        spec, mode, parts = _drop_model(spec), "whole", 1
    else:
        parts = tp
    if w.scale.ndim == 0:
        sspec = Spec()
    elif mode == "expert":
        # an expert stack's (E, 1, N) scales follow its E split (the
        # reference's effective layout: its `.scale` key misses the
        # scale rule and takes the expert one's E split)
        sspec = Spec("model", *([None] * (w.scale.ndim - 1)))
    else:
        sspec = _drop_model(leaf_spec(f"{site}/scale", w.scale.shape, mesh))
        if mode == "col" and w.scale.shape[-1] == w.data.shape[-1]:
            # per-channel scales go with the columns
            sspec = Spec(*sspec[:-1], "model")
    orig_dim = w.orig_dim // tp if mode == "row" else w.orig_dim
    return QuantShard(data=_cut(w.data, spec, mesh),
                      scale=_cut(w.scale, sspec, mesh) if sspec
                      else w.scale, orig_dim=orig_dim,
                      normal_dtype=w.normal_dtype, pair_axis=w.pair_axis,
                      mode=mode, parts=parts, declined=code, spec=spec,
                      scale_spec=sspec)


def _place_raw(x: torch.Tensor, site: str, mesh) -> torch.Tensor:
    """A raw leaf's part under its spec, the spec recorded on the part
    as `.placed` (a leaf the spec replicates comes back as it is)."""
    spec = leaf_spec(site, x.shape, mesh)
    if all(placement._part(e, mesh)[1] == 1 for e in spec):
        return x
    part = _cut(x, spec, mesh)
    part.placed = spec
    return part


def local_shard(w, site: str, mesh: Optional[mesh_lib.Mesh] = None):
    """This rank's placed leaf `w` at `site` under the reference's
    `param_spec` (`sharding/rules.py`): a `QuantizedTensor` becomes a
    `QuantShard` (its "model" part in the layout the backend computes,
    FSDP parts over the batch axes; whole along "model", with its
    decline code, where `shard_decline` declines the split); a
    `MixedExpertQuant` holds each group as its part (its calls decline
    whole, `shard_mixed_expert_group`, and gather the groups first); a
    raw tensor its part, with the spec as `.placed`, unless the spec
    replicates it (norms, biases, the router, the recurrent blocks).
    With no mesh, or a mesh of one rank, `w` comes back as it is."""
    mesh = mesh if mesh is not None else _MESH
    if mesh is None or _ranks(mesh) == 1:
        return w
    if isinstance(w, MixedExpertQuant):
        groups = tuple(
            dataclasses.replace(_place_quantized(g, site, mesh),
                                mode="whole", parts=1, declined=decline(
                                    "shard_mixed_expert_group"))
            if isinstance(g, QuantizedTensor) else _place_raw(g, site, mesh)
            for g in w.groups)
        return dataclasses.replace(w, groups=groups)
    if type(w) is QuantizedTensor:
        return _place_quantized(w, site, mesh)
    if isinstance(w, torch.Tensor) and w.is_floating_point():
        return _place_raw(w, site, mesh)
    return w


def place_params(tree, prefix: str = "", mesh=None):
    """`local_shard` over a parameter tree (dicts and lists), each leaf at
    its site address under `prefix`. Used on each layer as it is drawn,
    so a rank holds at most one whole layer beside its parts."""
    if isinstance(tree, dict):
        return {k: place_params(v, f"{prefix}/{k}" if prefix else str(k),
                                mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_params(v, f"{prefix}/{i}" if prefix else str(i), mesh)
                for i, v in enumerate(tree)]
    return local_shard(tree, prefix, mesh)


def _gather(x: torch.Tensor, spec: Optional[Spec], only=None):
    """`sharding/state.py::gather` of a part held under `spec` (None:
    whole) over the running mesh, the dims `only` accepts."""
    return x if spec is None else placement.gather(x, spec, _MESH, only)


def gathered(w):
    """The leaf a layer computes with: a placed leaf's FSDP parts (dims
    split over the batch axes) gathered, its "model" part kept (a
    declined `MixedExpertQuant` group: gathered whole). Unplaced leaves
    come back as they are."""
    if isinstance(w, MixedExpertQuant):
        if not any(isinstance(g, QuantShard) or hasattr(g, "placed")
                   for g in w.groups):
            return w
        groups = tuple(
            dataclasses.replace(g, data=_gather(g.data, g.spec),
                                scale=_gather(g.scale, g.scale_spec),
                                spec=None, scale_spec=None)
            if isinstance(g, QuantShard) else whole(g) for g in w.groups)
        return dataclasses.replace(w, groups=groups)
    if isinstance(w, QuantShard):
        if not any(_batch_entry(e) for e in (w.spec or ()) +
                   tuple(w.scale_spec or ())):
            return w
        return dataclasses.replace(
            w, data=_gather(w.data, w.spec, _batch_entry),
            scale=_gather(w.scale, w.scale_spec, _batch_entry),
            spec=_drop_batch(w.spec), scale_spec=_drop_batch(w.scale_spec))
    spec = getattr(w, "placed", None)
    if spec is None or not any(_batch_entry(e) for e in spec):
        return w
    out = _gather(w, spec, _batch_entry)
    out.placed = _drop_batch(spec)
    return out


def _drop_batch(spec: Optional[Spec]) -> Optional[Spec]:
    if spec is None:
        return None
    return Spec(*(None if _batch_entry(e) else e for e in spec))


def whole(w):
    """A placed raw leaf gathered whole (every split dim): for leaves a
    layer reads outside a matmul (an mLSTM's gate projections). Unplaced
    tensors come back as they are."""
    return _gather(w, getattr(w, "placed", None))


def _model_dim(spec: Optional[Spec]) -> Optional[int]:
    if spec is None:
        return None
    dims = [i for i, e in enumerate(spec) if "model" in placement._axes(e)]
    return dims[0] if dims else None


def declined_split_matmul(x: torch.Tensor, w: QuantShard,
                          policy: QuantPolicy,
                          fill: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """An expert stack split inside each expert (E does not divide
    "model"), which K6 declines: the fallback backend's matmul on this
    rank's part, column-parallel (N split: the columns gathered) or
    row-parallel (K split: this rank's slice of the lhs, the partial
    products summed in rank order), as XLA computes the reference's
    declined call. Expert stacks are weight-only (no activation
    scale)."""
    from repro_torch import backends
    fallback = backends.get_backend(
        backends.get_backend(policy.backend).fallback)
    cdt = torch_dtype(policy.compute_dtype)
    if w.mode == "row":
        k = w.orig_dim
        part = fallback.matmul(
            x.narrow(x.ndim - 1, _MESH.coord("model") * k, k), w, policy,
            fill=fill)
        return mesh_lib.rank_sum(part.to(cdt), _MESH)
    out = fallback.matmul(x, w, policy, fill=fill)
    return mesh_lib.all_gather(out.to(cdt), x.ndim - 1, _MESH)


def raw_matmul(x: torch.Tensor, w: torch.Tensor,
               cdt: torch.dtype) -> torch.Tensor:
    """x (..., K) @ a placed raw weight (K, N), or an (..., E, C, K) lhs
    @ a raw expert stack (E, K, N), in `cdt`: the FSDP parts gathered,
    then the "model" part computed as the quantized weights are:
    column-parallel (N split: the columns gathered), row-parallel (K
    split: this rank's slice of x, partial products summed in rank
    order) or expert-parallel (E split: the outputs gathered along E);
    `torch.matmul` on the local part."""
    w = gathered(w)
    dim = _model_dim(getattr(w, "placed", None))
    if dim is None:
        return torch.matmul(x.to(cdt), w.to(cdt))
    r, nd = _MESH.coord("model"), w.ndim
    if dim == nd - 1:
        return mesh_lib.all_gather(torch.matmul(x.to(cdt), w.to(cdt)),
                                   x.ndim - 1, _MESH)
    if dim == nd - 2:
        k = w.shape[-2]
        part = torch.matmul(x.narrow(x.ndim - 1, r * k, k).to(cdt),
                            w.to(cdt))
        return mesh_lib.rank_sum(part, _MESH)
    e = w.shape[0]
    part = torch.matmul(x.narrow(x.ndim - 3, r * e, e).to(cdt), w.to(cdt))
    return mesh_lib.all_gather(part, x.ndim - 3, _MESH)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of a placed embedding table: FSDP parts gathered; a vocab
    split ("model" on V) looks up the ids it holds, zeros elsewhere,
    and sums the ranks' rows in rank order; a width split gathers the
    rows' columns. An unplaced table is a plain lookup."""
    table = gathered(table)
    dim = _model_dim(getattr(table, "placed", None))
    if dim is None:
        return torch.nn.functional.embedding(tokens, table)
    if dim == 1:
        return mesh_lib.all_gather(
            torch.nn.functional.embedding(tokens, table), -1, _MESH)
    n = table.shape[0]
    local = tokens.to(torch.int64) - _MESH.coord("model") * n
    held = (local >= 0) & (local < n)
    rows = torch.nn.functional.embedding(torch.clamp(local, 0, n - 1), table)
    rows = torch.where(held[..., None], rows, torch.zeros_like(rows))
    return mesh_lib.rank_sum(rows, _MESH)


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


# ------------------------------------------------------ KV sequence parts
def mark_slots(cache, first: int, count: int, length: int,
               axes: Tuple[str, ...]):
    """Record on a cache site's K leaf that it holds slots [first, first
    + count) of `length`, split over the mesh axes `axes`."""
    leaf = cache["k"] if "k" in cache else cache["k_data"]
    leaf.kv_slots = (first, count, length, tuple(axes))
    return cache


def seq_part(cache) -> Optional[Tuple[int, int, int, Tuple[str, ...]]]:
    """(first slot, count, whole length, split axes) of a cache that
    holds a part of its slots, else None."""
    if cache is None:
        return None
    leaf = cache.get("k", cache.get("k_data"))
    return getattr(leaf, "kv_slots", None)


def kv_seq_axes(n_kv: int, length: int, mesh=None,
                long_context: Optional[bool] = None) -> Tuple[str, ...]:
    """The mesh axes a KV cache of `n_kv` heads and `length` slots
    splits its slots over: the reference's `cache_pspecs` rule. Where
    the heads do not divide "model", "model" (flash-decoding style); in
    a long-context cell, the batch axes. () where the slots stay whole
    (the heads split, or nothing divides)."""
    mesh = mesh if mesh is not None else _MESH
    long_context = _LONG_CONTEXT if long_context is None else long_context
    if mesh is None:
        return ()
    tp = mesh.size("model")
    if long_context:
        axes = tuple(a for a in BATCH_AXES if mesh.size(a) > 1)
        if not axes:
            return ()
        if tp > 1 and n_kv % tp == 0:
            raise NotImplementedError(
                f"a long-context cache of {n_kv} KV heads splits its heads "
                f"over \"model\" and its slots over {axes}: the port "
                f"splits one or the other")
    else:
        if tp == 1 or n_kv % tp == 0:
            return ()
        axes = ("model",)
    parts = 1
    for a in axes:
        parts *= mesh.size(a)
    return axes if length % parts == 0 else ()


def _axes_part(axes: Tuple[str, ...], mesh) -> Tuple[int, int]:
    """(this rank's part, parts) of a dim split over `axes`, in the
    order a PartitionSpec cuts it."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.size(a) + mesh.coord(a)
        n *= mesh.size(a)
    return idx, n


def make_kv_site(make: Callable, n_kv: int, backend: str,
                 length: Optional[int] = None):
    """A KV cache site of `n_kv` heads, from `make(heads)` (or, given the
    slab's `length`, `make(heads, slots)`), for calls on `backend`. On
    the sharded backend over a "model" axis > 1: this rank's heads
    where they split evenly and the attention kernels take the part's
    layout (its head dim, page size and length); else, for a slab of
    `length` slots, this rank's slots where the reference's
    `cache_pspecs` splits them (`kv_seq_axes`), which the decode
    attention then serves as a partial attention and a rank-order
    combine; else the whole cache, whose calls then decline with the
    same code and fall back whole."""
    from repro_torch import backends
    tp = _model_axis()
    if _MESH is None or not backend or not isinstance(
            backends.get_backend(backend), ShardedCudaBackend):
        return make(n_kv)
    seq = kv_seq_axes(n_kv, length, _MESH) if length else ()
    if seq:
        idx, parts = _axes_part(seq, _MESH)
        count = length // parts
        return mark_slots(make(n_kv, count), idx * count, count, length, seq)
    if tp <= 1 or _hkv_split_decline(n_kv, tp) is not None:
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


def local_kv_slots(cache, mesh=None, axes: Tuple[str, ...] = ("model",)):
    """This rank's slots of a whole slab cache site (a copy): every K/V
    leaf sliced at axis 1 over `axes`, the rest shared; marked for the
    attention calls."""
    mesh = mesh if mesh is not None else _MESH
    leaf = cache.get("k", cache.get("k_data"))
    length = int(leaf.shape[1])
    idx, parts = _axes_part(axes, mesh)
    count = length // parts
    out = {key: (val.narrow(1, idx * count, count).clone()
                 if key in KV_HEAD_KEYS else val)
           for key, val in cache.items()}
    return mark_slots(out, idx * count, count, length, axes)


def seq_decode_attention(q: torch.Tensor, cache, pos: torch.Tensor, *,
                         window: int = 0, ring: int = 0) -> torch.Tensor:
    """Single-token attention over a cache that holds a part of its slots
    (`seq_part`): this rank's plain attention over its slots (each
    slot's position from its global index, and on a ring from `pos`),
    kept as the partial (m, l, acc) of an online softmax, then the
    parts gathered over the split axes and combined in rank order, acc =
    Σ exp(m_r - m*)·acc_r / Σ exp(m_r - m*)·l_r: the combine GSPMD
    inserts for the reference's sequence-split cache. q (B, 1, H, D) ->
    (B, 1, H, D)."""
    first, count, length, axes = seq_part(cache)
    b, _, h, d = q.shape
    f32 = torch.float32
    if "k_data" in cache:
        k = decode_attn.dequant_codes(cache["k_data"])
        v = decode_attn.dequant_codes(cache["v_data"])
    else:
        k, v = cache["k"].to(f32), cache["v"].to(f32)
    hkv = k.shape[2]
    g = h // hkv
    qf = q.reshape(b, hkv, g, d).to(f32) / decode_attn._qscale(d)
    s = torch.matmul(qf, k.permute(0, 2, 3, 1))              # (B,Hkv,G,S)
    if "k_data" in cache:
        s = s * cache["k_scl"].permute(0, 2, 1)[:, :, None, :]
    slots = torch.arange(first, first + count, device=q.device)
    _, valid = decode_attn.slot_validity(pos.to(torch.int64), slots,
                                         window=window,
                                         ring=length if ring else 0)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    if "k_data" in cache:
        p = p * cache["v_scl"].permute(0, 2, 1)[:, :, None, :]
    acc = torch.matmul(p, v.permute(0, 2, 1, 3))             # (B,Hkv,G,D)
    parts = torch.cat([m, l_sum, acc], dim=-1)[None]
    for a in reversed(axes):
        parts = mesh_lib.all_gather(parts, 0, _MESH, a)
    m_star = parts[..., :1].amax(dim=0)
    num = den = None
    for part in parts:                                       # rank order
        w = torch.exp(part[..., :1] - m_star)
        num = w * part[..., 2:] if num is None else num + w * part[..., 2:]
        den = w * part[..., 1:2] if den is None else den + w * part[..., 1:2]
    out = num / torch.clamp(den, min=1e-30)
    return out.reshape(b, 1, h, d).to(q.dtype)


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
    def _counted(fn, name: str, layout: str, call: Callable):
        """call(), adding the growth of the launch counter of `fn` (K1's
        or K6's wrapper) to `_SHARD_LAUNCHES` under its layout."""
        before = dict(fn.mode_launches)
        out = call()
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
        if w.mode == "whole":
            # no "model" split: computed whole on every rank
            grouped = w.data.ndim == 3
            fn = ovp_matmul.grouped_ovp_matmul if grouped \
                else ovp_matmul.fused_ovp_matmul
            return self._counted(
                fn, "grouped" if grouped else "ovp_matmul", "whole",
                lambda: super(ShardedCudaBackend, self).matmul(
                    x, w, policy, act_scale=act_scale, fill=fill))
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
            out = self._counted(
                ovp_matmul.grouped_ovp_matmul, "grouped", "expert",
                lambda: ovp_matmul.grouped_ovp_matmul(xl, w, fill=fl, **kw))
            return mesh_lib.all_gather(out.to(cdt), x.ndim - 3, _MESH)
        if w.mode == "row":
            k = w.orig_dim
            xl = x.narrow(x.ndim - 1, r * k, k)
            part = self._counted(
                ovp_matmul.fused_ovp_matmul, "ovp_matmul", "row",
                lambda: ovp_matmul.fused_ovp_matmul(xl, w, **kw))
            return mesh_lib.rank_sum(part.to(cdt), _MESH)
        out = self._counted(
            ovp_matmul.fused_ovp_matmul, "ovp_matmul", "col",
            lambda: ovp_matmul.fused_ovp_matmul(x, w, **kw))
        return mesh_lib.all_gather(out.to(cdt), x.ndim - 1, _MESH)

    # -- decode / prefill attention over Hkv-split caches ------------------
    def _hkv_decline(self, reason: Optional[str], cache) -> Optional[str]:
        """The sharded decline of a (q, cache) call the parent's
        predicate answered with `reason`."""
        tp = _model_axis()
        part = cache_part(cache)
        slots = seq_part(cache)
        if slots is not None:
            # a part of the slots: the kernels serve whole slot ranges
            # only; the reference's kernel declines such a cache by its
            # heads, and the partial attention + combine computes it
            leaf = cache.get("k", cache.get("k_data"))
            code = reason or _hkv_split_decline(int(leaf.shape[2]), tp)
            if code is None:
                raise ValueError(
                    f"a cache holding slots {slots[0]}..{slots[0] + slots[1]}"
                    f" of {slots[2]} with heads that split over a \"model\""
                    f" axis of {tp}")
            return code
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
