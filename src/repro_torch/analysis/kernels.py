"""Kernel-contract pass over the CUDA launch configs: the port of
`repro/analysis/kernels.py`.

The reference traced every `pallas_call` and read its grid and block
specs. The port's kernels take their geometry from pure plan functions
(`kernels/ovp_matmul.py::launch_plan` and `grouped_launch_plan`,
`decode_attn.py::decode_plan`, `prefill_attn.py::prefill_plan`,
`ovp_encode.py::encode_plan`), so this pass asks them for the launch of
every case, describes each launch in one form (`Launch`) and checks:

- **KC_BLOCK_INDIVISIBLE**: a tile does not divide its operand after the
  wrapper's padding (K1's 16 and K6's 64 output columns, a cluster's
  shared column tiles, D in 8-value groups, a stage in whole pages, a
  K7 item inside one row), or the grid does not cover the operand
  exactly (row tiles, K slices over a cluster's split, key tiles over
  a decode or prefill split, K6's work items over a fill).
- **KC_PAIR_SPLIT**: an int8-code K tile or split slice (one value a
  byte) that holds an odd number of values and so cuts an
  outlier-victim pair; a K7 item of an odd number of values (an item
  writes whole bytes, one pair each). Packed nibbles are whole pairs by
  construction.
- **KC_SHARD_SPLIT**: the sharded half. `backends/sharded.py::
  row_shard_pair_aligned`, the predicate that decides whether a
  row-parallel K split over `tp` ranks keeps whole outlier-victim pairs
  (`shard_k_indivisible` otherwise), swept against an independent ground
  truth of where the shard boundaries fall; a fixture module that
  defines its own `row_shard_pair_aligned` is swept the same way.
- **KC_PAGE_TILE**: a paged launch that addresses its pool with another
  page size than the pool's (K3's per-token page lookup, K4's page-write
  tile), or whose block table backs other than the plan's slots.
- **KC_SMEM_BUDGET** (the reference's KC_VMEM_BUDGET): a block's shared
  memory (dynamic, as the plan reserves it, plus the FMA body's static
  tiles) over the budget (`--smem-budget`, default 232,448 bytes, the
  H100's opt-in maximum a block), or a plan that reserves less than its
  body needs (the C entry would refuse it).
- **KC_ALIAS_MISSING**: a pool-writing call (K4; K7's KV write through
  `layers.cache_write`) that hands back another pool than it was given
  where it must write in place. Run on the CPU (the plain versions; the
  CUDA wrappers pass the pools' own pointers and `chip_smoke.py` checks
  them on the card).
- **KC_NO_LAUNCH** (the reference's KC_NO_PALLAS_CALL): an entry point
  whose dispatch does not route CUDA operands to its kernel launch.
  Checked here with operands that report a CUDA device and the launch
  replaced by a probe (no card needed); on the card `chip_smoke.py`
  reads the launch counters.

Cases: the reference's eight (`_repo_cases`, at the reference's shapes,
plus the KV write), and every shape the served configs launch
(`served_launches`: every quantized linear's (K, N) of every arch at
decode rows, the prefill buckets, the exact-length and encoder and
patch prefills, in the served modes with int4 and int8 weights; every
expert stack at the MoE fill; every attention layout at the served
cache lengths, rings and pages; every KV write). Fixture modules may
define `analysis_cases() -> [dict]` (`Case` fields).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

from repro_torch.roofline.hw import SMEM_PER_BLOCK as DEFAULT_SMEM_BUDGET

from . import Finding

_FMA_BK2 = 256                  # csrc/ovp_matmul.cu BK2: K pairs a stage


@dataclasses.dataclass(frozen=True)
class Launch:
    """One planned launch as the pass checks it. `tiles`: (what, tile,
    extent), the tile divides the extent; `covers`: (what, tile, count,
    extent), `count` tiles cover the extent with none empty; `k_tiles`:
    (what, values), an even number of code values; `pages`: (what, tile
    rows, page rows), equal; `smem` the shared bytes a block uses and
    `smem_need` what its body needs."""
    kernel: str
    smem: int = 0
    smem_need: int = 0
    tiles: Tuple[Tuple[str, int, int], ...] = ()
    covers: Tuple[Tuple[str, int, int, int], ...] = ()
    k_tiles: Tuple[Tuple[str, int], ...] = ()
    pages: Tuple[Tuple[str, int, int], ...] = ()


@dataclasses.dataclass
class Case:
    """One kernel entry point at one shape. `launches()` describes the
    launches its call makes (port plans or `Launch`es); `build(device)`
    returns `(fn, args)`, the entry and its operands made from a seed on
    `device` (the CPU for the pass, the card in `chip_smoke.py`);
    `plain` the entry's plain version, same arguments (on any device);
    `probe()` the dispatch-level `(fn, args)` whose CUDA operands must
    reach `launch` (a "module:attr" of the port), default `build`;
    `pool_leaves` the cache leaves the call writes in place (the cache
    is the dict among `args`, handed back as the call's last output)."""
    name: str
    launches: Callable[[], list]
    build: Optional[Callable] = None
    launch: str = ""
    plain: Optional[Callable] = None
    probe: Optional[Callable] = None
    pool_leaves: Tuple[str, ...] = ()


# --------------------------------------------------------------------------
# Port plans -> Launch
# --------------------------------------------------------------------------
def describe(plan, *, n: Optional[int] = None, w_dtype: str = "int4",
             fill: Optional[np.ndarray] = None, pool_ps: int = 0,
             table_pages: int = 0, k: Optional[int] = None,
             r: Optional[int] = None) -> Launch:
    """The `Launch` of one port plan; `n` the operand's columns before
    the wrapper pads them, `w_dtype` the weight's codes, `fill` a K6
    call's (B, E) fill (its work items are then held to the fill, row
    by row), `pool_ps` / `table_pages` a paged call's pool page size
    and block-table width, `r` x `k` a K7 call's input."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm
    from repro_torch.kernels import prefill_attn as pa
    if isinstance(plan, Launch):
        return plan
    if isinstance(plan, mm.LaunchPlan):
        w_rows = 2 if w_dtype == "int8" else 1
        last = plan.k2 - (plan.split - 1) * plan.slice
        covers = [("row tiles", plan.row_tile, plan.grid[1], plan.rows),
                  ("K slices of the split", plan.slice, plan.split,
                   plan.k2)]
        if n is not None:
            covers.append(("column tiles", mm._BN, plan.n // mm._BN, n))
        if plan.body == "decode":
            need = mm._dec_smem(plan.row_tile, plan.slice, w_rows,
                                plan.split)
            smem = plan.smem
            k_tiles = [("K slice", 2 * plan.slice), ("last K slice", 2 * last)]
        else:
            need = smem = _FMA_BK2 * w_rows * mm._BN \
                + plan.row_tile * 2 * _FMA_BK2 * 4
            k_tiles = [("K stage", 2 * _FMA_BK2),
                       ("last K stage", 2 * (plan.k2 % _FMA_BK2 or _FMA_BK2))]
        return Launch(
            "K1", smem, need,
            tiles=(("N padded to the 16-column tile", mm._BN, plan.n),
                   ("column tiles a cluster shares", plan.share,
                    plan.n // mm._BN)),
            covers=tuple(covers),
            k_tiles=tuple(k_tiles) if w_dtype == "int8" else ())
    if isinstance(plan, mm.GroupedPlan):
        w_rows = 2 if w_dtype == "int8" else 1
        last = plan.k2 - (plan.split - 1) * plan.slice
        covers = [("K slices of the split", plan.slice, plan.split,
                   plan.k2)]
        if plan.body == "decode":
            tile = mm._GBN
            filled = fill is not None
            need = mm._grouped_smem(plan.row_tile, plan.slice, w_rows,
                                    plan.split, plan.e,
                                    mm._fill_entries(plan.b, plan.e, filled))
            smem = plan.smem
            k_tiles = [("K slice", 2 * plan.slice), ("last K slice", 2 * last)]
            if filled:
                listed, distinct = _item_rows(plan, fill)
                covers += [("work items over the fill (rows x column "
                            "tiles x ranks)", 1, distinct,
                            _filled_rows(plan, fill)),
                           ("work items, each row once", 1, listed,
                            distinct)]
        else:
            tile = mm._BN
            rt = plan.row_tile
            need = smem = _FMA_BK2 * w_rows * mm._BN + rt * 2 * _FMA_BK2 * 4
            k_tiles = [("K stage", 2 * _FMA_BK2),
                       ("last K stage", 2 * (plan.k2 % _FMA_BK2 or _FMA_BK2))]
        if n is not None:
            covers.append(("column tiles", tile, plan.n // tile, n))
        return Launch(
            "K6", smem, need,
            tiles=((f"N padded to the {tile}-column tile", tile, plan.n),
                   ("column groups a cluster shares", plan.share,
                    plan.n // tile)),
            covers=tuple(covers),
            k_tiles=tuple(k_tiles) if w_dtype == "int8" else ())
    if isinstance(plan, da.DecodePlan):
        paged = pool_ps > 0
        pages = ()
        covers = [("key tiles over the split", plan.tpr, plan.split,
                   plan.tiles),
                  ("32-token key tiles", da._TS, plan.tiles, plan.s)]
        if paged:
            pages = (("the page size K3 addresses the pool with", pool_ps,
                      pool_ps),)
            covers.append(("pages the block table backs", pool_ps,
                           table_pages, plan.s))
        return Launch(
            "K3" if paged else "K2", plan.smem,
            da._smem(plan.g, plan.d, plan.kind, plan.nbuf),
            tiles=(("D in 8-value groups", 8, plan.d),),
            covers=tuple(covers), pages=pages)
    if isinstance(plan, pa.PrefillPlan):
        pages = plan.s // plan.ps
        return Launch(
            "K4", plan.smem, pa._smem(plan.rows, plan.d, plan.nbuf,
                                      plan.split),
            tiles=(("D in 8-value groups", 8, plan.d),
                   ("the stage in whole pages", plan.ps, plan.s)),
            covers=(("query row tiles", plan.rows, plan.n_rt,
                     plan.c * plan.g),
                    ("key tiles over the split", plan.tpr, plan.split,
                     -(-plan.s // pa._TK)),
                    ("page-write clusters", plan.split,
                     plan.n_write // plan.split, plan.hkv * pages)),
            pages=(("the page-write tile", plan.ps,
                    pool_ps or plan.ps),))
    if isinstance(plan, enc.EncodePlan):
        tiles = [("threads in whole warps", 32, plan.threads)]
        if k is not None:
            tiles.append(("values an item, inside one row", plan.vec, k))
        return Launch(
            "K7", 0, 0, tiles=tuple(tiles),
            covers=(("items over the values", plan.vec, plan.items,
                     plan.items * plan.vec if r is None else r * k),),
            k_tiles=(("values an item (whole packed pairs)", plan.vec),))
    raise TypeError(f"no launch description for {type(plan).__name__}")


def _filled_rows(plan, fill) -> int:
    """Rows x column groups x ranks a K6 fill asks for."""
    from repro_torch.kernels.ovp_matmul import _GBN
    rows = int(np.clip(np.asarray(fill), 0, plan.c).sum())
    return rows * (plan.n // _GBN) * plan.split


@functools.lru_cache(maxsize=None)
def _items_covered(plan, fill_bytes: bytes, shape) -> Tuple[int, int]:
    fill = np.frombuffer(fill_bytes, np.int64).reshape(shape)
    listed, seen = 0, set()
    for _, rows, cols, ks in plan.items(fill):
        listed += len(rows)
        seen.update((r, cols.start, ks.start) for r in rows)
    return listed, len(seen)


def _item_rows(plan, fill) -> Tuple[int, int]:
    """(rows listed, distinct (row, column group, rank)) of K6's work
    items for a fill."""
    fill = np.ascontiguousarray(fill, np.int64)
    return _items_covered(plan, fill.tobytes(), fill.shape)


# --------------------------------------------------------------------------
# The reference's eight cases (`repro/analysis/kernels.py::_repo_cases`)
# and the KV write, at the reference's shapes
# --------------------------------------------------------------------------
def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _weight(gen, k: int, n: int, w_dtype: str, e: int = 0):
    """A (K, N) or (E, K, N) OVP weight from N(0, 1) at a per-channel 3σ
    scale: codes along K and (…, N) scales."""
    from repro_torch.core.ovp import ovp_quantize
    shape = (e, k, n) if e else (k, n)
    w = torch.randn(shape, generator=gen)
    nd = "int8" if w_dtype == "int8" else "int4"
    scale = 3.0 * w.std(dim=-2, keepdim=True) / (127.0 if nd == "int8"
                                                 else 7.0)
    qt = ovp_quantize(w, scale, nd, pair_axis=-2)
    return qt.data, qt.scale.reshape(*qt.scale.shape[:-2], n)


def _packed_kv(gen, b: int, s: int, hkv: int, d: int):
    from repro_torch.models.layers import _quant_kv_token
    kd, ks = _quant_kv_token(torch.randn((b, s, hkv, d), generator=gen))
    vd, vs = _quant_kv_token(torch.randn((b, s, hkv, d), generator=gen))
    return {"k_data": kd, "v_data": vd, "k_scl": ks, "v_scl": vs}


def _on(tree, device):
    """Every tensor of a tree of dicts, tuples and lists on `device`."""
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


_HKV, _G, _D, _PS, _N_PAGES, _N_LOG = 2, 2, 16, 8, 4, 2
_KV_RAW = ("k_data", "v_data", "k_scl", "v_scl")


def _repo_cases() -> List[Case]:
    from repro_torch.core.policy import OLIVE_SERVE
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm
    from repro_torch.kernels import prefill_attn as pa
    from repro_torch.models import layers

    h = _HKV * _G

    def matmul(w_dtype):
        def build(device):
            gen = _gen(1)
            a = torch.randn((128, 256), generator=gen)
            wd, sw = _weight(gen, 256, 128, w_dtype)
            fn = lambda a, wd, sw: mm.run(a, None, wd, sw,  # noqa: E731
                                          w_dtype=w_dtype, a_mode="fp")
            return fn, _on((a, wd, sw), device)
        def plain(a, wd, sw):
            return mm.fused_ovp_matmul_plain(a, None, wd, sw, w_dtype=w_dtype,
                                             a_mode="fp", a_dtype=w_dtype)
        return Case(f"fused_matmul_w{w_dtype[-1]}a16",
                    lambda: [describe(mm.launch_plan(128, 256, 128, w_dtype),
                                      n=128, w_dtype=w_dtype)],
                    build, "ovp_matmul:_launch", plain)

    def grouped(w_dtype):
        def build(device):
            gen = _gen(2)
            a = torch.randn((1, 2, 128, 256), generator=gen)
            wd, sw = _weight(gen, 256, 128, w_dtype, e=2)
            fn = lambda a, wd, sw: mm.run_grouped(  # noqa: E731
                a, None, wd, sw, w_dtype=w_dtype, a_mode="fp")
            return fn, _on((a, wd, sw), device)
        def plain(a, wd, sw):
            return mm.grouped_ovp_matmul_plain(
                a, None, wd, sw, w_dtype=w_dtype, a_mode="fp",
                a_dtype=w_dtype)
        return Case(f"grouped_matmul_w{w_dtype[-1]}a16",
                    lambda: [describe(mm.grouped_launch_plan(
                        1, 2, 128, 256, 128, w_dtype), n=128,
                        w_dtype=w_dtype)],
                    build, "ovp_matmul:_launch_grouped", plain)

    def encode(device):
        x = torch.randn((256, 512), generator=_gen(3))
        return enc.fused_ovp_encode, _on((x,), device)

    def decode_slab(device):
        gen = _gen(4)
        cache = _packed_kv(gen, 1, 32, _HKV, _D)
        q = torch.randn((1, 1, h, _D), generator=gen)
        pos = torch.tensor([7], dtype=torch.int32)
        return da.fused_decode_attention, _on((q, cache, pos), device)

    def paged_pools(gen):
        pools = _packed_kv(gen, _N_PAGES, _PS, _HKV, _D)
        pools["block_table"] = torch.arange(_N_LOG, dtype=torch.int32)[None]
        return pools

    def decode_paged(device):
        gen = _gen(5)
        cache = paged_pools(gen)
        q = torch.randn((1, 1, h, _D), generator=gen)
        pos = torch.tensor([_PS * _N_LOG - 1], dtype=torch.int32)
        return da.fused_decode_attention, _on((q, cache, pos), device)

    def prefill_paged(device):
        gen = _gen(6)
        c = 4
        cache = paged_pools(gen)
        for key in pa.STAGE_KEYS:
            cache[key] = torch.randn((1, _PS * _N_LOG, _HKV, _D),
                                     generator=gen)
        q = torch.randn((1, c, h, _D), generator=gen)
        positions = torch.arange(c, dtype=torch.int64)[None]
        return pa.fused_prefill_attention, _on((q, cache, positions), device)

    def kv_write(device):
        gen = _gen(7)
        cache = _packed_kv(gen, 4, 16, _HKV, _D)
        k = torch.randn((4, 1, _HKV, _D), generator=gen)
        v = torch.randn((4, 1, _HKV, _D), generator=gen)
        pos = torch.tensor([0, 5, 15, 9], dtype=torch.int32)

        return kv_write_fn, _on((cache, k, v, pos), device)

    def kv_write_fn(cache, k, v, pos):
        return layers.cache_write(cache, k, v, pos, OLIVE_SERVE)

    def kv_write_plain(cache, k, v, pos):
        return layers.cache_write(cache, k, v, pos, None)

    def kv_write_probe():
        x = torch.randn((4 * _HKV, _D), generator=_gen(8))
        s = torch.rand((4 * _HKV,), generator=_gen(9)) + 0.5
        return (lambda x, s: enc.fused_ovp_encode(x, scale=s)), (x, s)

    return [
        matmul("int4"), matmul("int8"), grouped("int4"), grouped("int8"),
        Case("ovp_encode",
             lambda: [describe(enc.encode_plan(256, 512), r=256, k=512)],
             encode, "ovp_encode:_launch", enc.ovp_encode_plain),
        Case("decode_attn_slab_packed",
             lambda: [describe(da.decode_plan(1, 32, h, _HKV, _D))],
             decode_slab, "decode_attn:_launch", da.decode_attention_plain),
        Case("decode_attn_paged_packed",
             lambda: [describe(da.decode_plan(1, _PS * _N_LOG, h, _HKV, _D),
                               pool_ps=_PS, table_pages=_N_LOG)],
             decode_paged, "decode_attn:_launch", da.decode_attention_plain),
        Case("prefill_attn_paged_packed",
             lambda: [describe(pa.prefill_plan(4, h, _HKV, _D, _PS * _N_LOG,
                                               _PS), pool_ps=_PS)],
             prefill_paged, "prefill_attn:_launch",
             pa.prefill_attention_plain, pool_leaves=_KV_RAW),
        Case("kv_write_packed",
             lambda: [describe(enc.encode_plan(4 * _HKV, _D, torch.float32,
                                               "row"), r=4 * _HKV, k=_D)] * 2,
             kv_write, "ovp_encode:_launch", kv_write_plain,
             probe=kv_write_probe, pool_leaves=_KV_RAW),
    ]


# --------------------------------------------------------------------------
# Every shape the served configs launch
# --------------------------------------------------------------------------
SLOTS = (1, 4)              # decode rows: the ring check's one row, 4 slots
# prefill rows: the slab buckets (16 .. max_len, and the 1024 and 2048 of
# the long prompts), the exact-length prefills of the hybrid (2100) and
# xLSTM (300) checks, the VLM's 4 x (256 patches + 8 tokens) and the
# encoder-decoder's 4 x 400 frames
PREFILL_ROWS = (16, 32, 64, 128, 256, 300, 512, 1024, 1056, 1600, 2048,
                2100)
SERVED_MODES = ("fp", "quantize", "static")
CACHE_LENS = (256, 512, 2048)   # max_len of the serve phases and checks
PAGE_SIZE = 16
PAGED_CHUNK = 16


def _linear_shapes(cfg):
    """(K, N) of every 2-D linear the served policy quantizes, and (E,
    K, N) of every expert stack: one block of each type of the config,
    and the top-level weights, on "meta" (shapes only)."""
    from repro_torch.core.policy import get_program
    from repro_torch.core.qlinear import is_linear_weight, tree_paths
    from repro_torch.models.model import block_params, build_model
    program = get_program("olive_serve")
    model = build_model(cfg, remat=False)
    top = next(model.init_stream(None, device="meta"))[1]
    first = {}
    for i in range(cfg.n_layers):
        first.setdefault(model.block_type(i), i)
    trees = [("", top)] + [(f"layers/{i}", block_params(None, cfg, bt,
                                                        "meta"))
                           for bt, i in first.items()]
    if cfg.enc_dec:
        trees.append(("enc_blocks", block_params(None, cfg, "attn", "meta")))
    dense, stacks = set(), set()
    for prefix, tree in trees:
        for path, w in tree_paths(tree, prefix):
            if not (is_linear_weight(path, w) and w.shape[-2] % 2 == 0
                    and program.resolve(path).enabled):
                continue
            (stacks if w.ndim == 3 else dense).add(tuple(w.shape))
    return sorted(dense), sorted(stacks)


def _cap(cfg, t: int) -> int:
    """The MoE layer's capacity a row of t tokens (`layers.moe_layer`)."""
    return max(int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts), 4)


def _routed_fill(b: int, e: int, c: int, tokens: int, k: int, seed: int):
    """A seeded top-k routing's (B, E) fill: each token picks k experts."""
    rng = np.random.default_rng(seed)
    fill = np.zeros((b, e), np.int64)
    for row in range(b):
        for _ in range(tokens):
            fill[row, rng.choice(e, size=k, replace=False)] += 1
    return np.minimum(fill, c)


@functools.lru_cache(maxsize=None)
def served_launches():
    """(name, Launch) of every launch the served configs make (pure:
    computed once a process)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm
    from repro_torch.kernels import prefill_attn as pa
    from repro_torch.models.model import RECURRENT_TYPES
    out = []
    for arch, cfg in ARCHS.items():
        dense, stacks = _linear_shapes(cfg)
        for k, n in dense:
            for rows in SLOTS + PREFILL_ROWS:
                for mode in SERVED_MODES:
                    for wd in ("int4", "int8"):
                        out.append((f"{arch}/K1 {mode} {wd} rows {rows} "
                                    f"K {k} N {n}", describe(
                                        mm.launch_plan(rows, k, n, wd, None,
                                                       mode), n=n,
                                        w_dtype=wd)))
        for e, k, n in stacks:
            calls = [(b, 1, b, _cap(cfg, 1)) for b in SLOTS] \
                + [(1, t, 1, _cap(cfg, t))
                   for t in (PAGED_CHUNK,) + PREFILL_ROWS[:5]]
            for i, (b, t, _, c) in enumerate(calls):
                # the work items are held to the fill at decode and chunk
                # sizes; a prefill's fill only sizes its plan
                fill = _routed_fill(b, e, c, t, cfg.top_k, i) \
                    if b * t <= PAGED_CHUNK else None
                for mode in SERVED_MODES:
                    for wd in ("int4", "int8"):
                        for filled in (True, False):
                            plan = mm.grouped_launch_plan(
                                b, e, c, k, n, wd, mode, filled=filled)
                            out.append((
                                f"{arch}/K6 {mode} {wd} B {b} E {e} C {c} "
                                f"K {k} N {n} {'fill' if filled else 'all'}",
                                describe(plan, n=n, w_dtype=wd,
                                         fill=fill if filled else None)))
        types = set(cfg.block_pattern)
        if types <= set(RECURRENT_TYPES):
            continue
        h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kinds = (None, torch.float32)
        for max_len in CACHE_LENS:
            lens = {max_len}
            if "local_attn" in types:
                lens.add(min(cfg.window, max_len))
            for s in sorted(lens):
                for b in SLOTS:
                    for fp in kinds:
                        out.append((f"{arch}/K2 B {b} S {s} {fp or 'packed'}",
                                    describe(da.decode_plan(b, s, h, hkv, d,
                                                            fp))))
        if cfg.enc_dec:
            for s in (400, 512):
                out.append((f"{arch}/K2 cross S {s} float32", describe(
                    da.decode_plan(4, s, h, hkv, d, torch.float32))))
        if types <= {"attn", "moe"}:
            for max_len in CACHE_LENS[:2]:
                n_log = max_len // PAGE_SIZE
                for fp in kinds:
                    out.append((f"{arch}/K3 B 4 S {max_len} {fp or 'packed'}",
                                describe(da.decode_plan(4, max_len, h, hkv, d,
                                                        fp),
                                         pool_ps=PAGE_SIZE,
                                         table_pages=n_log)))
            for stage in (16, 32, 64, 128, 256):
                for c in sorted({PAGED_CHUNK, stage}):
                    for fp in kinds:
                        out.append((
                            f"{arch}/K4 C {c} S {stage} {fp or 'packed'}",
                            describe(pa.prefill_plan(c, h, hkv, d, stage,
                                                     PAGE_SIZE, fp),
                                     pool_ps=PAGE_SIZE)))
        for r in sorted({b * hkv for b in SLOTS}
                        | {t * hkv for t in PREFILL_ROWS}):
            for dt in (torch.float32, torch.bfloat16):
                out.append((f"{arch}/K7 KV write R {r} K {d} {dt}", describe(
                    enc.encode_plan(r, d, dt, "row"), r=r, k=d)))
        out.extend(_shard_launches(arch, cfg, dense, stacks))
    return tuple(out)


def _shard_launches(arch: str, cfg, dense, stacks, tp: int = 2):
    """The launches one rank of a "model" axis of `tp` makes where
    `backends/sharded.py` splits (the decode shapes): each linear's
    column slice (N / tp) and row slice (K / tp, where the split keeps
    whole pairs), each expert stack's E / tp experts at its slice of the
    decode fill, and the attention and KV-write launches over Hkv / tp
    heads (G unchanged)."""
    from repro_torch.backends.sharded import row_shard_pair_aligned
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels import ovp_encode as enc
    from repro_torch.kernels import ovp_matmul as mm
    from repro_torch.kernels import prefill_attn as pa
    from repro_torch.models.model import RECURRENT_TYPES
    out = []
    tag = f"{arch}/tp {tp}"
    for k, n in dense:
        shapes = [(k, n // tp)] if n % tp == 0 else []
        if row_shard_pair_aligned(k // 2, tp, True):
            shapes.append((k // tp, n))
        for kl, nl in shapes:
            for rows in SLOTS:
                for wd in ("int4", "int8"):
                    out.append((f"{tag} K1 fp {wd} rows {rows} K {kl} N {nl}",
                                describe(mm.launch_plan(rows, kl, nl, wd, None,
                                                        "fp"), n=nl,
                                         w_dtype=wd)))
    for e, k, n in stacks:
        if e % tp:
            continue
        for i, b in enumerate(SLOTS):
            c = _cap(cfg, 1)
            fill = _routed_fill(b, e, c, 1, cfg.top_k, i)[:, :e // tp]
            plan = mm.grouped_launch_plan(b, e // tp, c, k, n, "int4", "fp",
                                          filled=True)
            out.append((f"{tag} K6 fp B {b} E {e // tp} C {c} K {k} N {n}",
                        describe(plan, n=n, w_dtype="int4", fill=fill)))
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if set(cfg.block_pattern) <= set(RECURRENT_TYPES) or hkv % tp:
        return out
    hl, kl = h // tp, hkv // tp
    for fp in (None, torch.float32):
        kind = fp or "packed"
        out.append((f"{tag} K2 B 4 S 256 {kind}",
                    describe(da.decode_plan(4, 256, hl, kl, d, fp))))
        if set(cfg.block_pattern) <= {"attn", "moe"}:
            out.append((f"{tag} K3 B 4 S 256 {kind}", describe(
                da.decode_plan(4, 256, hl, kl, d, fp), pool_ps=PAGE_SIZE,
                table_pages=256 // PAGE_SIZE)))
            out.append((f"{tag} K4 C {PAGED_CHUNK} S 256 {kind}", describe(
                pa.prefill_plan(PAGED_CHUNK, hl, kl, d, 256, PAGE_SIZE, fp),
                pool_ps=PAGE_SIZE)))
    out.append((f"{tag} K7 KV write R {4 * kl} K {d}", describe(
        enc.encode_plan(4 * kl, d, torch.float32, "row"), r=4 * kl, k=d)))
    return out


# --------------------------------------------------------------------------
# Checks
# --------------------------------------------------------------------------
def _check_launch(name: str, launch: Launch,
                  smem_budget: int) -> List[Finding]:
    where = f"{name}/{launch.kernel}"
    out: List[Finding] = []
    for what, tile, extent in launch.tiles:
        if tile <= 0 or extent % tile:
            out.append(Finding("KC_BLOCK_INDIVISIBLE", where,
                               f"{what}: tile {tile} does not divide "
                               f"{extent}"))
    for what, tile, count, extent in launch.covers:
        if count * tile < extent or (count - 1) * tile >= extent > 0:
            out.append(Finding("KC_BLOCK_INDIVISIBLE", where,
                               f"{what}: {count} x {tile} does not cover "
                               f"{extent} exactly"))
    for what, values in launch.k_tiles:
        if values % 2:
            out.append(Finding("KC_PAIR_SPLIT", where,
                               f"{what} holds {values} code values: an odd "
                               f"count splits an outlier-victim pair"))
    for what, tile, page in launch.pages:
        if tile != page:
            out.append(Finding("KC_PAGE_TILE", where,
                               f"{what} is {tile} rows, the pool's page "
                               f"{page}"))
    if launch.smem > smem_budget:
        out.append(Finding("KC_SMEM_BUDGET", where,
                           f"{launch.smem} bytes of shared memory a block, "
                           f"over the budget of {smem_budget}"))
    if launch.smem < launch.smem_need:
        out.append(Finding("KC_SMEM_BUDGET", where,
                           f"the plan reserves {launch.smem} bytes, its "
                           f"body needs {launch.smem_need}"))
    return out


class _Reached(Exception):
    """Raised by the probe that stands in for a kernel launch."""


class _CudaProbe(torch.Tensor):
    """A CPU tensor that reports a CUDA device: an entry point's dispatch
    takes its CUDA branch on a host without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _as_probe(tree):
    if isinstance(tree, dict):
        return {k: _as_probe(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_as_probe(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.Tensor._make_subclass(_CudaProbe, tree)
    return tree


def _reaches_launch(case: Case) -> bool:
    """Whether the entry, given CUDA operands, reaches `case.launch`."""
    import importlib
    mod_name, attr = case.launch.split(":")
    module = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    fn, args = case.probe() if case.probe else case.build("cpu")

    def reached(*args, **kwargs):
        raise _Reached

    with mock.patch.object(module, attr, reached):
        try:
            fn(*_as_probe(args))
        except _Reached:
            return True
    return False


def _aliasing(case: Case) -> List[Finding]:
    """The pool leaves the call hands back must be the tensors it was
    given (written in place), with their storage."""
    fn, args = case.build("cpu")
    cache = next(a for a in args if isinstance(a, dict))
    given = {k: (cache[k], cache[k].data_ptr()) for k in case.pool_leaves}
    out = fn(*args)
    back = out if isinstance(out, dict) else out[-1]
    moved = [k for k, (t, ptr) in given.items()
             if back.get(k) is not t or back[k].data_ptr() != ptr]
    if not moved:
        return []
    return [Finding("KC_ALIAS_MISSING", case.name,
                    f"the call writes {len(case.pool_leaves)} pool leaves "
                    f"but hands back new tensors for {moved}: pages it does "
                    f"not write would not come back intact")]


def _load_fixture_cases(path: Path) -> List[Case]:
    spec = importlib.util.spec_from_file_location(
        f"_analysis_fixture_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    maker = getattr(mod, "analysis_cases", None)
    if maker is None:
        return []
    return [c if isinstance(c, Case) else Case(**c) for c in maker()]


def repo_cases(fixtures: Sequence[str] = ()) -> List[Case]:
    """The reference's cases (and the KV write), then the fixtures'."""
    cases = _repo_cases()
    for f in fixtures:
        if str(f).endswith(".py"):
            cases.extend(_load_fixture_cases(Path(f)))
    return cases


def _shard_boundary_aligned(k_rows: int, tp: int, packed: bool) -> bool:
    """Ground truth for the row-parallel K split: pairs are the value
    indices (2p, 2p + 1), shards hold contiguous row ranges, and every
    shard must decode whole pairs, so K must divide and every shard's
    end (the last one's, the total value count, included) must land on
    an even value index."""
    if k_rows % tp != 0:
        return False
    per_shard = (k_rows // tp) * (2 if packed else 1)
    return all((s * per_shard) % 2 == 0 for s in range(1, tp + 1))


def _check_shard_split(predicate, where: str) -> List[Finding]:
    findings: List[Finding] = []
    for packed in (False, True):
        for tp in (1, 2, 3, 4, 8):
            for k_rows in range(1, 65):
                got = predicate(k_rows, tp, packed)
                want = _shard_boundary_aligned(k_rows, tp, packed)
                if got != want:
                    findings.append(Finding(
                        "KC_SHARD_SPLIT", where,
                        f"k_rows={k_rows} tp={tp} packed={packed}: the "
                        f"predicate says {got}, the shard-boundary ground "
                        f"truth says {want}"))
    return findings


def _shard_predicates(fixtures: Sequence[str]):
    """(predicate, location): the backend's, then each fixture module's
    own `row_shard_pair_aligned`."""
    from repro_torch.backends.sharded import row_shard_pair_aligned
    out = [(row_shard_pair_aligned,
            "backends/sharded.py::row_shard_pair_aligned")]
    for f in fixtures:
        if str(f).endswith(".py"):
            spec = importlib.util.spec_from_file_location(
                f"_analysis_shard_{Path(f).stem}", f)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if hasattr(mod, "row_shard_pair_aligned"):
                out.append((mod.row_shard_pair_aligned,
                            f"{Path(f).name}::row_shard_pair_aligned"))
    return out


def check(fixtures: Sequence[str] = (),
          smem_budget: Optional[int] = None) -> List[Finding]:
    if smem_budget is None:
        smem_budget = DEFAULT_SMEM_BUDGET
    findings: List[Finding] = []
    for case in repo_cases(fixtures):
        for launch in case.launches():
            findings.extend(_check_launch(case.name, describe(launch),
                                          smem_budget))
        if case.launch and not _reaches_launch(case):
            findings.append(Finding(
                "KC_NO_LAUNCH", case.name,
                f"CUDA operands do not reach {case.launch}: the entry "
                f"point would not launch its kernel"))
        if case.pool_leaves:
            findings.extend(_aliasing(case))
    for name, launch in served_launches():
        findings.extend(_check_launch(name, launch, smem_budget))
    for predicate, where in _shard_predicates(fixtures):
        findings.extend(_check_shard_split(predicate, where))
    return findings
