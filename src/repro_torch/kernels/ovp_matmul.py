"""K1, K5 and K6: the fused OVP matmul and its grouped per-expert twin —
hand-written CUDA kernels + plain versions.

Replaces the TPU kernel `repro/kernels/ovp_matmul.py:367`
(`fused_ovp_matmul_kernel`) in all its activation modes, and its host
wrapper `repro/kernels/ops.py:114` (`fused_ovp_matmul`):

    out[..., n] = (Σ_k a'[..., k] · w'[k, n]) · sa[...] · sw[n]

with w' the OVP-decoded weight (int4/flint4 nibbles packed along K, even
k in the high nibble, or int8 codes) and a' the activation in one of the
modes of `A_MODES`:
  fp        as-is, sa = 1 (W4A16);
  quantize  OVP fake-quantized in the prologue at the per-row scale sa,
            u = a / sa (K1, body `_fused_mm_kernel` :224, dynamic W4A4);
  static    OVP fake-quantized at ONE calibrated scalar s passed by
            value, u = a · (1/s), epilogue acc · (s · sw) (K5, body
            `_fused_mm_kernel_static` :263, static W4A4 serving);
  codes4    pre-packed OVP nibbles (…, K/2) decoded in the prologue,
            per-row sa (K1 `_act_tile_planes` :203);
  codes8    int8 OVP codes (…, K) decoded in the prologue, per-row sa.
The kernel source is `csrc/ovp_matmul.cu`; its header says how it is
tiled and what bounds it on the H100.

`fused_ovp_matmul` folds the lead dims into rows, broadcasts the scales
to (rows,) and (N,), and pads N to the kernel's 16-column tile. CPU
tensors take `fused_ovp_matmul_plain`; CUDA tensors launch the kernel (or
raise): one launch per call, which writes every output element once (no
zero-fill, no atomics). `launch_plan` works out that launch: the decode
body (row tile = rows up to 8, K split over a thread-block cluster of
1-8 blocks to fill the SMs, the block's weight slice streamed in with
cp.async) wherever its K slice fits shared memory, else the FMA body.
`fused_ovp_matmul.mode_launches[mode]` counts each mode's kernel
launches, and `fused_ovp_matmul.weight_launches[w_dtype]` the same
launches by weight dtype (`W_DTYPES`: mixed W4/W8 programs put int8
weights on some layers).

K6 replaces `repro/kernels/ovp_matmul.py:436` (`grouped_ovp_matmul_kernel`,
bodies `_grouped_mm_kernel` :300 and `_grouped_mm_kernel_static` :333)
and its host wrapper `repro/kernels/ops.py:236` (`grouped_ovp_matmul`):

    out[b, e, c, n] = (Σ_k a'[b, e, c, k] · w'[e, k, n]) · sa[b, e, c]
                      · sw[e, n]

over a stacked (E, K/2 | K, N) weight with per-expert scales, in every
mode above (the MoE expert einsums run `fp`). `grouped_ovp_matmul`
folds the dims left of (E, C, K) into B, broadcasts the scales to
(B, E, C) and (E, N), and launches one kernel (`ovp_grouped_mm_launch`
in the same source); `grouped_ovp_matmul.mode_launches[mode]` and
`.weight_launches[w_dtype]` count its launches apart from K1's. Given
the MoE dispatch's `fill` (B, E), the kernel computes only rows
c < fill[b, e] and reads only the
weights of experts with a filled row (a persistent grid on the decode
body; `grouped_launch_plan` works out its geometry, `GroupedPlan.items`
its work for a fill); the rows past the fill are left unwritten. A call
without a fill with more than 8 rows an expert runs the FMA body.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.datatypes import (ABFLOAT_FOR_NORMAL, NORMAL_MAX,
                                        abfloat_decode, abfloat_encode)
from repro_torch.core.ovp import QuantizedTensor, decode_pair_planes

from . import _build

_DTYPE_CODE = {"int4": 0, "flint4": 1, "int8": 2}
W_DTYPES = tuple(_DTYPE_CODE)
_BN = 16            # both bodies' output-column tile


# --------------------------------------------------------------------------
# Plain version (the kernel's arithmetic in torch ops)
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _byte_tables(w_dtype: str, device: torch.device):
    """(even, odd) decoded values of each of the 256 packed bytes: a
    4-bit pair is one byte, so a lookup decodes it exactly as
    `decode_pair_planes` does, in one gather instead of a chain of
    elementwise passes over the whole weight."""
    b = torch.arange(256, device=device).to(torch.uint8)
    return decode_pair_planes((b >> 4) & 0xF, b & 0xF, w_dtype)


def weight_planes(w_data: torch.Tensor, w_dtype: str):
    """Packed (…, K/2, N) nibbles or (…, K, N) int8 codes -> (even, odd)
    decoded fp32 planes, each (…, K/2, N)."""
    if w_dtype == "int8":
        return decode_pair_planes(w_data[..., 0::2, :], w_data[..., 1::2, :],
                                  w_dtype)
    even, odd = _byte_tables(w_dtype, w_data.device)
    idx = w_data.long()
    return even[idx], odd[idx]


def _roundtrip_normal(u: torch.Tensor, normal_dtype: str) -> torch.Tensor:
    if normal_dtype == "int4":
        return torch.clamp(torch.round(u), -7, 7)
    if normal_dtype == "int8":
        return torch.clamp(torch.round(u), -127, 127)
    # flint4: nearest of {0,1,2,3,4,6,8,16}, midpoint ties to the smaller
    a = torch.abs(u)
    mag = torch.full_like(a, 16.0)
    for edge, val in ((12.0, 8.0), (7.0, 6.0), (5.0, 4.0), (3.5, 3.0),
                      (2.5, 2.0), (1.5, 1.0), (0.5, 0.0)):
        mag = torch.where(a <= edge, val, mag)
    return torch.where((u < 0) & (mag > 0), -mag, mag)


def quantize_pair_planes(u0: torch.Tensor, u1: torch.Tensor,
                         normal_dtype: str):
    """Scaled activation planes -> OVP fake-quantized planes: the same
    outlier/victim selection and rounding as `core.ovp.ovp_encode_codes`,
    in the value domain (the kernel's quantize prologue)."""
    spec = ABFLOAT_FOR_NORMAL[normal_dtype]
    t = float(NORMAL_MAX[normal_dtype])
    a0, a1 = torch.abs(u0), torch.abs(u1)
    o0, o1 = a0 > t, a1 > t
    first_out = o0 & (~o1 | (a0 >= a1))
    second_out = o1 & ~first_out

    def outlier(u):
        return abfloat_decode(abfloat_encode(u, spec), spec)

    q0 = torch.where(first_out, outlier(u0),
                     torch.where(second_out, 0.0,
                                 _roundtrip_normal(u0, normal_dtype)))
    q1 = torch.where(second_out, outlier(u1),
                     torch.where(first_out, 0.0,
                                 _roundtrip_normal(u1, normal_dtype)))
    return q0.to(torch.float32), q1.to(torch.float32)


def _reciprocal(s: float) -> float:
    """1/s rounded once in float32 (the static prologue's multiplier)."""
    return float(np.float32(1.0) / np.float32(s))


def act_planes(a: torch.Tensor, sa: Optional[torch.Tensor], a_mode: str,
               a_dtype: str, s_static: Optional[float] = None):
    """The activation prologue: (…, Ka) operand -> (even, odd) fp32
    planes, each (…, K/2); `sa` has the operand's lead shape."""
    if a_mode == "codes4":
        return decode_pair_planes((a >> 4) & 0xF, a & 0xF, a_dtype)
    if a_mode == "codes8":
        return decode_pair_planes(a[..., 0::2], a[..., 1::2], "int8")
    af = a.to(torch.float32)
    if a_mode == "fp":
        return af[..., 0::2], af[..., 1::2]
    u = af / sa[..., None] if a_mode == "quantize" \
        else af * _reciprocal(s_static)
    return quantize_pair_planes(u[..., 0::2], u[..., 1::2], a_dtype)


def fused_ovp_matmul_plain(a: torch.Tensor, sa: Optional[torch.Tensor],
                           w_data: torch.Tensor, sw: torch.Tensor, *,
                           w_dtype: str, a_mode: str, a_dtype: str,
                           s_static: Optional[float] = None
                           ) -> torch.Tensor:
    """a (R, Ka) f32 or codes; sa (R,) row scales (quantize and codes
    modes) or None; `s_static` the calibrated scalar (static mode);
    w_data packed/int8 codes; sw (N,) -> (R, N) f32."""
    w_even, w_odd = weight_planes(w_data, w_dtype)
    a_even, a_odd = act_planes(a, sa, a_mode, a_dtype, s_static)
    acc = a_even @ w_even + a_odd @ w_odd
    if a_mode == "static":
        return acc * (sw * float(np.float32(s_static)))[None, :]
    if a_mode != "fp":
        acc = acc * sa[:, None]
    return acc * sw[None, :]


def fused_ovp_matmul_shape(a: torch.Tensor, w_data: torch.Tensor
                           ) -> torch.Tensor:
    """The plain version's output for a "meta" lhs: (R, N) f32 on
    "meta", no arithmetic (a Pallas call's abstract evaluation)."""
    return torch.empty((a.shape[0], w_data.shape[-1]), dtype=torch.float32,
                       device="meta")


def grouped_ovp_matmul_shape(a: torch.Tensor, w_data: torch.Tensor
                             ) -> torch.Tensor:
    """The grouped plain version's output for a "meta" lhs: (B, E, C, N)
    f32 on "meta", no arithmetic."""
    return torch.empty(tuple(a.shape[:-1]) + (w_data.shape[-1],),
                       dtype=torch.float32, device="meta")


def grouped_ovp_matmul_plain(a: torch.Tensor, sa: Optional[torch.Tensor],
                             w_data: torch.Tensor, sw: torch.Tensor, *,
                             w_dtype: str, a_mode: str, a_dtype: str,
                             s_static: Optional[float] = None,
                             fill: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """K6's arithmetic: a (B, E, C, Ka) f32 or codes; sa (B, E, C) slot
    scales (quantize and codes modes) or None; w_data (E, Kw, N) packed
    nibbles or int8 codes; sw (E, N) -> (B, E, C, N) f32, scaled in the
    Pallas body's order (acc · sa · sw; static acc · (s · sw)). With
    `fill` (B, E), rows c >= fill[b, e] are zeros (the kernel leaves them
    unwritten)."""
    w_even, w_odd = weight_planes(w_data, w_dtype)
    a_even, a_odd = act_planes(a, sa, a_mode, a_dtype, s_static)
    acc = a_even @ w_even + a_odd @ w_odd
    if a_mode == "static":
        out = acc * (sw * float(np.float32(s_static)))[:, None, :]
    else:
        if a_mode != "fp":
            acc = acc * sa[..., None]
        out = acc * sw[:, None, :]
    if fill is None:
        return out
    live = torch.arange(out.shape[2], device=out.device) < fill[..., None]
    return torch.where(live[..., None], out, 0.0)


# --------------------------------------------------------------------------
# CUDA launch
# --------------------------------------------------------------------------
A_MODES = ("fp", "quantize", "static", "codes4", "codes8")
_SIGNATURE = {"ovp_mm_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
              + [ctypes.c_float, ctypes.c_void_p],
              "ovp_grouped_mm_launch": [ctypes.c_void_p] * 6
              + [ctypes.c_int] * 14 + [ctypes.c_float, ctypes.c_void_p],
              "ovp_grouped_grid": [ctypes.c_int] * 9 + [ctypes.c_void_p]}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_operands(a, sa, w_data, sw, a_mode: str, what: str):
    """Check the operands' types and device, pad N (the last dim of the
    codes and the scales) to the kernel's 16-column tile with scale 1,
    and make every operand contiguous and 16-byte aligned. A missing
    `sa` becomes a placeholder pointer the mode never reads."""
    a_type = torch.uint8 if a_mode.startswith("codes") else torch.float32
    if a.dtype != a_type or w_data.dtype != torch.uint8:
        raise TypeError(f"{what} kernel ({a_mode}) takes {a_type} "
                        f"activations and uint8 codes, got {a.dtype} and "
                        f"{w_data.dtype}")
    if {t.device for t in (a, sa, w_data, sw) if t is not None} != \
            {a.device}:
        raise ValueError(f"{what} operands must share one device")
    n = w_data.shape[-1]
    if n % _BN:
        pad = _BN - n % _BN
        w_data = torch.nn.functional.pad(w_data, (0, pad))
        sw = torch.nn.functional.pad(sw, (0, pad), value=1.0)
    sw = _aligned(sw.float())
    return (_aligned(a), sw if sa is None else _aligned(sa.float()),
            _aligned(w_data), sw)


# The dense entry's launch plan (csrc/ovp_matmul.cu's header says why)
BODIES = ("decode", "fma")
_NT = 256             # threads per block, both bodies
_DEC_RM = 8           # the decode body's row-tile cap
_DEC_SLICE = 512      # most K pairs a decode block takes, when it can
_DEC_WARPS = _NT // 32
_TAB_COPIES = 16      # copies of the decode body's byte table
_FMA_RM = 8           # the FMA body's row tile
_FMA_GROUPED_RM = 16  # K6's FMA row tile above _FMA_RM rows an expert
_MIN_BLOCKS = 132     # one wave: an H100 has 132 SMs
_SPLITS = (1, 2, 4, 8)  # cluster sizes (8: the portable cap)
_MIN_SLICE = 32       # no split below this many K pairs a block
SMEM_MAX = 232448     # 227 KB, a block's dynamic shared-memory cap


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The geometry of one dense launch (K1/K5), as the C entry
    `ovp_mm_launch` takes it. A thread-block cluster is `share` column
    tiles x `split` K slices (decode body): block (x, y), with c, u =
    divmod(x, share·split) and t, rank = divmod(u, split), computes rows
    [y·row_tile, (y+1)·row_tile) ∩ [0, rows) and the 16 columns of tile
    c·share + t over the K pairs [rank·slice, (rank+1)·slice) ∩ [0, K/2).
    The split blocks of a tile add their partials in rank order; the
    share blocks of a K slice quantize its activations once between them
    (quantize and static modes). The FMA body runs split = share = 1,
    slice K/2 and static shared memory (`smem` 0)."""
    body: str
    rows: int
    k2: int             # K pairs
    n: int              # columns, padded to 16
    row_tile: int
    split: int
    share: int
    slice: int
    smem: int           # dynamic shared bytes a block (decode body)

    @property
    def grid(self):
        return ((self.n // _BN) * self.split,
                -(-self.rows // self.row_tile), 1)

    @property
    def blocks(self) -> int:
        x, y, z = self.grid
        return x * y * z

    def tile(self, x: int, y: int):
        """Block (x, y)'s (rows, columns, K pairs) as three ranges."""
        c, u = divmod(x, self.share * self.split)
        t, rank = divmod(u, self.split)
        n0 = (c * self.share + t) * _BN
        r0 = y * self.row_tile
        return (range(r0, min(self.rows, r0 + self.row_tile)),
                range(n0, n0 + _BN),
                range(rank * self.slice,
                      min(self.k2, (rank + 1) * self.slice)))


def _dec_smem(row_tile: int, slice_: int, w_rows: int, split: int) -> int:
    """A decode block's dynamic shared bytes: weight slice, activation
    planes, byte table (4-bit weights), warp partials and the cluster's
    gathered partials (the C side's `dec_smem_bytes`)."""
    return (slice_ * _BN * w_rows + row_tile * slice_ * 8
            + (256 * _TAB_COPIES * 8 if w_rows == 1 else 0)
            + _DEC_WARPS * row_tile * _BN * 4 + split * row_tile * _BN * 4)


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, k: int, n: int, w_dtype: str,
                body: Optional[str] = None, a_mode: str = "fp"
                ) -> LaunchPlan:
    """The launch of an (rows, K) x (K, n) dense call in `a_mode` (pure,
    memoized: the wrapper asks for it on every call). The decode body
    runs wherever its K slice fits shared memory; the FMA body is the
    fallback (`body` forces one of `BODIES`, for tests and measurement).
    The decode body takes the smallest cluster split that gives at least
    one wave of blocks and at most `_DEC_SLICE` pairs a block (slices
    stay at least `_MIN_SLICE` pairs), then a larger one if the slice
    does not fit. In the quantize and static modes the cluster then
    takes the most column tiles (`share`) that divide the tiles and keep
    it at 8 blocks, so they quantize each activation pair once."""
    if body not in (None,) + BODIES:
        raise ValueError(f"body {body!r}; options: {BODIES}")
    k2, n = k // 2, -(-n // _BN) * _BN
    if body != "fma":
        rt = min(rows, _DEC_RM)
        w_rows = 2 if w_dtype == "int8" else 1
        base = (n // _BN) * -(-rows // rt)
        fits = [s for s in _SPLITS if s == 1 or k2 // s >= _MIN_SLICE]
        fits = [s for s in fits
                if _dec_smem(rt, -(-k2 // s), w_rows, s) <= SMEM_MAX]
        good = [s for s in fits if base * s >= _MIN_BLOCKS
                and -(-k2 // s) <= _DEC_SLICE]
        if good or fits:
            split = good[0] if good else fits[-1]
            sl = -(-k2 // split)
            share = 1
            if a_mode in ("quantize", "static"):
                share = max(g for g in _SPLITS if g * split <= _SPLITS[-1]
                            and (n // _BN) % g == 0)
            return LaunchPlan("decode", rows, k2, n, rt, split, share, sl,
                              _dec_smem(rt, sl, w_rows, split))
    return LaunchPlan("fma", rows, k2, n, _FMA_RM, 1, 1, k2, 0)


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """The geometry of one K6 launch (`ovp_grouped_mm_launch`). The
    decode body is persistent: whole clusters of `share` 64-column
    groups x `split` K slices walk the work items, and the work depends
    on the data (the fill), so the plan fixes the tiling and `items`
    lists the work that a given fill makes. The FMA body (K slices too
    large for shared memory, and calls without a fill above `_FMA_RM`
    rows an expert) runs every row of every expert, fill ignored, on
    16-column tiles of `row_tile` rows."""
    body: str
    b: int
    e: int
    c: int
    k2: int             # K pairs
    n: int              # columns, padded to 64 (decode) or 16 (FMA)
    row_tile: int       # rows an item holds
    split: int
    share: int
    slice: int
    smem: int           # dynamic shared bytes a block (decode body)

    def items(self, fill: Optional[np.ndarray] = None):
        """The decode body's work for a (B, E) fill (None: every row), in
        the kernel's order: one entry per block of each cluster item,
        (expert, global rows of the (B, E, C) slots, columns, K pairs).
        An expert with no filled row has no entry."""
        if fill is None:
            fill = np.full((self.b, self.e), self.c)
        fill = np.clip(np.asarray(fill), 0, self.c)
        out = []
        for e in range(self.e):
            rows = [(b * self.e + e) * self.c + c for b in range(self.b)
                    for c in range(int(fill[b, e]))]
            for y in range(-(-len(rows) // self.row_tile)):
                part = rows[y * self.row_tile:(y + 1) * self.row_tile]
                for g in range(self.n // _GBN // self.share):
                    for t in range(self.share):
                        n0 = (g * self.share + t) * _GBN
                        for rank in range(self.split):
                            out.append((e, part, range(n0, n0 + _GBN),
                                        range(rank * self.slice,
                                              min(self.k2, (rank + 1)
                                                  * self.slice))))
        return out


_GROUPED_RM = 4       # K6's row-tile cap
_GBN = 64             # K6's output columns a work item
_FILL_SMEM = 8192     # K6 caches a fill of at most this many entries


def _fill_entries(b: int, e: int, filled: bool) -> int:
    return b * e if filled and b * e <= _FILL_SMEM else 0


def _grouped_smem(row_tile: int, slice_: int, w_rows: int, split: int,
                  e: int, fill_entries: int) -> int:
    """A K6 decode block's dynamic shared bytes: two buffers of the
    weight slice (64 columns) and `row_tile` activation rows, the half2
    byte table, partials for 4 rows, two buffers of column scales, two
    item row lists, the per-expert row counts and item offsets, and the
    cached fill (int16) (the C side's `grouped_smem_bytes`)."""
    return (2 * (slice_ * _GBN * w_rows + row_tile * slice_ * 8)
            + (256 * _TAB_COPIES * 4 if w_rows == 1 else 0)
            + _DEC_WARPS * _GROUPED_RM * _GBN * 4
            + split * _GROUPED_RM * _GBN * 4 + 2 * _GBN * 4
            + 2 * _GROUPED_RM * 8 + (2 * e + 1) * 4 + fill_entries * 2)


@functools.lru_cache(maxsize=None)
def grouped_launch_plan(b: int, e: int, c: int, k: int, n: int,
                        w_dtype: str, a_mode: str = "fp",
                        body: Optional[str] = None,
                        filled: bool = False) -> GroupedPlan:
    """The launch of a (B, E, C, K) x (E, K, n) grouped call, with a fill
    when `filled` (pure, memoized). Decode body wherever its K slice fits
    shared memory, a work item 64 columns x min(B·C, 4) rows (at decode
    an expert holds a row or two; an item of more rows re-reads its
    expert's weights from L2), N padded to 64; the smallest cluster
    split whose slice fits (the persistent grid fills the card whatever
    the split, and a split adds two cluster barriers to every item,
    which cost more than the loads they share out); in the quantize and
    static modes the cluster then shares quantization over the most
    column groups that divide them, as K1's plan. Without a fill and
    with more than `_FMA_RM` rows an expert, the FMA body: its 16-row
    tiles decode each weight once for 16 rows where the decode body's
    items do it for 4 (at E 8, K = N = 1024 and 16 rows an expert the
    FMA body took 0.70× the decode body's time in quantize mode, 0.47× in
    codes8 and 0.98× in fp, one H100 run). `body` forces one of
    `BODIES` (measurement)."""
    if body not in (None,) + BODIES:
        raise ValueError(f"body {body!r}; options: {BODIES}")
    if body is None and not filled and b * c > _FMA_RM:
        body = "fma"
    k2 = k // 2
    fe = _fill_entries(b, e, filled)
    if body != "fma":
        n = -(-n // _GBN) * _GBN
        rt = min(b * c, _GROUPED_RM)
        w_rows = 2 if w_dtype == "int8" else 1
        fits = [s for s in _SPLITS if s == 1 or k2 // s >= _MIN_SLICE]
        fits = [s for s in fits if _grouped_smem(
            rt, -(-k2 // s), w_rows, s, e, fe) <= SMEM_MAX]
        if fits:
            split = fits[0]
            sl = -(-k2 // split)
            share = 1
            if a_mode in ("quantize", "static"):
                share = max(g for g in _SPLITS if g * split <= _SPLITS[-1]
                            and (n // _GBN) % g == 0)
            return GroupedPlan("decode", b, e, c, k2, n, rt, split, share,
                               sl, _grouped_smem(rt, sl, w_rows, split, e,
                                                 fe))
    rt = _FMA_RM if b * c <= _FMA_RM else _FMA_GROUPED_RM
    return GroupedPlan("fma", b, e, c, k2, -(-n // _BN) * _BN, rt, 1, 1, k2,
                       0)


def _launch(a: torch.Tensor, sa: Optional[torch.Tensor],
            w_data: torch.Tensor, sw: torch.Tensor, *, w_dtype: str,
            a_mode: str, a_dtype: str, s_static: Optional[float],
            plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    r, k = a.shape[0], w_data.shape[0] * (1 if w_dtype == "int8" else 2)
    n = w_data.shape[1]
    if plan is None:
        plan = launch_plan(r, k, n, w_dtype, None, a_mode)
    elif (plan.rows, plan.k2, plan.n) != (r, k // 2, -(-n // _BN) * _BN):
        raise ValueError(f"{plan} is not a plan for a ({r}, {k}) x "
                         f"({k}, {n}) call")
    a, sa, w_data, sw = _kernel_operands(a, sa, w_data, sw, a_mode,
                                         "ovp_matmul")
    out = torch.empty((r, plan.n), dtype=torch.float32, device=a.device)
    lib = _build.load("ovp_matmul", _SIGNATURE)
    err = lib.ovp_mm_launch(
        a.data_ptr(), sa.data_ptr(), w_data.data_ptr(), sw.data_ptr(),
        out.data_ptr(), r, k, plan.n, _DTYPE_CODE[w_dtype],
        A_MODES.index(a_mode), _DTYPE_CODE[a_dtype],
        BODIES.index(plan.body), plan.row_tile, plan.split, plan.share,
        plan.slice, plan.smem, float(np.float32(s_static or 1.0)),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "ovp_matmul")
    fused_ovp_matmul.mode_launches[a_mode] += 1
    fused_ovp_matmul.weight_launches[w_dtype] += 1
    return out[:, :n]


def _checked_modes(a, sa, w_data, *, w_dtype: str, a_mode: str,
                   a_dtype: Optional[str], s_static: Optional[float]):
    """Validate one call's modes and K against the weight; returns the
    plain version's and the launch's keyword arguments."""
    if a_mode not in A_MODES:
        raise ValueError(f"activation mode {a_mode!r}; options: {A_MODES}")
    a_dtype = a_dtype or w_dtype
    if a_mode == "codes8" and a_dtype != "int8":
        raise ValueError("codes8 activations are int8 OVP codes")
    if (a_mode == "static") != (s_static is not None):
        raise ValueError("s_static is the static mode's scale, and only "
                         "its")
    if a_mode in ("quantize", "codes4", "codes8") and sa is None:
        raise ValueError(f"{a_mode} mode needs per-row scales sa")
    k = w_data.shape[-2] * (1 if w_dtype == "int8" else 2)
    ka = a.shape[-1] * (2 if a_mode == "codes4" else 1)
    if ka != k or k % 2:
        raise ValueError(f"lhs K={ka} ({a_mode}) does not match the "
                         f"{w_dtype} weight {tuple(w_data.shape)}")
    return dict(w_dtype=w_dtype, a_mode=a_mode, a_dtype=a_dtype,
                s_static=s_static)


def run(a: torch.Tensor, sa: Optional[torch.Tensor], w_data: torch.Tensor,
        sw: torch.Tensor, *, w_dtype: str, a_mode: str,
        a_dtype: Optional[str] = None, s_static: Optional[float] = None,
        plan: Optional[LaunchPlan] = None) -> torch.Tensor:
    """(R, Ka) x codes -> (R, N): the plain version for CPU tensors, the
    kernel for CUDA tensors, the output's shape alone for "meta" tensors
    (`fused_ovp_matmul_shape`; no launch is counted), an error for
    anything else. `a_dtype`
    defaults to the weight's (fp mode ignores it); static mode needs
    `s_static`, the quantize and codes modes `sa`. `plan` replaces
    `launch_plan`'s launch (tests and measurement force a body or a
    share with it); the plain version ignores it."""
    kw = _checked_modes(a, sa, w_data, w_dtype=w_dtype, a_mode=a_mode,
                        a_dtype=a_dtype, s_static=s_static)
    if a.device.type == "cpu":
        return fused_ovp_matmul_plain(a, sa, w_data, sw, **kw)
    if a.device.type == "meta":
        return fused_ovp_matmul_shape(a, w_data)
    if a.device.type != "cuda":
        raise ValueError(f"ovp_matmul runs on cpu, cuda or meta, not "
                         f"{a.device}")
    return _launch(a, sa, w_data, sw, plan=plan, **kw)


def _col_scale(s, n: int, device) -> torch.Tensor:
    """A scalar or per-channel weight scale -> (N,) f32."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    return torch.broadcast_to(s.reshape(-1) if s.ndim else s, (n,))


def _row_scale(s, lead: tuple, device) -> torch.Tensor:
    """A scalar or per-row scale (shaped `lead`, or anything that
    broadcasts to `lead + (1,)`) -> one f32 scale per folded row."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.ndim and s.shape == lead:
        s = s[..., None]
    return torch.broadcast_to(s, tuple(lead) + (1,)).reshape(-1)


def fused_ovp_matmul(x: Union[torch.Tensor, QuantizedTensor],
                     w: QuantizedTensor, *,
                     a_dtype: Optional[str] = None,
                     act_scale: Optional[torch.Tensor] = None,
                     static_act_scale: Optional[float] = None
                     ) -> torch.Tensor:
    """(…, K) @ OVP (K, N) -> (…, N) f32, one kernel launch on CUDA.

    `x` a pre-quantized `QuantizedTensor` (pairs along K): its codes are
    decoded in the prologue (`codes4` packed, `codes8` int8) at its
    scale. `x` real with `a_dtype` set: activations are OVP-quantized in
    the prologue, at `static_act_scale` (a calibrated Python float,
    passed to the kernel by value: K5) or else at `act_scale` (a
    per-tensor scalar or one scale per row). Otherwise W4A16. Weight
    pairs must run along K (`pair_axis == -2`)."""
    if w.data.ndim != 2 or w.pair_axis % 2 != 0:
        raise ValueError("fused_ovp_matmul takes a 2-D weight paired "
                         "along K")
    sw = _col_scale(w.scale, w.data.shape[-1], w.data.device)
    sa = s_static = None
    if isinstance(x, QuantizedTensor):
        if x.pair_axis != -1:
            raise ValueError("a pre-quantized lhs pairs along its last "
                             "axis")
        a_mode = "codes4" if x.is_packed else "codes8"
        a_dtype = x.normal_dtype
        lead = x.data.shape[:-1]
        a = x.data.reshape(-1, x.data.shape[-1])
        sa = _row_scale(x.scale, lead, x.data.device)
    else:
        lead = x.shape[:-1]
        a = x.reshape(-1, x.shape[-1]).to(torch.float32)
        if a_dtype is None:
            a_mode = "fp"
        elif static_act_scale is not None:
            a_mode, s_static = "static", float(static_act_scale)
        elif act_scale is None:
            raise ValueError("in-kernel activation quantization needs an "
                             "act_scale (per-tensor or per-row) or a "
                             "static_act_scale constant")
        else:
            a_mode = "quantize"
            sa = _row_scale(act_scale, lead, x.device)
    out = run(a, sa, w.data, sw, w_dtype=w.normal_dtype, a_mode=a_mode,
              a_dtype=a_dtype, s_static=s_static)
    return out.reshape(*lead, sw.shape[0])


fused_ovp_matmul.mode_launches = dict.fromkeys(A_MODES, 0)
fused_ovp_matmul.weight_launches = dict.fromkeys(W_DTYPES, 0)


# --------------------------------------------------------------------------
# K6: the grouped per-expert matmul
# --------------------------------------------------------------------------
def grouped_grid_blocks(plan: GroupedPlan, w_dtype: str) -> int:
    """The block count of K6's persistent grid for `plan` on this card
    (one wave of resident clusters; needs the card)."""
    out = ctypes.c_int(0)
    err = _build.load("ovp_matmul", _SIGNATURE).ovp_grouped_grid(
        plan.b, plan.e, plan.c, plan.n, _DTYPE_CODE[w_dtype],
        plan.row_tile, plan.split, plan.share, plan.smem,
        ctypes.addressof(out))
    _build.check(err, "grouped ovp_matmul grid")
    return out.value


def check_grouped_plan(plan: GroupedPlan, b: int, e: int, c: int, k: int,
                       n: int) -> GroupedPlan:
    """`plan` if it is a plan for a (B, E, C, K) x (E, K, n) call, else a
    ValueError (a forced plan's shape, checked before the launch)."""
    tile = _GBN if plan.body == "decode" else _BN
    if (plan.b, plan.e, plan.c, plan.k2, plan.n) != (
            b, e, c, k // 2, -(-n // tile) * tile):
        raise ValueError(f"{plan} is not a plan for a ({b}, {e}, {c}, {k})"
                         f" x ({e}, {k}, {n}) call")
    return plan


def _launch_grouped(a: torch.Tensor, sa: Optional[torch.Tensor],
                    w_data: torch.Tensor, sw: torch.Tensor, *, w_dtype: str,
                    a_mode: str, a_dtype: str, s_static: Optional[float],
                    fill: Optional[torch.Tensor],
                    plan: Optional[GroupedPlan] = None) -> torch.Tensor:
    b, e, c = a.shape[:3]
    k = w_data.shape[1] * (1 if w_dtype == "int8" else 2)
    n = w_data.shape[2]
    if plan is None:
        plan = grouped_launch_plan(b, e, c, k, n, w_dtype, a_mode,
                                   filled=fill is not None)
    else:
        check_grouped_plan(plan, b, e, c, k, n)
    if plan.n != n:    # the decode body's 64-column items: pad N
        w_data = torch.nn.functional.pad(w_data, (0, plan.n - n))
        sw = torch.nn.functional.pad(sw, (0, plan.n - n), value=1.0)
    a, sa, w_data, sw = _kernel_operands(a, sa, w_data, sw, a_mode,
                                         "grouped ovp_matmul")
    if fill is not None:
        if fill.shape != (b, e) or fill.device != a.device:
            raise ValueError(f"grouped ovp_matmul: fill {tuple(fill.shape)} "
                             f"on {fill.device}, expected ({b}, {e}) on "
                             f"{a.device}")
        fill = fill.to(torch.int32).contiguous()
    out = torch.empty((b, e, c, plan.n), dtype=torch.float32,
                      device=a.device)
    lib = _build.load("ovp_matmul", _SIGNATURE)
    err = lib.ovp_grouped_mm_launch(
        a.data_ptr(), sa.data_ptr(), w_data.data_ptr(), sw.data_ptr(),
        out.data_ptr(), 0 if fill is None else fill.data_ptr(), b, e, c, k,
        plan.n, _DTYPE_CODE[w_dtype], A_MODES.index(a_mode),
        _DTYPE_CODE[a_dtype], BODIES.index(plan.body), plan.row_tile,
        plan.split, plan.share, plan.slice, plan.smem,
        float(np.float32(s_static or 1.0)),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "grouped ovp_matmul")
    grouped_ovp_matmul.mode_launches[a_mode] += 1
    grouped_ovp_matmul.weight_launches[w_dtype] += 1
    return out[..., :n]


def run_grouped(a: torch.Tensor, sa: Optional[torch.Tensor],
                w_data: torch.Tensor, sw: torch.Tensor, *, w_dtype: str,
                a_mode: str, a_dtype: Optional[str] = None,
                s_static: Optional[float] = None,
                fill: Optional[torch.Tensor] = None,
                plan: Optional[GroupedPlan] = None) -> torch.Tensor:
    """(B, E, C, Ka) x stacked codes (E, Kw, N) -> (B, E, C, N): the
    plain version for CPU tensors, K6 for CUDA tensors, the output's
    shape alone for "meta" tensors (`grouped_ovp_matmul_shape`; no
    launch is counted), an error for anything else. Scales: sa (B, E, C), sw (E, N). `fill` (B, E) int:
    only rows c < fill[b, e] are computed; the others are zeros on the
    CPU and unwritten (unspecified) on the card. `plan` replaces
    `grouped_launch_plan`'s launch (measurement forces a body with it; a
    decode plan made with `filled` must come with a fill); the plain
    version ignores it."""
    if a.ndim != 4 or w_data.ndim != 3 or a.shape[1] != w_data.shape[0]:
        raise ValueError(f"grouped ovp_matmul takes a (B, E, C, K) lhs "
                         f"and an (E, K, N) stack; got {tuple(a.shape)} "
                         f"and {tuple(w_data.shape)}")
    kw = _checked_modes(a, sa, w_data, w_dtype=w_dtype, a_mode=a_mode,
                        a_dtype=a_dtype, s_static=s_static)
    if a.device.type == "cpu":
        return grouped_ovp_matmul_plain(a, sa, w_data, sw, fill=fill, **kw)
    if a.device.type == "meta":
        return grouped_ovp_matmul_shape(a, w_data)
    if a.device.type != "cuda":
        raise ValueError(f"grouped ovp_matmul runs on cpu, cuda or meta, "
                         f"not {a.device}")
    return _launch_grouped(a, sa, w_data, sw, fill=fill, plan=plan, **kw)


def _as_4d(x: torch.Tensor):
    """(…, E, C, K) -> ((B, E, C, K), lead): the dims left of (E, C, K)
    fold into B."""
    if x.ndim < 3:
        raise ValueError(f"grouped lhs must be at least 3-D, got "
                         f"{tuple(x.shape)}")
    return x.reshape(-1, *x.shape[-3:]), tuple(x.shape[:-3])


def _expert_row_scale(s, lead: tuple, device) -> torch.Tensor:
    """A scalar or per-slot activation scale (shaped like the lhs without
    K, or broadcastable to it with a trailing 1) -> (B, E, C) f32."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.ndim and s.shape == lead:
        s = s[..., None]
    return torch.broadcast_to(s, tuple(lead) + (1,)).reshape(
        -1, *lead[-2:])


def _expert_col_scale(s, e: int, n: int, device) -> torch.Tensor:
    """Per-expert weight scales -> (E, N) f32: a scalar (shared), (E,)
    or (E, 1, 1) per-expert tensor scales, or (E, 1, N) per-expert
    channel scales."""
    s = torch.as_tensor(s, dtype=torch.float32, device=device)
    if s.ndim == 0:
        return torch.broadcast_to(s, (e, n))
    return torch.broadcast_to(s.reshape(e, -1), (e, n))


def grouped_ovp_matmul(x: Union[torch.Tensor, QuantizedTensor],
                       w: QuantizedTensor, *,
                       a_dtype: Optional[str] = None,
                       act_scale: Optional[torch.Tensor] = None,
                       static_act_scale: Optional[float] = None,
                       fill: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(…, E, C, K) @ stacked OVP (E, K, N) -> (…, E, C, N) f32, one
    launch of K6 on CUDA: the per-expert mirror of `fused_ovp_matmul`,
    with the same activation modes (fp lhs by default, in-kernel OVP
    quantization with `a_dtype` and `act_scale` or `static_act_scale`,
    or a pre-quantized `QuantizedTensor` lhs). `fill` (…, E) integer,
    the filled capacity rows of each (…, expert): row c is computed only
    where c < fill (the MoE dispatch's kept slots take ranks 0..fill-1);
    the rows past it are zeros on the CPU and left unwritten on the card,
    so no caller may read them. None computes every row."""
    if w.data.ndim != 3 or w.pair_axis % 3 != 1:
        raise ValueError("grouped_ovp_matmul takes an (E, K, N) stack "
                         "paired along K")
    e, n = w.data.shape[0], w.data.shape[-1]
    sw = _expert_col_scale(w.scale, e, n, w.data.device)
    sa = s_static = None
    if isinstance(x, QuantizedTensor):
        if x.pair_axis != -1:
            raise ValueError("a pre-quantized lhs pairs along its last "
                             "axis")
        a_mode = "codes4" if x.is_packed else "codes8"
        a_dtype = x.normal_dtype
        a, lead = _as_4d(x.data)
        sa = _expert_row_scale(x.scale, x.data.shape[:-1], x.data.device)
    else:
        a, lead = _as_4d(x.to(torch.float32))
        if a_dtype is None:
            a_mode = "fp"
        elif static_act_scale is not None:
            a_mode, s_static = "static", float(static_act_scale)
        elif act_scale is None:
            raise ValueError("in-kernel activation quantization needs an "
                             "act_scale (per-tensor or per-slot) or a "
                             "static_act_scale constant")
        else:
            a_mode = "quantize"
            sa = _expert_row_scale(act_scale, x.shape[:-1], x.device)
    if fill is not None:
        fill = fill.reshape(-1, e)
    out = run_grouped(a, sa, w.data, sw, w_dtype=w.normal_dtype,
                      a_mode=a_mode, a_dtype=a_dtype, s_static=s_static,
                      fill=fill)
    return out.reshape(*lead, *out.shape[-3:])


grouped_ovp_matmul.mode_launches = dict.fromkeys(A_MODES, 0)
grouped_ovp_matmul.weight_launches = dict.fromkeys(W_DTYPES, 0)
