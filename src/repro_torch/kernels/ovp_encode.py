"""K7: the standalone OVP encoder — hand-written CUDA kernel + plain
version.

Replaces the TPU kernel `repro/kernels/ovp_encode.py:59`
(`ovp_encode_pallas`, body `_encode_kernel` :42) together with the
division of its host wrapper (`repro/kernels/ops.py:345`): real values x
(R, K) -> u = x / scale -> packed OVP bytes (R, K/2) uint8, int4 normals
with E2M1 abfloat outliers, the even value of each pair in the high
nibble. Int4 only, as the reference asserts. The scale is none (x is
already scaled), a scalar, or one per row: the KV-cache write encodes
each (token, kv head) row of a new K or V at its 3σ scale this way
(`backends.encode_kv`). The kernel source is `csrc/ovp_encode.cu`; its
header says what bounds it on the H100, and `encode_plan` holds its
launch geometry.

`fused_ovp_encode` takes `ovp_encode_plain` for CPU tensors and launches
the kernel for CUDA tensors (or raises); `fused_ovp_encode.launches`
counts kernel launches. `kernels.ops.ovp_encode` is the public entry.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import numbers
import torch

from repro_torch.core.ovp import ovp_encode_codes, pack4

from . import _build

_SIGNATURE = {"ovp_encode_launch": [ctypes.c_void_p] * 2 + [ctypes.c_int]
              + [ctypes.c_float] + [ctypes.c_void_p] + [ctypes.c_int] * 7
              + [ctypes.c_void_p]}

# the input kinds and scale kinds of the C entry
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SCALE_KINDS = ("none", "scalar", "row")
MAX_THREADS = 256
_SMS = 132            # an H100 has 132 SMs
_CAP_BLOCKS = 4 * _SMS    # 1024 threads an SM: what the SMs hold at once


@dataclasses.dataclass(frozen=True)
class EncodePlan:
    """K7's launch geometry for one call: `vec` values of one row an item
    (16 or 8 through 16-byte loads and one 8- or 4-byte store, or 2: one
    pair, scalar loads, one byte), `items` = R * K / vec, `blocks` x
    `threads`, each thread walking items by a stride of blocks x
    threads."""
    vec: int
    items: int
    blocks: int
    threads: int

    @property
    def stride(self) -> int:
        """Global thread t encodes items t, t + stride, ...; item i holds
        pairs i * vec/2 .. (i + 1) * vec/2 - 1 of the flat output."""
        return self.blocks * self.threads


@functools.lru_cache(maxsize=None)
def encode_plan(r: int, k: int, dtype: torch.dtype = torch.float32,
                scale_kind: str = "none", aligned: bool = True
                ) -> EncodePlan:
    """The geometry of one K7 call on an (r, k) input of `dtype` whose
    base is 16-byte aligned (`aligned`), from shapes alone.

    - vec: 16-byte loads need K a multiple of the item and an aligned
      base; 16 values an item where the call fills more than one wave of
      resident threads at 8 (bytes in flight), else 8 (more threads
      for a short call); 2 (a pair) otherwise.
    - threads: 256, or the items rounded up to a warp when fewer.
    - blocks: the fewest that cover the items, capped at what the SMs
      hold (`_CAP_BLOCKS`), past which threads stride.
    The scale kind does not change the geometry (one division a value)."""
    if k <= 0 or k % 2 or r < 0:
        raise ValueError(f"ovp_encode takes (R, K) with K even, got "
                         f"({r}, {k})")
    if dtype not in DTYPES:
        raise ValueError(f"ovp_encode kernel takes {sorted(map(str, DTYPES))}"
                         f", got {dtype}")
    if scale_kind not in SCALE_KINDS:
        raise ValueError(f"scale kind {scale_kind!r} not in {SCALE_KINDS}")
    if aligned and k % 16 == 0 and \
            r * k // 8 > _CAP_BLOCKS * MAX_THREADS:
        vec = 16
    elif aligned and k % 8 == 0:
        vec = 8
    else:
        vec = 2
    items = r * k // vec
    threads = min(MAX_THREADS, max(32, -(-items // 32) * 32))
    blocks = max(1, min(-(-items // threads), _CAP_BLOCKS))
    return EncodePlan(vec=vec, items=items, blocks=blocks, threads=threads)


def _divisor(scale, x: torch.Tensor) -> torch.Tensor:
    """The scale as an f32 tensor on x's device that broadcasts over (R,
    K): a true division by it rounds as the kernel's (a Python scalar
    divisor may become a multiply by its reciprocal on the card)."""
    if isinstance(scale, torch.Tensor):
        s = scale.to(device=x.device, dtype=torch.float32)
        return s.reshape(()) if s.numel() == 1 else s.reshape(-1, 1)
    return torch.full((), float(scale), dtype=torch.float32,
                      device=x.device)


def ovp_encode_plain(x: torch.Tensor, scale=None) -> torch.Tensor:
    """(R, K) real values -> (R, K/2) packed int4 OVP bytes at u = x /
    scale (none, a scalar, or per row (R,) / (R, 1)): the division, then
    Algorithm 1 and 2 in torch ops (`core.ovp.ovp_encode_codes`) and
    `pack4`."""
    u = x.to(torch.float32)
    if scale is not None:
        u = u / _divisor(scale, x)
    return pack4(ovp_encode_codes(u, "int4"))


def ovp_encode_shape(x: torch.Tensor) -> torch.Tensor:
    """The plain version's output for a "meta" x: (R, K/2) uint8 on
    "meta", no arithmetic."""
    return torch.empty((x.shape[0], x.shape[1] // 2), dtype=torch.uint8,
                       device="meta")


def _scale_args(scale, r: int, device: torch.device):
    """(kind, row tensor or None, row stride, scalar) for the C entry."""
    if scale is None:
        return "none", None, 0, 0.0
    if isinstance(scale, torch.Tensor):
        if scale.numel() == 1 and scale.device.type == "cpu":
            return "scalar", None, 0, float(scale)
        s = scale.to(device=device, dtype=torch.float32).reshape(-1)
        s = s.contiguous()
        return "row", s, 1 if s.numel() == r and r > 1 else 0, 0.0
    return "scalar", None, 0, float(scale)


def _launch(x: torch.Tensor, scale) -> torch.Tensor:
    if x.dtype not in DTYPES:
        x = x.to(torch.float32)
    x = x.contiguous()
    r, k = x.shape
    kind, srow, s_stride, s_val = _scale_args(scale, r, x.device)
    plan = encode_plan(r, k, x.dtype, kind, x.data_ptr() % 16 == 0)
    out = torch.empty((r, k // 2), dtype=torch.uint8, device=x.device)
    if plan.items == 0:
        return out
    lib = _build.load("ovp_encode", _SIGNATURE)
    err = lib.ovp_encode_launch(
        x.data_ptr(), None if srow is None else srow.data_ptr(), s_stride,
        s_val, out.data_ptr(), r, k, DTYPES[x.dtype],
        SCALE_KINDS.index(kind), plan.vec, plan.blocks, plan.threads,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ovp_encode")
    fused_ovp_encode.launches += 1
    return out


def fused_ovp_encode(x: torch.Tensor, normal_dtype: str = "int4",
                     scale=None) -> torch.Tensor:
    """(R, K) real values (f32, bf16 or fp16 read as they are; another
    dtype cast to f32 first) -> (R, K/2) packed OVP bytes at u = x /
    scale: the plain version for CPU tensors, one kernel launch for CUDA
    tensors, an error for anything else. `scale`: None (x already
    scaled), a Python or 1-element scalar, or an (R,) / (R, 1) tensor.
    "meta" tensors give the output's shape alone (`ovp_encode_shape`;
    no launch is counted)."""
    if normal_dtype != "int4":
        raise ValueError("the encoder kernel targets int4 activations, "
                         f"not {normal_dtype!r}")
    if x.ndim != 2 or x.shape[1] % 2:
        raise ValueError(f"ovp_encode takes (R, K) with K even, got "
                         f"{tuple(x.shape)}")
    if scale is not None and not isinstance(scale, numbers.Real):
        scale = torch.as_tensor(scale)
        if scale.numel() not in (1, x.shape[0]):
            raise ValueError(f"ovp_encode scale of shape "
                             f"{tuple(scale.shape)} for {x.shape[0]} rows: "
                             f"give a scalar or one scale a row")
    if x.device.type == "cpu":
        return ovp_encode_plain(x, scale)
    if x.device.type == "meta":
        return ovp_encode_shape(x)
    if x.device.type != "cuda":
        raise ValueError(f"ovp_encode runs on cpu, cuda or meta, not "
                         f"{x.device}")
    return _launch(x, scale)


fused_ovp_encode.launches = 0
