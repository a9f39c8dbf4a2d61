"""Outlier-Victim Pair (OVP) encoding (paper §3, Algorithm 1).

Port of `repro/core/ovp.py`. Per adjacent pair along `pair_axis`:
  normal–normal   -> both quantized with the normal dtype
  outlier–normal  -> the normal neighbour becomes the victim (its slot
                     holds the identifier), the outlier is abfloat
  outlier–outlier -> the smaller magnitude is pruned; equal magnitudes
                     keep the left one
4-bit codes pack two per byte (one byte is one pair, the even index in
the high nibble); int8 codes stay one per byte. A stacked per-expert
weight is one `QuantizedTensor` with (E, K/2, N) data and (E, 1, N)
(or (E, 1, 1)) scales; `MixedExpertQuant` holds a stack whose experts
quantized under different policies.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.analysis import sanitize

from .datatypes import (ABFLOAT_FOR_NORMAL, ID4, ID8, NORMAL_MAX, AbfloatSpec,
                        abfloat_decode, abfloat_encode, normal_decode,
                        normal_encode)


def identifier(normal_dtype: str) -> int:
    return ID8 if normal_dtype == "int8" else ID4


def _interleave(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """(…, P) even and odd planes -> (…, 2P) in pair order."""
    return torch.stack([x0, x1], dim=-1).reshape(*x0.shape[:-1],
                                                 2 * x0.shape[-1])


def ovp_encode_codes(u: torch.Tensor, normal_dtype: str = "int4",
                     spec: Optional[AbfloatSpec] = None,
                     pair_axis: int = -1) -> torch.Tensor:
    """Scaled tensor -> uint8 code tensor (same shape), Algorithm 1."""
    spec = ABFLOAT_FOR_NORMAL[normal_dtype] if spec is None else spec
    ident = identifier(normal_dtype)
    t = float(NORMAL_MAX[normal_dtype])
    v = torch.movedim(u, pair_axis, -1)
    if v.shape[-1] % 2 != 0:
        raise ValueError(f"pair axis length {v.shape[-1]} must be even")
    if sanitize.enabled():
        sanitize.check(torch.isfinite(v),
                       "ovp_encode_codes: non-finite scaled input (NaN/Inf "
                       "upstream of the encoder, or a zero/garbage scale)")
    x0, x1 = v[..., 0::2], v[..., 1::2]
    a0, a1 = torch.abs(x0), torch.abs(x1)
    o0, o1 = a0 > t, a1 > t
    first_out = o0 & (~o1 | (a0 >= a1))
    second_out = o1 & ~first_out
    # a Python scalar: no host-to-device copy (and stream sync) per call
    c0 = torch.where(first_out, abfloat_encode(x0, spec),
                     torch.where(second_out, ident,
                                 normal_encode(x0, normal_dtype)))
    c1 = torch.where(second_out, abfloat_encode(x1, spec),
                     torch.where(first_out, ident,
                                 normal_encode(x1, normal_dtype)))
    return torch.movedim(_interleave(c0, c1), -1, pair_axis)


def decode_pair_planes(n0: torch.Tensor, n1: torch.Tensor,
                       normal_dtype: str,
                       spec: Optional[AbfloatSpec] = None):
    """Two code planes (pair-mates) -> decoded float32 planes: if my
    neighbour holds the identifier I am the outlier (abfloat), if I hold
    it I am the victim (0), otherwise I am a normal value."""
    spec = ABFLOAT_FOR_NORMAL[normal_dtype] if spec is None else spec
    ident = identifier(normal_dtype)
    v0 = torch.where(n1 == ident, abfloat_decode(n0, spec),
                     torch.where(n0 == ident, 0.0,
                                 normal_decode(n0, normal_dtype)))
    v1 = torch.where(n0 == ident, abfloat_decode(n1, spec),
                     torch.where(n1 == ident, 0.0,
                                 normal_decode(n1, normal_dtype)))
    return v0, v1


def ovp_decode_codes(codes: torch.Tensor, normal_dtype: str = "int4",
                     spec: Optional[AbfloatSpec] = None,
                     pair_axis: int = -1) -> torch.Tensor:
    """uint8 code tensor -> scaled float32 values. Victims decode to 0."""
    c = torch.movedim(codes, pair_axis, -1)
    if sanitize.enabled():
        ident = identifier(normal_dtype)
        sanitize.check(~((c[..., 0::2] == ident) & (c[..., 1::2] == ident)),
                       "ovp_decode_codes: both codes of a pair hold the "
                       "identifier — not a valid OVP encoding (corrupt or "
                       "misaligned code stream)")
    v0, v1 = decode_pair_planes(c[..., 0::2], c[..., 1::2], normal_dtype,
                                spec)
    return torch.movedim(_interleave(v0, v1), -1, pair_axis)


def pack4(codes: torch.Tensor, pair_axis: int = -1) -> torch.Tensor:
    """(…, 2K, …) nibble codes -> (…, K, …) bytes; even index = high."""
    c = torch.movedim(codes, pair_axis, -1).to(torch.uint8)
    packed = (c[..., 0::2] << 4) | (c[..., 1::2] & 0xF)
    return torch.movedim(packed, -1, pair_axis)


def unpack4(packed: torch.Tensor, pair_axis: int = -1) -> torch.Tensor:
    """(…, K, …) bytes -> (…, 2K, …) nibble codes."""
    p = torch.movedim(packed, pair_axis, -1).to(torch.uint8)
    c = _interleave((p >> 4) & 0xF, p & 0xF)
    return torch.movedim(c, -1, pair_axis)


@dataclasses.dataclass
class QuantizedTensor:
    """OVP-quantized tensor.

    data:   uint8. 4-bit dtypes: packed nibbles, `pair_axis` length = dim/2.
            int8: one code per byte, full length.
    scale:  float32, broadcastable against the dequantized tensor.
    normal_dtype: "int4" | "flint4" | "int8"
    pair_axis: axis along which values pair/pack (stored negative)
    orig_dim: unpacked length of pair_axis
    """
    data: torch.Tensor
    scale: torch.Tensor
    normal_dtype: str
    pair_axis: int
    orig_dim: int

    @property
    def is_packed(self) -> bool:
        return self.normal_dtype != "int8"

    @property
    def shape(self):
        s = list(self.data.shape)
        s[self.pair_axis % len(s)] = self.orig_dim
        return tuple(s)

    def nbytes(self) -> int:
        """Stored bytes: the codes plus the fp32 scales."""
        return self.data.numel() + self.scale.numel() * 4


@dataclasses.dataclass
class MixedExpertQuant:
    """A stacked (E, K, N) expert weight whose experts resolved to
    different per-site policies (sites `<path>/<e>`), grouped by policy.

    groups:     one entry per distinct policy: a stacked QuantizedTensor
                (Ei, K/2 | K, N), or a raw (Ei, K, N) tensor for experts
                left unquantized
    expert_ids: expert_ids[g][i] is the original expert index of
                groups[g]'s i-th slice
    n_experts:  E, the stack the groups partition

    Built once per stack, on the weights' device: `group_index[g]`, the
    int64 tensor of `expert_ids[g]`, and `order`, the inverse permutation
    that puts the concatenated group outputs back in expert order. A
    dispatch reads them and copies nothing from the host, which a
    captured step could not do.
    """
    groups: tuple
    expert_ids: tuple
    n_experts: int
    group_index: tuple = dataclasses.field(init=False, repr=False,
                                           compare=False)
    order: torch.Tensor = dataclasses.field(init=False, repr=False,
                                            compare=False)

    def __post_init__(self):
        g0 = self.groups[0]
        device = (g0.data if isinstance(g0, QuantizedTensor) else g0).device
        self.group_index = tuple(
            torch.as_tensor(ids, dtype=torch.int64, device=device)
            for ids in self.expert_ids)
        flat = [e for ids in self.expert_ids for e in ids]
        self.order = torch.as_tensor(
            sorted(range(len(flat)), key=flat.__getitem__),
            dtype=torch.int64, device=device)

    @property
    def shape(self):
        return (self.n_experts,) + tuple(self.groups[0].shape[1:])

    def nbytes(self) -> int:
        """Stored bytes of every group (a raw group at its dtype)."""
        return sum(g.nbytes() if isinstance(g, QuantizedTensor)
                   else g.numel() * g.element_size() for g in self.groups)


def ovp_quantize(x: torch.Tensor, scale, normal_dtype: str = "int4",
                 spec: Optional[AbfloatSpec] = None,
                 pair_axis: int = -1) -> QuantizedTensor:
    """Quantize a real tensor with OVP at a given scale."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    if sanitize.enabled():
        sanitize.check((scale > 0) & torch.isfinite(scale),
                       "ovp_quantize: scale must be positive and finite")
    u = x.to(torch.float32) / scale
    codes = ovp_encode_codes(u, normal_dtype, spec, pair_axis)
    neg_ax = pair_axis if pair_axis < 0 else pair_axis - x.ndim
    data = pack4(codes, neg_ax) if normal_dtype != "int8" else codes
    # contiguous storage: the kernels read the codes as laid out
    return QuantizedTensor(data=data.contiguous(), scale=scale.contiguous(),
                           normal_dtype=normal_dtype, pair_axis=neg_ax,
                           orig_dim=x.shape[neg_ax])


def ovp_dequantize(qt: QuantizedTensor,
                   spec: Optional[AbfloatSpec] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """decode(codes) * scale."""
    codes = unpack4(qt.data, qt.pair_axis) if qt.is_packed else qt.data
    vals = ovp_decode_codes(codes, qt.normal_dtype, spec, qt.pair_axis)
    return (vals * qt.scale).to(dtype)


def _abfloat_values(u: torch.Tensor, spec: AbfloatSpec) -> torch.Tensor:
    """`abfloat_decode(abfloat_encode(u))` in the value domain: the
    magnitude clamped to [min_mag, max_mag] and rounded to mb mantissa
    bits at its exponent e = floor(log2), i.e. round(m · 2^(mb - e)) ·
    2^(e - mb) with the sign. The code path's other steps change no
    value in that range: its mantissa-overflow bump encodes the same
    value (2^mb · 2^(e + 1 - mb) = 2^(mb + 1) · 2^(e - mb)), its field
    clamps and its e=0/m=0 rule never act on a clamped magnitude, and
    max_mag is at most the 2^15 clip."""
    mag = torch.clamp(torch.abs(u), spec.min_mag, spec.max_mag)
    step = torch.exp2(torch.floor(torch.log2(mag)) - spec.mb)
    val = torch.round(mag / step) * step
    return torch.where(u < 0, -val, val)


def ovp_fake_quant(x: torch.Tensor, scale, normal_dtype: str = "int4",
                   spec: Optional[AbfloatSpec] = None,
                   pair_axis: int = -1) -> torch.Tensor:
    """quantize -> dequantize without packing (the scale search, QAT):
    `ovp_decode_codes(ovp_encode_codes(x / scale)) * scale`, computed on
    values in about a quarter of the tensor ops for int normals: per
    pair along `pair_axis`, the outlier (`ovp_encode_codes`' rule) takes
    its abfloat value, its victim 0, and normal pairs round half to even
    within ±NORMAL_MAX. Bit for bit the code path's
    (tests/test_torch_qat.py); flint4 normals run the code path."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    u = x.to(torch.float32) / scale
    if normal_dtype == "flint4":
        codes = ovp_encode_codes(u, normal_dtype, spec, pair_axis)
        return ovp_decode_codes(codes, normal_dtype, spec, pair_axis) * scale
    spec = ABFLOAT_FOR_NORMAL[normal_dtype] if spec is None else spec
    t = float(NORMAL_MAX[normal_dtype])
    u = torch.movedim(u, pair_axis, -1)
    if u.shape[-1] % 2 != 0:
        raise ValueError(f"pair axis length {u.shape[-1]} must be even")
    pairs = u.unflatten(-1, (-1, 2))
    a = torch.abs(pairs)
    over = a > t
    first = over[..., 0] & (~over[..., 1] | (a[..., 0] >= a[..., 1]))
    second = over[..., 1] & ~first
    outlier = torch.stack([first, second], dim=-1)
    victim = torch.stack([second, first], dim=-1)
    q = torch.where(outlier, _abfloat_values(pairs, spec),
                    torch.where(victim, 0.0,
                                torch.clamp(torch.round(pairs), -t, t)))
    # + 0.0: a normal rounding to -0 is +0 in the code path
    return (torch.movedim(q.flatten(-2), -1, pair_axis) + 0.0) * scale


def pair_statistics(x: torch.Tensor, k_sigma: float = 3.0,
                    pair_axis: int = -1) -> dict:
    """Fractions of normal-normal / outlier-normal / outlier-outlier pairs
    (paper §2.3, Table 2): an outlier lies beyond k_sigma population σ of
    the mean."""
    v = torch.movedim(x.to(torch.float32), pair_axis, -1)
    mu = v.mean()
    sigma = torch.sqrt(((v - mu) ** 2).mean())
    out = torch.abs(v - mu) > k_sigma * sigma
    o0, o1 = out[..., 0::2], out[..., 1::2]
    nn = ((~o0) & (~o1)).to(torch.float32).mean()
    oo = (o0 & o1).to(torch.float32).mean()
    return {"normal_normal": float(nn),
            "outlier_normal": float(1.0 - nn - oo),
            "outlier_outlier": float(oo),
            "outlier_ratio": float(out.to(torch.float32).mean()),
            "sigma": float(sigma)}
