"""Numeric data types for OliVe OVP quantization (paper §3.2–3.3).

Port of `repro/core/datatypes.py`. Encoders and decoders work on *scaled*
values (value / scale) and on integer nibble/byte codes held in uint8
tensors, branch-free (`torch.where` chains), so the same arithmetic runs
on any device.

Normal data types (Table 3)
  int4    values 0,±1..±7         identifier 1000b  (-8 removed)
  flint4  values 0,±1..±4,±6,±8,±16 identifier 1000b (-0, unused by design)
  int8    values 0,±1..±127       identifier 10000000b (-128 removed)

Outlier data type: abfloat (§3.3), value = sign × (2^mb + m) << (e + bias);
E2M1 for the 4-bit types, E4M3 for int8. The e=0, m=0 codes are never
emitted, so an outlier cannot forge the victim identifier.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ID4 = 0x8          # 1000b
ID8 = 0x80         # 10000000b

# Normal-value max magnitude (the outlier threshold T, §3.4)
NORMAL_MAX = {"int4": 7, "flint4": 16, "int8": 127}

# flint4 magnitude LUT (ANT data type): index = low 3 bits of the code
FLINT4_LUT = np.array([0, 1, 2, 3, 4, 6, 8, 16], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class AbfloatSpec:
    """sign × (2^mb + m) << (e + bias); total bits = 1 + ebits + mb."""
    ebits: int
    mb: int
    bias: int

    @property
    def bits(self) -> int:
        return 1 + self.ebits + self.mb

    @property
    def min_mag(self) -> int:
        # code bits e=0, m=1 (e=0, m=0 is disabled)
        return ((1 << self.mb) + 1) << self.bias

    @property
    def max_mag(self) -> int:
        base = (1 << (self.mb + 1)) - 1
        mag = base << ((1 << self.ebits) - 1 + self.bias)
        # §4.5: outliers clip at 2^15 so int32 accumulators cannot overflow
        return min(mag, 1 << 15)

    def magnitudes(self) -> np.ndarray:
        """Every representable magnitude, sorted (e=0, m=0 excluded)."""
        out = [min(((1 << self.mb) + m) << (e + self.bias), 1 << 15)
               for e in range(1 << self.ebits) for m in range(1 << self.mb)
               if e or m]
        return np.unique(np.array(out, dtype=np.float32))


def default_bias(normal_dtype: str, mb: int) -> int:
    """Adaptive bias (§3.3): smallest b with min outlier mag > normal max."""
    t = NORMAL_MAX[normal_dtype]
    b = 0
    while (((1 << mb) + 1) << b) <= t:
        b += 1
    return b


# the paper's configurations (§3.3): E2M1 for the 4-bit types, E4M3 for int8
E2M1_INT4 = AbfloatSpec(ebits=2, mb=1, bias=default_bias("int4", 1))
E2M1_FLINT4 = AbfloatSpec(ebits=2, mb=1, bias=default_bias("flint4", 1))
E4M3_INT8 = AbfloatSpec(ebits=4, mb=3, bias=default_bias("int8", 3))

ABFLOAT_FOR_NORMAL = {"int4": E2M1_INT4, "flint4": E2M1_FLINT4,
                      "int8": E4M3_INT8}


def abfloat_spec_for(normal_dtype: str, ebits: int | None = None,
                     mb: int | None = None) -> AbfloatSpec:
    """Spec for a normal dtype; `ebits` / `mb` override it (the Fig. 5
    sweep), with the adaptive bias of the mantissa width."""
    if ebits is None and mb is None:
        return ABFLOAT_FOR_NORMAL[normal_dtype]
    ebits = 2 if ebits is None else ebits
    mb = 1 if mb is None else mb
    return AbfloatSpec(ebits=ebits, mb=mb, bias=default_bias(normal_dtype, mb))


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8)


# --------------------------------------------------------------------------
# Normal-value encode / decode
# --------------------------------------------------------------------------
def int_normal_encode(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Scaled value -> two's-complement code; the identifier pattern
    100..0b is never produced (range clipped to ±(2^(bits-1)-1)).
    `torch.round` rounds half to even, as `jnp.round` does."""
    nmax = (1 << (bits - 1)) - 1
    q = torch.clamp(torch.round(u), -nmax, nmax).to(torch.int32)
    return _u8(q & ((1 << bits) - 1))


def int_normal_decode(code: torch.Tensor, bits: int) -> torch.Tensor:
    """Code -> scaled value. The identifier decodes to 0 (victim)."""
    c = code.to(torch.int32)
    half = 1 << (bits - 1)
    v = torch.where(c >= half, c - (1 << bits), c)
    return torch.where(c == half, 0, v).to(torch.float32)


def flint4_encode(u: torch.Tensor) -> torch.Tensor:
    """Nearest flint4 value; code = sign<<3 | idx, never 1000b. Ties go to
    the smaller index (argmin returns the first minimum)."""
    lut = torch.as_tensor(FLINT4_LUT, device=u.device)
    d = torch.abs(torch.abs(u)[..., None] - lut)
    idx = torch.argmin(d, dim=-1).to(torch.int32)
    neg = (u < 0) & (idx > 0)  # -0 is the identifier; encode 0 as +0
    return _u8((neg.to(torch.int32) << 3) | idx)


def flint4_decode(code: torch.Tensor) -> torch.Tensor:
    lut = torch.as_tensor(FLINT4_LUT, device=code.device)
    c = code.to(torch.int64)
    mag = lut[c & 0x7]
    v = torch.where(((c >> 3) & 1) == 1, -mag, mag)
    return torch.where(c == ID4, 0.0, v).to(torch.float32)


def normal_encode(u: torch.Tensor, normal_dtype: str) -> torch.Tensor:
    if normal_dtype == "int4":
        return int_normal_encode(u, 4)
    if normal_dtype == "flint4":
        return flint4_encode(u)
    if normal_dtype == "int8":
        return int_normal_encode(u, 8)
    raise ValueError(f"unknown normal dtype {normal_dtype!r}")


def normal_decode(code: torch.Tensor, normal_dtype: str) -> torch.Tensor:
    if normal_dtype == "int4":
        return int_normal_decode(code, 4)
    if normal_dtype == "flint4":
        return flint4_decode(code)
    if normal_dtype == "int8":
        return int_normal_decode(code, 8)
    raise ValueError(f"unknown normal dtype {normal_dtype!r}")


# --------------------------------------------------------------------------
# abfloat encode / decode (Algorithm 2 / Fig. 7)
# --------------------------------------------------------------------------
def abfloat_encode(u: torch.Tensor, spec: AbfloatSpec) -> torch.Tensor:
    """Scaled value -> abfloat code. Magnitude clamps to [min_mag,
    max_mag]; the disabled ±0 codes are never produced.

    floor(log2(.)) may land one off next to a power of two; the mantissa
    overflow bump below absorbs that, so the code is exact either way."""
    sign = (u < 0).to(torch.int32)
    mag = torch.clamp(torch.abs(u), spec.min_mag, spec.max_mag).to(
        torch.float32)
    exp = torch.floor(torch.log2(mag)).to(torch.int32) - spec.mb
    base = torch.round(mag / torch.exp2(exp.to(torch.float32))).to(
        torch.int32)
    ovf = base == (1 << (spec.mb + 1))
    exp = torch.where(ovf, exp + 1, exp)
    base = torch.where(ovf, 1 << spec.mb, base)
    efield = torch.clamp(exp - spec.bias, 0, (1 << spec.ebits) - 1)
    mfield = base & ((1 << spec.mb) - 1)
    code = (sign << (spec.ebits + spec.mb)) | (efield << spec.mb) | mfield
    zero_bits = (efield == 0) & (mfield == 0)
    return _u8(torch.where(zero_bits, code | 1, code))


def abfloat_decode(code: torch.Tensor, spec: AbfloatSpec) -> torch.Tensor:
    """abfloat code -> scaled value. ±0 codes decode to 0."""
    c = code.to(torch.int32)
    sign_bit = (c >> (spec.ebits + spec.mb)) & 1
    bits = c & ((1 << (spec.ebits + spec.mb)) - 1)
    e = bits >> spec.mb
    m = bits & ((1 << spec.mb) - 1)
    integer = (1 << spec.mb) + m
    mag = integer.to(torch.float32) * torch.exp2(
        (e + spec.bias).to(torch.float32))
    mag = torch.clamp(mag, max=float(1 << 15))
    v = torch.where(sign_bit == 1, -mag, mag)
    return torch.where(bits == 0, 0.0, v).to(torch.float32)


def abfloat_nearest(u: torch.Tensor, spec: AbfloatSpec) -> torch.Tensor:
    """Round to the nearest representable abfloat value (the reference
    mode the tests hold `abfloat_encode` to); ties take the smaller
    magnitude."""
    mags = torch.as_tensor(spec.magnitudes(), device=u.device)
    a = torch.clamp(torch.abs(u.to(torch.float32)), spec.min_mag,
                    spec.max_mag)
    val = mags[torch.argmin(torch.abs(a[..., None] - mags), dim=-1)]
    return torch.where(u < 0, -val, val)
