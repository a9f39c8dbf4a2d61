// Int4 OVP encode on the device, shared by the kernels that write packed
// OVP codes: K4's cache-write prefill (prefill_attn.cu) and K7's
// standalone encoder (ovp_encode.cu).
//
// The function is core/ovp.py::ovp_encode_codes for int4 normals and their
// E2M1 abfloat (bias 2) outliers, and must stay exact: round half to even,
// an exact floor(log2), no fast-math. It is computed without a conversion
// instruction (F2I, FRND: a quarter of the FP32 rate on Hopper) or a MUFU:
// - int4: rint(v) for |v| <= 7 is (v + 1.5 * 2^23) - 1.5 * 2^23. The sum
//   lies in [2^23, 2^24), where one ulp is 1, so the add rounds v half to
//   even, and since 1.5 * 2^23 is even the low bits of the sum's pattern
//   are the rounded integer in two's complement. The clip to +-7 comes
//   first: it commutes with the rounding, +-7 being integers.
// - abfloat: the magnitude m, clamped to [12, 96], is 2^E * (1 + f). The
//   reference's code is (ef << 1) | mf with 2^(ef + 2) * (2 + mf) the value
//   m rounds to, half to even, on the grid {12, 16, 24, 32, 48, 64, 96}:
//   m / 2^(E-1) = 2 + 2f rounds to 2 for f <= 1/4, 3 for 1/4 < f < 3/4 and
//   4 (the next binade's 2) for f >= 3/4, so the field is 2E - 6 plus
//   those two steps, read off the exponent and mantissa bits (the
//   reference's floor(log2) and mantissa-overflow bump, exactly). Within
//   [12, 96] the field is 1..7, so the disabled e=0, m=0 code never arises.
// chip_smoke.py holds this encode against the plain version on every
// float32 pattern.
#pragma once

#include <stdint.h>

namespace ovp {

// int4 normal code: clip to +-7, round half to even, two's complement
__device__ __forceinline__ uint32_t enc_int4(float u) {
  const float c = fminf(fmaxf(u, -7.f), 7.f);
  return __float_as_uint(c + 12582912.f) & 15u;  // + 1.5 * 2^23
}

// int4's E2M1 abfloat (bias 2) code of an outlier u (|u| > 7)
__device__ __forceinline__ uint32_t enc_abfloat4(float u) {
  // positive floats order as their bit patterns: clamp to [12, 96]
  const int b = min(max(__float_as_int(fabsf(u)), 0x41400000), 0x42C00000);
  const int frac = b & 0x7fffff;
  const int field = 2 * (b >> 23) - 260 + (frac > 0x200000) +
                    (frac >= 0x600000);
  return ((__float_as_uint(u) >> 28) & 8u) | (uint32_t)field;
}

// Algorithm 1 on one scaled pair -> one packed byte (even code high). At
// most one value of a pair is the outlier (the larger magnitude above 7;
// equal magnitudes keep the left one), its neighbour the victim (8), so
// one abfloat encode serves both slots. Selects, no branch: neighbouring
// pairs of a warp take different cases.
__device__ __forceinline__ uint32_t enc_pair(float u0, float u1) {
  const float a0 = fabsf(u0), a1 = fabsf(u1);
  const bool first = a0 > 7.f && !(a1 > a0);
  const bool second = a1 > 7.f && !first;
  const uint32_t f = enc_abfloat4(first ? u0 : u1);
  const uint32_t normal = (enc_int4(u0) << 4) | enc_int4(u1);
  const uint32_t outlier = first ? (f << 4) | 8u : 0x80u | f;
  return first || second ? outlier : normal;
}

}  // namespace ovp
