// Int4 OVP encode on the device, shared by the kernels that write packed
// OVP codes: K4's cache-write prefill (prefill_attn.cu) and K7's
// standalone encoder (ovp_encode.cu).
//
// The arithmetic is core/ovp.py::ovp_encode_codes for int4 normals and
// their E2M1 abfloat (bias 2) outliers, and must stay exact: rintf
// (round half to even), exact log2f and ldexpf, no fast-math. A fused
// multiply-add or a reassociation would move a value on a rounding
// boundary to the other code.
#pragma once

#include <stdint.h>

namespace ovp {

// int4 normal code: round half to even, clip to +-7, two's complement
__device__ __forceinline__ int enc_int4(float u) {
  const int q = (int)fminf(fmaxf(rintf(u), -7.f), 7.f);
  return q & 15;
}

// int4's E2M1 abfloat (bias 2): magnitude clamped to [12, 96], exact
// floor(log2) with the mantissa-overflow bump, the e=0, m=0 code disabled
__device__ __forceinline__ int enc_abfloat4(float u) {
  const int sign = u < 0.f ? 1 : 0;
  const float mag = fminf(fmaxf(fabsf(u), 12.f), 96.f);
  int ex = (int)floorf(log2f(mag)) - 1;
  int base = (int)rintf(ldexpf(mag, -ex));
  if (base == 4) {
    ex += 1;
    base = 2;
  }
  const int ef = min(max(ex - 2, 0), 3);
  const int mf = base & 1;
  const int code = (sign << 3) | (ef << 1) | mf;
  return (ef == 0 && mf == 0) ? (code | 1) : code;
}

// Algorithm 1 on one scaled pair -> one packed byte (even code high)
__device__ __forceinline__ uint8_t enc_pair(float u0, float u1) {
  const float a0 = fabsf(u0), a1 = fabsf(u1);
  const bool o0 = a0 > 7.f, o1 = a1 > 7.f;
  const bool first = o0 && (!o1 || a0 >= a1);  // ties keep the left one
  const bool second = o1 && !first;
  const int c0 = first ? enc_abfloat4(u0) : (second ? 8 : enc_int4(u0));
  const int c1 = second ? enc_abfloat4(u1) : (first ? 8 : enc_int4(u1));
  return (uint8_t)((c0 << 4) | (c1 & 15));
}

}  // namespace ovp
