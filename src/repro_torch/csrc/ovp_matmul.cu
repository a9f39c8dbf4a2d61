// Fused OVP matmul for Hopper (sm_90a), fp32 FMA on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ovp_matmul.py:367
// (fused_ovp_matmul_kernel -> pallas_call at :417) in every activation
// mode, for int4 / flint4 packed-nibble weights and int8
// one-code-per-byte weights: K1 (body _fused_mm_kernel :224, modes fp,
// quantize, codes4, codes8) and K5 (a_static=True, body
// _fused_mm_kernel_static :263); and the grouped per-expert matmul K6
// (grouped_ovp_matmul_kernel :436 -> pallas_call at :489, bodies
// _grouped_mm_kernel :300 and _grouped_mm_kernel_static :333), the same
// body with an expert grid dimension (entry ovp_grouped_mm_launch).
//
//   K1/K5: out[r, n]       = (sum_k a'[r, k] * w'[k, n]) * sa[r] * sw[n]
//   K6:    out[b, e, c, n] = (sum_k a'[b, e, c, k] * w'[e, k, n])
//                            * sa[b, e, c] * sw[e, n]
//
// a' is, by mode:
//   fp        the fp32 activation, sa = 1;
//   quantize  its OVP fake-quantization at the per-row scale sa (u = a /
//             sa, Algorithm 1 pair selection, rintf rounding, exact log2f
//             abfloat encode);
//   static    the same at ONE calibrated scale s passed by value (K5):
//             u = a * (1 / s) with 1 / s an IEEE division, and the
//             epilogue acc * (s * sw[n]), in the Pallas body's order;
//             no scale plane is read;
//   codes4    pre-packed OVP nibbles (R, K/2), even k high, decoded with
//             the weight side's pair decode; per-row sa;
//   codes8    int8 OVP codes (R, K), one per byte; per-row sa.
// w' is the weight code decoded branch-free per pair: a neighbour
// holding the identifier makes the value an abfloat outlier, holding it
// yourself makes you the victim (0), otherwise the value is a normal
// code.
//
// Launch shape (K1): grid (N / 16, ceil(R / 8), split), 256 threads. A
// block owns 8 rows x 16 output columns and walks K inside the block in
// stages of 256 pairs: each stage loads the packed weight rows with one
// 16-byte load per row (16 columns of one K pair, coalesced along N) into
// shared memory, runs the activation prologue once per stage (quantize
// or decode into fp32 shared memory), and 16 k-groups of 16 threads
// accumulate disjoint pair subsets in registers; a shared-memory
// reduction over the k-groups and the scale epilogue finish the tile.
// Narrow 16-column tiles are chosen for the decode shapes of the serving
// path (rows = 4 slots, N = 1024 or 2816): they give 64 or 176 blocks
// where 128-column tiles would give 8 or 22. When the grid would still
// hold fewer than 100 blocks the wrapper splits K in two along
// gridDim.z; each half adds its scaled partial into a zeroed output with
// atomicAdd, which is order-independent for two addends, so the result
// stays deterministic.
//
// What bounds it on the H100: at decode (R = 4) the packed weight bytes
// (K/2 * N per call, 0.5-1.4 MB on the path) over 3.35 TB/s are well
// under a microsecond, so launch latency and the serial load-decode-FMA
// chain of each stage bound the kernel in every mode; nothing overlaps a
// stage's loads with the previous stage's math yet (no cp.async/TMA
// pipeline, no tensor cores). The codes modes read 1/8 (codes4) or 1/4
// (codes8) of the fp32 activation bytes, which at R = 4 is a few KB and
// moves nothing. Making it fast is later work.
//
// K6 (the MoE expert einsums wg, wu, wd; weight-only "fp" on the serving
// path, every mode through the kernel API): grid (N / 16, ceil(R / BM),
// E), one expert per blockIdx.z, its R = B * C rows (batch folded into
// the expert's rows by address arithmetic, no permute copy of the
// (B, E, C, K) activation). At decode (4 slots, capacity 4) R = 16 and
// BM = 16, so each expert's packed weight tile is read once per call;
// every capacity slot is computed, empty ones included, as the reference
// computes them. What bounds it: the fp32 FMAs of B * E * C rows (Qwen3-
// 30B-A3B wg at decode: 2048 x 2048 x 768, 6.4 GFLOP, 0.096 ms at 67
// TFLOP/s) over the packed weight bytes (101 MB, 0.030 ms at 3.35 TB/s);
// each column tile re-reads its expert's activation rows from L2.
//
// Tolerance against the plain versions (kernels/ovp_matmul.py,
// fused_ovp_matmul_plain and grouped_ovp_matmul_plain): decoded weights,
// decoded codes and quantized activations are exact in both; only the
// fp32 summation order differs, so rtol 1e-5 and atol 1e-5 * max|ref|.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 16;        // output columns per block
constexpr int BM_DENSE = 8;   // rows per block: K1, and K6 up to 8 rows
constexpr int BM_GROUPED = 16;  // rows per block: K6 above 8 rows
constexpr int BK2 = 256;      // K pairs per stage
constexpr int NT = 256;       // threads per block
constexpr int KG = NT / BN;   // k-groups

enum { DT_INT4 = 0, DT_FLINT4 = 1, DT_INT8 = 2 };
enum { A_FP = 0, A_QUANT = 1, A_STATIC = 2, A_CODES4 = 3, A_CODES8 = 4 };

struct Spec {
  int ebits, mb, bias;
};

// abfloat layouts: E2M1 for the 4-bit types (bias 2 int4, 3 flint4),
// E4M3 bias 4 for int8 (repro/core/datatypes.py ABFLOAT_FOR_NORMAL)
__device__ __forceinline__ Spec spec_for(int dt) {
  return dt == DT_INT8 ? Spec{4, 3, 4}
                       : (dt == DT_FLINT4 ? Spec{2, 1, 3} : Spec{2, 1, 2});
}

__device__ __forceinline__ float dec_abfloat(int c, Spec s) {
  const int nb = s.ebits + s.mb;
  const int bits = c & ((1 << nb) - 1);
  const int e = bits >> s.mb, m = bits & ((1 << s.mb) - 1);
  const int mag = min(((1 << s.mb) + m) << (e + s.bias), 1 << 15);
  const float v = ((c >> nb) & 1) ? -(float)mag : (float)mag;
  return bits == 0 ? 0.f : v;
}

__device__ __forceinline__ float dec_normal(int c, int dt) {
  if (dt == DT_INT8) return (float)(c >= 128 ? c - 256 : c);
  if (dt == DT_INT4) return (float)(c >= 8 ? c - 16 : c);
  const int idx = c & 7;  // flint4 magnitudes {0,1,2,3,4,6,8,16}
  const float mag = idx <= 4 ? (float)idx
                             : (idx == 5 ? 6.f : (idx == 6 ? 8.f : 16.f));
  return ((c >> 3) & 1) ? -mag : mag;
}

__device__ __forceinline__ void dec_pair(int c0, int c1, int dt, float& v0,
                                         float& v1) {
  const int id = dt == DT_INT8 ? 0x80 : 0x8;
  const Spec s = spec_for(dt);
  v0 = c1 == id ? dec_abfloat(c0, s) : (c0 == id ? 0.f : dec_normal(c0, dt));
  v1 = c0 == id ? dec_abfloat(c1, s) : (c1 == id ? 0.f : dec_normal(c1, dt));
}

__device__ __forceinline__ float rt_normal(float u, int dt) {
  if (dt == DT_INT4) return fminf(fmaxf(rintf(u), -7.f), 7.f);
  if (dt == DT_INT8) return fminf(fmaxf(rintf(u), -127.f), 127.f);
  // flint4: nearest magnitude, midpoint ties to the smaller one
  const float a = fabsf(u);
  const float mag = a <= 0.5f ? 0.f : a <= 1.5f ? 1.f : a <= 2.5f ? 2.f
                  : a <= 3.5f ? 3.f : a <= 5.f ? 4.f : a <= 7.f ? 6.f
                  : a <= 12.f ? 8.f : 16.f;
  return (u < 0.f && mag > 0.f) ? -mag : mag;
}

// abfloat encode -> decode (Algorithm 2): exact log2f, exact power-of-two
// scaling and round-half-even, so it matches the plain version bit for bit
__device__ __forceinline__ float rt_abfloat(float u, Spec s) {
  const float lo = (float)(((1 << s.mb) + 1) << s.bias);
  const long long top = (long long)((1 << (s.mb + 1)) - 1)
                        << ((1 << s.ebits) - 1 + s.bias);
  const float hi = (float)(top < (1 << 15) ? top : (1 << 15));
  const float mag = fminf(fmaxf(fabsf(u), lo), hi);
  int ex = (int)floorf(log2f(mag)) - s.mb;
  int base = (int)rintf(ldexpf(mag, -ex));
  if (base == (1 << (s.mb + 1))) {
    ex += 1;
    base = 1 << s.mb;
  }
  const int ef = min(max(ex - s.bias, 0), (1 << s.ebits) - 1);
  int mf = base & ((1 << s.mb) - 1);
  if (ef == 0 && mf == 0) mf = 1;  // the disabled e=0, m=0 code
  const int m = min(((1 << s.mb) + mf) << (ef + s.bias), 1 << 15);
  return u < 0.f ? -(float)m : (float)m;
}

// Algorithm 1 on one scaled activation pair, value domain
__device__ __forceinline__ void quant_pair(float u0, float u1, int dt,
                                           float& q0, float& q1) {
  const float t = dt == DT_INT8 ? 127.f : (dt == DT_FLINT4 ? 16.f : 7.f);
  const Spec s = spec_for(dt);
  const float a0 = fabsf(u0), a1 = fabsf(u1);
  const bool o0 = a0 > t, o1 = a1 > t;
  const bool first = o0 && (!o1 || a0 >= a1);  // ties keep the left one
  const bool second = o1 && !first;
  q0 = first ? rt_abfloat(u0, s) : (second ? 0.f : rt_normal(u0, dt));
  q1 = second ? rt_abfloat(u1, s) : (first ? 0.f : rt_normal(u1, dt));
}

// One block: BM rows x BN output columns of ONE expert's problem (K1 is
// the one-expert case), walking its K range in stages of BK2 pairs. Row
// r in [0, R) of expert e is the global row ((r / C) * E + e) * C + r % C
// of the (B, E, C, K) activation and (B, E, C, N) output, R = B * C, so
// the batch dim folds into each expert's rows with no copy; K1 passes
// E = 1, C = R (global row = r). blockIdx.z = e * split + the K split.
template <int WDT, int BM>
__global__ void __launch_bounds__(NT)
ovp_mm_kernel(const void* __restrict__ a, const float* __restrict__ sa,
              const uint8_t* __restrict__ w, const float* __restrict__ sw,
              float* __restrict__ out, int R, int K, int N, int E, int C,
              int a_mode, int a_dtype, int split, int k2_per_split,
              float s_static) {
  constexpr int WROWS = WDT == DT_INT8 ? 2 : 1;  // weight byte rows per pair
  __shared__ __align__(16) uint8_t w_s[BK2 * WROWS * BN];
  // activation planes of a stage; after the K loop the same memory holds
  // the k-group partial sums (KG * BM * (BN + 1) <= BM * 2 * BK2 floats)
  __shared__ __align__(16) float a_s[BM][2 * BK2];
  float(*red)[BM][BN + 1] = reinterpret_cast<float(*)[BM][BN + 1]>(&a_s[0][0]);

  const int tid = threadIdx.x, c = tid % BN, kg = tid / BN;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int e = blockIdx.z / split;
  const int k2b = (blockIdx.z % split) * k2_per_split;
  const int k2e = min(K / 2, k2b + k2_per_split);
  w += (size_t)e * (K / 2) * WROWS * N;          // this expert's stack entry
  sw += (size_t)e * N;
  const float inv_static = 1.0f / s_static;  // IEEE: no fast-math
  const float* af = static_cast<const float*>(a);
  const uint8_t* ab = static_cast<const uint8_t*>(a);
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int k0 = k2b; k0 < k2e; k0 += BK2) {
    // weight stage: one 16-byte load per byte row, rows past the range
    // read as code 0 (a normal 0 pair)
    for (int i = tid; i < BK2 * WROWS; i += NT) {
      const int row = k0 * WROWS + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < k2e * WROWS)
        v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)row * N + n0));
      reinterpret_cast<uint4*>(w_s)[i] = v;
    }
    // activation prologue: each pair read once, OVP fake-quantized at
    // the row scale ("quantize") or the calibrated scalar ("static"),
    // or decoded from its codes ("codes4", "codes8")
    for (int i = tid; i < BM * BK2; i += NT) {
      const int r = i / BK2, p = i % BK2;
      const int lr = r0 + r, k2 = k0 + p;
      float q0 = 0.f, q1 = 0.f;
      if (lr < R && k2 < k2e) {
        const size_t row = ((size_t)(lr / C) * E + e) * C + lr % C;
        if (a_mode == A_CODES4) {
          const int byte = ab[row * (K / 2) + k2];
          dec_pair(byte >> 4, byte & 15, a_dtype, q0, q1);
        } else if (a_mode == A_CODES8) {
          const uchar2 cc =
              *reinterpret_cast<const uchar2*>(ab + row * K + 2 * k2);
          dec_pair(cc.x, cc.y, DT_INT8, q0, q1);
        } else {
          const float2 x =
              *reinterpret_cast<const float2*>(af + row * K + 2 * k2);
          if (a_mode == A_QUANT) {
            const float s = sa[row];
            quant_pair(x.x / s, x.y / s, a_dtype, q0, q1);
          } else if (a_mode == A_STATIC) {
            quant_pair(x.x * inv_static, x.y * inv_static, a_dtype, q0, q1);
          } else {
            q0 = x.x;
            q1 = x.y;
          }
        }
      }
      a_s[r][2 * p] = q0;
      a_s[r][2 * p + 1] = q1;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = kg; p < BK2; p += KG) {
      int c0, c1;
      if (WDT == DT_INT8) {
        c0 = w_s[(2 * p) * BN + c];
        c1 = w_s[(2 * p + 1) * BN + c];
      } else {
        const int byte = w_s[p * BN + c];
        c0 = byte >> 4;  // even k in the high nibble
        c1 = byte & 15;
      }
      float w0, w1;
      dec_pair(c0, c1, WDT, w0, w1);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float2 av = *reinterpret_cast<const float2*>(&a_s[r][2 * p]);
        acc[r] = fmaf(av.x, w0, acc[r]);
        acc[r] = fmaf(av.y, w1, acc[r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < BM; ++r) red[kg][r][c] = acc[r];
  __syncthreads();
  for (int i = tid; i < BM * BN; i += NT) {
    const int r = i / BN, cc = i % BN;
    const int lr = r0 + r, col = n0 + cc;
    float s = 0.f;
    for (int g = 0; g < KG; ++g) s += red[g][r][cc];
    if (lr < R) {
      const size_t row = ((size_t)(lr / C) * E + e) * C + lr % C;
      const float v = a_mode == A_FP       ? s * sw[col]
                      : a_mode == A_STATIC ? s * (s_static * sw[col])
                                           : s * sa[row] * sw[col];
      if (split == 1)
        out[row * N + col] = v;
      else
        atomicAdd(out + row * N + col, v);
    }
  }
}

template <int BM>
int launch(const void* a, const void* sa, const void* w, const void* sw,
           void* out, int R, int K, int N, int E, int C, int w_dtype,
           int a_mode, int a_dtype, int split, float s_static,
           void* stream) {
  const int k2 = K / 2;
  const int per = ((k2 + split - 1) / split + BK2 - 1) / BK2 * BK2;
  const dim3 grid(N / BN, (R + BM - 1) / BM, E * split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* saf = static_cast<const float*>(sa);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* swf = static_cast<const float*>(sw);
  float* of = static_cast<float*>(out);
  switch (w_dtype) {
    case DT_INT4:
      ovp_mm_kernel<DT_INT4, BM><<<grid, NT, 0, st>>>(
          a, saf, wb, swf, of, R, K, N, E, C, a_mode, a_dtype, split, per,
          s_static);
      break;
    case DT_FLINT4:
      ovp_mm_kernel<DT_FLINT4, BM><<<grid, NT, 0, st>>>(
          a, saf, wb, swf, of, R, K, N, E, C, a_mode, a_dtype, split, per,
          s_static);
      break;
    case DT_INT8:
      ovp_mm_kernel<DT_INT8, BM><<<grid, NT, 0, st>>>(
          a, saf, wb, swf, of, R, K, N, E, C, a_mode, a_dtype, split, per,
          s_static);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1: a (R, K) f32, or (R, K/2) packed nibbles (codes4), or (R, K) int8
// codes (codes8); sa (R,) f32 (read in the quantize and codes modes);
// w (K/2, N) packed nibbles or (K, N) int8 codes; sw (N,) f32; s_static
// the calibrated scale (static mode); out (R, N) f32, zeroed by the
// caller when split > 1. N must be a multiple of 16 and every pointer
// 16-byte aligned. Returns cudaGetLastError().
extern "C" int ovp_mm_launch(const void* a, const void* sa, const void* w,
                             const void* sw, void* out, int R, int K, int N,
                             int w_dtype, int a_mode, int a_dtype, int split,
                             float s_static, void* stream) {
  return launch<BM_DENSE>(a, sa, w, sw, out, R, K, N, 1, R, w_dtype,
                          a_mode, a_dtype, split, s_static, stream);
}

// K6: a (B, E, C, Ka) in the K1 layouts, sa (B, E, C) f32, w (E, Kw, N),
// sw (E, N) f32, out (B, E, C, N) f32; every expert's R = B * C rows in
// one launch, grid (N / 16, ceil(R / BM), E). Row tile BM = 16 when an
// expert has more than 8 rows (16 at decode: 4 slots x capacity 4), so
// each expert's weight tile is read once per call; else 8. Same layout
// rules as K1. Returns cudaGetLastError().
extern "C" int ovp_grouped_mm_launch(const void* a, const void* sa,
                                     const void* w, const void* sw,
                                     void* out, int B, int E, int C, int K,
                                     int N, int w_dtype, int a_mode,
                                     int a_dtype, float s_static,
                                     void* stream) {
  const int R = B * C;
  return R > BM_DENSE
             ? launch<BM_GROUPED>(a, sa, w, sw, out, R, K, N, E, C, w_dtype,
                                  a_mode, a_dtype, 1, s_static, stream)
             : launch<BM_DENSE>(a, sa, w, sw, out, R, K, N, E, C, w_dtype,
                                a_mode, a_dtype, 1, s_static, stream);
}
