// Fused OVP matmul for Hopper (sm_90a), fp32 FMA on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ovp_matmul.py:367
// (fused_ovp_matmul_kernel -> pallas_call at :417) in every activation
// mode, for int4 / flint4 packed-nibble weights and int8
// one-code-per-byte weights: K1 (body _fused_mm_kernel :224, modes fp,
// quantize, codes4, codes8) and K5 (a_static=True, body
// _fused_mm_kernel_static :263), both through the dense entry
// ovp_mm_launch; and the grouped per-expert matmul K6
// (grouped_ovp_matmul_kernel :436 -> pallas_call at :489, bodies
// _grouped_mm_kernel :300 and _grouped_mm_kernel_static :333), the FMA
// template below with an expert grid dimension (entry
// ovp_grouped_mm_launch).
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
// The dense entry (K1/K5) has two bodies; the wrapper's launch plan
// (kernels/ovp_matmul.py::launch_plan) picks one and passes its geometry
// in:
//
// * the decode body (ovp_dec_kernel), at every row count wherever a
//   block's K slice fits shared memory (decode steps, prompts, prefill
//   chunks, the calibration forward; every shape of the served models).
//   What bounds K1 at decode on the H100 is latency, not bytes: a
//   Qwen1.5 layer's 6.4 MB of packed weights take 2 us at 3.35 TB/s
//   over 7 launches, and each launch costs several us of fixed latency
//   (about 5.5 us at K = N = 1024, PERF.md). So the design takes out
//   every wait that is not a memory round trip:
//   - one launch per call: a column tile's K range is split over
//     `split` blocks of one thread block CLUSTER (split in 1, 2, 4, 8),
//     each block reduces its slice in registers (warp shuffles over its
//     8 k-groups, then the 8 warps in order in shared memory), stores
//     its partial into the shared memory of the tile's rank-0 block
//     (distributed shared memory), and after one cluster barrier rank 0
//     adds them in rank order 0..split-1 and writes the tile; no zeroed
//     output, no atomics, the same result on every run;
//   - the block's whole slice is in flight before the first FMA: the
//     fp32 activations by 8-byte cp.async in a first commit group, then
//     the weights (16 columns x its K pairs, 16 or 32 bytes a pair) by
//     16-byte cp.async.cg in commit groups of DEC_STAGE pairs, all issued
//     together into dynamic shared memory; the byte table and the
//     activation prologue run while they land, and the FMAs start on
//     each weight group as it arrives (cp.async.wait_group);
//   - the activation prologue runs once per block over its K slice, for
//     the real rows only: the row tile RM is a template on 1..8 and
//     equals the call's rows up to 8, so a 4-slot decode does 4 rows of
//     FMAs, not 8. quantize / static rewrite the landed activations in
//     shared memory (the abfloat round trip only for a pair that holds
//     an outlier), the codes modes decode from direct loads;
//   - in the quantize and static modes the quantization, not the FMAs,
//     would dominate: every 16-column tile needs the same quantized
//     rows. So the cluster also spans `share` column tiles (split x
//     share <= 8 blocks, share the largest that divides the tiles): the
//     share blocks of one K slice each quantize 1/share of it and store
//     the result into all of them through distributed shared memory,
//     one cluster barrier, and each activation pair is quantized once
//     per cluster, not once per tile (share 1 is the same path with
//     the block's own slice stored in place);
//   - each thread owns 4 columns: one 4-byte weight load per pair row
//     (two for int8) and one float2 activation load per row feed 8
//     FMAs; 4-bit codes decode through a 256-entry (even, odd) float2
//     table built per launch from dec_pair (the plain version's
//     _byte_tables, the same values), int8 codes arithmetically. The
//     table is kept in TAB_COPIES = 16 copies so the lanes of a
//     half-warp, whose bytes are random, read distinct bank pairs: one
//     copy cost about 6 shared-memory wavefronts a lookup, and that
//     conflict, not the FMAs, set the time of the larger tiles;
//   - tiling for the card: 16-column tiles and the smallest split with
//     >= 132 blocks (one wave of SMs) and <= 512 pairs a block. At rows
//     4: Qwen1.5-0.5B K 1024 -> N 1024 split 4 (256 blocks of 128 pairs;
//     share 2 in the quantize modes), N 2816 split 1 (176 of 512, share
//     8), K 2816 -> N 1024 split 4 (256 of 352, share 2); Qwen3-30B-A3B
//     attention K 2048 -> N 4096 split 2 (512 of 512), N 512 split 8
//     (256 of 128), K 4096 -> N 2048 split 4 (512 of 512). 41-61 KB of
//     shared memory a block, 32 KB of it the byte table (above);
// * the FMA body (ovp_mm_kernel, the first template, which K6 runs), as
//   the fallback where a decode block's slice would not fit shared
//   memory (K above about 38,000 at 8 rows): an 8 x 16 tile per block
//   over all of K in stages of 256 pairs, the prologue per stage, 16
//   k-groups reduced in shared memory, one block per tile. Its loads
//   and FMAs run in series; the decode body was 14-49 % faster at every
//   row count timed, 8 to 512 (both bodies forced in one run of
//   chip_smoke.py, PERF.md), so no row count selects it.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 16;        // output columns per block (both bodies)
constexpr int BM_DENSE = 8;   // rows per block: FMA body, K6 up to 8 rows
constexpr int BM_GROUPED = 16;  // rows per block: K6 above 8 rows
constexpr int BK2 = 256;      // K pairs per stage (FMA body)
constexpr int NT = 256;       // threads per block (both bodies)
constexpr int KG = NT / BN;   // k-groups (FMA body)

// decode body: 4 threads x 4 columns cover the 16-column tile, so 64
// k-groups of 4 threads, 8 of them in each warp
constexpr int DEC_CPT = 4;                // columns per thread
constexpr int DEC_KG = NT / (BN / DEC_CPT);
constexpr int DEC_WARPS = NT / 32;
constexpr int DEC_RM_MAX = 8;             // row tile cap
constexpr int DEC_STAGE = 128;            // K pairs per cp.async group
// copies of the byte table: lane l of a half-warp reads copy l % 16, so
// the 16 lanes of a 64-bit shared load hit 16 distinct bank pairs
constexpr int TAB_COPIES = 16;
constexpr int SMEM_MAX = 232448;          // 227 KB opt-in per block

enum { DT_INT4 = 0, DT_FLINT4 = 1, DT_INT8 = 2 };
enum { A_FP = 0, A_QUANT = 1, A_STATIC = 2, A_CODES4 = 3, A_CODES8 = 4 };
enum { BODY_DECODE = 0, BODY_FMA = 1 };

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

// Algorithm 1's choice on one scaled pair: is the first or the second
// value the outlier (at most one is)
__device__ __forceinline__ void pick_outlier(float u0, float u1, int dt,
                                             bool& first, bool& second) {
  const float t = dt == DT_INT8 ? 127.f : (dt == DT_FLINT4 ? 16.f : 7.f);
  const float a0 = fabsf(u0), a1 = fabsf(u1);
  const bool o0 = a0 > t, o1 = a1 > t;
  first = o0 && (!o1 || a0 >= a1);  // ties keep the left one
  second = o1 && !first;
}

// Algorithm 1 on one scaled activation pair, value domain
__device__ __forceinline__ void quant_pair(float u0, float u1, int dt,
                                           float& q0, float& q1) {
  const Spec s = spec_for(dt);
  bool first, second;
  pick_outlier(u0, u1, dt, first, second);
  q0 = first ? rt_abfloat(u0, s) : (second ? 0.f : rt_normal(u0, dt));
  q1 = second ? rt_abfloat(u1, s) : (first ? 0.f : rt_normal(u1, dt));
}

// the same values, with the abfloat round trip run once per pair and
// only for a pair that holds an outlier (about 2 in 100 on outlier data)
__device__ __forceinline__ void quant_pair_lazy(float u0, float u1, int dt,
                                                float& q0, float& q1) {
  bool first, second;
  pick_outlier(u0, u1, dt, first, second);
  float ov = 0.f;
  if (first || second) ov = rt_abfloat(first ? u0 : u1, spec_for(dt));
  q0 = first ? ov : (second ? 0.f : rt_normal(u0, dt));
  q1 = second ? ov : (first ? 0.f : rt_normal(u1, dt));
}

// The activation prologue on one pair k2 of global row `row`: OVP
// fake-quantized at the row scale ("quantize") or the calibrated scalar
// ("static", inv_static = 1 / s), decoded from its codes ("codes4",
// "codes8"), or read as is ("fp")
__device__ __forceinline__ void act_pair(const void* a, const float* sa,
                                         size_t row, int k2, int K,
                                         int a_mode, int a_dtype,
                                         float inv_static, float& q0,
                                         float& q1) {
  const float* af = static_cast<const float*>(a);
  const uint8_t* ab = static_cast<const uint8_t*>(a);
  if (a_mode == A_CODES4) {
    const int byte = ab[row * (K / 2) + k2];
    dec_pair(byte >> 4, byte & 15, a_dtype, q0, q1);
  } else if (a_mode == A_CODES8) {
    const uchar2 cc = *reinterpret_cast<const uchar2*>(ab + row * K + 2 * k2);
    dec_pair(cc.x, cc.y, DT_INT8, q0, q1);
  } else {
    const float2 x = *reinterpret_cast<const float2*>(af + row * K + 2 * k2);
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

// the scale epilogue, in the Pallas bodies' order; sar is the row's
// scale (read only in the quantize and codes modes, see row_scale)
__device__ __forceinline__ float epilogue(float s, int a_mode, float sar,
                                          float swc, float s_static) {
  return a_mode == A_FP       ? s * swc
         : a_mode == A_STATIC ? s * (s_static * swc)
                              : s * sar * swc;
}

// sa[row] where the mode has per-row scales; fp and static pass a
// placeholder pointer that must not be read
__device__ __forceinline__ float row_scale(const float* sa, size_t row,
                                           int a_mode) {
  return a_mode == A_FP || a_mode == A_STATIC ? 1.f : sa[row];
}

// ---------------------------------------------------------------------
// FMA body: K6, and K1/K5 where a decode block's slice does not fit
// ---------------------------------------------------------------------
// One block: BM rows x BN output columns of ONE expert's problem (K1 is
// the one-expert case), walking all of K in stages of BK2 pairs. Row r
// in [0, R) of expert e is the global row ((r / C) * E + e) * C + r % C
// of the (B, E, C, K) activation and (B, E, C, N) output, R = B * C, so
// the batch dim folds into each expert's rows with no copy; K1 passes
// E = 1, C = R (global row = r). blockIdx.z = e.
template <int WDT, int BM>
__global__ void __launch_bounds__(NT)
ovp_mm_kernel(const void* __restrict__ a, const float* __restrict__ sa,
              const uint8_t* __restrict__ w, const float* __restrict__ sw,
              float* __restrict__ out, int R, int K, int N, int E, int C,
              int a_mode, int a_dtype, float s_static) {
  constexpr int WROWS = WDT == DT_INT8 ? 2 : 1;  // weight byte rows per pair
  __shared__ __align__(16) uint8_t w_s[BK2 * WROWS * BN];
  // activation planes of a stage; after the K loop the same memory holds
  // the k-group partial sums (KG * BM * (BN + 1) <= BM * 2 * BK2 floats)
  __shared__ __align__(16) float a_s[BM][2 * BK2];
  float(*red)[BM][BN + 1] = reinterpret_cast<float(*)[BM][BN + 1]>(&a_s[0][0]);

  const int tid = threadIdx.x, c = tid % BN, kg = tid / BN;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int k2e = K / 2;
  w += (size_t)e * (K / 2) * WROWS * N;          // this expert's stack entry
  sw += (size_t)e * N;
  const float inv_static = 1.0f / s_static;  // IEEE: no fast-math
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < k2e; k0 += BK2) {
    // weight stage: one 16-byte load per byte row, rows past the range
    // read as code 0 (a normal 0 pair)
    for (int i = tid; i < BK2 * WROWS; i += NT) {
      const int row = k0 * WROWS + i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < k2e * WROWS)
        v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)row * N + n0));
      reinterpret_cast<uint4*>(w_s)[i] = v;
    }
    // activation prologue: each pair of the stage read once
    for (int i = tid; i < BM * BK2; i += NT) {
      const int r = i / BK2, p = i % BK2;
      const int lr = r0 + r, k2 = k0 + p;
      float q0 = 0.f, q1 = 0.f;
      if (lr < R && k2 < k2e) {
        const size_t row = ((size_t)(lr / C) * E + e) * C + lr % C;
        act_pair(a, sa, row, k2, K, a_mode, a_dtype, inv_static, q0, q1);
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
      out[row * N + col] = epilogue(s, a_mode, row_scale(sa, row, a_mode),
                                    sw[col], s_static);
    }
  }
}

template <int BM>
int launch_fma(const void* a, const void* sa, const void* w, const void* sw,
               void* out, int R, int K, int N, int E, int C, int w_dtype,
               int a_mode, int a_dtype, float s_static, void* stream) {
  const dim3 grid(N / BN, (R + BM - 1) / BM, E);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* saf = static_cast<const float*>(sa);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* swf = static_cast<const float*>(sw);
  float* of = static_cast<float*>(out);
  switch (w_dtype) {
    case DT_INT4:
      ovp_mm_kernel<DT_INT4, BM><<<grid, NT, 0, st>>>(
          a, saf, wb, swf, of, R, K, N, E, C, a_mode, a_dtype, s_static);
      break;
    case DT_FLINT4:
      ovp_mm_kernel<DT_FLINT4, BM><<<grid, NT, 0, st>>>(
          a, saf, wb, swf, of, R, K, N, E, C, a_mode, a_dtype, s_static);
      break;
    case DT_INT8:
      ovp_mm_kernel<DT_INT8, BM><<<grid, NT, 0, st>>>(
          a, saf, wb, swf, of, R, K, N, E, C, a_mode, a_dtype, s_static);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Decode body: K1/K5
// ---------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's groups are pending (n clamped to
// 7, which only ever waits longer)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 7 ? n : 7) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// dynamic shared memory of one decode block, in this order: the weight
// slice (slice x 16 x wrows bytes), the activation planes (rm x slice
// float2), the byte table (256 x TAB_COPIES float2, 4-bit weights only),
// the warp partials (8 x rm x 16 floats) and the cluster's partials
// gathered in rank 0 (split x rm x 16 floats). launch_plan in
// kernels/ovp_matmul.py computes the same sum.
inline int dec_smem_bytes(int rm, int slice, int wrows, int split) {
  return slice * BN * wrows + rm * slice * 8
         + (wrows == 1 ? 256 * TAB_COPIES * 8 : 0)
         + DEC_WARPS * rm * BN * 4 + split * rm * BN * 4;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// the two halves of a cluster barrier: arrive at the start, wait just
// before the first distributed-shared-memory access (a block's shared
// memory may be written by its cluster only once every block runs)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One block: RM rows x 16 columns x one K slice of `slice` pairs. A
// cluster holds `share` column tiles x `split` K slices: block x = c *
// (share * split) + t * split + rank has column tile c * share + t and K
// slice [rank * slice, min(K / 2, (rank + 1) * slice)); rank 0 of a tile
// adds the tile's split partials and writes it. With share > 1
// (quantize and static modes) the share blocks of one K slice each
// quantize 1/share of its activations and store them into all share
// blocks (share 1: its whole slice, in place), so a cluster quantizes
// each activation pair once. Row tile r0 = blockIdx.y * RM.
template <int WDT, int RM>
__global__ void __launch_bounds__(NT)
ovp_dec_kernel(const void* __restrict__ a, const float* __restrict__ sa,
               const uint8_t* __restrict__ w, const float* __restrict__ sw,
               float* __restrict__ out, int R, int K, int N, int a_mode,
               int a_dtype, int split, int share, int slice,
               float s_static) {
  constexpr int WROWS = WDT == DT_INT8 ? 2 : 1;  // weight byte rows per pair
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* w_s = smem;
  float2* a_s = reinterpret_cast<float2*>(smem + (size_t)slice * BN * WROWS);
  float2* tab = a_s + RM * slice;  // [byte][copy]
  float* red = reinterpret_cast<float*>(
      tab + (WDT == DT_INT8 ? 0 : 256 * TAB_COPIES));  // [warp][RM][BN]
  float* gather = red + DEC_WARPS * RM * BN;         // [rank][RM][BN]

  const int tid = threadIdx.x;
  const int csize = split * share, crank = blockIdx.x % csize;
  const int t = crank / split, rank = crank % split;
  const int n0 = (blockIdx.x / csize * share + t) * BN, r0 = blockIdx.y * RM;
  const int rows = min(RM, R - r0);  // real rows of this tile
  const int k2b = rank * slice;
  const int len = max(0, min(K / 2 - k2b, slice));
  const int nst = (len + DEC_STAGE - 1) / DEC_STAGE;
  // fp32 activations (fp, quantize, static) stream in ahead of the
  // weights; the quantize modes take this block's part [q_lo, q_hi) of
  // the slice (all of it when share == 1)
  const bool quant = a_mode == A_QUANT || a_mode == A_STATIC;
  const bool act_async = quant || a_mode == A_FP;
  const int q_sub = (len + share - 1) / share;
  const int q_lo = min(len, t * q_sub), q_hi = min(len, q_lo + q_sub);
  const float* af = static_cast<const float*>(a);
  if (csize > 1) cluster_arrive_relaxed();

  // the epilogue's scales, read now so the tail waits on no load
  const int er = tid / BN, ec = tid % BN;
  float swc = 0.f, sar = 1.f;
  if (rank == 0 && tid < RM * BN && er < rows) {
    swc = sw[n0 + ec];
    sar = row_scale(sa, r0 + er, a_mode);
  }

  // 1. the whole slice in flight: a first commit group holding the
  // block's (part of the) activations, then one group per stage of
  // weight rows
  if (act_async) {
    const int m = q_hi - q_lo;
    for (int i = tid; i < rows * m; i += NT) {
      const int r = i / m, p = q_lo + i - r * m;
      cp_async8(a_s + r * slice + p,
                af + (size_t)(r0 + r) * K + 2 * (k2b + p));
    }
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    const int p0 = s * DEC_STAGE, cnt = min(DEC_STAGE, len - p0);
    for (int i = tid; i < cnt * WROWS; i += NT) {
      const size_t brow = (size_t)(k2b + p0) * WROWS + i;
      cp_async16(w_s + ((size_t)p0 * WROWS + i) * BN, w + brow * N + n0);
    }
    cp_async_commit();
  }
  // 2. while they land: zero planes for rows past R (last row tile only),
  // the byte table of the 4-bit weight types, and the codes modes'
  // prologue (decoded from direct loads)
  for (int i = tid; i < (RM - rows) * len; i += NT)
    a_s[(rows + i / len) * slice + i % len] = make_float2(0.f, 0.f);
  if (WDT != DT_INT8) {
    float v0, v1;
    dec_pair(tid >> 4, tid & 15, WDT, v0, v1);  // NT == 256 entries
    // copies in a rotated order: a half-warp's stores hit distinct banks
    for (int c = 0; c < TAB_COPIES; ++c)
      tab[tid * TAB_COPIES + ((c + tid) & (TAB_COPIES - 1))] =
          make_float2(v0, v1);
  }
  if (!act_async)
    for (int i = tid; i < rows * len; i += NT) {
      const int r = i / len, p = i - r * len;
      float q0, q1;
      act_pair(a, sa, r0 + r, k2b + p, K, a_mode, a_dtype, 1.f, q0, q1);
      a_s[r * slice + p] = make_float2(q0, q1);
    }
  // 3. quantize, static: once the activations land, quantize this
  // block's part (each thread the pairs it copied, so its own wait
  // suffices) in place, or with share > 1 into every block of the
  // cluster that holds the same K slice, then one cluster barrier
  const float inv_static = 1.0f / s_static;  // IEEE: no fast-math
  if (quant) {
    cp_async_wait(nst);  // the oldest group: the activations
    if (share > 1) cluster_wait();  // every block of the cluster runs
    const int m = q_hi - q_lo;
    for (int i = tid; i < rows * m; i += NT) {
      const int r = i / m, p = q_lo + i - r * m;
      const float2 x = a_s[r * slice + p];
      float q0, q1;
      if (a_mode == A_QUANT) {
        const float s_r = sa[r0 + r];
        quant_pair_lazy(x.x / s_r, x.y / s_r, a_dtype, q0, q1);
      } else {
        quant_pair_lazy(x.x * inv_static, x.y * inv_static, a_dtype, q0,
                        q1);
      }
      if (share == 1) {
        a_s[r * slice + p] = make_float2(q0, q1);
      } else {
        cg::cluster_group cluster = cg::this_cluster();
        for (int u = 0; u < share; ++u)
          cluster.map_shared_rank(a_s, u * split + rank)[r * slice + p] =
              make_float2(q0, q1);
      }
    }
    if (share > 1) cg::this_cluster().sync();
  }
  // 4. per stage as it lands, the FMAs. Thread (kg, q) owns columns
  // 4q..4q+3 and the pairs kg, kg + 64, ...
  const int q = tid % (BN / DEC_CPT), kg = tid / (BN / DEC_CPT);
  const float2* my_tab = tab + (tid & (TAB_COPIES - 1));
  float acc[RM][DEC_CPT];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < DEC_CPT; ++j) acc[r][j] = 0.f;
  for (int s = 0; s < nst; ++s) {
    const int p0 = s * DEC_STAGE, cnt = min(DEC_STAGE, len - p0);
    cp_async_wait(nst - 1 - s);
    __syncthreads();
    for (int p = p0 + kg; p < p0 + cnt; p += DEC_KG) {
      float w0[DEC_CPT], w1[DEC_CPT];
      if (WDT == DT_INT8) {
        const uint32_t ev = *reinterpret_cast<const uint32_t*>(
            w_s + (size_t)(2 * p) * BN + DEC_CPT * q);
        const uint32_t od = *reinterpret_cast<const uint32_t*>(
            w_s + (size_t)(2 * p + 1) * BN + DEC_CPT * q);
#pragma unroll
        for (int j = 0; j < DEC_CPT; ++j)
          dec_pair((ev >> (8 * j)) & 255, (od >> (8 * j)) & 255, WDT, w0[j],
                   w1[j]);
      } else {
        const uint32_t b = *reinterpret_cast<const uint32_t*>(
            w_s + (size_t)p * BN + DEC_CPT * q);
#pragma unroll
        for (int j = 0; j < DEC_CPT; ++j) {
          const float2 t = my_tab[((b >> (8 * j)) & 255) * TAB_COPIES];
          w0[j] = t.x;
          w1[j] = t.y;
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float2 av = a_s[r * slice + p];
#pragma unroll
        for (int j = 0; j < DEC_CPT; ++j) {
          acc[r][j] = fmaf(av.x, w0[j], acc[r][j]);
          acc[r][j] = fmaf(av.y, w1[j], acc[r][j]);
        }
      }
    }
  }
  // 5. the block's partial: the 8 k-groups of a warp by shuffles (lanes
  // 4 apart share q), then the 8 warps in order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < DEC_CPT; ++j) {
      float v = acc[r][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < BN / DEC_CPT)
        red[(warp * RM + r) * BN + DEC_CPT * lane + j] = v;
    }
  __syncthreads();
  float part = 0.f;
  if (tid < RM * BN)
    for (int g = 0; g < DEC_WARPS; ++g) part += red[g * RM * BN + tid];
  // 6. the K split: every block stores its partial into the shared
  // memory of its tile's rank 0 (distributed shared memory), one cluster
  // barrier, and rank 0 adds them in rank order; no block reads another's
  // memory after it
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (share == 1) cluster_wait();  // every block of the cluster runs
    if (tid < RM * BN)
      cluster.map_shared_rank(gather, t * split)[rank * RM * BN + tid] =
          part;
    cluster.sync();
    if (rank == 0 && tid < RM * BN) {
      part = 0.f;
      for (int src = 0; src < split; ++src)
        part += gather[src * RM * BN + tid];
    }
  }
  if (rank == 0 && tid < RM * BN && er < rows)
    out[(size_t)(r0 + er) * N + n0 + ec] =
        epilogue(part, a_mode, sar, swc, s_static);
}

template <int WDT, int RM>
int launch_dec_rm(const void* a, const float* sa, const uint8_t* w,
                  const float* sw, float* out, int R, int K, int N,
                  int a_mode, int a_dtype, int split, int share, int slice,
                  int smem, float s_static, cudaStream_t st) {
  auto kern = ovp_dec_kernel<WDT, RM>;
  // raise this instantiation's dynamic shared memory cap once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N / BN) * split, (R + RM - 1) / RM, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split * share;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split * share > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, a, sa, w, sw, out, R, K, N, a_mode, a_dtype, split, share,
      slice, s_static);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int WDT>
int launch_dec(int rm, const void* a, const float* sa, const uint8_t* w,
               const float* sw, float* out, int R, int K, int N, int a_mode,
               int a_dtype, int split, int share, int slice, int smem,
               float s_static, cudaStream_t st) {
#define OVP_DEC_RM(M)                                                      \
  case M:                                                                  \
    return launch_dec_rm<WDT, M>(a, sa, w, sw, out, R, K, N, a_mode,       \
                                 a_dtype, split, share, slice, smem,       \
                                 s_static, st);
  switch (rm) {
    OVP_DEC_RM(1)
    OVP_DEC_RM(2)
    OVP_DEC_RM(3)
    OVP_DEC_RM(4)
    OVP_DEC_RM(5)
    OVP_DEC_RM(6)
    OVP_DEC_RM(7)
    OVP_DEC_RM(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef OVP_DEC_RM
}

}  // namespace

// K1/K5: a (R, K) f32, or (R, K/2) packed nibbles (codes4), or (R, K) int8
// codes (codes8); sa (R,) f32 (read in the quantize and codes modes);
// w (K/2, N) packed nibbles or (K, N) int8 codes; sw (N,) f32; s_static
// the calibrated scale (static mode); out (R, N) f32, every element
// written once. N must be a multiple of 16 and every pointer 16-byte
// aligned. The geometry comes from the wrapper's launch plan: body 0
// (decode) with row tile rm in 1..8, a cluster of split (K slices) x
// share (column tiles quantizing together; quantize and static modes
// only) blocks, at most 8, share dividing N / 16, slice K pairs a block
// and smem dynamic shared bytes (at least dec_smem_bytes(rm, slice,
// wrows, split), at most 227 KB); body 1 (FMA) reads none of the five.
// Returns the launch's cudaError_t.
extern "C" int ovp_mm_launch(const void* a, const void* sa, const void* w,
                             const void* sw, void* out, int R, int K, int N,
                             int w_dtype, int a_mode, int a_dtype, int body,
                             int rm, int split, int share, int slice,
                             int smem, float s_static, void* stream) {
  if (body == BODY_FMA)
    return launch_fma<BM_DENSE>(a, sa, w, sw, out, R, K, N, 1, R, w_dtype,
                                a_mode, a_dtype, s_static, stream);
  const int wrows = w_dtype == DT_INT8 ? 2 : 1;
  const bool pow2 = split > 0 && share > 0 && !(split & (split - 1)) &&
                    !(share & (share - 1));
  if (body != BODY_DECODE || rm < 1 || rm > DEC_RM_MAX || slice < 1 ||
      !pow2 || split * share > 8 || (N / BN) % share != 0 ||
      (share > 1 && a_mode != A_QUANT && a_mode != A_STATIC) ||
      (long long)split * slice < K / 2 || smem > SMEM_MAX ||
      smem < dec_smem_bytes(rm, slice, wrows, split))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* saf = static_cast<const float*>(sa);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* swf = static_cast<const float*>(sw);
  float* of = static_cast<float*>(out);
  switch (w_dtype) {
    case DT_INT4:
      return launch_dec<DT_INT4>(rm, a, saf, wb, swf, of, R, K, N, a_mode,
                                 a_dtype, split, share, slice, smem, s_static,
                                 st);
    case DT_FLINT4:
      return launch_dec<DT_FLINT4>(rm, a, saf, wb, swf, of, R, K, N, a_mode,
                                   a_dtype, split, share, slice, smem,
                                   s_static, st);
    case DT_INT8:
      return launch_dec<DT_INT8>(rm, a, saf, wb, swf, of, R, K, N, a_mode,
                                 a_dtype, split, share, slice, smem, s_static,
                                 st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
             ? launch_fma<BM_GROUPED>(a, sa, w, sw, out, R, K, N, E, C,
                                      w_dtype, a_mode, a_dtype, s_static,
                                      stream)
             : launch_fma<BM_DENSE>(a, sa, w, sw, out, R, K, N, E, C,
                                    w_dtype, a_mode, a_dtype, s_static,
                                    stream);
}
