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
// _grouped_mm_kernel :300 and _grouped_mm_kernel_static :333), a
// persistent kernel on the decode body that computes only the filled
// capacity rows (entry ovp_grouped_mm_launch).
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
// * the FMA body (ovp_mm_kernel, the first template), as the fallback
//   where a decode block's slice would not fit shared memory (K above
//   about 38,000 at 8 rows): an 8 x 16 tile per block over all of K in
//   stages of 256 pairs, the prologue per stage, 16 k-groups reduced in
//   shared memory, one block per tile. Its loads and FMAs run in series;
//   the decode body was 14-49 % faster at every row count timed, 8 to
//   512 (both bodies forced in one run of chip_smoke.py, PERF.md), so no
//   row count selects it.
//
// K6 (the MoE expert einsums wg, wu, wd; weight-only "fp" on the serving
// path, every mode through the kernel API) computes only the capacity
// slots that hold a token. The MoE dispatch puts the kept assignments of
// (batch row b, expert e) in slots 0..fill[b, e] - 1, and the caller
// passes that fill (B, E) on the card (no host sync): at decode (4
// slots x top-8 of Qwen3-30B-A3B's 128 experts, capacity 4) about 30
// experts hold 32 rows of the 2,048 slots, and their weights are about a
// quarter of the 101 MB stack. Rows past the fill are left unwritten
// (nothing reads them; the plain version writes zeros there). The
// design, ovp_grouped_dec_kernel:
//   - persistent: one wave of blocks walks work items (expert, up to 4
//     filled rows, 64 output columns); the per-expert row counts and
//     item offsets are scanned from the fill in each block's shared
//     memory, so an expert with no filled row has no item and no block
//     reads a byte of its weights, and the grid does not depend on the
//     data;
//   - the decode body per item (the same dec_issue / dec_compute as K1):
//     cp.async weight streaming, the 16-copy byte table (in fp16, which
//     holds every decoded 4-bit value exactly, halving its shared
//     memory), the real rows only, the batch folded into the expert's
//     rows through a row list (global row (b * E + e) * C + c);
//   - what bounds it is latency, not bytes: a handful of small items per
//     block, each a memory round trip plus a table-lookup chain. So an
//     item is 64 columns wide (64-byte weight rows, four times the bytes
//     of a 16-column tile per round trip), the next item's loads (and
//     its column scales) go out before the current one computes (two
//     buffers), its row list comes from the fill cached in shared
//     memory, the FMA loop keeps four pair rows in flight, and K is not
//     split over a cluster where the slice fits (a split costs two
//     cluster barriers an item, more than it saves; measured, PERF.md);
//   - a call without a fill (the kernel API) with more than 8 rows an
//     expert runs the FMA body instead, as the wrapper's plan picks it:
//     its 16-row tiles decode each weight once for 16 rows, an item for
//     at most 4 (measured, PERF.md).
//
// Tolerance against the plain versions (kernels/ovp_matmul.py,
// fused_ovp_matmul_plain and grouped_ovp_matmul_plain): decoded weights,
// decoded codes and quantized activations are exact in both; only the
// fp32 summation order differs, so rtol 1e-5 and atol 1e-5 * max|ref|.
#include <cooperative_groups.h>
#include <cuda_fp16.h>
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
constexpr int DEC_WARPS = NT / 32;
constexpr int DEC_RM_MAX = 8;             // row tile cap
constexpr int GROUPED_RM = 4;             // K6's row tile cap
constexpr int GBN = 64;                   // K6's output columns an item
constexpr int FILL_SMEM = 8192;           // K6 fill entries cached
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

// Algorithm 1 on one scaled activation pair, value domain: the outlier
// (at most one of the two) takes the abfloat round trip, run once per
// pair and only for a pair that holds an outlier (about 2 in 100 on
// outlier data), its partner is the victim (0), otherwise both take the
// normal round trip. Every quantizing prologue calls this one function.
__device__ __forceinline__ void quant_pair(float u0, float u1, int dt,
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

// K6's decode block: two buffers of the weight slice and of rm
// activation rows, the byte table (half2), partials for GROUPED_RM rows,
// two buffers of the item's GBN column scales, two item row lists
// (GROUPED_RM 8-byte global rows each), the per-expert row counts and
// item offsets (2 E + 1 ints) and, when cached, the fill (B x E int16);
// grouped_launch_plan computes the same sum
inline int grouped_smem_bytes(int rm, int slice, int wrows, int split,
                              int E, int fill_entries) {
  return 2 * (slice * GBN * wrows + rm * slice * 8)
         + (wrows == 1 ? 256 * TAB_COPIES * 4 : 0)
         + DEC_WARPS * GROUPED_RM * GBN * 4 + split * GROUPED_RM * GBN * 4
         + 2 * GBN * 4 + 2 * GROUPED_RM * 8 + (2 * E + 1) * 4
         + fill_entries * 2;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// the two halves of a cluster barrier: arrive at the start, wait just
// before the first distributed-shared-memory access (a block's shared
// memory may be written by its cluster only once every block runs). The
// dense kernel arrives relaxed, once; K6 arrives with release semantics
// at every work item, so no block writes a peer's memory before the
// peer is done reading it for the previous item.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the global row of a tile's row r: K1/K5 rows r0 + r
struct DenseRows {
  int r0;
  __device__ __forceinline__ size_t operator()(int r) const {
    return (size_t)(r0 + r);
  }
};

// K6: the item's rows, listed in shared memory
struct ListedRows {
  const long long* row;
  __device__ __forceinline__ size_t operator()(int r) const {
    return (size_t)row[r];
  }
};

// The decode body on one tile (`rows` real rows, row_of(r) their global
// rows, x 16 columns from n0 x one K slice, `rank` of `split`, for the
// block at column position t of its cluster's `share` tiles), in two
// phases so that K6 can issue one tile's loads while it computes the one
// before:
//
// dec_issue: the whole slice in flight, a first commit group holding the
// block's (part of the) fp32 activations (fp, quantize, static; the
// quantize modes take this block's part [q_lo, q_hi) of the slice, all
// of it when share == 1) and, given sw_s (K6), the tile's column scales,
// then one group per stage of DEC_STAGE weight pair rows of the tile's
// BNW columns (16 for K1/K5, 64 for K6). Returns the number of groups
// committed.
template <int WDT, int BNW, class RowOf>
__device__ __forceinline__ int dec_issue(const void* __restrict__ a,
                                         const uint8_t* __restrict__ w,
                                         RowOf row_of, int rows, int K,
                                         int N, int n0, int k2b, int len,
                                         int q_lo, int q_hi, bool act_async,
                                         int slice, uint8_t* w_s,
                                         float2* a_s,
                                         const float* sw = nullptr,
                                         float* sw_s = nullptr) {
  constexpr int WROWS = WDT == DT_INT8 ? 2 : 1;  // weight byte rows per pair
  const int tid = threadIdx.x;
  const float* af = static_cast<const float*>(a);
  int groups = 0;
  if (act_async || sw_s != nullptr) {
    const int m = q_hi - q_lo;
    if (act_async)
      for (int i = tid; i < rows * m; i += NT) {
        const int r = i / m, p = q_lo + i - r * m;
        cp_async8(a_s + r * slice + p, af + row_of(r) * K + 2 * (k2b + p));
      }
    if (sw_s != nullptr && tid < BNW / 4)  // the tile's column scales
      cp_async16(sw_s + 4 * tid, sw + n0 + 4 * tid);
    cp_async_commit();
    ++groups;
  }
  constexpr int CH = BNW / 16;  // 16-byte chunks of a weight byte row
  for (int p0 = 0; p0 < len; p0 += DEC_STAGE) {
    const int cnt = min(DEC_STAGE, len - p0);
    for (int i = tid; i < cnt * WROWS * CH; i += NT) {
      const int row = i / CH, ch = i - row * CH;
      const size_t brow = (size_t)(k2b + p0) * WROWS + row;
      cp_async16(w_s + ((size_t)p0 * WROWS + row) * BNW + 16 * ch,
                 w + brow * N + n0 + 16 * ch);
    }
    cp_async_commit();
    ++groups;
  }
  return groups;
}

// dec_compute, once the tile's loads are issued and the codes modes'
// prologue has filled its activation planes: quantize / static quantize
// this block's part in place, or with share > 1 into every block of the
// cluster that holds the same K slice, one cluster barrier; the FMAs;
// the block's partial; the K split's partials added in rank order by
// rank 0 through distributed shared memory, which writes the tile.
// pending < 0 (K1/K5): the FMAs start on each weight stage as it lands;
// pending >= 0 (K6): wait for this tile's groups at once, `pending`
// groups of the next tile still in flight. RM is the register row tile;
// with DYN the FMAs and reductions of rows past `rows` are skipped (K6,
// whose row count is the data's), else all RM rows are computed (K1/K5,
// rows = RM but in a last ragged tile, whose planes are zeroed). The
// caller has arrived at the cluster barrier when split * share > 1 (one
// wait here matches it). swc, sar: the epilogue's scales, read early.
template <int WDT, int RM, bool DYN, int BNW, class RowOf>
__device__ __forceinline__ void dec_compute(
    const float* __restrict__ sa, float* __restrict__ out, RowOf row_of,
    int rows, int K, int N, int n0, int t, int rank, int split, int share,
    int slice, int len, int q_lo, int q_hi, int a_mode, int a_dtype,
    float s_static, int pending, float swc, float sar, const uint8_t* w_s,
    float2* a_s, const void* tab, float* red, float* gather,
    const float* sw_s = nullptr) {
  // K6 (DYN) keeps its byte table in half precision: every decoded 4-bit
  // value (at most 192 in magnitude, a few significant bits) is exact in
  // fp16, and half the bytes halve the table's shared-memory traffic
  constexpr bool HT = DYN;
  const int tid = threadIdx.x;
  const int nst = (len + DEC_STAGE - 1) / DEC_STAGE;
  const bool staged = pending < 0;
  if (!staged) cp_async_wait(pending);
  // quantize, static (each thread quantizes the pairs it copied, so its
  // own wait suffices)
  const float inv_static = 1.0f / s_static;  // IEEE: no fast-math
  if (a_mode == A_QUANT || a_mode == A_STATIC) {
    if (staged) cp_async_wait(nst);  // the oldest group: the activations
    if (share > 1) cluster_wait();   // every block of the cluster runs
    const int m = q_hi - q_lo;
    for (int i = tid; i < rows * m; i += NT) {
      const int r = i / m, p = q_lo + i - r * m;
      const float2 x = a_s[r * slice + p];
      float q0, q1;
      if (a_mode == A_QUANT) {
        const float s_r = sa[row_of(r)];
        quant_pair(x.x / s_r, x.y / s_r, a_dtype, q0, q1);
      } else {
        quant_pair(x.x * inv_static, x.y * inv_static, a_dtype, q0, q1);
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
  // the FMAs. Thread (kg, q) owns columns 4q..4q+3 and the pairs kg,
  // kg + KGN, ... (64 k-groups for a 16-column tile, 16 for 64 columns)
  constexpr int QN = BNW / DEC_CPT, KGN = NT / QN;
  static_assert(RM * BNW <= NT, "one output a thread");
  const int q = tid % QN, kg = tid / QN;
  const float2* my_tab =
      static_cast<const float2*>(tab) + (tid & (TAB_COPIES - 1));
  const __half2* my_htab =
      static_cast<const __half2*>(tab) + (tid & (TAB_COPIES - 1));
  float acc[RM][DEC_CPT];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < DEC_CPT; ++j) acc[r][j] = 0.f;
  for (int s = 0; s < nst; ++s) {
    const int p0 = s * DEC_STAGE, cnt = min(DEC_STAGE, len - p0);
    if (staged) cp_async_wait(nst - 1 - s);
    __syncthreads();
    // one pair row of this thread's 4 columns: decode, then the FMAs
    auto step = [&](int p) {
      float w0[DEC_CPT], w1[DEC_CPT];
      if (WDT == DT_INT8) {
        const uint32_t ev = *reinterpret_cast<const uint32_t*>(
            w_s + (size_t)(2 * p) * BNW + DEC_CPT * q);
        const uint32_t od = *reinterpret_cast<const uint32_t*>(
            w_s + (size_t)(2 * p + 1) * BNW + DEC_CPT * q);
#pragma unroll
        for (int j = 0; j < DEC_CPT; ++j)
          dec_pair((ev >> (8 * j)) & 255, (od >> (8 * j)) & 255, WDT, w0[j],
                   w1[j]);
      } else {
        const uint32_t b = *reinterpret_cast<const uint32_t*>(
            w_s + (size_t)p * BNW + DEC_CPT * q);
#pragma unroll
        for (int j = 0; j < DEC_CPT; ++j) {
          const int byte = (b >> (8 * j)) & 255;
          const float2 tv = HT ? __half22float2(my_htab[byte * TAB_COPIES])
                               : my_tab[byte * TAB_COPIES];
          w0[j] = tv.x;
          w1[j] = tv.y;
        }
      }
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        if (DYN && r >= rows) break;
        const float2 av = a_s[r * slice + p];
#pragma unroll
        for (int j = 0; j < DEC_CPT; ++j) {
          acc[r][j] = fmaf(av.x, w0[j], acc[r][j]);
          acc[r][j] = fmaf(av.y, w1[j], acc[r][j]);
        }
      }
    };
    if (DYN && WDT != DT_INT8) {
      // K6's item has a row or two: the table-lookup chain, not the FMAs,
      // sets the pace, so four pair rows are in flight at once (int8's
      // arithmetic decode would spill registers unrolled)
#pragma unroll 4
      for (int p = p0 + kg; p < p0 + cnt; p += KGN) step(p);
    } else {
      for (int p = p0 + kg; p < p0 + cnt; p += KGN) step(p);
    }
  }
  // the block's partial: the k-groups of a warp by shuffles (lanes QN
  // apart share q), then the 8 warps in order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if (DYN && r >= rows) break;
#pragma unroll
    for (int j = 0; j < DEC_CPT; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = QN; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < QN) red[(warp * RM + r) * BNW + DEC_CPT * lane + j] = v;
    }
  }
  __syncthreads();
  const int er = tid / BNW, ec = tid % BNW;
  float part = 0.f;
  if (tid < RM * BNW && er < rows)
    for (int g = 0; g < DEC_WARPS; ++g) part += red[g * RM * BNW + tid];
  // the K split: every block stores its partial into the shared memory
  // of its tile's rank 0, one cluster barrier, and rank 0 adds them in
  // rank order; no block reads another's memory after it
  if (split > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (share == 1) cluster_wait();  // every block of the cluster runs
    if (tid < RM * BNW)
      cluster.map_shared_rank(gather, t * split)[rank * RM * BNW + tid] =
          part;
    cluster.sync();
    if (rank == 0 && tid < RM * BNW) {
      part = 0.f;
      for (int src = 0; src < split; ++src)
        part += gather[src * RM * BNW + tid];
    }
  }
  if (rank == 0 && tid < RM * BNW && er < rows) {
    if (sw_s != nullptr) swc = sw_s[ec];
    out[row_of(er) * N + n0 + ec] =
        epilogue(part, a_mode, sar, swc, s_static);
  }
}

// K1/K5: the epilogue's scales of thread tid's (row, column), read
// before the tile's loads land so the tail waits on no load
template <class RowOf>
__device__ __forceinline__ void epilogue_scales(const float* sa,
                                                const float* sw,
                                                RowOf row_of, int rows,
                                                int n0, int rank, int rm,
                                                int a_mode, float& swc,
                                                float& sar) {
  const int tid = threadIdx.x, er = tid / BN, ec = tid % BN;
  swc = 0.f;
  sar = 1.f;
  if (rank == 0 && tid < rm * BN && er < rows) {
    swc = sw[n0 + ec];
    sar = row_scale(sa, row_of(er), a_mode);
  }
}

// the codes modes' prologue: decoded from direct loads into the planes
template <class RowOf>
__device__ __forceinline__ void codes_prologue(const void* a,
                                               const float* sa,
                                               RowOf row_of, int rows,
                                               int K, int k2b, int len,
                                               int slice, int a_mode,
                                               int a_dtype, float2* a_s) {
  for (int i = threadIdx.x; i < rows * len; i += NT) {
    const int r = i / len, p = i - r * len;
    float q0, q1;
    act_pair(a, sa, row_of(r), k2b + p, K, a_mode, a_dtype, 1.f, q0, q1);
    a_s[r * slice + p] = make_float2(q0, q1);
  }
}

// the byte table of the 4-bit weight types, in TAB_COPIES copies, as
// float2 (K1/K5) or half2 (K6, HT)
template <int WDT, bool HT>
__device__ __forceinline__ void build_table(void* tab) {
  if (WDT == DT_INT8) return;
  const int tid = threadIdx.x;
  float v0, v1;
  dec_pair(tid >> 4, tid & 15, WDT, v0, v1);  // NT == 256 entries
  // copies in a rotated order: a half-warp's stores hit distinct banks
  for (int c = 0; c < TAB_COPIES; ++c) {
    const int at = tid * TAB_COPIES + ((c + tid) & (TAB_COPIES - 1));
    if (HT)
      static_cast<__half2*>(tab)[at] = __floats2half2_rn(v0, v1);
    else
      static_cast<float2*>(tab)[at] = make_float2(v0, v1);
  }
}

// K1/K5, one block: RM rows x 16 columns x one K slice of `slice` pairs.
// A cluster holds `share` column tiles x `split` K slices: block x = c *
// (share * split) + t * split + rank has column tile c * share + t and K
// slice [rank * slice, min(K / 2, (rank + 1) * slice)); rank 0 of a tile
// adds the tile's split partials and writes it. With share > 1
// (quantize and static modes) the share blocks of one K slice each
// quantize 1/share of its activations and store them into all share
// blocks (share 1: its whole slice, in place), so a cluster quantizes
// each activation pair once. Row tile r0 = blockIdx.y * RM. While the
// loads land: zero planes for rows past R (last row tile only), the
// byte table, the codes modes' prologue.
template <int WDT, int RM>
__global__ void __launch_bounds__(NT)
ovp_dec_kernel(const void* __restrict__ a, const float* __restrict__ sa,
               const uint8_t* __restrict__ w, const float* __restrict__ sw,
               float* __restrict__ out, int R, int K, int N, int a_mode,
               int a_dtype, int split, int share, int slice,
               float s_static) {
  constexpr int WROWS = WDT == DT_INT8 ? 2 : 1;
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
  const int rows = min(RM, R - r0);
  const DenseRows row_of{r0};
  const int k2b = rank * slice, len = max(0, min(K / 2 - k2b, slice));
  const int q_sub = (len + share - 1) / share;
  const int q_lo = min(len, t * q_sub), q_hi = min(len, q_lo + q_sub);
  const bool act_async =
      a_mode == A_FP || a_mode == A_QUANT || a_mode == A_STATIC;
  if (csize > 1) cluster_arrive_relaxed();
  float swc, sar;
  epilogue_scales(sa, sw, row_of, rows, n0, rank, RM, a_mode, swc, sar);
  dec_issue<WDT, BN>(a, w, row_of, rows, K, N, n0, k2b, len, q_lo, q_hi,
                     act_async, slice, w_s, a_s);
  for (int i = tid; i < (RM - rows) * len; i += NT)
    a_s[(rows + i / len) * slice + i % len] = make_float2(0.f, 0.f);
  build_table<WDT, false>(tab);
  if (!act_async)
    codes_prologue(a, sa, row_of, rows, K, k2b, len, slice, a_mode, a_dtype,
                   a_s);
  dec_compute<WDT, RM, false, BN>(sa, out, row_of, rows, K, N, n0, t, rank,
                                  split, share, slice, len, q_lo, q_hi,
                                  a_mode, a_dtype, s_static, -1, swc, sar,
                                  w_s, a_s, tab, red, gather);
}

// K6, persistent (the header says why): gridDim.x blocks (whole
// clusters of split x share) walk the call's work items. The per-expert
// row counts come from the fill (or B * C each without it); an expert
// with rows has ceil(rows / rm) row items, and an item is (row item,
// group of `share` 64-column groups), in expert order. Cluster c takes
// items c, c + clusters, ...; an expert with no filled row has no item.
// The rows of item (e, y) are the expert's filled rows y * rm .. y * rm
// + rm - 1 in batch order: row j of expert e is slot c of batch row b,
// where the rows of batch rows before b take the first j - c; global
// row (b * E + e) * C + c of the (B, E, C, K) activation and (B, E, C,
// N) output. Rows past a (b, e)'s fill are never written. The fill is
// copied to shared memory once (int16, when B x E is at most FILL_SMEM
// entries; else it is read from global memory), every item's row list
// is a scan of it, and the next item's loads are issued into the second
// of two buffers before the current item computes; the byte table is
// built once per block.
template <int WDT>
__global__ void __launch_bounds__(NT)
ovp_grouped_dec_kernel(const void* __restrict__ a,
                       const float* __restrict__ sa,
                       const uint8_t* __restrict__ w,
                       const float* __restrict__ sw,
                       float* __restrict__ out, const int* __restrict__ fill,
                       int B, int E, int C, int K, int N, int a_mode,
                       int a_dtype, int rm, int split, int share, int slice,
                       int fill_cached, float s_static) {
  constexpr int WROWS = WDT == DT_INT8 ? 2 : 1;
  constexpr int RM = GROUPED_RM;
  extern __shared__ __align__(16) uint8_t smem[];
  const int wbytes = slice * GBN * WROWS;
  uint8_t* w_buf[2] = {smem, smem + wbytes};
  float2* a_buf[2] = {reinterpret_cast<float2*>(smem + 2 * wbytes),
                      reinterpret_cast<float2*>(smem + 2 * wbytes) +
                          rm * slice};
  __half2* tab = reinterpret_cast<__half2*>(a_buf[1] + rm * slice);
  float* red = reinterpret_cast<float*>(
      tab + (WDT == DT_INT8 ? 0 : 256 * TAB_COPIES));
  float* gather = red + DEC_WARPS * RM * GBN;
  float* sw_buf[2] = {gather + split * RM * GBN,
                      gather + split * RM * GBN + GBN};
  long long* rowlist = reinterpret_cast<long long*>(sw_buf[1] + GBN);
  int* cnt = reinterpret_cast<int*>(rowlist + 2 * RM);  // [E] rows per expert
  int* ystart = cnt + E;                                // [E + 1] first item
  short* fill_s = reinterpret_cast<short*>(ystart + E + 1);  // [B][E]

  const int tid = threadIdx.x, lane = tid % 32;
  if (fill != nullptr && fill_cached)
    for (int i = tid; i < B * E; i += NT)
      fill_s[i] = (short)min(max(fill[i], 0), C);
  __syncthreads();
  auto fill_at = [&](int b, int e) {
    return fill_cached ? (int)fill_s[b * E + e]
                       : min(max(fill[(size_t)b * E + e], 0), C);
  };
  for (int e = tid; e < E; e += NT) {
    int c = B * C;
    if (fill != nullptr) {
      c = 0;
      for (int b = 0; b < B; ++b) c += fill_at(b, e);
    }
    cnt[e] = c;
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the row items per expert
    int run = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int v = e < E ? (cnt[e] + rm - 1) / rm : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      if (e < E) ystart[e] = run + incl - v;
      run += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) ystart[E] = run;
  }
  build_table<WDT, true>(tab);
  __syncthreads();

  const int csize = split * share, crank = blockIdx.x % csize;
  const int t = crank / split, rank = crank % split;
  const int groups = (N / GBN) / share;
  const int items = ystart[E] * groups, stride = gridDim.x / csize;
  const size_t wstride = (size_t)(K / 2) * WROWS * N;
  const int k2b = rank * slice, len = max(0, min(K / 2 - k2b, slice));
  const int q_sub = (len + share - 1) / share;
  const int q_lo = min(len, t * q_sub), q_hi = min(len, q_lo + q_sub);
  const bool act_async =
      a_mode == A_FP || a_mode == A_QUANT || a_mode == A_STATIC;

  // item it -> its expert, first row, rows and column offset; its row
  // list into rowlist[buf * RM ...]
  auto locate = [&](int it, int& e, int& rows, int& n0) {
    const int yi = it / groups, cgi = it % groups;
    int lo = 0, hi = E;  // the e with ystart[e] <= yi < ystart[e + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (ystart[mid] <= yi) lo = mid; else hi = mid;
    }
    e = lo;
    const int r0 = (yi - ystart[e]) * rm;
    rows = min(rm, cnt[e] - r0);
    n0 = (cgi * share + t) * GBN;
    return r0;
  };
  auto list_rows = [&](int e, int r0, int rows, long long* list) {
    if (fill != nullptr) {
      if (tid < 32) {  // scan the fill over batch rows, 32 at a time
        int run = 0;
        for (int b0 = 0; b0 < B && run < r0 + rows; b0 += 32) {
          const int b = b0 + lane;
          const int f = b < B ? fill_at(b, e) : 0;
          int incl = f;
          for (int o = 1; o < 32; o <<= 1) {
            const int u = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += u;
          }
          const int jlo = run + incl - f, jhi = run + incl;
          for (int j = max(jlo, r0); j < min(jhi, r0 + rows); ++j)
            list[j - r0] = ((long long)b * E + e) * C + (j - jlo);
          run += __shfl_sync(0xffffffffu, incl, 31);
        }
      }
    } else if (tid < rows) {
      const int j = r0 + tid;
      list[tid] = ((long long)(j / C) * E + e) * C + j % C;
    }
  };

  int it = blockIdx.x / csize, e = 0, rows = 0, n0 = 0, pend = 0;
  if (it < items) {
    const int r0 = locate(it, e, rows, n0);
    list_rows(e, r0, rows, rowlist);
    __syncthreads();
    dec_issue<WDT, GBN>(a, w + e * wstride, ListedRows{rowlist}, rows, K, N,
                        n0, k2b, len, q_lo, q_hi, act_async, slice,
                        w_buf[0], a_buf[0], sw + (size_t)e * N, sw_buf[0]);
  }
  for (int k = 0; it < items; it += stride, ++k) {
    const int buf = k & 1;
    const ListedRows cur{rowlist + buf * RM};
    // the next item's loads go out before this one computes
    const int nxt = it + stride;
    int ne = 0, nrows = 0, nn0 = 0;
    pend = 0;
    if (nxt < items) {
      const int nr0 = locate(nxt, ne, nrows, nn0);
      list_rows(ne, nr0, nrows, rowlist + (buf ^ 1) * RM);
      __syncthreads();
      pend = dec_issue<WDT, GBN>(a, w + ne * wstride,
                                 ListedRows{rowlist + (buf ^ 1) * RM}, nrows,
                                 K, N, nn0, k2b, len, q_lo, q_hi, act_async,
                                 slice, w_buf[buf ^ 1], a_buf[buf ^ 1],
                                 sw + (size_t)ne * N, sw_buf[buf ^ 1]);
    }
    if (csize > 1) cluster_arrive();
    // the column scale lands with the item's loads; the row scale (the
    // quantize and codes modes only) is read here
    const float sar =
        row_scale(sa, cur(min((int)threadIdx.x / GBN, rows - 1)), a_mode);
    if (!act_async)
      codes_prologue(a, sa, cur, rows, K, k2b, len, slice, a_mode, a_dtype,
                     a_buf[buf]);
    dec_compute<WDT, RM, true, GBN>(sa, out, cur, rows, K, N, n0, t, rank,
                                    split, share, slice, len, q_lo, q_hi,
                                    a_mode, a_dtype, s_static, pend, 0.f,
                                    sar, w_buf[buf], a_buf[buf], tab, red,
                                    gather, sw_buf[buf]);
    __syncthreads();  // the next issue rewrites this item's buffers
    e = ne;
    rows = nrows;
    n0 = nn0;
  }
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

// K6's persistent grid: as many whole clusters as are resident at once
// on the card (one wave), at most one per work item of a full fill. The
// kernel prefers the largest shared-memory carveout, so that as many
// blocks share an SM as their dynamic shared memory allows; the
// occupancy is asked once per (instantiation, shared bytes).
template <int WDT>
int grouped_grid(int B, int E, int C, int N, int rm, int split, int share,
                 int smem, int* blocks) {
  auto kern = ovp_grouped_dec_kernel<WDT>;
  static cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  static const cudaError_t carve_err =
      attr_err != cudaSuccess ? attr_err
                              : cudaFuncSetAttribute(
                                    kern,
                                    cudaFuncAttributePreferredSharedMemoryCarveout,
                                    (int)cudaSharedmemCarveoutMaxShared);
  if (carve_err != cudaSuccess) return (int)carve_err;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  static int seen_smem[8] = {0}, seen_blocks[8] = {0};
  int per_sm = 0;
  for (int i = 0; i < 8 && seen_smem[i] != 0; ++i)
    if (seen_smem[i] == smem) per_sm = seen_blocks[i];
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, NT, smem);
    if (e != cudaSuccess) return (int)e;
    per_sm = max(per_sm, 1);
    for (int i = 0; i < 8; ++i)
      if (seen_smem[i] == 0 || i == 7) {
        seen_smem[i] = smem;
        seen_blocks[i] = per_sm;
        break;
      }
  }
  const int csize = split * share;
  const long long most = (long long)E * ((B * C + rm - 1) / rm) *
                         ((N / GBN) / share);
  *blocks = csize * (int)min(most, (long long)max(sms * per_sm / csize, 1));
  return (int)cudaSuccess;
}

template <int WDT>
int launch_grouped_dec(const void* a, const float* sa, const uint8_t* w,
                       const float* sw, float* out, const int* fill, int B,
                       int E, int C, int K, int N, int a_mode, int a_dtype,
                       int rm, int split, int share, int slice, int smem,
                       float s_static, cudaStream_t st) {
  int blocks = 0;
  const int err0 =
      grouped_grid<WDT>(B, E, C, N, rm, split, share, smem, &blocks);
  if (err0 != 0) return err0;
  const int csize = split * share;
  const int fill_cached = fill != nullptr && B * E <= FILL_SMEM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ovp_grouped_dec_kernel<WDT>, a, sa, w, sw, out, fill, B, E, C,
      K, N, a_mode, a_dtype, rm, split, share, slice, fill_cached, s_static);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
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
// sw (E, N) f32, out (B, E, C, N) f32; fill (B, E) int32 or null: row c
// of (b, e) is computed only for c < fill[b, e] (clamped into [0, C];
// null: every row), the other rows of out are left unwritten. body 0
// (decode): the persistent grouped kernel with row tile rm (1..8, at
// most B * C), a cluster of split x share blocks (as K1's), slice K
// pairs a block and smem dynamic shared bytes (at least
// grouped_smem_bytes); body 1 (FMA): the FMA template over every row of
// every expert, grid (N / 16, ceil(B * C / BM), E) with BM 8 up to 8
// rows an expert and 16 above, for a K slice that does not fit or a
// call without a fill above 8 rows an expert (fill ignored: computing a
// row past it is harmless, its value is unspecified). Same layout rules
// as K1. Returns the launch's cudaError_t.
extern "C" int ovp_grouped_mm_launch(const void* a, const void* sa,
                                     const void* w, const void* sw,
                                     void* out, const void* fill, int B,
                                     int E, int C, int K, int N, int w_dtype,
                                     int a_mode, int a_dtype, int body,
                                     int rm, int split, int share, int slice,
                                     int smem, float s_static,
                                     void* stream) {
  const int R = B * C;
  if (body == BODY_FMA)
    return R > BM_DENSE
               ? launch_fma<BM_GROUPED>(a, sa, w, sw, out, R, K, N, E, C,
                                        w_dtype, a_mode, a_dtype, s_static,
                                        stream)
               : launch_fma<BM_DENSE>(a, sa, w, sw, out, R, K, N, E, C,
                                      w_dtype, a_mode, a_dtype, s_static,
                                      stream);
  const int wrows = w_dtype == DT_INT8 ? 2 : 1;
  const bool pow2 = split > 0 && share > 0 && !(split & (split - 1)) &&
                    !(share & (share - 1));
  const int fill_entries = fill != nullptr && B * E <= FILL_SMEM ? B * E : 0;
  if (body != BODY_DECODE || rm < 1 || rm > GROUPED_RM || rm > R ||
      N % GBN != 0 || slice < 1 || !pow2 || split * share > 8 ||
      (N / GBN) % share != 0 ||
      (share > 1 && a_mode != A_QUANT && a_mode != A_STATIC) ||
      (long long)split * slice < K / 2 || smem > SMEM_MAX ||
      smem < grouped_smem_bytes(rm, slice, wrows, split, E, fill_entries))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* saf = static_cast<const float*>(sa);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  const float* swf = static_cast<const float*>(sw);
  const int* fi = static_cast<const int*>(fill);
  float* of = static_cast<float*>(out);
  switch (w_dtype) {
    case DT_INT4:
      return launch_grouped_dec<DT_INT4>(a, saf, wb, swf, of, fi, B, E, C, K,
                                         N, a_mode, a_dtype, rm, split,
                                         share, slice, smem, s_static, st);
    case DT_FLINT4:
      return launch_grouped_dec<DT_FLINT4>(a, saf, wb, swf, of, fi, B, E, C,
                                           K, N, a_mode, a_dtype, rm, split,
                                           share, slice, smem, s_static, st);
    case DT_INT8:
      return launch_grouped_dec<DT_INT8>(a, saf, wb, swf, of, fi, B, E, C, K,
                                         N, a_mode, a_dtype, rm, split,
                                         share, slice, smem, s_static, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The block count of K6's persistent grid for this plan (what
// ovp_grouped_mm_launch launches with body 0), into *blocks. Returns a
// cudaError_t.
extern "C" int ovp_grouped_grid(int B, int E, int C, int N, int w_dtype,
                                int rm, int split, int share, int smem,
                                void* blocks) {
  int* out = static_cast<int*>(blocks);
  switch (w_dtype) {
    case DT_INT4:
      return grouped_grid<DT_INT4>(B, E, C, N, rm, split, share, smem, out);
    case DT_FLINT4:
      return grouped_grid<DT_FLINT4>(B, E, C, N, rm, split, share, smem,
                                     out);
    case DT_INT8:
      return grouped_grid<DT_INT8>(B, E, C, N, rm, split, share, smem, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
