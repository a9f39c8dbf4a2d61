// Fused cache-write prefill for Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attn.py:170
// (_prefill_call -> pallas_call at :205; bodies _prefill_kernel_packed
// :142 and _prefill_kernel_fp :155, with _quant_tile :101 and
// _attend_tile :111).
//
// One launch per cache site per prefill chunk does two things:
//   write  — every (page tile, kv head) of the request's raw K/V stage
//            (S, Hkv, D) f32 is quantized with the arithmetic of
//            layers._quant_kv_token: per token row mu = mean, std =
//            sqrt(mean((x - mu)^2)) over D, s = max(3 * std / 7, 1e-6),
//            int4 OVP encode of x / s (Algorithm 1 pair selection, rintf,
//            exact log2f / ldexpf abfloat encode, IEEE division), packed
//            two codes per byte (even value in the high nibble), and
//            written to page bt[tile] of the pool in place. fp32 caches
//            copy the raw tile instead. Pages outside the request's table
//            keep their bytes. Every stage tile is rewritten on every
//            chunk, rows not yet prefilled included (zeros: scale 1e-6,
//            code 0), as the TPU kernel does; the rewrite is idempotent.
//   attend — causal online-softmax attention of the chunk's C queries
//            (C, H, D) over the RAW stage, query row c at absolute
//            position qpos = off + c (off = positions[0], read on the
//            card), keys kpos <= qpos. Queries are pre-scaled by
//            1 / float32(sqrt(D)).
//
// Launch shape: one grid of 128-thread blocks, two kinds of block.
//   attention blocks, Hkv * ceil(C * G / 8): one per (kv head, tile of 8
//     query rows, row r = c * G + g). The block walks the stage in
//     tiles of 32 keys up to its causal limit (off + its last c), with
//     K2's chain: load the tile to shared memory, one thread per (row,
//     key) score, one warp per row online softmax with shuffles, one
//     thread per (row, lane) p . V. Tiles past the limit are fully
//     masked in the TPU kernel and add exactly nothing, so skipping them
//     changes no bit.
//   write blocks, Hkv * (S / ps): one per (page tile, kv head), so each
//     page tile is quantized and written by exactly one block. One warp
//     per token row (K and V rows of the tile): each lane holds whole
//     pairs, and the mean and the variance are warp butterfly sums, a
//     fixed order that gives every lane the same bits.
// On the serving path (C = 16, S = 256 after the last chunk, Hkv = 16,
// G = 1, D = 64, ps = 16) that is 32 attention and 256 write blocks.
//
// What bounds it on the H100: bytes. It must read the stage (2 * S * Hkv
// * D * 4 bytes, 2 MB at S = 256) and q, and write the pages (2 * S * Hkv
// * (D / 2 + 4) bytes) and the output; that is under a microsecond at
// 3.35 TB/s, and the attention's 4 * H * D * sum(qpos + 1) fp32
// operations are fewer still, so launch latency and each attention
// block's serial per-tile chain set the time. Making it fast (tensor
// cores on the raw tile, more rows per block) is later work.
//
// Tolerance against the plain version (kernels/prefill_attn.py,
// prefill_attention_plain): the output differs only in fp32 summation
// order and the tile-wise softmax rescaling, atol 1e-5. The mean and
// variance sums run in another order than torch's, so a scale may differ
// in the last bit (rtol 1e-6) and a code that sits on a rounding boundary
// can flip; chip_smoke.py counts the differing code bytes and fails above
// 0.01 % of them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ovp_codec.cuh"

namespace {

constexpr int TS = 32;      // keys per attention tile (one per warp lane)
constexpr int QT = 8;       // query rows per attention block
constexpr int NT = 128;     // threads per block
constexpr int NW = NT / 32;
constexpr int DMAX = 128;   // largest head_dim the kernel takes
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One (page tile, kv head): quantize-and-write (packed) or copy (fp) the
// tile's ps K rows and ps V rows onto physical page bt[tile].
template <bool PACKED>
__device__ void write_tile(const float* __restrict__ sk,
                           const float* __restrict__ sv,
                           const int* __restrict__ bt, void* kd, void* vd,
                           float* ks, float* vs, int tile, int h, int Hkv,
                           int D, int ps, int P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int page = min(max(bt[tile], 0), P - 1);
  const int D2 = D / 2;
  for (int rr = warp; rr < 2 * ps; rr += NW) {
    const int r = rr % ps;                 // row in the tile
    const bool is_v = rr >= ps;
    const size_t src = ((size_t)tile * ps + r) * Hkv + h;   // stage row
    const size_t dst = ((size_t)page * ps + r) * Hkv + h;   // pool row
    const float2* x = reinterpret_cast<const float2*>((is_v ? sv : sk)
                                                      + src * D);
    if (!PACKED) {
      float2* y = reinterpret_cast<float2*>(
          static_cast<float*>(is_v ? vd : kd) + dst * D);
      for (int p = lane; p < D2; p += 32) y[p] = x[p];
      continue;
    }
    float2 xv[DMAX / 64];                  // this lane's pairs
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 64; ++i) {
      const int p = lane + 32 * i;
      xv[i] = p < D2 ? x[p] : make_float2(0.f, 0.f);
      sum += xv[i].x + xv[i].y;
    }
    const float mu = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX / 64; ++i) {
      if (lane + 32 * i < D2) {
        const float e0 = xv[i].x - mu, e1 = xv[i].y - mu;
        sq += e0 * e0 + e1 * e1;
      }
    }
    const float sd = sqrtf(warp_sum(sq) / (float)D);
    const float s = fmaxf(3.f * sd / 7.f, 1e-6f);
    uint8_t* y = static_cast<uint8_t*>(is_v ? vd : kd) + dst * D2;
#pragma unroll
    for (int i = 0; i < DMAX / 64; ++i) {
      const int p = lane + 32 * i;
      if (p < D2) y[p] = ovp::enc_pair(xv[i].x / s, xv[i].y / s);
    }
    if (lane == 0) (is_v ? vs : ks)[dst] = s;
  }
}

// One (kv head, tile of QT query rows): causal online-softmax attention
// over the raw stage, out (C, H, D) in the natural layout.
__device__ void attend_rows(const float* __restrict__ q,
                            const float* __restrict__ sk,
                            const float* __restrict__ sv, int off,
                            float* __restrict__ out, int h, int r0, int C,
                            int S, int Hkv, int G, int D, float qscale) {
  __shared__ float k_s[TS][DMAX + 1];
  __shared__ __align__(16) float v_s[TS][DMAX];
  __shared__ float q_s[QT][DMAX];
  __shared__ float o_s[QT * DMAX];
  __shared__ float p_s[QT][TS];
  __shared__ float m_s[QT], l_s[QT], corr_s[QT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G;
  const int nr = min(QT, C * G - r0);     // live rows in this block
  for (int i = tid; i < QT * D; i += NT) {
    const int r = i / D, d = i % D, row = r0 + r;
    float v = 0.f;
    if (r < nr) {
      const int c = row / G, g = row % G;
      v = q[((size_t)c * H + h * G + g) * D + d] / qscale;
    }
    q_s[r][d] = v;
    o_s[i] = 0.f;
  }
  if (tid < QT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int kmax = min(off + (r0 + nr - 1) / G, S - 1);  // causal limit
  const int W = D / 4;
  for (int t0 = 0; t0 <= kmax; t0 += TS) {
    for (int i = tid; i < TS * W; i += NT) {
      const int t = i / W, wi = i % W, s = t0 + t;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (s < S) {
        const size_t o4 = ((size_t)s * Hkv + h) * W + wi;
        kx = reinterpret_cast<const float4*>(sk)[o4];
        vx = reinterpret_cast<const float4*>(sv)[o4];
      }
      const int d = 4 * wi;
      k_s[t][d] = kx.x;
      k_s[t][d + 1] = kx.y;
      k_s[t][d + 2] = kx.z;
      k_s[t][d + 3] = kx.w;
      *reinterpret_cast<float4*>(&v_s[t][d]) = vx;
    }
    __syncthreads();

    for (int i = tid; i < QT * TS; i += NT) {
      const int r = i / TS, t = i % TS, s = t0 + t;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(q_s[r][d], k_s[t][d], acc);
      const int qpos = off + (r0 + r) / G;
      p_s[r][t] = (r < nr && s < S && s <= qpos) ? acc : NEG_INF;
    }
    __syncthreads();

    for (int r = warp; r < QT; r += NW) {
      const float m_prev = m_s[r];
      const float sv_ = p_s[r][lane];
      float mx = sv_;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sv_ - m_new);
      const float sum = warp_sum(p);
      const float corr = expf(m_prev - m_new);
      p_s[r][lane] = p;
      __syncwarp();
      if (lane == 0) {
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < QT * D; i += NT) {
      const int r = i / D, d = i % D;
      float acc = 0.f;
      for (int t = 0; t < TS; ++t) acc = fmaf(p_s[r][t], v_s[t][d], acc);
      o_s[i] = o_s[i] * corr_s[r] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < nr * D; i += NT) {
    const int r = i / D, d = i % D, row = r0 + r;
    const int c = row / G, g = row % G;
    out[((size_t)c * H + h * G + g) * D + d] =
        o_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(NT)
prefill_attn_kernel(const float* __restrict__ q,
                    const float* __restrict__ sk,
                    const float* __restrict__ sv,
                    const int* __restrict__ positions,
                    const int* __restrict__ bt, void* kd, void* vd,
                    float* ks, float* vs, float* __restrict__ out, int C,
                    int S, int Hkv, int G, int D, int ps, int P,
                    float qscale) {
  const int n_qt = (C * G + QT - 1) / QT;
  const int blk = blockIdx.x;
  if (blk < Hkv * n_qt) {
    attend_rows(q, sk, sv, positions[0], out, blk / n_qt, (blk % n_qt) * QT,
                C, S, Hkv, G, D, qscale);
  } else {
    const int w = blk - Hkv * n_qt;       // (tile, head), head fastest
    write_tile<PACKED>(sk, sv, bt, kd, vd, ks, vs, w / Hkv, w % Hkv, Hkv, D,
                       ps, P);
  }
}

}  // namespace

// q (C, H, D) f32 with H = Hkv * G (batch 1); stage sk/sv (S, Hkv, D) f32;
// positions (C,) i32, only positions[0] read; bt (>= S / ps,) i32, the
// request's block-table row; pools: packed kd/vd (P, ps, Hkv, D/2) u8 and
// ks/vs (P, ps, Hkv) f32, or fp kd/vd (P, ps, Hkv, D) f32 (ks/vs unused),
// written in place; out (C, H, D) f32. Needs D % 8 == 0, D <= 128,
// S % ps == 0. qscale = float32(sqrt(D)). Returns cudaGetLastError().
extern "C" int prefill_attn_launch(const void* q, const void* sk,
                                   const void* sv, const void* positions,
                                   const void* bt, void* kd, void* vd,
                                   void* ks, void* vs, void* out, int C,
                                   int S, int Hkv, int G, int D, int ps,
                                   int P, int packed, float qscale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_qt = (C * G + QT - 1) / QT;
  const dim3 grid(Hkv * n_qt + Hkv * (S / ps));
  const float* qf = static_cast<const float*>(q);
  const float* skf = static_cast<const float*>(sk);
  const float* svf = static_cast<const float*>(sv);
  const int* pi = static_cast<const int*>(positions);
  const int* bi = static_cast<const int*>(bt);
  float* ksf = static_cast<float*>(ks);
  float* vsf = static_cast<float*>(vs);
  float* of = static_cast<float*>(out);
  if (packed)
    prefill_attn_kernel<true><<<grid, NT, 0, st>>>(
        qf, skf, svf, pi, bi, kd, vd, ksf, vsf, of, C, S, Hkv, G, D, ps, P,
        qscale);
  else
    prefill_attn_kernel<false><<<grid, NT, 0, st>>>(
        qf, skf, svf, pi, bi, kd, vd, ksf, vsf, of, C, S, Hkv, G, D, ps, P,
        qscale);
  return (int)cudaGetLastError();
}
