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
//            written to page bt[tile] of the pool in place. fp pools take
//            the raw tile rounded to the pool's dtype (f32, or bf16 /
//            fp16 by the _rn intrinsics, as the plain version's
//            .to(dtype)). Pages outside the request's table keep their
//            bytes. Every stage tile is rewritten on every chunk, rows not
//            yet prefilled included (zeros: scale 1e-6, code 0), as the
//            TPU kernel does; the rewrite is idempotent.
//   attend — causal online-softmax attention of the chunk's C queries
//            (C, H, D) over the RAW f32 stage, query row c at absolute
//            position qpos = off + c (off = positions[0], read on the
//            card), keys kpos <= qpos. Queries are pre-scaled by
//            1 / float32(sqrt(D)).
//
// What bounds it on the H100: almost nothing but latency. At the MoE
// path's shape (Hkv 4, G 8, D 128, C 16 over a 256-token stage) the
// attention is 65 MFLOP (1 us at 67 TFLOP/s) over a 1 MB stage (0.3 us
// at 3.35 TB/s). The first port (8 query rows a block, one (row, key)
// dot product a thread as a D-long FMA chain out of shared memory, four
// barriers and synchronous loads per 32-key tile, each block walking
// every tile) took 52 us there, nearly all of it the attention half
// (timed apart: 51 us attention, 11 us page writes). So the design:
//
// * many query rows share each K/V tile: a block holds QR = 4 x warps
//   query rows (up to 32; rows r = c * G + g of one kv head, so the G
//   heads of a token share the tile), and every tile it loads serves all
//   of them;
// * register tiling on the CUDA cores, no tensor cores: lane (rg, kg) of
//   a warp scores its row rg against keys kg, kg + 8, kg + 16, kg + 24
//   of the 32-key tile, float4 by float4 along D (5 shared loads feed 16
//   FMAs; K rows padded to D + 4 floats so a quarter-warp's 16-byte loads
//   hit distinct banks), four independent chains; then it owns the
//   column groups kg, kg + 8, ... (float4) of its row's output for PV.
//   Tensor cores would need a 3xTF32 split to hold atol 1e-5 (plain TF32
//   keeps about 3 decimal digits); at these sizes the work is a few
//   microseconds of FMAs, so the split's three products and its operand
//   shuffles are not worth their complexity yet;
// * the softmax needs no barrier: a row's 32 scores sit in 8 lanes of
//   one warp (shuffles for max and sum), and its probabilities go
//   through a warp-private shared row for PV;
// * K/V tiles double-buffered with cp.async (zero-filled past S) where a
//   block walks more than one tile;
// * the keys split across a thread-block cluster of `split` blocks (1, 2,
//   4 or 8) when Hkv x row tiles alone would leave SMs idle: rank j walks
//   key tiles [j * tpr, (j + 1) * tpr) up to the block's causal limit and
//   keeps its partial (m, l, o) in its shared memory; after one cluster
//   barrier, rank j combines a 1/split share of the rows from every
//   rank's memory (distributed shared memory) in rank order 0..split-1:
//   M = max m_r, L = sum l_r * exp(m_r - M), o = sum o_r * exp(m_r - M),
//   out = o / max(L, 1e-30). Deterministic, no atomics. A rank whose
//   keys are all past a row's position holds m = -1e30, and its weight
//   exp(-1e30 - M) is exactly 0 (rank 0 always holds key 0, so M is a
//   real score);
// * the write half keeps its design (one block per (page tile, kv head),
//   one warp per token row, warp butterfly sums): 11 us alone, run
//   beside the attention blocks in the same grid.
//
// Launch (kernels/prefill_attn.py::prefill_plan computes it): one grid
// of 32 x warps threads, attention blocks first, Hkv x n_rt x split
// (cluster rank fastest), then the write blocks, Hkv x (S / ps) rounded
// up to whole clusters. On the serving paths: Qwen1.5-0.5B (Hkv 16, G 1,
// D 64, C 16) 4 warps, 16 rows a block, split 8: 128 attention and 256
// write blocks; Qwen3-30B-A3B (Hkv 4, G 8, D 128, C 16) 8 warps, 32 rows,
// 4 row tiles a head, split 8: 128 attention and 64 write blocks.
//
// Tolerance against the plain version (kernels/prefill_attn.py,
// prefill_attention_plain): the output differs only in fp32 summation
// order, the tile-wise softmax rescaling and the rank combine, atol
// 1e-5. The mean and variance sums run in another order than torch's,
// so a scale may differ in the last bit (rtol 1e-6) and a code that sits
// on a rounding boundary can flip; chip_smoke.py counts the differing
// code bytes and fails above 0.01 % of them. fp pools equal the plain
// version's rounding exactly.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ovp_codec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TK = 32;      // keys per attention tile
constexpr int DMAX = 256;   // largest head_dim (float4 groups per lane <= 8)
constexpr int SMEM_MAX = 232448;  // 227 KB, a block's opt-in cap
constexpr float NEG_INF = -1e30f;

// pool layouts: OVP-packed nibbles, or fp in one of three dtypes
enum { KV_PACKED = 0, KV_F32 = 1, KV_BF16 = 2, KV_F16 = 3 };

// an attention block's dynamic shared memory (floats), in this order:
// q_s [QR][D] (the rank's o partial after the keys), k_s [nbuf][TK][D +
// 4], v_s [nbuf][TK][D], p_s [QR][TK + 1], m_s, l_s [QR], and the
// combine's factors f_s [QR][split] and sums L_s [QR]. prefill_plan in
// kernels/prefill_attn.py computes the same sum.
inline int smem_bytes(int qr, int D, int nbuf, int split) {
  return 4 * (qr * D + nbuf * TK * (D + 4) + nbuf * TK * D + qr * (TK + 1)
              + 2 * qr + qr * (split + 1));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes to shared memory, zero-filled when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One (page tile, kv head): quantize-and-write (packed) or round (fp) the
// tile's ps K rows and ps V rows onto physical page bt[tile].
__device__ void write_tile(const float* __restrict__ sk,
                           const float* __restrict__ sv,
                           const int* __restrict__ bt, void* kd, void* vd,
                           float* ks, float* vs, int kind, int tile, int h,
                           int Hkv, int D, int ps, int P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int page = min(max(bt[tile], 0), P - 1);
  const int D2 = D / 2;
  for (int rr = warp; rr < 2 * ps; rr += nw) {
    const int r = rr % ps;                 // row in the tile
    const bool is_v = rr >= ps;
    const size_t src = ((size_t)tile * ps + r) * Hkv + h;   // stage row
    const size_t dst = ((size_t)page * ps + r) * Hkv + h;   // pool row
    const float2* x = reinterpret_cast<const float2*>((is_v ? sv : sk)
                                                      + src * D);
    void* pool = is_v ? vd : kd;
    if (kind == KV_F32) {
      float2* y = reinterpret_cast<float2*>(pool) + dst * D2;
      for (int p = lane; p < D2; p += 32) y[p] = x[p];
      continue;
    }
    if (kind == KV_BF16) {
      __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(pool) + dst * D2;
      for (int p = lane; p < D2; p += 32)
        y[p] = __floats2bfloat162_rn(x[p].x, x[p].y);
      continue;
    }
    if (kind == KV_F16) {
      __half2* y = reinterpret_cast<__half2*>(pool) + dst * D2;
      for (int p = lane; p < D2; p += 32)
        y[p] = __floats2half2_rn(x[p].x, x[p].y);
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
    uint8_t* y = static_cast<uint8_t*>(pool) + dst * D2;
#pragma unroll
    for (int i = 0; i < DMAX / 64; ++i) {
      const int p = lane + 32 * i;
      if (p < D2) y[p] = ovp::enc_pair(xv[i].x / s, xv[i].y / s);
    }
    if (lane == 0) (is_v ? vs : ks)[dst] = s;
  }
}

// One attention block: kv head h, query rows [r0, r0 + QR) (row r = c *
// G + g), key tiles [rank * tpr, (rank + 1) * tpr) below its causal
// limit. GPL = the most float4 column groups a lane owns (D <= 32 * GPL).
template <int GPL>
__device__ void attend_rows(const float* __restrict__ q,
                            const float* __restrict__ sk,
                            const float* __restrict__ sv, int off,
                            float* __restrict__ out, int h, int r0,
                            int rank, int split, int tpr, int nbuf, int C,
                            int S, int Hkv, int G, int D, float qscale) {
  extern __shared__ __align__(16) float smem[];
  const int NT = blockDim.x, QR = 4 * (NT >> 5), KS = D + 4, D4 = D / 4;
  float* q_s = smem;                               // [QR][D]
  float* k_s = q_s + QR * D;                       // [nbuf][TK][KS]
  float* v_s = k_s + nbuf * TK * KS;               // [nbuf][TK][D]
  float* p_s = v_s + nbuf * TK * D;                // [QR][TK + 1]
  float* m_s = p_s + QR * (TK + 1);                // [QR]
  float* l_s = m_s + QR;                           // [QR]
  float* f_s = l_s + QR;                           // [QR][split]
  float* L_s = f_s + QR * split;                   // [QR]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kg = lane & 7;
  const int H = Hkv * G, rows = C * G;
  const int row = warp * 4 + rg;                   // this lane's row
  const bool live = r0 + row < rows;
  const int qpos = off + (r0 + row) / G;

  // the key range: tiles up to the block's causal limit, this rank's share
  const int last = min(r0 + QR, rows) - 1;
  const int ntiles = min(off + last / G, S - 1) / TK + 1;
  const int t_lo = min(rank * tpr, ntiles), t_hi = min(t_lo + tpr, ntiles);

  auto load_tile = [&](int tile, int buf) {
    for (int i = tid; i < TK * D4; i += NT) {
      const int t = i / D4, c4 = i - t * D4, s = tile * TK + t;
      const size_t at = ((size_t)(s < S ? s : 0) * Hkv + h) * D + 4 * c4;
      const int bytes = s < S ? 16 : 0;
      cp_async16(k_s + (buf * TK + t) * KS + 4 * c4, sk + at, bytes);
      cp_async16(v_s + (buf * TK + t) * D + 4 * c4, sv + at, bytes);
    }
    cp_async_commit();
  };
  if (t_lo < t_hi) load_tile(t_lo, 0);
  // the block's queries, pre-scaled, while the first tile lands
  for (int i = tid; i < QR * D4; i += NT) {
    const int rr = i / D4, c4 = i - rr * D4, r = r0 + rr;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      v = reinterpret_cast<const float4*>(
          q + ((size_t)(r / G) * H + h * G + r % G) * D)[c4];
      v.x /= qscale;
      v.y /= qscale;
      v.z /= qscale;
      v.w /= qscale;
    }
    reinterpret_cast<float4*>(q_s)[i] = v;
  }

  float m = NEG_INF, l = 0.f;
  float4 o[GPL];
#pragma unroll
  for (int j = 0; j < GPL; ++j) o[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* qr = q_s + row * D;
  float* pr = p_s + row * (TK + 1);
  for (int it = t_lo; it < t_hi; ++it) {
    const int buf = nbuf == 2 ? (it - t_lo) & 1 : 0;
    if (nbuf == 1 && it > t_lo) load_tile(it, 0);
    if (nbuf == 2 && it + 1 < t_hi) {
      load_tile(it + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // scores of this lane's row against keys kg + 8 i
    const float* kt = k_s + buf * TK * KS;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(kt + (kg + 8 * i) * KS + d);
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }
    // mask, then the online softmax over the row's 8 lanes
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = it * TK + kg + 8 * i;
      if (!(live && s <= qpos && s < S)) sc[i] = NEG_INF;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(sc[i] - m_new);
      pr[kg + 8 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();
    // o = o * corr + p . V over this lane's column groups kg + 8 j
    const float* vt = v_s + buf * TK * D;
#pragma unroll
    for (int j = 0; j < GPL; ++j) {
      o[j].x *= corr;
      o[j].y *= corr;
      o[j].z *= corr;
      o[j].w *= corr;
    }
    for (int t = 0; t < TK; ++t) {
      const float p = pr[t];
#pragma unroll
      for (int j = 0; j < GPL; ++j) {
        const int gi = kg + 8 * j;
        if (gi < D4) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vt + t * D + 4 * gi);
          o[j].x = fmaf(p, vv.x, o[j].x);
          o[j].y = fmaf(p, vv.y, o[j].y);
          o[j].z = fmaf(p, vv.z, o[j].z);
          o[j].w = fmaf(p, vv.w, o[j].w);
        }
      }
    }
    __syncthreads();  // the next load overwrites this buffer
  }
  __syncthreads();    // every lane's queries read (q_s is reused)

  if (split == 1) {
    if (!live) return;
    const int r = r0 + row;
    float4* orow = reinterpret_cast<float4*>(
        out + ((size_t)(r / G) * H + h * G + r % G) * D);
    const float dl = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < GPL; ++j) {
      const int gi = kg + 8 * j;
      if (gi < D4)
        orow[gi] = make_float4(o[j].x / dl, o[j].y / dl, o[j].z / dl,
                               o[j].w / dl);
    }
    return;
  }
  // the rank's partial into its own memory, then the rank-order combine
#pragma unroll
  for (int j = 0; j < GPL; ++j) {
    const int gi = kg + 8 * j;
    if (gi < D4) reinterpret_cast<float4*>(q_s + row * D)[gi] = o[j];
  }
  if (kg == 0) {
    m_s[row] = m;
    l_s[row] = l;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int part = (QR + split - 1) / split;
  const int rb = min(QR, rank * part), re = min(QR, rb + part);
  for (int rr = rb + tid; rr < re; rr += NT) {
    float M = NEG_INF;
    for (int src = 0; src < split; ++src)
      M = fmaxf(M, cluster.map_shared_rank(m_s, src)[rr]);
    float L = 0.f;
    for (int src = 0; src < split; ++src) {
      const float f = expf(cluster.map_shared_rank(m_s, src)[rr] - M);
      f_s[rr * split + src] = f;
      L = fmaf(cluster.map_shared_rank(l_s, src)[rr], f, L);
    }
    L_s[rr] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < (re - rb) * D4; i += NT) {
    const int rr = rb + i / D4, gi = i % D4, r = r0 + rr;
    if (r >= rows) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < split; ++src) {
      const float f = f_s[rr * split + src];
      const float4 ov = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(q_s, src) + rr * D)[gi];
      acc.x = fmaf(ov.x, f, acc.x);
      acc.y = fmaf(ov.y, f, acc.y);
      acc.z = fmaf(ov.z, f, acc.z);
      acc.w = fmaf(ov.w, f, acc.w);
    }
    const float dl = L_s[rr];
    reinterpret_cast<float4*>(
        out + ((size_t)(r / G) * H + h * G + r % G) * D)[gi] =
        make_float4(acc.x / dl, acc.y / dl, acc.z / dl, acc.w / dl);
  }
  cluster.sync();  // no block leaves while its memory is read
}

// blocks [0, n_attn): attention, cluster rank = block % split, (kv head,
// row tile) = block / split; blocks past it: page writes, (tile, head)
// with the head fastest, the padding blocks of the last cluster idle.
template <int GPL>
__global__ void __launch_bounds__(256)
prefill_attn_kernel(const float* __restrict__ q,
                    const float* __restrict__ sk,
                    const float* __restrict__ sv,
                    const int* __restrict__ positions,
                    const int* __restrict__ bt, void* kd, void* vd,
                    float* ks, float* vs, float* __restrict__ out, int C,
                    int S, int Hkv, int G, int D, int ps, int P, int kind,
                    float qscale, int n_attn, int n_rt, int split, int tpr,
                    int nbuf) {
  const int blk = blockIdx.x;
  if (blk < n_attn) {
    const int pair = blk / split, qr = 4 * (blockDim.x >> 5);
    attend_rows<GPL>(q, sk, sv, positions[0], out, pair / n_rt,
                     (pair % n_rt) * qr, blk % split, split, tpr, nbuf, C,
                     S, Hkv, G, D, qscale);
  } else {
    const int w = blk - n_attn;           // (tile, head), head fastest
    if (w < Hkv * (S / ps))
      write_tile(sk, sv, bt, kd, vd, ks, vs, kind, w / Hkv, w % Hkv, Hkv,
                 D, ps, P);
  }
}

template <int GPL>
int launch_gpl(const float* q, const float* sk, const float* sv,
               const int* pi, const int* bi, void* kd, void* vd, float* ks,
               float* vs, float* out, int C, int S, int Hkv, int G, int D,
               int ps, int P, int kind, float qscale, int warps, int n_rt,
               int split, int tpr, int nbuf, int smem, int halves,
               cudaStream_t st) {
  auto kern = prefill_attn_kernel<GPL>;
  // raise this instantiation's dynamic shared memory cap once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr_err != cudaSuccess) return (int)attr_err;
  const int n_attn = halves & 1 ? Hkv * n_rt * split : 0;
  const int n_write =
      halves & 2 ? (Hkv * (S / ps) + split - 1) / split * split : 0;
  if (n_attn + n_write == 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_attn + n_write, 1, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, q, sk, sv, pi, bi, kd, vd, ks, vs, out, C, S, Hkv, G, D,
      ps, P, kind, qscale, n_attn, n_rt, split, tpr, nbuf);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// q (C, H, D) f32 with H = Hkv * G (batch 1); stage sk/sv (S, Hkv, D) f32;
// positions (C,) i32, only positions[0] read; bt (>= S / ps,) i32, the
// request's block-table row; pools, written in place: kind 0 (packed)
// kd/vd (P, ps, Hkv, D/2) u8 and ks/vs (P, ps, Hkv) f32, kind 1/2/3 (fp)
// kd/vd (P, ps, Hkv, D) in f32 / bf16 / fp16 (ks/vs unused); out (C, H,
// D) f32. qscale = float32(sqrt(D)). The plan (prefill_plan): `warps`
// warps a block (query rows 4 x warps), n_rt row tiles a kv head, a key
// split of `split` blocks (1, 2, 4, 8) of tpr key tiles each, nbuf tile
// buffers (2 when tpr > 1), smem dynamic shared bytes (at least
// smem_bytes). halves: 1 attention blocks only, 2 write blocks only, 3
// both (the served call; the others time each half alone). Needs D % 8
// == 0, D <= 256, S % ps == 0. Returns the launch's cudaError_t.
extern "C" int prefill_attn_launch(const void* q, const void* sk,
                                   const void* sv, const void* positions,
                                   const void* bt, void* kd, void* vd,
                                   void* ks, void* vs, void* out, int C,
                                   int S, int Hkv, int G, int D, int ps,
                                   int P, int kind, float qscale, int warps,
                                   int n_rt, int split, int tpr, int nbuf,
                                   int smem, int halves, void* stream) {
  const int qr = 4 * warps;
  if (warps < 1 || warps > 8 || D < 8 || D % 8 || D > DMAX || ps < 1 ||
      S % ps || n_rt * qr < C * G || split < 1 || split > 8 ||
      (split & (split - 1)) || (long long)split * tpr * TK < S ||
      nbuf < 1 || nbuf > 2 || (tpr > 1 && nbuf < 2) || smem > SMEM_MAX ||
      smem < smem_bytes(qr, D, nbuf, split) || kind < KV_PACKED ||
      kind > KV_F16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* skf = static_cast<const float*>(sk);
  const float* svf = static_cast<const float*>(sv);
  const int* pi = static_cast<const int*>(positions);
  const int* bi = static_cast<const int*>(bt);
  float* ksf = static_cast<float*>(ks);
  float* vsf = static_cast<float*>(vs);
  float* of = static_cast<float*>(out);
  const int gpl = (D / 4 + 7) / 8;
#define PREFILL_GPL(N)                                                     \
  if (gpl <= N)                                                            \
    return launch_gpl<N>(qf, skf, svf, pi, bi, kd, vd, ksf, vsf, of, C, S, \
                         Hkv, G, D, ps, P, kind, qscale, warps, n_rt,      \
                         split, tpr, nbuf, smem, halves, st);
  PREFILL_GPL(1)
  PREFILL_GPL(2)
  PREFILL_GPL(4)
  PREFILL_GPL(8)
#undef PREFILL_GPL
  return (int)cudaErrorInvalidValue;
}
