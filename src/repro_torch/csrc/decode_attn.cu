// Decode attention for Hopper (sm_90a), fp32 on the CUDA cores: the slab
// kernel (K2) and the paged kernel (K3) are one body, templated on how a
// logical token row is addressed.
//
// K2 replaces the TPU kernel src/repro/kernels/decode_attn.py:358
// (_decode_attn_call -> pallas_call at :384 packed, :393 fp; bodies
// _decode_attn_kernel_packed :308 and _decode_attn_kernel_fp :336, with
// _online_softmax_step :247, _tile_mask :268 and _scores :284).
// K3 replaces src/repro/kernels/decode_attn.py:404
// (_paged_decode_attn_call -> pallas_call at :452), the same bodies with
// kv tile j read from physical page block_table[b, j].
//
// Single-token GQA attention of q (B, H, D) against a KV cache, either
// OVP-packed int4 nibbles (rows, Hkv, D/2) u8 with per-(token, head) f32
// scales (rows, Hkv), or an fp cache (rows, Hkv, D) in f32, bf16 or fp16:
//   s = (q / sqrt(D)) . k_codes * k_scl, masked from pos (length, ring,
//   sliding window, padded tail) to -1e30, online softmax in fp32,
//   o += (p * v_scl) . v_codes, out = o / max(l, 1e-30).
// Slab (K2): logical token s of batch row b is cache row b * S + s.
// Paged (K3): the cache is a pool of P pages of ps rows and token s of
// row b is pool row bt[b, s / ps] * ps + s % ps. There is no scalar
// prefetch on the GPU: each block reads its own table entries while it
// loads a tile (the table is 64 bytes per row on the serving path). The
// tile size stays 32 logical tokens whatever the page size, and the
// decode, score, softmax and PV arithmetic is shared verbatim, so K3 on a
// pool is bit-identical to K2 on the same tokens laid out as a slab, for
// any even page size. Table entries are clamped into [0, P) so a
// malformed table can never read outside the pool; parked engine rows
// (all-zero table rows, pos = s_len) attend over page 0 and are thrown
// away by the caller.
//
// The output is written in the natural (B, 1, H, D) layout; the TPU
// kernel's even/odd plane layout is not needed here.
//
// Launch shape: one block of 128 threads per (batch row, kv head), so the
// G query heads of a group share each decoded K/V tile. The block loops
// over S in tiles of 32 tokens: the packed bytes are read as 32-bit words
// (fp caches as 16-byte vectors) and decoded into shared memory (K rows
// padded to D+1 floats so the per-token dot products are bank-conflict
// free), one thread scores each (query head, token), one warp per query
// head runs the online-softmax update with shuffles, and one thread per
// (query head, lane) accumulates p . V. On the serving path (B = 4 slots,
// S = max_len = 256, Hkv = 16, G = 1, D = 64; paged: 16 pages of 16 rows
// per slot) that is 64 blocks of 8 tiles each.
//
// Layouts: any G (H % Hkv == 0) and any D % 8 == 0 whose tiles fit one
// block's shared memory, which is sized from the call's (G, D) at launch
// (dynamic shared memory; 101 KB at G 16, D 256, above the 48 KB static
// cap, so each instantiation raises its cap once); fp caches in f32,
// bf16 or fp16, converted to f32 as they load (the plain version's
// .to(float32)). kernels/decode_attn.py::kernel_layout computes the same
// bytes and refuses what does not fit.
//
// What bounds it on the H100: the packed cache of one layer is 0.3 MB per
// step (K and V nibbles plus scales), which 3.35 TB/s reads in about
// 0.1 us, so the kernel is bound by launch latency and the serial
// per-tile chain (load, decode, barrier, score, barrier, softmax,
// barrier, PV) inside each block, not by bytes. Splitting S across
// blocks (flash-decoding) and overlapping tile loads are later work.
//
// Tolerance against the plain version (kernels/decode_attn.py,
// decode_attention_plain, which gathers a paged cache into a slab first):
// decoded codes are exact; the dot products, the exp and the tile-wise
// softmax rescaling differ from the dense softmax only in fp32 rounding
// order, so atol 1e-5 on outputs whose values are O(1). K3 against K2 on
// the same tokens: bit-identical (torch.equal).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 32;     // kv tokens per tile (one per warp lane)
constexpr int NT = 128;    // threads per block
constexpr int SMEM_MAX = 232448;  // 227 KB, a block's opt-in cap
constexpr float NEG_INF = -1e30f;

// cache layouts: OVP-packed nibbles, or fp in one of three dtypes
enum { KV_PACKED = 0, KV_F32 = 1, KV_BF16 = 2, KV_F16 = 3 };

// one block's dynamic shared memory (floats), in this order: v_s [TS][D],
// k_s [TS][D + 1], q_s [G][D], o_s [G][D], p_s [G][TS], m_s, l_s, corr_s
// [G], kscl_s, vscl_s [TS]; kernel_layout in kernels/decode_attn.py
// computes the same sum
inline int smem_bytes(int G, int D) {
  return 4 * (TS * D + TS * (D + 1) + 2 * G * D + G * TS + 3 * G + 2 * TS);
}

// 8 consecutive 16-bit fp values -> f32
template <int KIND>
__device__ __forceinline__ void load8(const uint4 x, float* y) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f;
    if (KIND == KV_BF16)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    else
      f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    y[2 * i] = f.x;
    y[2 * i + 1] = f.y;
  }
}

// Slab: logical token s of batch row b is cache row b * S + s.
struct SlabRows {
  int S;
  __device__ __forceinline__ size_t operator()(int b, int s) const {
    return (size_t)b * S + s;
  }
};

// Paged: token s of batch row b is row s % ps of page bt[b, s / ps] of a
// pool of P pages (bt is (B, n) int32; entries are clamped into [0, P)).
struct PagedRows {
  const int* bt;
  int n, ps, P;
  __device__ __forceinline__ size_t operator()(int b, int s) const {
    const int page = min(max(bt[(size_t)b * n + s / ps], 0), P - 1);
    return (size_t)page * ps + s % ps;
  }
};

// int4 OVP pair decode with the E2M1 bias-2 outlier format
__device__ __forceinline__ float dec_int4(int c, int neighbour) {
  if (neighbour == 8) {  // I am the outlier
    const int bits = c & 7;
    const int mag = (2 + (bits & 1)) << ((bits >> 1) + 2);
    const float v = (c & 8) ? -(float)mag : (float)mag;
    return bits == 0 ? 0.f : v;
  }
  if (c == 8) return 0.f;  // I am the victim
  return (float)(c >= 8 ? c - 16 : c);
}

// S is the logical cache length (the slab length, or s_len = ring or
// n * ps for a pool); rows(b, s) addresses token s of batch row b. DC is
// the head dim when it is one of the served ones (64, 128), so that the
// unrolled loops' shared-memory strides are constants, else 0 (D_rt).
template <int KIND, class Rows, int DC>
__global__ void __launch_bounds__(NT)
decode_attn_kernel(const float* __restrict__ q, const void* __restrict__ kd,
                   const void* __restrict__ vd, const float* __restrict__ ks,
                   const float* __restrict__ vs, const int* __restrict__ pos,
                   float* __restrict__ out, Rows rows, int S, int Hkv, int G,
                   int D_rt, float qscale, int window, int ring) {
  constexpr bool PACKED = KIND == KV_PACKED;
  const int D = DC ? DC : D_rt;
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;                       // [TS][D], float4 rows
  float* k_s = v_s + TS * D;               // [TS][D + 1]
  float* q_s = k_s + TS * (D + 1);         // [G][D]
  float* o_s = q_s + G * D;                // [G * D]
  float* p_s = o_s + G * D;                // [G][TS]
  float* m_s = p_s + G * TS;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  float* kscl_s = corr_s + G;              // [TS]
  float* vscl_s = kscl_s + TS;             // [TS]
  const int DK = D + 1;                    // k_s row stride

  const int b = blockIdx.x / Hkv, h = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = Hkv * G;
  const int p_cur = pos[b];

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    q_s[g * D + d] = q[((size_t)b * H + h * G + g) * D + d] / qscale;
    o_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += TS) {
    // ---- stage: decode one tile of K and V into shared memory ---------
    if (PACKED) {
      const int W = D / 8;  // 32-bit words per token row (D/2 bytes)
      const uint32_t* kw = static_cast<const uint32_t*>(kd);
      const uint32_t* vw = static_cast<const uint32_t*>(vd);
      for (int i = tid; i < TS * W; i += NT) {
        const int t = i / W, wi = i % W, s = t0 + t;
        uint32_t kx = 0u, vx = 0u;
        if (s < S) {
          const size_t off = (rows(b, s) * Hkv + h) * W + wi;
          kx = kw[off];
          vx = vw[off];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kb = (kx >> (8 * j)) & 0xFF, vb = (vx >> (8 * j)) & 0xFF;
          const int d = 8 * wi + 2 * j;  // byte 4*wi+j holds pair d, d+1
          k_s[t * DK + d] = dec_int4(kb >> 4, kb & 15);
          k_s[t * DK + d + 1] = dec_int4(kb & 15, kb >> 4);
          v_s[t * D + d] = dec_int4(vb >> 4, vb & 15);
          v_s[t * D + d + 1] = dec_int4(vb & 15, vb >> 4);
        }
      }
      for (int t = tid; t < TS; t += NT) {
        const int s = t0 + t;
        const size_t off = s < S ? rows(b, s) * Hkv + h : 0;
        kscl_s[t] = s < S ? ks[off] : 1.f;
        vscl_s[t] = s < S ? vs[off] : 1.f;
      }
    } else if (KIND == KV_F32) {
      const int W = D / 4;  // float4 per token row
      const float4* kf = static_cast<const float4*>(kd);
      const float4* vf = static_cast<const float4*>(vd);
      for (int i = tid; i < TS * W; i += NT) {
        const int t = i / W, wi = i % W, s = t0 + t;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (s < S) {
          const size_t off = (rows(b, s) * Hkv + h) * W + wi;
          kx = kf[off];
          vx = vf[off];
        }
        const int d = 4 * wi;
        k_s[t * DK + d] = kx.x;
        k_s[t * DK + d + 1] = kx.y;
        k_s[t * DK + d + 2] = kx.z;
        k_s[t * DK + d + 3] = kx.w;
        *reinterpret_cast<float4*>(&v_s[t * D + d]) = vx;
      }
    } else {
      const int W = D / 8;  // 16-byte vectors of 8 values per token row
      const uint4* kh = static_cast<const uint4*>(kd);
      const uint4* vh = static_cast<const uint4*>(vd);
      for (int i = tid; i < TS * W; i += NT) {
        const int t = i / W, wi = i % W, s = t0 + t;
        uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
        if (s < S) {
          const size_t off = (rows(b, s) * Hkv + h) * W + wi;
          kx = kh[off];
          vx = vh[off];
        }
        float kf[8], vf[8];
        load8<KIND>(kx, kf);
        load8<KIND>(vx, vf);
        const int d = 8 * wi;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          k_s[t * DK + d + j] = kf[j];
          v_s[t * D + d + j] = vf[j];
        }
      }
    }
    __syncthreads();

    // ---- scores, scale fold and in-kernel mask ------------------------
    for (int i = tid; i < G * TS; i += NT) {
      const int g = i / TS, t = i % TS, s = t0 + t;
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc = fmaf(q_s[g * D + d], k_s[t * DK + d], acc);
      if (PACKED) acc *= kscl_s[t];
      int abs_pos;
      bool valid;
      if (ring) {
        int r = (p_cur - s) % ring;
        if (r < 0) r += ring;
        abs_pos = p_cur - r;
        valid = abs_pos >= 0;
      } else {
        abs_pos = s;
        valid = s <= p_cur;
      }
      valid = valid && s < S;
      if (window) valid = valid && abs_pos > p_cur - window && abs_pos <= p_cur;
      p_s[g * TS + t] = valid ? acc : NEG_INF;
    }
    __syncthreads();

    // ---- online softmax: one warp per query head, one token per lane --
    for (int g = warp; g < G; g += NT / 32) {
      const float m_prev = m_s[g];
      const float sv = p_s[g * TS + lane];
      float mx = sv;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_prev, mx);
      float p = expf(sv - m_new);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_prev - m_new);
      if (PACKED) p *= vscl_s[lane];
      p_s[g * TS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // ---- o = o * corr + p . V -----------------------------------------
    for (int i = tid; i < G * D; i += NT) {
      const int g = i / D, d = i % D;
      float acc = 0.f;
      for (int t = 0; t < TS; ++t)
        acc = fmaf(p_s[g * TS + t], v_s[t * D + d], acc);
      o_s[i] = o_s[i] * corr_s[g] + acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    out[((size_t)b * H + h * G + g) * D + d] = o_s[i] / fmaxf(l_s[g], 1e-30f);
  }
}

template <int KIND, class Rows, int DC>
int launch_kind(const float* q, const void* kd, const void* vd,
                const float* ks, const float* vs, const int* pos, float* out,
                Rows rows, int B, int S, int Hkv, int G, int D, float qscale,
                int window, int ring, cudaStream_t st) {
  auto kern = decode_attn_kernel<KIND, Rows, DC>;
  // raise this instantiation's dynamic shared memory cap once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr_err != cudaSuccess) return (int)attr_err;
  kern<<<B * Hkv, NT, smem_bytes(G, D), st>>>(q, kd, vd, ks, vs, pos, out,
                                              rows, S, Hkv, G, D, qscale,
                                              window, ring);
  return (int)cudaGetLastError();
}

template <class Rows>
int launch(const void* q, const void* kd, const void* vd, const void* ks,
           const void* vs, const void* pos, void* out, Rows rows, int B,
           int S, int Hkv, int G, int D, int kind, float qscale, int window,
           int ring, void* stream) {
  if (G < 1 || D < 8 || D % 8 || smem_bytes(G, D) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* pi = static_cast<const int*>(pos);
  float* of = static_cast<float*>(out);
#define DECODE_ATTN_KIND(K)                                                \
  case K:                                                                  \
    return D == 64 ? launch_kind<K, Rows, 64>(qf, kd, vd, ksf, vsf, pi, of, \
                                              rows, B, S, Hkv, G, D,        \
                                              qscale, window, ring, st)     \
           : D == 128                                                      \
               ? launch_kind<K, Rows, 128>(qf, kd, vd, ksf, vsf, pi, of,   \
                                           rows, B, S, Hkv, G, D, qscale,  \
                                           window, ring, st)               \
               : launch_kind<K, Rows, 0>(qf, kd, vd, ksf, vsf, pi, of,     \
                                         rows, B, S, Hkv, G, D, qscale,    \
                                         window, ring, st);
  switch (kind) {
    DECODE_ATTN_KIND(KV_PACKED)
    DECODE_ATTN_KIND(KV_F32)
    DECODE_ATTN_KIND(KV_BF16)
    DECODE_ATTN_KIND(KV_F16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_ATTN_KIND
}

}  // namespace

// K2. q (B, H, D) f32 with H = Hkv * G; kind 0 (packed): kd/vd (B, S,
// Hkv, D/2) u8 and ks/vs (B, S, Hkv) f32; kind 1/2/3 (fp): kd/vd (B, S,
// Hkv, D) in f32 / bf16 / fp16 (ks/vs unused); pos (B,) i32; out (B, H,
// D) f32. Needs D % 8 == 0 and smem_bytes(G, D) <= 227 KB. qscale =
// float32(sqrt(D)). Returns the launch's cudaError_t.
extern "C" int decode_attn_launch(const void* q, const void* kd,
                                  const void* vd, const void* ks,
                                  const void* vs, const void* pos, void* out,
                                  int B, int S, int Hkv, int G, int D,
                                  int kind, float qscale, int window,
                                  int ring, void* stream) {
  return launch(q, kd, vd, ks, vs, pos, out, SlabRows{S}, B, S, Hkv, G, D,
                kind, qscale, window, ring, stream);
}

// K3. As K2, over pools: packed kd/vd (P, ps, Hkv, D/2) u8 and ks/vs
// (P, ps, Hkv) f32, or fp kd/vd (P, ps, Hkv, D); bt (B, n) i32; S is
// s_len (ring, or n * ps), at most n * ps. Returns the launch's
// cudaError_t.
extern "C" int paged_decode_attn_launch(const void* q, const void* kd,
                                        const void* vd, const void* ks,
                                        const void* vs, const void* pos,
                                        const void* bt, void* out, int B,
                                        int S, int Hkv, int G, int D, int n,
                                        int ps, int P, int kind,
                                        float qscale, int window, int ring,
                                        void* stream) {
  const PagedRows rows{static_cast<const int*>(bt), n, ps, P};
  return launch(q, kd, vd, ks, vs, pos, out, rows, B, S, Hkv, G, D, kind,
                qscale, window, ring, stream);
}
