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
//   sliding window) to -1e30, online softmax in fp32,
//   o += (p * v_scl) . v_codes, out = o / max(l, 1e-30).
// Slab (K2): logical token s of batch row b is cache row b * S + s.
// Paged (K3): the cache is a pool of P pages of ps rows and token s of
// row b is pool row bt[b, s / ps] * ps + s % ps (entries clamped into
// [0, P), so a malformed table never reads outside the pool; parked
// engine rows, all-zero table rows at pos = s_len, attend over page 0
// and are thrown away by the caller). The tile size is 32 logical tokens
// whatever the page size, the split and the live range depend on the
// logical length S alone, and the arithmetic is shared verbatim, so K3
// on a pool is bit-identical to K2 on the same tokens laid out as a slab.
//
// What bounds it on the H100: latency. One layer's packed cache at the
// serving shapes (B 4, S 256) is under 0.3 MB, which 3.35 TB/s reads in
// 0.1 us; the FLOPs are a few microseconds of one SM at most. The first
// port (one 128-thread block per (row, kv head): 64 blocks at Qwen1.5's
// shape, 16 at Qwen3's, 4 at G 16 / D 256; every block walking all of S
// whatever pos is; per tile synchronous loads, a decode and four
// barriers, a D-long dependent FMA chain per score) took 25-250 us.
// The design:
//
// * the keys split over a thread-block cluster of `split` blocks (1, 2, 4
//   or 8; kernels/decode_attn.py::decode_plan picks it from the shapes
//   alone: the smallest power of two that puts 132 blocks on the card).
//   Each rank reads pos[b] on the card, computes the row's live tiles
//   (those that can hold a valid slot: 0 .. pos / 32, bounded below by a
//   window, all of S under a ring once pos >= ring - 1) and walks its
//   contiguous share of them, keeping a partial (m, l, o) in its shared
//   memory. After one cluster barrier the ranks combine through
//   distributed shared memory in rank order 0..split-1, every rank's
//   (m, l, o) requested at once: M = max m_r, L = sum l_r exp(m_r - M),
//   o = sum o_r exp(m_r - M), out = o / max(L, 1e-30). Deterministic, no
//   atomics, one launch and no host sync: the grid is fixed by the
//   shapes, so a CUDA graph can capture it. A rank with no live tile
//   keeps m = -1e30, l = 0, o = 0 and weighs exactly 0; where rank 0
//   holds every live tile (a row shorter than one share, the common case
//   in served traffic) the others leave at once and rank 0 writes o / l
//   itself with no cluster barrier, which is the combine's value exactly.
//   A row whose every slot is masked walks all of S instead, where the
//   plain version averages V uniformly (m = -1e30, every p = 1); slots
//   past S (the zero-filled tail of the last tile) get p = 0, as the
//   plain version has no such slots. The per-token mask is the plain
//   version's, so skipping a fully masked tile changes nothing;
// * the raw tile bytes (packed nibbles and scales, or fp rows) stream
//   into shared memory with cp.async, zero-filled past S, double
//   buffered where a rank can walk more than one tile (the next tile
//   lands while this one is decoded and used). Packed codes decode
//   through a 256-entry byte table (half2, exact for every int4 OVP
//   code) in 16 copies, so a warp's lookups spread over the banks; with
//   the branchy arithmetic decode a packed tile cost about twice a bf16
//   one on the H100;
// * every warp works at every G. G >= 3: a warp owns query rows (w, w +
//   4, ...), one token per lane: the score is a float4 dot product with
//   four independent accumulators, two rows at a time sharing each K
//   load, and the row's online softmax stays in the warp (shuffles), so
//   the scores need no block barrier; the warp's PV splits the columns
//   over lanes (and the 32 tokens over up to 8 lanes with a shuffle sum
//   where D / 4 < 32), two rows sharing each V load. G 1 and 2: 4 / G
//   warps share a row: each scores 32 / (4 / G) tokens with 4 / G lanes
//   a token (a shuffle sum), one barrier, then every warp of the row runs
//   the same softmax and takes 1 / (4 / G) of the PV columns. K and V
//   rows are padded so that a quarter-warp's 16-byte loads hit distinct
//   banks. Barriers a tile: tile landed, decode done (packed and 16-bit
//   caches), scores exchanged (G 1, 2);
// * decoded codes stay exact and everything accumulates in fp32 on the
//   CUDA cores; tensor cores would not help a latency-bound call.
//
// Launch (kernels/decode_attn.py::decode_plan computes it): B x Hkv x
// split blocks of 128 threads, cluster rank fastest, clusters of split
// blocks. Serving paths (B 4, S 256): Qwen1.5-0.5B (Hkv 16, G 1, D 64)
// split 4, 256 blocks, two tiles a rank at most; Qwen3-30B-A3B (Hkv 4,
// G 8, D 128) split 8, 128 blocks, one tile a rank.
//
// Layouts: any G (H % Hkv == 0) and any D % 8 == 0 whose tiles fit one
// block's shared memory, sized from (G, D, cache kind, buffers) at
// launch (dynamic shared memory, up to 227 KB; each instantiation raises
// its cap once); fp caches in f32, bf16 or fp16, converted to f32 as
// they are decoded (the plain version's .to(float32)); compile-time
// strides for the served head dims 64 and 128. decode_plan computes the
// same bytes (smem_bytes below) and refuses what does not fit.
//
// Tolerance against the plain version (kernels/decode_attn.py,
// decode_attention_plain, which gathers a paged cache into a slab first):
// decoded codes are exact; the dot products, the exp, the tile-wise
// softmax rescaling and the rank combine differ from the dense softmax
// only in fp32 rounding order, so atol 1e-5 on outputs whose values are
// O(1). K3 against K2 on the same tokens: bit-identical (torch.equal).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TS = 32;     // kv tokens per tile (one per warp lane)
constexpr int NT = 128;    // threads per block
constexpr int NW = NT / 32;
constexpr int SMEM_MAX = 232448;  // 227 KB, a block's opt-in cap
constexpr int SPLIT_MAX = 8;      // cluster ranks (portable cluster size)
// copies of the packed byte table: lane l reads copy l % 16, so a warp's
// 32-bit lookups hit at most two lanes a bank
constexpr int TAB_COPIES = 16;
constexpr float NEG_INF = -1e30f;

// cache layouts: OVP-packed nibbles, or fp in one of three dtypes
enum { KV_PACKED = 0, KV_F32 = 1, KV_BF16 = 2, KV_F16 = 3 };

// How a block's warps share the work (decode_plan mirrors it):
// wpr warps per query row (4 / G for G 1, 2; else 1, a warp owning rows);
// K tile rows padded to ks floats (the wpr lanes of a token read
// neighbouring float4 columns); a warp's PV covers ncol float4 columns
// with tsp lanes splitting the 32 tokens of each, V rows padded to vs.
struct Geom {
  int wpr, ks, ncol, tsp, vs;
};

__host__ __device__ inline Geom geom(int G, int D) {
  Geom g;
  g.wpr = G == 1 ? 4 : (G == 2 ? 2 : 1);
  g.ks = D + 4 * g.wpr;
  g.ncol = (D / 4 + g.wpr - 1) / g.wpr;
  g.tsp = 1;
  while (g.tsp < 8 && 2 * g.tsp * g.ncol <= 32) g.tsp *= 2;
  g.vs = D + (g.tsp > 1 ? 32 / g.tsp : 0);
  return g;
}

// raw bytes of one tile buffer: packed K and V nibbles [TS][D/2] and K, V
// scales [TS]; f32 K [TS][ks] and V [TS][vs] (used in place); 16-bit K
// and V [TS][D]
__host__ __device__ inline int raw_bytes(int kind, int D, const Geom& g) {
  if (kind == KV_PACKED) return TS * D + 8 * TS;
  if (kind == KV_F32) return 4 * TS * (g.ks + g.vs);
  return 4 * TS * D;
}

// one block's dynamic shared memory, in this order: nbuf raw tile
// buffers; the decoded f32 tiles k_s [TS][ks], v_s [TS][vs] (not for f32
// caches); q_s [G][D]; o_s [G][D] (the rank's partial o); p_s [G * wpr]
// [TS] (a warp's probabilities); sc_s [G][TS] (scores, wpr > 1 only);
// the packed byte table [256][TAB_COPIES] half2 (packed caches only);
// m_s, l_s [G * wpr]. decode_plan in kernels/decode_attn.py computes the
// same sum.
inline int smem_bytes(int G, int D, int kind, int nbuf) {
  const Geom g = geom(G, D);
  const int dec = kind == KV_F32 ? 0 : 4 * TS * (g.ks + g.vs);
  const int tab = kind == KV_PACKED ? 4 * 256 * TAB_COPIES : 0;
  return nbuf * raw_bytes(kind, D, g) + dec + tab +
         4 * (2 * G * D + G * g.wpr * TS + (g.wpr > 1 ? G * TS : 0) +
              2 * G * g.wpr);
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

// the byte table: entry b (a packed pair, even value in the high nibble)
// holds the pair's two decoded codes as half2 (every int4 OVP code, the
// outliers up to 96 included, is exact in fp16), in TAB_COPIES copies at
// b * TAB_COPIES + copy; the copies are written in a rotated order so a
// warp's stores spread over the banks
__device__ __forceinline__ void build_table(__half2* tab) {
  for (int b = threadIdx.x; b < 256; b += NT) {
    const __half2 v = __floats2half2_rn(dec_int4(b >> 4, b & 15),
                                        dec_int4(b & 15, b >> 4));
    for (int c = 0; c < TAB_COPIES; ++c)
      tab[b * TAB_COPIES + ((c + b) & (TAB_COPIES - 1))] = v;
  }
}

// 8 values (a packed 32-bit word of 4 pairs) -> two float4 at y; `tab`
// is this lane's copy of the byte table
__device__ __forceinline__ void dec_packed_word(uint32_t x,
                                                const __half2* tab,
                                                float* y) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // byte j holds pair 2j, 2j+1
    const float2 f = __half22float2(tab[((x >> (8 * j)) & 0xFF) *
                                        TAB_COPIES]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int KIND>
__device__ __forceinline__ void dec_fp16x8(const uint4 x, float* y) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f;
    if (KIND == KV_BF16)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    else
      f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
  reinterpret_cast<float4*>(y)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(y)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// CB bytes to shared memory, zero-filled when bytes == 0
template <int CB>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(CB), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4 v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

__device__ __forceinline__ void dot4(float4& a, const float4 q,
                                     const float4 k) {
  a.x = fmaf(q.x, k.x, a.x);
  a.y = fmaf(q.y, k.y, a.y);
  a.z = fmaf(q.z, k.z, a.z);
  a.w = fmaf(q.w, k.w, a.w);
}

__device__ __forceinline__ float hsum(const float4 a) {
  return (a.x + a.y) + (a.z + a.w);
}

// The tiles [t_lo, t_hi) of a row at position p that can hold a valid
// slot (decode_plan's live_tiles mirrors it). With no valid slot at all,
// every tile: the plain version then averages V over all S slots.
__device__ __forceinline__ void live_tiles(int p, int S, int window,
                                           int ring, int& t_lo, int& t_hi) {
  int lo = 0, hi = min(p, S - 1);
  if (window) lo = max(p - window + 1, 0);
  if (ring && (p >= ring - 1 || S > ring)) {
    lo = 0;
    hi = S - 1;
  }
  if (lo > hi) {
    lo = 0;
    hi = S - 1;
  }
  t_lo = lo / TS;
  t_hi = hi / TS + 1;
}

// One warp's online-softmax step of row slot `idx` (row g's copy of the
// warp) at this lane's token: masked score sc, live = the slot exists
// (s < S). Writes p (times the V scale) to p_s[idx], updates m_s/l_s and
// returns the rescale factor of the row's o.
template <bool PACKED>
__device__ __forceinline__ float softmax_row(float sc, bool live, float vscl,
                                             float* p_s, float* m_s,
                                             float* l_s, int idx, int lane) {
  const float m_prev = m_s[idx];
  const float m_new = fmaxf(m_prev, warp_max(sc));
  float p = live ? expf(sc - m_new) : 0.f;
  const float sum = warp_sum(p);
  const float corr = expf(m_prev - m_new);
  const float l_new = l_s[idx] * corr + sum;
  if (PACKED) p *= vscl;
  p_s[idx * TS + lane] = p;
  __syncwarp();
  if (lane == 0) {
    m_s[idx] = m_new;
    l_s[idx] = l_new;
  }
  __syncwarp();
  return corr;
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
                   int D_rt, float qscale, int window, int ring, int split,
                   int nbuf) {
  constexpr bool PACKED = KIND == KV_PACKED;
  const int D = DC ? DC : D_rt;
  const int D4 = D / 4;
  const Geom geo = geom(G, D);
  const int KS = geo.ks, VS = geo.vs, wpr = geo.wpr;
  const int rawb = raw_bytes(KIND, D, geo);
  extern __shared__ __align__(16) float smem[];
  char* raw = reinterpret_cast<char*>(smem);
  float* k_s = reinterpret_cast<float*>(raw + nbuf * rawb);  // [TS][KS]
  float* v_s = k_s + TS * KS;                                // [TS][VS]
  float* q_s = KIND == KV_F32 ? k_s : v_s + TS * VS;         // [G][D]
  float* o_s = q_s + G * D;                                  // [G][D]
  float* p_s = o_s + G * D;                    // [G * wpr][TS]
  float* sc_s = p_s + G * wpr * TS;            // [G][TS] (wpr > 1)
  __half2* tab = reinterpret_cast<__half2*>(sc_s + (wpr > 1 ? G * TS : 0));
  float* m_s = reinterpret_cast<float*>(tab + (PACKED ? 256 * TAB_COPIES
                                                      : 0));  // [G * wpr]
  float* l_s = m_s + G * wpr;                                  // [G * wpr]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % split, pair = blockIdx.x / split;
  const int b = pair / Hkv, h = pair % Hkv, H = Hkv * G;
  const int p_cur = pos[b];

  auto load_tile = [&](int tile, int buf) {
    char* r = raw + buf * rawb;
    const int t0 = tile * TS;
    if (PACKED) {
      const int RB = D / 2;  // bytes per token row
      const char* kb = static_cast<const char*>(kd);
      const char* vb = static_cast<const char*>(vd);
      if (RB % 16 == 0) {
        const int nc = RB / 16;
        for (int i = tid; i < 2 * TS * nc; i += NT) {
          const int kv = i / (TS * nc), j = i - kv * TS * nc;
          const int t = j / nc, c = j - t * nc, s = t0 + t;
          const size_t at = ((s < S ? rows(b, s) : 0) * Hkv + h) * RB + 16 * c;
          cp_async<16>(r + kv * TS * RB + t * RB + 16 * c,
                       (kv ? vb : kb) + at, s < S ? 16 : 0);
        }
      } else {
        const int nc = RB / 4;
        for (int i = tid; i < 2 * TS * nc; i += NT) {
          const int kv = i / (TS * nc), j = i - kv * TS * nc;
          const int t = j / nc, c = j - t * nc, s = t0 + t;
          const size_t at = ((s < S ? rows(b, s) : 0) * Hkv + h) * RB + 4 * c;
          cp_async<4>(r + kv * TS * RB + t * RB + 4 * c, (kv ? vb : kb) + at,
                      s < S ? 4 : 0);
        }
      }
      float* scl = reinterpret_cast<float*>(r + TS * D);  // [2][TS]
      for (int i = tid; i < 2 * TS; i += NT) {
        const int kv = i / TS, t = i - kv * TS, s = t0 + t;
        const size_t at = (s < S ? rows(b, s) : 0) * Hkv + h;
        cp_async<4>(scl + i, (kv ? vs : ks) + at, s < S ? 4 : 0);
      }
    } else if (KIND == KV_F32) {
      const float* kf = static_cast<const float*>(kd);
      const float* vf = static_cast<const float*>(vd);
      float* rf = reinterpret_cast<float*>(r);
      for (int i = tid; i < 2 * TS * D4; i += NT) {
        const int kv = i / (TS * D4), j = i - kv * TS * D4;
        const int t = j / D4, c = j - t * D4, s = t0 + t;
        const size_t at = ((s < S ? rows(b, s) : 0) * Hkv + h) * D + 4 * c;
        cp_async<16>(kv ? rf + TS * KS + t * VS + 4 * c : rf + t * KS + 4 * c,
                     (kv ? vf : kf) + at, s < S ? 16 : 0);
      }
    } else {
      const int RB = 2 * D, nc = D / 8;  // 16-byte chunks per row
      const char* kb = static_cast<const char*>(kd);
      const char* vb = static_cast<const char*>(vd);
      for (int i = tid; i < 2 * TS * nc; i += NT) {
        const int kv = i / (TS * nc), j = i - kv * TS * nc;
        const int t = j / nc, c = j - t * nc, s = t0 + t;
        const size_t at = ((s < S ? rows(b, s) : 0) * Hkv + h) * RB + 16 * c;
        cp_async<16>(r + kv * TS * RB + t * RB + 16 * c, (kv ? vb : kb) + at,
                     s < S ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // the queries, pre-scaled, while pos is on its way; partials zeroed;
  // the byte table
  {
    const float4* qg =
        reinterpret_cast<const float4*>(q + ((size_t)b * H + h * G) * D);
    float4* q4 = reinterpret_cast<float4*>(q_s);
    float4* o4 = reinterpret_cast<float4*>(o_s);
    for (int i = tid; i < G * D4; i += NT) {
      float4 v = qg[i];
      v.x /= qscale;
      v.y /= qscale;
      v.z /= qscale;
      v.w /= qscale;
      q4[i] = v;
      o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < G * wpr; i += NT) {
      m_s[i] = NEG_INF;
      l_s[i] = 0.f;
    }
    if (PACKED) build_table(tab);
  }

  // this rank's contiguous share of the row's live tiles
  int t_lo, t_hi;
  live_tiles(p_cur, S, window, ring, t_lo, t_hi);
  const int per = (t_hi - t_lo + split - 1) / split;
  const int my_lo = min(t_lo + rank * per, t_hi);
  const int my_hi = min(my_lo + per, t_hi);
  // every live tile on rank 0 (a short row): the other ranks would add
  // exactly nothing, so they leave and rank 0 writes the row itself, with
  // no cluster barrier (the whole cluster sees the same pos)
  const bool alone = t_hi - t_lo <= per;
  if (alone && rank > 0) return;

  if (my_lo < my_hi) load_tile(my_lo, 0);

  const float4* q4 = reinterpret_cast<const float4*>(q_s);
  float4* o4 = reinterpret_cast<float4*>(o_s);
  for (int it = my_lo; it < my_hi; ++it) {
    const int buf = nbuf == 2 ? (it - my_lo) & 1 : 0;
    if (nbuf == 1 && it > my_lo) {
      __syncthreads();  // every warp done with the buffer
      load_tile(it, 0);
    }
    cp_async_wait_all();
    __syncthreads();  // the tile landed, the previous one is used up
    if (nbuf == 2 && it + 1 < my_hi) load_tile(it + 1, buf ^ 1);
    const char* r = raw + buf * rawb;

    // ---- decode the raw tile into f32 K / V rows (f32 caches: in place)
    const float* kt;
    const float* vt;
    if (KIND == KV_F32) {
      kt = reinterpret_cast<const float*>(r);
      vt = kt + TS * KS;
    } else {
      const int W = D / 8;  // 8-value groups per token row
      for (int i = tid; i < 2 * TS * W; i += NT) {
        const int kv = i / (TS * W), j = i - kv * TS * W;
        const int t = j / W, wi = j - t * W;
        float* dst = kv ? v_s + t * VS + 8 * wi : k_s + t * KS + 8 * wi;
        if (PACKED)
          dec_packed_word(reinterpret_cast<const uint32_t*>(r)[kv * TS * W + j],
                          tab + (lane & (TAB_COPIES - 1)), dst);
        else
          dec_fp16x8<KIND>(reinterpret_cast<const uint4*>(r)[kv * TS * W + j],
                           dst);
      }
      __syncthreads();
      kt = k_s;
      vt = v_s;
    }
    const float* kscl = reinterpret_cast<const float*>(r + TS * D);
    const float* vscl = kscl + TS;

    // ---- this lane's token: the plain version's mask ---------------------
    const int s = it * TS + lane;
    bool valid;
    int abs_pos;
    if (ring) {
      int rr = (p_cur - s) % ring;
      if (rr < 0) rr += ring;
      abs_pos = p_cur - rr;
      valid = abs_pos >= 0;
    } else {
      abs_pos = s;
      valid = s <= p_cur;
    }
    const bool live = s < S;
    valid = valid && live;
    if (window) valid = valid && abs_pos > p_cur - window && abs_pos <= p_cur;
    const float ks_t = PACKED ? kscl[lane] : 1.f;
    const float vs_t = PACKED ? vscl[lane] : 1.f;
    const float4* vt4 = reinterpret_cast<const float4*>(vt);
    const int VS4 = VS / 4, tsp = geo.tsp, cpl = 32 / tsp;
    const int ci = lane / tsp, tg = lane - ci * tsp;

    if (wpr == 1) {
      // ---- a warp owns rows warp, warp + 4, ...: two at a time --------
      const float4* kr = reinterpret_cast<const float4*>(kt + lane * KS);
      for (int ga = warp; ga < G; ga += 2 * NW) {
        const int gb = ga + NW;
        const bool two = gb < G;
        float4 aa = make_float4(0.f, 0.f, 0.f, 0.f), ab = aa;
        const float4* qa = q4 + ga * D4;
        const float4* qb = q4 + (two ? gb : ga) * D4;
        if (two) {
#pragma unroll 8
          for (int c = 0; c < D4; ++c) {
            const float4 k4 = kr[c];
            dot4(aa, qa[c], k4);
            dot4(ab, qb[c], k4);
          }
        } else {
#pragma unroll 8
          for (int c = 0; c < D4; ++c) dot4(aa, qa[c], kr[c]);
        }
        float sa = hsum(aa) * ks_t, sb = hsum(ab) * ks_t;
        sa = valid ? sa : NEG_INF;
        sb = valid ? sb : NEG_INF;
        const float ca =
            softmax_row<PACKED>(sa, live, vs_t, p_s, m_s, l_s, ga, lane);
        float cb = 1.f;
        if (two)
          cb = softmax_row<PACKED>(sb, live, vs_t, p_s, m_s, l_s, gb, lane);
        // o = o * corr + p . V over this lane's columns and tokens
        const float* pa = p_s + ga * TS;
        const float* pb = p_s + (two ? gb : ga) * TS;
        for (int c0 = 0; c0 < D4; c0 += cpl) {
          const int c = c0 + ci;
          const bool act = c < D4;
          float4 oa = make_float4(0.f, 0.f, 0.f, 0.f), ob = oa;
          if (act) {
#pragma unroll 8
            for (int t = tg; t < TS; t += tsp) {
              const float4 v4 = vt4[t * VS4 + c];
              fma4(oa, pa[t], v4);
              if (two) fma4(ob, pb[t], v4);
            }
          }
          for (int o = 1; o < tsp; o <<= 1) {
            oa.x += __shfl_xor_sync(0xffffffffu, oa.x, o);
            oa.y += __shfl_xor_sync(0xffffffffu, oa.y, o);
            oa.z += __shfl_xor_sync(0xffffffffu, oa.z, o);
            oa.w += __shfl_xor_sync(0xffffffffu, oa.w, o);
            if (two) {  // warp-uniform
              ob.x += __shfl_xor_sync(0xffffffffu, ob.x, o);
              ob.y += __shfl_xor_sync(0xffffffffu, ob.y, o);
              ob.z += __shfl_xor_sync(0xffffffffu, ob.z, o);
              ob.w += __shfl_xor_sync(0xffffffffu, ob.w, o);
            }
          }
          if (act && tg == 0) {
            float4 x = o4[ga * D4 + c];
            o4[ga * D4 + c] =
                make_float4(fmaf(x.x, ca, oa.x), fmaf(x.y, ca, oa.y),
                            fmaf(x.z, ca, oa.z), fmaf(x.w, ca, oa.w));
            if (two) {
              x = o4[gb * D4 + c];
              o4[gb * D4 + c] =
                  make_float4(fmaf(x.x, cb, ob.x), fmaf(x.y, cb, ob.y),
                              fmaf(x.z, cb, ob.z), fmaf(x.w, cb, ob.w));
            }
          }
        }
      }
    } else {
      // ---- G 1, 2: wpr warps share row g -------------------------------
      const int g = warp / wpr, part = warp - g * wpr;
      const int L = wpr, tt = lane / L, l = lane - tt * L;
      const int t = part * (TS / L) + tt;
      const float4* kr = reinterpret_cast<const float4*>(kt + t * KS);
      const float4* qg = q4 + g * D4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = l; c < D4; c += L) dot4(a, qg[c], kr[c]);
      float sc = hsum(a);
      for (int o = 1; o < L; o <<= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (l == 0) sc_s[g * TS + t] = PACKED ? sc * kscl[t] : sc;
      __syncthreads();
      sc = valid ? sc_s[g * TS + lane] : NEG_INF;
      const int idx = g * wpr + part;
      const float corr =
          softmax_row<PACKED>(sc, live, vs_t, p_s, m_s, l_s, idx, lane);
      const float* pr = p_s + idx * TS;
      const int c_beg = part * geo.ncol;
      const int c_end = min(D4, c_beg + geo.ncol);
      for (int c0 = c_beg; c0 < c_end; c0 += cpl) {
        const int c = c0 + ci;
        const bool act = c < c_end;
        float4 oa = make_float4(0.f, 0.f, 0.f, 0.f);
        if (act) {
#pragma unroll 8
          for (int tk = tg; tk < TS; tk += tsp)
            fma4(oa, pr[tk], vt4[tk * VS4 + c]);
        }
        for (int o = 1; o < tsp; o <<= 1) {
          oa.x += __shfl_xor_sync(0xffffffffu, oa.x, o);
          oa.y += __shfl_xor_sync(0xffffffffu, oa.y, o);
          oa.z += __shfl_xor_sync(0xffffffffu, oa.z, o);
          oa.w += __shfl_xor_sync(0xffffffffu, oa.w, o);
        }
        if (act && tg == 0) {
          const float4 x = o4[g * D4 + c];
          o4[g * D4 + c] =
              make_float4(fmaf(x.x, corr, oa.x), fmaf(x.y, corr, oa.y),
                          fmaf(x.z, corr, oa.z), fmaf(x.w, corr, oa.w));
        }
      }
    }
  }

  float4* og = reinterpret_cast<float4*>(out + ((size_t)b * H + h * G) * D);
  if (split == 1 || alone) {
    __syncthreads();
    for (int i = tid; i < G * D4; i += NT) {
      const float dl = fmaxf(l_s[(i / D4) * wpr], 1e-30f);
      const float4 x = o4[i];
      og[i] = make_float4(x.x / dl, x.y / dl, x.z / dl, x.w / dl);
    }
    return;
  }
  // the rank-order combine of every rank's (m, l, o) through DSMEM
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int i = rank * NT + tid; i < G * D4; i += split * NT) {
    const int slot = (i / D4) * wpr;
    // every rank's (m, l, o) requested at once: one DSMEM round trip
    float mr[SPLIT_MAX], lr[SPLIT_MAX];
    float4 orr[SPLIT_MAX];
#pragma unroll
    for (int src = 0; src < SPLIT_MAX; ++src) {
      if (src < split) {
        mr[src] = cluster.map_shared_rank(m_s, src)[slot];
        lr[src] = cluster.map_shared_rank(l_s, src)[slot];
        orr[src] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(o_s, src))[i];
      }
    }
    float M = NEG_INF;
#pragma unroll
    for (int src = 0; src < SPLIT_MAX; ++src)
      if (src < split) M = fmaxf(M, mr[src]);
    float L = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int src = 0; src < SPLIT_MAX; ++src) {
      if (src < split) {
        const float f = expf(mr[src] - M);
        L = fmaf(lr[src], f, L);
        fma4(acc, f, orr[src]);
      }
    }
    const float dl = fmaxf(L, 1e-30f);
    og[i] = make_float4(acc.x / dl, acc.y / dl, acc.z / dl, acc.w / dl);
  }
  cluster.sync();  // no block leaves while its memory is read
}

template <int KIND, class Rows, int DC>
int launch_kind(const float* q, const void* kd, const void* vd,
                const float* ks, const float* vs, const int* pos, float* out,
                Rows rows, int B, int S, int Hkv, int G, int D, float qscale,
                int window, int ring, int split, int nbuf, int smem,
                cudaStream_t st) {
  auto kern = decode_attn_kernel<KIND, Rows, DC>;
  // raise this instantiation's dynamic shared memory cap once
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (attr_err != cudaSuccess) return (int)attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * split, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, q, kd, vd, ks, vs, pos, out, rows, S,
                         Hkv, G, D, qscale, window, ring, split, nbuf);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <class Rows>
int launch(const void* q, const void* kd, const void* vd, const void* ks,
           const void* vs, const void* pos, void* out, Rows rows, int B,
           int S, int Hkv, int G, int D, int kind, float qscale, int window,
           int ring, int split, int nbuf, int smem, void* stream) {
  if (G < 1 || D < 8 || D % 8 || S < 1 || kind < KV_PACKED ||
      kind > KV_F16 || split < 1 || split > SPLIT_MAX ||
      (split & (split - 1)) ||
      nbuf < 1 || nbuf > 2 || smem > SMEM_MAX ||
      smem < smem_bytes(G, D, kind, nbuf))
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors and cp.async chunks: the operands must be aligned
  if (((uintptr_t)q | (uintptr_t)kd | (uintptr_t)vd | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* pi = static_cast<const int*>(pos);
  float* of = static_cast<float*>(out);
#define DECODE_ATTN_KIND(K)                                                 \
  case K:                                                                   \
    return D == 64    ? launch_kind<K, Rows, 64>(qf, kd, vd, ksf, vsf, pi,  \
                                                 of, rows, B, S, Hkv, G, D, \
                                                 qscale, window, ring,      \
                                                 split, nbuf, smem, st)     \
           : D == 128 ? launch_kind<K, Rows, 128>(qf, kd, vd, ksf, vsf, pi, \
                                                  of, rows, B, S, Hkv, G,   \
                                                  D, qscale, window, ring,  \
                                                  split, nbuf, smem, st)    \
                      : launch_kind<K, Rows, 0>(qf, kd, vd, ksf, vsf, pi,   \
                                                of, rows, B, S, Hkv, G, D,  \
                                                qscale, window, ring,       \
                                                split, nbuf, smem, st);
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
// D) f32; q, kd, vd and out 16-byte aligned. qscale = float32(sqrt(D)).
// The plan (decode_plan): a key split of `split` blocks (1, 2, 4, 8) a
// cluster, nbuf tile buffers, smem dynamic shared bytes (at least
// smem_bytes, at most 227 KB). Needs D % 8 == 0. Returns the launch's
// cudaError_t.
extern "C" int decode_attn_launch(const void* q, const void* kd,
                                  const void* vd, const void* ks,
                                  const void* vs, const void* pos, void* out,
                                  int B, int S, int Hkv, int G, int D,
                                  int kind, float qscale, int window,
                                  int ring, int split, int nbuf, int smem,
                                  void* stream) {
  return launch(q, kd, vd, ks, vs, pos, out, SlabRows{S}, B, S, Hkv, G, D,
                kind, qscale, window, ring, split, nbuf, smem, stream);
}

// K3. As K2, over pools: packed kd/vd (P, ps, Hkv, D/2) u8 and ks/vs
// (P, ps, Hkv) f32, or fp kd/vd (P, ps, Hkv, D); bt (B, n) i32; S is
// s_len (ring, or n * ps), at most n * ps, and the plan is K2's for S.
// Returns the launch's cudaError_t.
extern "C" int paged_decode_attn_launch(const void* q, const void* kd,
                                        const void* vd, const void* ks,
                                        const void* vs, const void* pos,
                                        const void* bt, void* out, int B,
                                        int S, int Hkv, int G, int D, int n,
                                        int ps, int P, int kind,
                                        float qscale, int window, int ring,
                                        int split, int nbuf, int smem,
                                        void* stream) {
  const PagedRows rows{static_cast<const int*>(bt), n, ps, P};
  return launch(q, kd, vd, ks, vs, pos, out, rows, B, S, Hkv, G, D, kind,
                qscale, window, ring, split, nbuf, smem, stream);
}
