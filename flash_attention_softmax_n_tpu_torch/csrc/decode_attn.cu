// K8: unnormalised single-token attention statistics over a per-slot-length
// KV cache, for Hopper (sm_90a):
//   s[g,p] = (q[g] . k[p]) (* qs[g] under int8 compute) (* ks[p] when quantized)
//   m[g] = max_p s,  l[g] = sum_p exp(s - m),  acc[g] = sum_p exp(s - m) (* vs[p]) v[p]
// over positions p < lengths[b], with the G = H/KVH query rows of one KV
// head together. Slots of length 0 give (acc 0, m NEG_INF, l 0).
//
// Replaces the Pallas kernel _kernel
// (flash_attention_softmax_n_tpu/kernels/decode_attention.py:60), which
// walks 256-position tiles in order with a running (m, l, acc). The cache is
// f32, bf16, int8 or fp8 e4m3 (the last two with per-position scales, one
// byte read per cached value). Rounding follows the Pallas kernel: q comes in
// its compute type (bf16 or f32; int8 with per-row scales under int8
// compute), k is rounded to q's type (exact from int8 and e4m3), p is rounded
// to bf16 before the PV product unless the cache is f32, and under int8
// compute p is requantized per row over each 256-position tile and both
// products are integer: exact in f32 in the split kernel, whose layout fits
// only up to about hd 400 (hd * 128 * 128 and 256 * 127 * 128 stay below
// 2^24), and in int32 in decode_attn_int8c_kernel, which takes the head
// dims above (the tile's k and v rows, 270 KB at hd 512, do not fit a
// block: they come through a buffer in sub-tiles).
//
// What bounds it on the H100: the valid k and v rows, read once, at 3.35
// TB/s; at decode batch sizes that is well under a microsecond, so launch
// latency and the serial chain of one CTA (load, QK, softmax, PV, write)
// set its time. The design shortens that chain and fills the card:
// - Flash decoding with a split length chosen per call by the plan
//   (kernels/decode_attention.py decode_attn_plan, which also keeps a
//   split's k and v rows within 48 KB so that a few CTAs share an SM; the
//   operator checks only what the kernel needs, fasn_decode_attn_plan_ok):
//   the longest of 256, 128, 64 and 32 positions that still gives about
//   one CTA per SM over (split, KV head, slot) with every slot full (32 at
//   B8 S256 and B2 S512, 256 at B64 S256 and S512), and 16 where no
//   longer split's rows fit the 48 KB (a wide head dim: bf16 at hd 512).
//   Any head dim runs as it is: JAX pads hd to a multiple of 128 for its
//   lanes, and zero columns would change no score and add only zero
//   columns of acc, while padding the cache here would copy it. Splits past a slot's
//   length cost little, but splitting its valid rows further costs a CTA's
//   fixed chain and a merge step: the plan sees the window, not the
//   lengths. Under int8 compute the split stays 256 positions at every
//   head dim: p is requantized over the Pallas kernel's 256-position tile,
//   and a different tile is a different function. A split at or past the slot's
//   length exits at once, so only rows below lengths[b] are read.
// - A CTA puts all of its split's valid k and v rows in flight at once,
//   16-byte cp.async copies into padded shared rows (row pitch an odd
//   number of 16-byte chunks, so lanes on neighbouring rows hit distinct
//   banks), with q and the scales beside them, and waits once. A view whose
//   rows or strides are not 16-byte multiples is copied element by element
//   into the same layout.
// - Products, chosen per call by the plan (decode_attn_products), and both
//   timed on the card at the serving lines (utils/bench_decode_attn.py):
//   * MMA, bf16 q over a bf16, int8 or e4m3 cache with hd a multiple of
//     16: mma.sync m16n8k16 in bf16 with f32 accumulators. QK as
//     s^T = k q^T (16 positions by 8 query rows a tile: G = 8 fills n8
//     without padding, G = 16 takes two tiles), PV as acc^T = v^T p^T (16
//     head dims by 8 rows, positions the reduction). k's values widen to
//     bf16 exactly in registers (int8 and e4m3 included), v's are read
//     across positions from shared memory, and p is already bf16. Rows at
//     or past the split's valid length are zeroed in shared memory first,
//     so stale bytes never reach a product.
//   * FMA, every other mode (f32 q or cache, int8 compute, other head
//     dims): QK one thread per (position, group of query rows), the k row
//     read from shared memory once per group in 16-byte chunks and q
//     broadcast; PV one thread per (head dim, group of rows), four
//     positions at a time. f32 q keeps f32 products, and int8 compute's
//     integer products are exact in f32.
//   One warp per query row takes m, p and l with shuffles between them.
// - Each split writes (acc, m, l) partials; decode_attn_merge_kernel merges
//   a slot's valid splits in split order (no atomics, so repeated calls are
//   bit-equal), one thread per output value. Both alternatives were timed
//   on the card and lost (utils/bench_decode_attn.py): the merge in two
//   passes of independent loads moved nothing, and folding it into the last
//   CTA of each (slot, KV head), found through arrival counters, took 0.0126
//   and 0.0159 ms at fp8 B8 S256 and B2 S512 against 0.0093 and 0.0101 for
//   the two launches on an NVIDIA H100 80GB HBM3: one CTA merging 16
//   splits in series is slower than a second launch spread over the card.
// The cache is taken by strides: the decode loop passes a view that slices
// S and takes one layer, and copying it would read the whole cache every
// layer.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "launchers.h"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_G = 16;
constexpr int MIN_SPLIT = 16;  // one mma tile of positions
constexpr int MAX_SPLIT = 256;
constexpr int INT8_SPLIT = 256;         // the Pallas kernel's tile: int8 compute's only split
constexpr int SMEM_MAX = 227 * 1024;    // the H100's dynamic shared memory a block
constexpr float NEG_INF = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// a k value as the QK product takes it: rounded to q's type (bf16 q, f32 cache)
template <typename QT, typename KT>
__device__ __forceinline__ float k_operand(KT v) {
  const float f = to_f32(v);
  return (std::is_same<QT, __nv_bfloat16>::value && std::is_same<KT, float>::value)
             ? round_bf16(f)
             : f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// two f32 values as one bf16x2 register, the first in the low half (the
// lower column of an mma fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

// two consecutive cached values at `at` as bf16x2: exact from bf16, int8
// and e4m3
template <typename KT>
__device__ __forceinline__ uint32_t pair_bf16(const uint8_t* at) {
  const KT* v = reinterpret_cast<const KT*>(at);
  return pack_bf16(to_f32(v[0]), to_f32(v[1]));
}
template <>
__device__ __forceinline__ uint32_t pair_bf16<__nv_bfloat16>(const uint8_t* at) {
  return *reinterpret_cast<const uint32_t*>(at);
}

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int slot_length(const FasnDecode& a, int b) {
  return min(max(a.lengths[b], 0), a.S);
}

// bytes of one cached row rounded up to 16; a shared row is one 16-byte
// chunk longer, so rows of 64, 128 or 256 bytes (the serving shapes') lie an
// odd number of chunks apart and 8 neighbouring rows start in 8 different
// bank groups
__host__ __device__ __forceinline__ int row_bytes(int hd, int elem) {
  return (hd * elem + 15) / 16 * 16;
}

// The shared-memory layout of one CTA (split length L, G rows, head dim HD
// padded to HDP elements of the cache's type): q (G x HDP f32, zeros past
// HD), scores (G x L f32), the k and v scales (L f32 each), the row scales
// of int8 compute (MAX_G f32), then the k and v rows (L x pitch bytes each).
struct Layout {
  int hdp, pitch, q_at, s_at, ks_at, vs_at, rs_at, k_at, v_at, bytes;
  __host__ __device__ Layout(int G, int HD, int L, int elem) {
    const int rb = row_bytes(HD, elem);
    hdp = rb / elem;
    pitch = rb + 16;
    q_at = 0;
    s_at = q_at + G * hdp * 4;
    ks_at = s_at + G * L * 4;
    vs_at = ks_at + L * 4;
    rs_at = vs_at + L * 4;
    k_at = (rs_at + MAX_G * 4 + 15) / 16 * 16;
    v_at = k_at + L * pitch;
    bytes = v_at + L * pitch;
  }
};

// QT: q's type (float, bf16; int8_t under int8 compute, INT8C); KT: the
// cache's; MMA: the tensor-core products (bf16 q, a bf16, int8 or e4m3
// cache, HD a multiple of 16), else f32 FMAs
template <typename QT, typename KT, bool INT8C, bool MMA>
__global__ void __launch_bounds__(THREADS)
    decode_attn_split_kernel(const FasnDecode a, int L, int vec, float* __restrict__ part_acc,
                             float* __restrict__ part_m, float* __restrict__ part_l) {
  constexpr int ELEM = sizeof(KT);
  constexpr int E = 16 / ELEM;  // cache values in a 16-byte chunk
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = sp * L;
  const int len = slot_length(a, b);
  if (s0 >= len) return;
  const int n = min(L, len - s0);
  const int G = a.G, HD = a.HD, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool quantized = a.k_scales != nullptr;
  const Layout lay(G, HD, L, ELEM);

  extern __shared__ __align__(16) uint8_t smem[];
  float* sQ = reinterpret_cast<float*>(smem + lay.q_at);
  float* sS = reinterpret_cast<float*>(smem + lay.s_at);
  float* sKs = reinterpret_cast<float*>(smem + lay.ks_at);
  float* sVs = reinterpret_cast<float*>(smem + lay.vs_at);
  float* sRowScale = reinterpret_cast<float*>(smem + lay.rs_at);
  uint8_t* sK = smem + lay.k_at;
  uint8_t* sV = smem + lay.v_at;

  const long long bh = (long long)b * a.KVH + h;
  const KT* k = static_cast<const KT*>(a.k) + b * a.k_sb + h * a.k_sh + (long long)s0 * a.k_ss;
  const KT* v = static_cast<const KT*>(a.v) + b * a.v_sb + h * a.v_sh + (long long)s0 * a.v_ss;

  // every valid k and v row of the split in flight at once, then q and the
  // scales while they land
  const int rb = lay.hdp * ELEM;
  if (vec) {
    const int chunks = rb / 16, per = n * chunks;
    for (int e = tid; e < 2 * per; e += THREADS) {
      const int which = e / per, r = (e % per) / chunks, c = e % chunks;
      const uint8_t* src = reinterpret_cast<const uint8_t*>(which ? v + r * a.v_ss : k + r * a.k_ss);
      cp_async16((which ? sV : sK) + r * lay.pitch + 16 * c, src + 16 * c);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    // element copies; the padding past HD is zeroed, as q's is
    const int per = n * lay.hdp;
    for (int e = tid; e < 2 * per; e += THREADS) {
      const int which = e / per, r = (e % per) / lay.hdp, d = e % lay.hdp;
      KT val;
      if (d < HD)
        val = which ? v[r * a.v_ss + d] : k[r * a.k_ss + d];
      else
        memset(&val, 0, sizeof(KT));
      reinterpret_cast<KT*>((which ? sV : sK) + r * lay.pitch)[d] = val;
    }
  }
  const QT* q = static_cast<const QT*>(a.q) + bh * G * HD;
  for (int e = tid; e < G * lay.hdp; e += THREADS) {
    const int g = e / lay.hdp, d = e % lay.hdp;
    sQ[e] = d < HD ? to_f32(q[g * HD + d]) : 0.f;
  }
  if (quantized) {
    const float* ks = a.k_scales + b * a.ks_sb + h * a.ks_sh + (long long)s0 * a.ks_ss;
    const float* vs = a.v_scales + b * a.vs_sb + h * a.vs_sh + (long long)s0 * a.vs_ss;
    for (int r = tid; r < n; r += THREADS) {
      sKs[r] = ks[r * a.ks_ss];
      sVs[r] = vs[r * a.vs_ss];
    }
  }
  if (MMA) {
    // v rows from n up to the next 16: the PV products' last reduction step
    // reads them
    const int tail = (16 - n % 16) % 16;
    for (int e = tid; e < tail * rb / 16; e += THREADS)
      reinterpret_cast<uint4*>(sV + (n + e / (rb / 16)) * lay.pitch)[e % (rb / 16)] =
          make_uint4(0, 0, 0, 0);
  }
  if (vec) asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int gid = lane >> 2, t4 = lane & 3;  // an mma fragment's row and column pair
  const int ntiles = (G + 7) / 8;               // 8 query rows an mma tile
  const float* qs = INT8C ? a.q_scales + bh * G : nullptr;
  if (MMA) {
    // s^T = k q^T, 16 positions by 8 query rows a tile: k's rows p0 + gid
    // and p0 + gid + 8 form A; q's row n0 + gid forms B (zero past G); rows
    // past n give scores that are never stored
    for (int tile = warp; tile < (n + 15) / 16 * ntiles; tile += THREADS / 32) {
      const int p0 = tile / ntiles * 16, n0 = tile % ntiles * 8, g = n0 + gid;
      const uint8_t* k_lo = sK + (p0 + gid) * lay.pitch;
      const uint8_t* k_hi = k_lo + 8 * lay.pitch;
      const float* qrow = sQ + g * lay.hdp;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d0 = 0; d0 < HD; d0 += 16) {
        const int d = d0 + 2 * t4;
        const uint32_t frag[4] = {pair_bf16<KT>(k_lo + d * ELEM), pair_bf16<KT>(k_hi + d * ELEM),
                                  pair_bf16<KT>(k_lo + (d + 8) * ELEM),
                                  pair_bf16<KT>(k_hi + (d + 8) * ELEM)};
        uint32_t b0 = 0, b1 = 0;
        if (g < G) {
          const float2 x0 = *reinterpret_cast<const float2*>(qrow + d);
          const float2 x1 = *reinterpret_cast<const float2*>(qrow + d + 8);
          b0 = pack_bf16(x0.x, x0.y);
          b1 = pack_bf16(x1.x, x1.y);
        }
        mma_bf16(c, frag, b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + gid + (i >= 2 ? 8 : 0), row = n0 + 2 * t4 + (i & 1);
        if (p < n && row < G) sS[row * L + p] = quantized ? c[i] * sKs[p] : c[i];
      }
    }
  }
  // scores: one thread per (position, group of rows); the k row's 16-byte
  // chunks read once per group, q broadcast across the warp
  const int groups = max(1, min(G, THREADS / L)), gs = (G + groups - 1) / groups;
  for (int e = tid; !MMA && e < L * groups; e += THREADS) {
    const int p = e % L, g0 = (e / L) * gs;
    if (p >= n || g0 >= G) continue;
    float s[MAX_G];
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) s[j] = 0.f;
    const uint8_t* krow = sK + p * lay.pitch;
    for (int c = 0; c < rb / 16; ++c) {
      KT kv[E];
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + 16 * c);
      memcpy(kv, &raw, 16);
      float kf[E];
#pragma unroll
      for (int i = 0; i < E; ++i) kf[i] = k_operand<QT>(kv[i]);
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j >= gs || g0 + j >= G) break;
        const float4* qrow = reinterpret_cast<const float4*>(sQ + (g0 + j) * lay.hdp + c * E);
        float acc = s[j];
#pragma unroll
        for (int i = 0; i < E / 4; ++i) {
          const float4 q4 = qrow[i];
          acc = fmaf(q4.x, kf[4 * i], acc);
          acc = fmaf(q4.y, kf[4 * i + 1], acc);
          acc = fmaf(q4.z, kf[4 * i + 2], acc);
          acc = fmaf(q4.w, kf[4 * i + 3], acc);
        }
        s[j] = acc;
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) {
      if (j >= gs || g0 + j >= G) break;
      float dot = s[j];
      if (INT8C) dot = dot * qs[g0 + j];
      if (quantized) dot = dot * sKs[p];
      sS[(g0 + j) * L + p] = dot;
    }
  }
  __syncthreads();

  // per row: m, p = exp(s - m), l = sum p; fold the v scales into p; round
  // p to bf16 (PV in bf16 unless the cache is f32) or requantize it to int8
  const long long part_row = (bh * gridDim.x + sp) * G;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* row = sS + g * L;
    float m = NEG_INF;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, row[r]);
    m = warp_max(m);
    float l = 0.f, p_max = 0.f;
    for (int r = lane; r < n; r += 32) {
      float p = expf(row[r] - m);
      l += p;
      if (quantized) p = p * sVs[r];
      p_max = fmaxf(p_max, p);
      row[r] = p;
    }
    l = warp_sum(l);
    if (INT8C) {
      p_max = warp_max(p_max);
      const float r_scale = p_max == 0.f ? 1.f : p_max / 127.f;
      for (int r = lane; r < n; r += 32)
        row[r] = fminf(fmaxf(rintf(row[r] / r_scale), -128.f), 127.f);
      if (lane == 0) sRowScale[g] = r_scale;
    } else if (!std::is_same<KT, float>::value) {
      for (int r = lane; r < n; r += 32) row[r] = round_bf16(row[r]);
    }
    // p from n up to the next 16 (the PV products' last reduction step)
    if (MMA && lane < (16 - n % 16) % 16) row[n + lane] = 0.f;
    if (lane == 0) {
      part_m[part_row + g] = m;
      part_l[part_row + g] = l;
    }
  }
  __syncthreads();

  float* out = part_acc + part_row * HD;
  if (MMA) {
    // acc^T = v^T p^T, 16 head dims by 8 query rows a tile, 16 positions a
    // step: v's values at (positions p, p + 1, p + 8, p + 9; head dims
    // d0 + gid, + 8) form A, p's row n0 + gid forms B (zero past G)
    auto v_at = [&](int r, int d) {
      return to_f32(reinterpret_cast<const KT*>(sV + r * lay.pitch)[d]);
    };
    for (int tile = warp; tile < HD / 16 * ntiles; tile += THREADS / 32) {
      const int d0 = tile / ntiles * 16 + gid, n0 = tile % ntiles * 8, g = n0 + gid;
      const float* prow = sS + g * L;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p0 = 0; p0 < n; p0 += 16) {  // the same steps in every lane
        const int p = p0 + 2 * t4;
        const uint32_t frag[4] = {pack_bf16(v_at(p, d0), v_at(p + 1, d0)),
                                  pack_bf16(v_at(p, d0 + 8), v_at(p + 1, d0 + 8)),
                                  pack_bf16(v_at(p + 8, d0), v_at(p + 9, d0)),
                                  pack_bf16(v_at(p + 8, d0 + 8), v_at(p + 9, d0 + 8))};
        uint32_t b0 = 0, b1 = 0;
        if (g < G) {
          const float2 x0 = *reinterpret_cast<const float2*>(prow + p);
          const float2 x1 = *reinterpret_cast<const float2*>(prow + p + 8);
          b0 = pack_bf16(x0.x, x0.y);
          b1 = pack_bf16(x1.x, x1.y);
        }
        mma_bf16(c, frag, b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = n0 + 2 * t4 + (i & 1);
        if (row < G) out[row * HD + d0 + (i >= 2 ? 8 : 0)] = c[i];
      }
    }
    return;
  }
  // acc[g, d] = sum_p p[g, p] v[p, d]: one thread per (d, group of rows),
  // four positions at a time; above 128 head dims a thread takes every
  // THREADS-th one
  const int dgroups = max(1, THREADS / HD), dgs = (G + dgroups - 1) / dgroups;
  for (int e = tid; e < dgroups * HD; e += THREADS) {
    const int d = e % HD, g0 = (e / HD) * dgs;
    if (g0 >= G) continue;
    float acc[MAX_G];
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) acc[j] = 0.f;
    const int n4 = n & ~3;
    for (int p = 0; p < n4; p += 4) {
      float vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        vv[i] = to_f32(reinterpret_cast<const KT*>(sV + (p + i) * lay.pitch)[d]);
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j >= dgs || g0 + j >= G) break;
        const float4 p4 = *reinterpret_cast<const float4*>(sS + (g0 + j) * L + p);
        acc[j] = fmaf(p4.x, vv[0], acc[j]);
        acc[j] = fmaf(p4.y, vv[1], acc[j]);
        acc[j] = fmaf(p4.z, vv[2], acc[j]);
        acc[j] = fmaf(p4.w, vv[3], acc[j]);
      }
    }
    for (int p = n4; p < n; ++p) {
      const float vp = to_f32(reinterpret_cast<const KT*>(sV + p * lay.pitch)[d]);
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j >= dgs || g0 + j >= G) break;
        acc[j] = fmaf(sS[(g0 + j) * L + p], vp, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_G; ++j) {
      if (j >= dgs || g0 + j >= G) break;
      const int g = g0 + j;
      out[g * HD + d] = INT8C ? acc[j] * sRowScale[g] : acc[j];
    }
  }
}

// Int8 compute where the split kernel's layout (the 256-position tile's k
// and v rows whole) does not fit a block: a wide head dim. The same
// function, tile by tile: the tile's scores stay whole in shared memory
// (G x 256 f32), q as int8, while k's rows and then v's come through one
// buffer of SUB positions at a time (the longest of 256, 128, 64, 32, 16
// whose layout fits, int8c_sub), and the requantized p as int8 rows. Both
// products sum in int32 (__dp4a), exact at any head dim, as the Pallas
// kernel's int32 dots are; PV's sums
// over a tile's SUB-position pieces are integers below 256 * 128 * 128 =
// 2^22, so carrying them in f32 between pieces (in this CTA's own rows of
// part_acc) is exact too, and the results equal the split kernel's
// wherever both fit.
struct Int8cLayout {
  int qb, pitch, q_at, s_at, ks_at, vs_at, rs_at, p_at, rows_at, bytes;
  __host__ __device__ Int8cLayout(int G, int HD, int sub) {
    qb = row_bytes(HD, 1);
    pitch = qb + 16;
    q_at = 0;
    s_at = (G * qb + 15) / 16 * 16;
    ks_at = s_at + G * INT8_SPLIT * 4;
    vs_at = ks_at + INT8_SPLIT * 4;
    rs_at = vs_at + INT8_SPLIT * 4;
    p_at = (rs_at + MAX_G * 4 + 15) / 16 * 16;
    rows_at = (p_at + G * INT8_SPLIT + 15) / 16 * 16;
    bytes = rows_at + sub * pitch;
  }
};

// the longest sub-tile whose layout fits a block; 0 if none does
__host__ __device__ inline int int8c_sub(int G, int HD) {
  for (int sub = INT8_SPLIT; sub >= MIN_SPLIT; sub /= 2)
    if (Int8cLayout(G, HD, sub).bytes <= SMEM_MAX) return sub;
  return 0;
}

// the sum of 16 int8 products of two 16-byte chunks, added to acc
__device__ __forceinline__ int dot16(const uint4& x, const uint4& y, int acc) {
  acc = __dp4a(static_cast<int>(x.x), static_cast<int>(y.x), acc);
  acc = __dp4a(static_cast<int>(x.y), static_cast<int>(y.y), acc);
  acc = __dp4a(static_cast<int>(x.z), static_cast<int>(y.z), acc);
  return __dp4a(static_cast<int>(x.w), static_cast<int>(y.w), acc);
}

__global__ void __launch_bounds__(THREADS)
    decode_attn_int8c_kernel(const FasnDecode a, int sub, int vec, float* __restrict__ part_acc,
                             float* __restrict__ part_m, float* __restrict__ part_l) {
  constexpr int L = INT8_SPLIT;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = sp * L;
  const int len = slot_length(a, b);
  if (s0 >= len) return;
  const int n = min(L, len - s0);
  const int G = a.G, HD = a.HD, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Int8cLayout lay(G, HD, sub);
  const int chunks = lay.qb / 16;

  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + lay.q_at);
  float* sS = reinterpret_cast<float*>(smem + lay.s_at);
  float* sKs = reinterpret_cast<float*>(smem + lay.ks_at);
  float* sVs = reinterpret_cast<float*>(smem + lay.vs_at);
  float* sRowScale = reinterpret_cast<float*>(smem + lay.rs_at);
  int8_t* sP = reinterpret_cast<int8_t*>(smem + lay.p_at);
  uint8_t* sRows = smem + lay.rows_at;

  const long long bh = (long long)b * a.KVH + h;
  const int8_t* k = static_cast<const int8_t*>(a.k) + b * a.k_sb + h * a.k_sh + (long long)s0 * a.k_ss;
  const int8_t* v = static_cast<const int8_t*>(a.v) + b * a.v_sb + h * a.v_sh + (long long)s0 * a.v_ss;
  // rows r0 .. r0 + rn of k or v into the buffer (zeros past HD)
  auto load_rows = [&](const int8_t* src, long long ss, int r0, int rn) {
    if (vec) {
      for (int e = tid; e < rn * chunks; e += THREADS) {
        const int r = e / chunks, c = e % chunks;
        cp_async16(sRows + r * lay.pitch + 16 * c,
                   reinterpret_cast<const uint8_t*>(src + (r0 + r) * ss) + 16 * c);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    } else {
      for (int e = tid; e < rn * lay.qb; e += THREADS) {
        const int r = e / lay.qb, d = e % lay.qb;
        reinterpret_cast<int8_t*>(sRows + r * lay.pitch)[d] =
            d < HD ? src[(r0 + r) * ss + d] : int8_t(0);
      }
    }
  };

  const int8_t* q = static_cast<const int8_t*>(a.q) + bh * G * HD;
  for (int e = tid; e < G * lay.qb; e += THREADS) {
    const int g = e / lay.qb, d = e % lay.qb;
    sQ[e] = d < HD ? q[g * HD + d] : int8_t(0);
  }
  const float* ks = a.k_scales + b * a.ks_sb + h * a.ks_sh + (long long)s0 * a.ks_ss;
  const float* vs = a.v_scales + b * a.vs_sb + h * a.vs_sh + (long long)s0 * a.vs_ss;
  for (int r = tid; r < n; r += THREADS) {
    sKs[r] = ks[r * a.ks_ss];
    sVs[r] = vs[r * a.vs_ss];
  }
  const float* qs = a.q_scales + bh * G;

  // scores, sub-tile by sub-tile: one thread per (position, group of rows)
  for (int r0 = 0; r0 < n; r0 += sub) {
    const int rn = min(sub, n - r0);
    __syncthreads();  // the buffer's previous rows are consumed
    load_rows(k, a.k_ss, r0, rn);
    __syncthreads();
    const int groups = max(1, min(G, THREADS / sub)), gs = (G + groups - 1) / groups;
    for (int e = tid; e < sub * groups; e += THREADS) {
      const int p = e % sub, g0 = (e / sub) * gs;
      if (p >= rn || g0 >= G) continue;
      int s[MAX_G];
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) s[j] = 0;
      const uint8_t* krow = sRows + p * lay.pitch;
      for (int c = 0; c < chunks; ++c) {
        const uint4 kc = *reinterpret_cast<const uint4*>(krow + 16 * c);
#pragma unroll
        for (int j = 0; j < MAX_G; ++j) {
          if (j >= gs || g0 + j >= G) break;
          s[j] = dot16(*reinterpret_cast<const uint4*>(sQ + (g0 + j) * lay.qb + 16 * c), kc, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j >= gs || g0 + j >= G) break;
        sS[(g0 + j) * L + r0 + p] = static_cast<float>(s[j]) * qs[g0 + j] * sKs[r0 + p];
      }
    }
  }
  __syncthreads();

  // per row, as the split kernel: m, p = exp(s - m), l, the v scales
  // folded into p, then p requantized to int8 over the tile (zeros past n)
  const long long part_row = (bh * gridDim.x + sp) * G;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* row = sS + g * L;
    float m = NEG_INF;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, row[r]);
    m = warp_max(m);
    float l = 0.f, p_max = 0.f;
    for (int r = lane; r < n; r += 32) {
      float p = expf(row[r] - m);
      l += p;
      p = p * sVs[r];
      p_max = fmaxf(p_max, p);
      row[r] = p;
    }
    l = warp_sum(l);
    p_max = warp_max(p_max);
    const float r_scale = p_max == 0.f ? 1.f : p_max / 127.f;
    for (int r = lane; r < L; r += 32)
      sP[g * L + r] = r < n ? static_cast<int8_t>(fminf(fmaxf(rintf(row[r] / r_scale), -128.f),
                                                        127.f))
                            : int8_t(0);
    if (lane == 0) {
      sRowScale[g] = r_scale;
      part_m[part_row + g] = m;
      part_l[part_row + g] = l;
    }
  }

  // acc[g, d .. d + 3] = sum_p p[g, p] v[p, d .. d + 3] in int32 a
  // sub-tile: one thread per (4 head dims, group of rows), 4 positions a
  // step, the 4 rows' words transposed with byte permutes so that __dp4a
  // sums over positions against p's packed row (past n p is zero, so the
  // buffer's stale rows there add nothing); the sub-tiles' sums carried in
  // part_acc
  float* out = part_acc + part_row * HD;
  const int quads = lay.qb / 4;
  const int qgroups = max(1, THREADS / quads), qgs = (G + qgroups - 1) / qgroups;
  for (int r0 = 0; r0 < n; r0 += sub) {
    const int rn = min(sub, n - r0);
    const bool last = r0 + sub >= n;
    __syncthreads();  // p is final; the buffer's k rows consumed
    load_rows(v, a.v_ss, r0, rn);
    __syncthreads();
    for (int e = tid; e < qgroups * quads; e += THREADS) {
      const int d4 = e % quads, g0 = (e / quads) * qgs;
      if (g0 >= G) continue;
      int acc[MAX_G][4];
#pragma unroll
      for (int j = 0; j < MAX_G; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0;
      for (int p = 0; p < rn; p += 4) {
        const uint8_t* at = sRows + p * lay.pitch + 4 * d4;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(at);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(at + lay.pitch);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(at + 2 * lay.pitch);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(at + 3 * lay.pitch);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        // vt[c]: head dim d + c at positions p .. p + 3
        const int vt[4] = {static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                           static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                           static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                           static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
        for (int j = 0; j < MAX_G; ++j) {
          if (j >= qgs || g0 + j >= G) break;
          const int pw = *reinterpret_cast<const int*>(sP + (g0 + j) * L + r0 + p);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][c] = __dp4a(pw, vt[c], acc[j][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < MAX_G; ++j) {
        if (j >= qgs || g0 + j >= G) break;
        const int g = g0 + j;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = 4 * d4 + c;
          if (d >= HD) continue;
          float total = static_cast<float>(acc[j][c]);
          if (r0 > 0) total += out[g * HD + d];
          out[g * HD + d] = last ? total * sRowScale[g] : total;
        }
      }
    }
  }
}

// merge a slot's valid splits in split order; one thread per (b, h, g, d)
__global__ void decode_attn_merge_kernel(const FasnDecode a, int L, int n_splits,
                                         const float* __restrict__ part_acc,
                                         const float* __restrict__ part_m,
                                         const float* __restrict__ part_l, float* __restrict__ acc,
                                         float* __restrict__ m_out, float* __restrict__ l_out) {
  const long long total = (long long)a.B * a.KVH * a.G * a.HD;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    const int d = static_cast<int>(at % a.HD);
    const long long bhg = at / a.HD;  // (b * KVH + h) * G + g
    const int g = static_cast<int>(bhg % a.G);
    const long long bh = bhg / a.G;
    const int b = static_cast<int>(bh / a.KVH);
    const int valid = (slot_length(a, b) + L - 1) / L;
    float m = NEG_INF, l = 0.f, o = 0.f;
    for (int s = 0; s < valid; ++s) {
      const long long row = (bh * n_splits + s) * a.G + g;
      const float ms = part_m[row];
      const float m_new = fmaxf(m, ms);
      const float alpha = expf(m - m_new), beta = expf(ms - m_new);
      o = o * alpha + part_acc[row * a.HD + d] * beta;
      l = l * alpha + part_l[row] * beta;
      m = m_new;
    }
    acc[at] = o;
    if (d == 0) {
      m_out[bhg] = m;
      l_out[bhg] = l;
    }
  }
}

// 16-byte copies where every row of k and v starts on 16 bytes
bool vec_ok(const FasnDecode& a, int elem) {
  const long long rb = (long long)a.HD * elem;
  auto aligned = [](long long v) { return v % 16 == 0; };
  return aligned(rb) && aligned(reinterpret_cast<uintptr_t>(a.k)) &&
         aligned(reinterpret_cast<uintptr_t>(a.v)) && aligned(a.k_sb * elem) &&
         aligned(a.k_sh * elem) && aligned(a.k_ss * elem) && aligned(a.v_sb * elem) &&
         aligned(a.v_sh * elem) && aligned(a.v_ss * elem);
}

template <typename QT, typename KT, bool INT8C, bool MMA = false>
cudaError_t launch(const FasnDecode& a, int L, float* part_acc, float* part_m, float* part_l,
                   float* acc, float* m, float* l, cudaStream_t stream) {
  const int n_splits = (a.S + L - 1) / L;
  if (n_splits > 0) {
    const Layout lay(a.G, a.HD, L, sizeof(KT));
    auto kernel = decode_attn_split_kernel<QT, KT, INT8C, MMA>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return err;
    dim3 grid(n_splits, a.KVH, a.B);
    kernel<<<grid, THREADS, lay.bytes, stream>>>(a, L, vec_ok(a, sizeof(KT)) ? 1 : 0, part_acc,
                                                 part_m, part_l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long total = (long long)a.B * a.KVH * a.G * a.HD;
  const int blocks = static_cast<int>((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                                       : 132 * 16);
  if (blocks == 0) return cudaSuccess;
  decode_attn_merge_kernel<<<blocks, 256, 0, stream>>>(a, L, n_splits, part_acc, part_m, part_l,
                                                       acc, m, l);
  return cudaGetLastError();
}

// int8 compute: the split kernel where its layout fits, else the sub-tiled
// one (both take the 256-position tile)
cudaError_t launch_int8c(const FasnDecode& a, float* part_acc, float* part_m, float* part_l,
                         float* acc, float* m, float* l, cudaStream_t stream) {
  if (Layout(a.G, a.HD, INT8_SPLIT, 1).bytes <= SMEM_MAX)
    return launch<int8_t, int8_t, true>(a, INT8_SPLIT, part_acc, part_m, part_l, acc, m, l,
                                        stream);
  const int sub = int8c_sub(a.G, a.HD);
  if (sub == 0) return cudaErrorInvalidValue;
  const int n_splits = (a.S + INT8_SPLIT - 1) / INT8_SPLIT;
  if (n_splits > 0) {
    const Int8cLayout lay(a.G, a.HD, sub);
    cudaError_t err = cudaFuncSetAttribute(
        decode_attn_int8c_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return err;
    decode_attn_int8c_kernel<<<dim3(n_splits, a.KVH, a.B), THREADS, lay.bytes, stream>>>(
        a, sub, vec_ok(a, 1) ? 1 : 0, part_acc, part_m, part_l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long total = (long long)a.B * a.KVH * a.G * a.HD;
  const int blocks = static_cast<int>((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                                       : 132 * 16);
  if (blocks == 0) return cudaSuccess;
  decode_attn_merge_kernel<<<blocks, 256, 0, stream>>>(a, INT8_SPLIT, n_splits, part_acc, part_m,
                                                       part_l, acc, m, l);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t by_cache(const FasnDecode& a, int L, float* part_acc, float* part_m, float* part_l,
                     float* acc, float* m, float* l, cudaStream_t stream) {
  if (a.kv_dtype == 0)
    return launch<QT, float, false>(a, L, part_acc, part_m, part_l, acc, m, l, stream);
  if (a.kv_dtype == 1)
    return launch<QT, __nv_bfloat16, false>(a, L, part_acc, part_m, part_l, acc, m, l, stream);
  if (a.kv_dtype == 2)
    return launch<QT, int8_t, false>(a, L, part_acc, part_m, part_l, acc, m, l, stream);
  if (a.kv_dtype == 3)
    return launch<QT, __nv_fp8_e4m3, false>(a, L, part_acc, part_m, part_l, acc, m, l, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fasn_decode_attn_plan_ok(int split, int products, int G, int HD, int q_dtype,
                                        int kv_dtype) {
  static const int elem[] = {4, 2, 1, 1};
  if (G < 1 || G > MAX_G || HD < 1 || kv_dtype < 0 || kv_dtype > 3) return 0;
  const bool int8c = q_dtype == 2;
  if (int8c ? split != INT8_SPLIT
            : split != MIN_SPLIT && split != 32 && split != 64 && split != 128 &&
                  split != MAX_SPLIT)
    return 0;
  if (products == 1)  // the tensor-core products
    return q_dtype == 1 && kv_dtype >= 1 && HD % 16 == 0 &&
           Layout(G, HD, split, elem[kv_dtype]).bytes <= SMEM_MAX;
  if (int8c) return products == 0 && int8c_sub(G, HD) > 0;
  return products == 0 && Layout(G, HD, split, elem[kv_dtype]).bytes <= SMEM_MAX;
}

extern "C" int fasn_decode_attn(const FasnDecode* a, int split, int products, float* part_acc,
                                float* part_m, float* part_l, float* acc, float* m, float* l,
                                cudaStream_t stream) {
  if (products == 1) {
    if (a->kv_dtype == 1)
      return launch<__nv_bfloat16, __nv_bfloat16, false, true>(*a, split, part_acc, part_m,
                                                                part_l, acc, m, l, stream);
    if (a->kv_dtype == 2)
      return launch<__nv_bfloat16, int8_t, false, true>(*a, split, part_acc, part_m, part_l,
                                                         acc, m, l, stream);
    return launch<__nv_bfloat16, __nv_fp8_e4m3, false, true>(*a, split, part_acc, part_m,
                                                              part_l, acc, m, l, stream);
  }
  if (a->q_dtype == 0)
    return by_cache<float>(*a, split, part_acc, part_m, part_l, acc, m, l, stream);
  if (a->q_dtype == 1)
    return by_cache<__nv_bfloat16>(*a, split, part_acc, part_m, part_l, acc, m, l, stream);
  return launch_int8c(*a, part_acc, part_m, part_l, acc, m, l, stream);
}
