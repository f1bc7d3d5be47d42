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
// products are integer (exact in f32 here: hd * 128 * 128 and 256 * 127 *
// 128 stay below 2^24).
//
// Design (flash decoding): the grid is (256-position split, KV head, slot);
// a split at or past the slot's length exits at once, so only positions
// below lengths[b] are read, which is the point of the kernel against the
// plain route that reads the padded cache. A CTA stages its k rows in
// 32-row chunks in shared memory, keeps the split's (G x 256) scores there,
// takes each row's max and sum with one warp per row, then stages the v
// rows and accumulates acc with one thread per (g, d) pair. Each split
// writes (acc, m, l) partials; a second kernel merges a slot's valid splits
// in split order into the same unnormalised statistics (no atomics, so
// repeated calls are bit-equal). The cache is taken by strides: the decode
// loop passes a view that slices S and takes one layer, and copying it
// would read the whole cache every layer. The function must read each
// valid k and v row once, so its bound is device-memory bytes; this first
// version computes with scalar f32 FMAs.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "launchers.h"

namespace {

constexpr int SPLIT = 256;  // positions per CTA: the Pallas kernel's tile
constexpr int CHUNK = 32;   // k or v rows staged at a time
constexpr int THREADS = 128;
constexpr int MAX_G = 16;
constexpr int MAX_HD = 128;
constexpr int PAIRS = MAX_G * MAX_HD / THREADS;  // (g, d) pairs per thread, at most
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

__device__ __forceinline__ int slot_length(const FasnDecode& a, int b) {
  return min(max(a.lengths[b], 0), a.S);
}

// QT: q's type (float, bf16; int8_t under int8 compute, INT8C); KT: the cache's
template <typename QT, typename KT, bool INT8C>
__global__ void __launch_bounds__(THREADS)
    decode_attn_split_kernel(const FasnDecode a, float* __restrict__ part_acc,
                             float* __restrict__ part_m, float* __restrict__ part_l) {
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int s0 = sp * SPLIT;
  const int len = slot_length(a, b);
  if (s0 >= len) return;
  const int n = min(SPLIT, len - s0);
  const int G = a.G, HD = a.HD, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool quantized = a.k_scales != nullptr;

  __shared__ float sQ[MAX_G * MAX_HD];
  __shared__ float sS[MAX_G * SPLIT];
  __shared__ float sKV[CHUNK * (MAX_HD + 1)];
  __shared__ float sRowScale[MAX_G];

  const long long bh = (long long)b * a.KVH + h;
  const QT* q = static_cast<const QT*>(a.q) + bh * G * HD;
  for (int e = tid; e < G * HD; e += THREADS) sQ[e] = to_f32(q[e]);
  const KT* k = static_cast<const KT*>(a.k) + b * a.k_sb + h * a.k_sh;
  const KT* v = static_cast<const KT*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ks = quantized ? a.k_scales + b * a.ks_sb + h * a.ks_sh : nullptr;
  const float* vs = quantized ? a.v_scales + b * a.vs_sb + h * a.vs_sh : nullptr;
  const float* qs = INT8C ? a.q_scales + bh * G : nullptr;

  // scores of the split, chunk by chunk
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int cn = min(CHUNK, n - c0);
    __syncthreads();
    for (int e = tid; e < cn * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      sKV[r * (MAX_HD + 1) + d] = k_operand<QT>(k[(long long)(s0 + c0 + r) * a.k_ss + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * cn; e += THREADS) {
      const int g = e / cn, r = e % cn;
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot = fmaf(sQ[g * HD + d], sKV[r * (MAX_HD + 1) + d], dot);
      if (INT8C) dot = dot * qs[g];
      if (quantized) dot = dot * ks[(long long)(s0 + c0 + r) * a.ks_ss];
      sS[g * SPLIT + c0 + r] = dot;
    }
  }
  __syncthreads();

  // per row: m, p = exp(s - m), l = sum p; fold the v scales into p; round
  // p to bf16 (PV in bf16 unless the cache is f32) or requantize it to int8
  const long long part_row = (bh * gridDim.x + sp) * G;
  for (int g = warp; g < G; g += THREADS / 32) {
    float* row = sS + g * SPLIT;
    float m = NEG_INF;
    for (int r = lane; r < n; r += 32) m = fmaxf(m, row[r]);
    m = warp_max(m);
    float l = 0.f, p_max = 0.f;
    for (int r = lane; r < n; r += 32) {
      float p = expf(row[r] - m);
      l += p;
      if (quantized) p = p * vs[(long long)(s0 + r) * a.vs_ss];
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
    if (lane == 0) {
      part_m[part_row + g] = m;
      part_l[part_row + g] = l;
    }
  }

  // acc[g, d] = sum_p p[g, p] v[p, d]
  float acc[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int cn = min(CHUNK, n - c0);
    __syncthreads();
    for (int e = tid; e < cn * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      sKV[r * (MAX_HD + 1) + d] = to_f32(v[(long long)(s0 + c0 + r) * a.v_ss + d]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx < G * HD) {
        const int g = idx / HD, d = idx % HD;
        const float* prow = sS + g * SPLIT + c0;
        float s = acc[i];
        for (int r = 0; r < cn; ++r) s = fmaf(prow[r], sKV[r * (MAX_HD + 1) + d], s);
        acc[i] = s;
      }
    }
  }
  float* out = part_acc + part_row * HD;
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int idx = tid + i * THREADS;
    if (idx < G * HD) out[idx] = INT8C ? acc[i] * sRowScale[idx / HD] : acc[i];
  }
}

// merge a slot's valid splits in split order; one thread per (b, h, g, d)
__global__ void decode_attn_merge_kernel(const FasnDecode a, int n_splits,
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
    const int valid = (slot_length(a, b) + SPLIT - 1) / SPLIT;
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

template <typename QT, typename KT, bool INT8C>
cudaError_t launch(const FasnDecode& a, float* part_acc, float* part_m, float* part_l,
                   float* acc, float* m, float* l, cudaStream_t stream) {
  const int n_splits = (a.S + SPLIT - 1) / SPLIT;
  if (n_splits > 0) {
    dim3 grid(n_splits, a.KVH, a.B);
    decode_attn_split_kernel<QT, KT, INT8C><<<grid, THREADS, 0, stream>>>(a, part_acc, part_m,
                                                                           part_l);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long total = (long long)a.B * a.KVH * a.G * a.HD;
  const int blocks = static_cast<int>((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                                       : 132 * 16);
  if (blocks == 0) return cudaSuccess;
  decode_attn_merge_kernel<<<blocks, 256, 0, stream>>>(a, n_splits, part_acc, part_m, part_l,
                                                       acc, m, l);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t by_cache(const FasnDecode& a, float* part_acc, float* part_m, float* part_l,
                     float* acc, float* m, float* l, cudaStream_t stream) {
  if (a.kv_dtype == 0) return launch<QT, float, false>(a, part_acc, part_m, part_l, acc, m, l, stream);
  if (a.kv_dtype == 1)
    return launch<QT, __nv_bfloat16, false>(a, part_acc, part_m, part_l, acc, m, l, stream);
  if (a.kv_dtype == 2) return launch<QT, int8_t, false>(a, part_acc, part_m, part_l, acc, m, l, stream);
  if (a.kv_dtype == 3)
    return launch<QT, __nv_fp8_e4m3, false>(a, part_acc, part_m, part_l, acc, m, l, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fasn_decode_attn_splits(int S) { return (S + SPLIT - 1) / SPLIT; }

extern "C" int fasn_decode_attn(const FasnDecode* a, float* part_acc, float* part_m,
                                float* part_l, float* acc, float* m, float* l,
                                cudaStream_t stream) {
  if (a->G < 1 || a->G > MAX_G || a->HD < 1 || a->HD > MAX_HD) return cudaErrorInvalidValue;
  if (a->q_dtype == 0) return by_cache<float>(*a, part_acc, part_m, part_l, acc, m, l, stream);
  if (a->q_dtype == 1)
    return by_cache<__nv_bfloat16>(*a, part_acc, part_m, part_l, acc, m, l, stream);
  if (a->q_dtype == 2 && a->kv_dtype == 2)
    return launch<int8_t, int8_t, true>(*a, part_acc, part_m, part_l, acc, m, l, stream);
  return cudaErrorInvalidValue;
}
