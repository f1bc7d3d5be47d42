// Device code shared by the flash-attention kernels K1 (flash_fwd.cu), K5
// (flash_bwd_dq.cu) and K6 (flash_bwd_dkv.cu): tile shape, dtype
// conversions, row reductions, the score modifiers (bias, ALiBi, causal
// mask) and the dropout hash, so the three kernels form every score and
// every dropout decision the same way. The prefill-phase kernel K10
// (prefill_phases.cu) takes the tile shape, conversions, reductions and
// launch helpers. The tile shape, thread layout and 16-lane reductions are
// those of the scalar f32 kernels; the bf16 kernels of K1, K5, K6 and K10
// run on attn_tile.h's tensor-core tile and take the score modifiers, the
// dropout hash, NEG_INF and DEAD_LSE from here. Device code: only the .cu files, compiled by
// nvcc, include it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "launchers.h"

namespace fasn {

constexpr int BQ = 64;  // query rows of a tile
constexpr int BK = 64;  // keys of a tile
constexpr int THREADS = 256;
// thread (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16 i (i < 4)
// and tile columns tx + 16 j (j < 4)
constexpr int R4 = 4;
// rounded from double, as the Python side computes them
constexpr float NEG_INF = (float)(-0.7 * (double)FLT_MAX);
constexpr float DEAD_LSE = (float)(0.5 * -0.7 * (double)FLT_MAX);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round an f32 value to T's precision and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over the 16 lanes (tx) that share a tile row
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// What the Pallas kernels add to q k^T before the softmax, for one (b, h):
// the f32 bias, then -slope * |q_pos + (S - L) - k_pos| (ALiBi), then
// NEG_INF (finite: -inf - -inf would be NaN) where the key is past S, the
// query past L, or the key causally invisible (k_pos <= q_pos + S - L).
struct ScoreMods {
  const float* bias;  // this (b, h)'s (L, S) plane, or null
  float slope;
  bool alibi;
  bool causal;
  int L, S, off;

  // branch-free in the mask, so the bias loads of a thread's 16 scores are
  // predicated and issued together instead of one per branch
  __device__ __forceinline__ float operator()(float x, int qi, int kj) const {
    const bool ok = kj < S && qi < L && (!causal || kj <= qi + off);
    if (ok && bias) x += bias[(long long)qi * S + kj];
    if (alibi) x -= slope * fabsf((float)(qi + off - kj));
    return ok ? x : NEG_INF;
  }
};

__device__ __forceinline__ ScoreMods score_mods(const FasnAttn& a, int b, int h) {
  ScoreMods m;
  m.bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh : nullptr;
  m.alibi = a.slopes != nullptr;
  m.slope = m.alibi ? a.slopes[h] : 0.f;
  m.causal = a.causal != 0;
  m.L = a.L;
  m.S = a.S;
  m.off = a.S - a.L;
  return m;
}

// Inverted dropout keyed on global coordinates: murmur3's finalizer over
// q*A + k*B + b*C + h*D + seed in wrapping uint32 arithmetic (signed
// overflow would be undefined), kept where its low 31 bits reach the
// threshold round(rate * 2^31). Bit-equal to the JAX package's dropout_keep.
struct Dropout {
  bool on;
  uint32_t seed, threshold;
  float mult;

  __device__ __forceinline__ float operator()(int b, int h, int qi, int kj) const {
    uint32_t x = (uint32_t)qi * 0x9E3779B9u + (uint32_t)kj * 0x85EBCA6Bu +
                 (uint32_t)b * 0xC2B2AE35u + (uint32_t)h * 0x27D4EB2Fu + seed;
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return (x & 0x7FFFFFFFu) >= threshold ? mult : 0.f;
  }
};

__device__ __forceinline__ Dropout dropout_of(const FasnAttn& a) {
  Dropout d;
  d.on = a.seed != nullptr;
  d.seed = d.on ? (uint32_t)a.seed[0] : 0u;
  d.threshold = a.drop_threshold;
  d.mult = a.drop_mult;
  return d;
}

// Calls f(Type<T>{}, Int<D>{}) for the head dim (32, 64, 128);
// cudaErrorInvalidValue for anything else. The scalar kernels take T =
// float (bf16 inputs run on attn_tile.h).
template <typename T>
struct Type {
  using type = T;
};
template <int N>
struct Int {
  static constexpr int value = N;
};

template <typename T, typename F>
cudaError_t dispatch_d(int D, F& f) {
  switch (D) {
    case 32:
      return f(Type<T>{}, Int<32>{});
    case 64:
      return f(Type<T>{}, Int<64>{});
    case 128:
      return f(Type<T>{}, Int<128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// launch with `smem` bytes of dynamic shared memory, raising the kernel's
// limit first (above 48 KB it must be asked for)
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace fasn
