// Device code shared by the flash-attention kernels K1 (flash_fwd.cu), K5
// (flash_bwd_dq.cu) and K6 (flash_bwd_dkv.cu): tile shape, dtype
// conversions, row reductions, the score modifiers (bias, ALiBi, causal
// mask) and the dropout hash, so the three kernels form every score and
// every dropout decision the same way. The prefill-phase kernel K10
// (prefill_phases.cu) takes the tile shape, conversions, reductions and
// launch helpers. The tile shape, thread layout and 16-lane reductions are
// those of the scalar f32 kernels; the bf16 kernels of K1, K5, K6 and K10,
// and K1's, K5's and K6's f32 kernels at D <= 128 (flash_fwd_f32.cu,
// flash_bwd_f32.cu) and K5's and K6's above (flash_bwd_f32_wide.cu), run on
// attn_tile.h's tensor-core tiles and take the score modifiers, the
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

// Calls f(Type<T>{}, Int<D>{}) for the head dim (32, 64, 128, and 256 up
// to MAX_D); cudaErrorInvalidValue for anything else. The scalar kernels
// take T = float.
template <typename T>
struct Type {
  using type = T;
};
template <int N>
struct Int {
  static constexpr int value = N;
};

template <typename T, int MAX_D = 128, typename F>
cudaError_t dispatch_d(int D, F& f) {
  switch (D) {
    case 32:
      return f(Type<T>{}, Int<32>{});
    case 64:
      return f(Type<T>{}, Int<64>{});
    case 128:
      return f(Type<T>{}, Int<128>{});
    case 256:
      if constexpr (MAX_D >= 256) return f(Type<T>{}, Int<256>{});
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Head dims above 256 (multiples of WIDE_OC, as the wrappers pad them): the
// wide scalar kernels of K1 (bf16 above 512: its bf16 kernel at 384 and
// 512 takes all of D a CTA, attn_tile.h's WideRing, and f32 K1 streams D
// through flash_fwd_f32_wide.cu's ring) and K10 (f32, and bf16 above 512;
// K5 and K6 stream D through attn_tile.h's chunk_dots in bf16 and
// flash_bwd_f32_wide.cu's ring in f32). A CTA takes
// WIDE_OC columns of the outputs (column chunk blockIdx.z % (D / WIDE_OC))
// and accumulates the scores it needs over the whole of D in WIDE_KC-column
// chunks through shared memory, so its shared memory does not grow with D.
// Every CTA of a tile forms the same scores in the same order, so the row
// statistics (lse, delta) agree bit for bit across its column chunks; the
// score products are done D / WIDE_OC times over, which a repair accepts.
// ---------------------------------------------------------------------------
constexpr int WIDE_KC = 64;   // D columns of a score chunk
constexpr int WIDE_OC = 128;  // output columns of a CTA
constexpr int WIDE_KP = WIDE_KC + 1;

__host__ __device__ constexpr bool wide_d(int D) { return D > 256 && D % WIDE_OC == 0; }

// the grid's z: (batch, column chunk) pairs; 0 if it does not fit
inline unsigned wide_z(int B, int D) {
  const long long z = (long long)B * (D / WIDE_OC);
  return z <= 65535 ? static_cast<unsigned>(z) : 0u;
}

// columns d0 .. d0 + WIDE_KC of rows row0 .. row0 + TB - 1 of a (rows, D)
// head into dst (TB x WIDE_KP), times `scale` rounded to T (scale 1 keeps a
// value as it is), rows at or past `end` as zeros
template <typename T, int TB>
__device__ __forceinline__ void wide_chunk(float* dst, const T* src, int row0, int end, int D,
                                           int d0, float scale) {
  for (int i = threadIdx.x; i < TB * WIDE_KC; i += THREADS) {
    const int r = i / WIDE_KC, c = i % WIDE_KC;
    float x = 0.f;
    if (row0 + r < end) x = round_to<T>(to_f32(src[(long long)(row0 + r) * D + d0 + c]) * scale);
    dst[r * WIDE_KP + c] = x;
  }
}

// s[i][j] = sum over d < D of A[a0 + ty + 16 i][d] B[b0 + tx + 16 j][d],
// in WIDE_KC-column chunks from column 0 up, as the scalar kernels sum: A
// scaled by a_scale and B by b_scale, each rounded to T; A's rows at or
// past a_end and B's past b_end as zeros. smem holds the chunks: 2 x TB x
// WIDE_KP floats. Every chunk starts with __syncthreads, so the caller's
// buffers of the previous tile are free once it returns.
template <typename T, int R>
__device__ __forceinline__ void wide_dots(float* smem, int D, const T* A, float a_scale, int a0,
                                          int a_end, const T* B, float b_scale, int b0, int b_end,
                                          float (&s)[R][R]) {
  constexpr int TB = 16 * R;
  float* sA = smem;
  float* sB = sA + TB * WIDE_KP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += WIDE_KC) {
    __syncthreads();
    wide_chunk<T, TB>(sA, A, a0, a_end, D, d0, a_scale);
    wide_chunk<T, TB>(sB, B, b0, b_end, D, d0, b_scale);
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < WIDE_KC; ++d) {
      float av[R], bv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) av[i] = sA[(ty + 16 * i) * WIDE_KP + d];
#pragma unroll
      for (int j = 0; j < R; ++j) bv[j] = sB[(tx + 16 * j) * WIDE_KP + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

// columns oc0 .. oc0 + WIDE_OC of rows row0 .. row0 + TB - 1 of a (rows, D)
// head into dst (TB x WIDE_OC), times `scale` rounded to T, rows at or past
// `end` as zeros
template <typename T, int TB>
__device__ __forceinline__ void wide_cols(float* dst, const T* src, int row0, int end, int D,
                                          int oc0, float scale) {
  for (int i = threadIdx.x; i < TB * WIDE_OC; i += THREADS) {
    const int r = i / WIDE_OC, c = i % WIDE_OC;
    float x = 0.f;
    if (row0 + r < end) x = round_to<T>(to_f32(src[(long long)(row0 + r) * D + oc0 + c]) * scale);
    dst[i] = x;
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
