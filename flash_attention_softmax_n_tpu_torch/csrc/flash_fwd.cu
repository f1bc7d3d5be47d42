// K1: softmax-N flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas forward kernels _fwd_single_kernel, _fwd_kernel and
// _fwd_pipeline_kernel (flash_attention_softmax_n_tpu/kernels/
// flash_attention.py:345, :279, :501): three TPU tilings of one function,
//   o = softmax_n(q k^T * scale + bias) v,  lse = log(n + sum_j exp(s_j)).
// The +n enters as a phantom key with score 0 and value 0: the online
// softmax starts from m = 0, l = n (n > 0) instead of m = NEG_INF, l = 0.
//
// Design: one CTA per (q tile of 64 rows, head, batch); the CTA loops over
// KV tiles of 64 keys with an f32 online softmax, so scores never reach
// device memory. 256 threads; thread (ty, tx) owns rows ty + 16 i (i < 4)
// of the tile, score columns tx + 16 j and output columns tx + 16 j, so the
// row statistics (m, l) and the rescale factor live in registers and a row
// reduction is a shuffle across 16 lanes. Products are scalar f32 FMAs from
// shared memory (no tensor cores yet), so at long sequences the kernel is
// bound by shared-memory bandwidth and f32 issue rate, far from the card's
// bf16 tensor-core bound; at serving prefill shapes it is small next to the
// matmuls around it.
//
// Numerics follow the Pallas kernel: the scale is folded into q in q's
// dtype, scores and statistics are f32, the f32 bias is added before
// masking, masked keys take NEG_INF (finite: -inf - -inf would be NaN),
// p is rounded to v's dtype before the PV product, and at n == 0 a row with
// no visible key (rectangular causal with L > S) gives o = 0, lse = NEG_INF.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "launchers.h"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int RQ = BQ / 16;  // rows per thread
constexpr int CK = BK / 16;  // score columns per thread
// rounded from double, as the Python side computes it
constexpr float NEG_INF = (float)(-0.7 * (double)FLT_MAX);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
                     int H, int L, int S, long long bias_sb, long long bias_sh, float scale,
                     float n, int causal) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;           // BQ x DP
  float* sK = sQ + BQ * DP;   // BK x DP
  float* sV = sK + BK * DP;   // BK x D
  float* sP = sV + BK * D;    // BQ x BKP

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * H + h;
  const T* qb = q + bh * L * D;
  const T* kb = k + bh * S * D;
  const T* vb = v + bh * S * D;
  const float* biasb = bias ? bias + b * bias_sb + h * bias_sh : nullptr;
  const int off = S - L;  // rectangular causal offset

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < L) val = round_to<T>(to_f32(qb[(long long)(q0 + r) * D + c]) * scale);
    sQ[r * DP + c] = val;
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = n > 0.f ? 0.f : NEG_INF;
    l[i] = n;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int kv_end = S;
  if (causal) {
    const int last_row = min(q0 + BQ, L) - 1;
    kv_end = min(S, last_row + off + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < S) {
        kv = to_f32(kb[(long long)(k0 + r) * D + c]);
        vv = to_f32(vb[(long long)(k0 + r) * D + c]);
      }
      sK[r * DP + c] = kv;
      sV[r * D + c] = vv;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < S && qi < L && (!causal || kj <= qi + off);
        float x = s[i][j];
        if (ok && biasb) x += biasb[(long long)qi * S + kj];
        x = ok ? x : NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        rsum += p;
        sP[(ty + 16 * i) * BKP + tx + 16 * j] = round_to<T>(p);
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = sP[(ty + 16 * i) * BKP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= L) continue;
    const bool dead = n == 0.f && (l[i] == 0.f || m[i] == NEG_INF);
    T* orow = o + (bh * L + qi) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = from_f32<T>(dead ? 0.f : acc[i][c] / l[i]);
    if (tx == 0) lse[bh * L + qi] = dead ? NEG_INF : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* o,
                   float* lse, int B, int H, int L, int S, long long bias_sb, long long bias_sh,
                   float scale, float n, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(o), lse, H, L, S, bias_sb, bias_sh, scale, n, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const float* bias,
                       void* o, float* lse, int B, int H, int L, int S, long long bias_sb,
                       long long bias_sh, float scale, float n, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, bias, o, lse, B, H, L, S, bias_sb, bias_sh, scale, n, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, o, lse, B, H, L, S, bias_sb, bias_sh, scale, n, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, o, lse, B, H, L, S, bias_sb, bias_sh, scale, n,
                            causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fasn_flash_fwd(const void* q, const void* k, const void* v, const float* bias,
                              void* o, float* lse, int B, int H, int L, int S, int D, int dtype,
                              long long bias_sb, long long bias_sh, float scale, float n,
                              int causal, cudaStream_t stream) {
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, bias, o, lse, B, H, L, S, bias_sb, bias_sh,
                                     scale, n, causal, stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, bias, o, lse, B, H, L, S, bias_sb, bias_sh, scale, n,
                             causal, stream);
  return cudaErrorInvalidValue;
}
