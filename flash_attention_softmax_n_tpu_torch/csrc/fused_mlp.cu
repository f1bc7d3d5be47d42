// K9: the SwiGLU MLP of a decode step over int8 weights, for Hopper (sm_90a):
//   out = ((silu(g) * u) @ Wd) * sd,  g = (x @ Wg) * sg,  u = (x @ Wu) * su,
// with g and u accumulated in f32 and scaled before the silu, h = silu(g)*u
// rounded to x's type before the down product, and the down product's
// per-column scale applied after its accumulation.
//
// Replaces the Pallas kernel _mlp_kernel
// (flash_attention_softmax_n_tpu/kernels/fused_mlp.py:44), which walks the
// d_ff axis in order inside one accumulator. On Hopper that would leave one
// CTA per row tile to stream all three weight matrices; instead each CTA
// takes one (64 rows x 64 d_ff columns) tile: it accumulates g and u over K
// in 32-deep slices staged in shared memory, forms its h tile in shared
// memory, and writes its partial down product (64 rows x K, f32) to a
// scratch buffer, K in 64-column chunks. A second kernel sums the d_ff
// tiles' partials in tile order, applies sd and casts: no atomics, so
// repeated calls are bit-equal, and no (M, d_ff) activation reaches device
// memory. At decode batch sizes the function must stream 3*K*F weight
// bytes, so its bound is device-memory bytes; the partials add
// (F/64)*M*K*4 bytes each way. This first version multiplies with scalar
// f32 FMAs and is bound by their issue rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "launchers.h"

namespace {

constexpr int BM = 64;
constexpr int BF = 64;  // d_ff columns per CTA
constexpr int BK = 32;  // K rows per slice of the gate/up products
constexpr int BC = 64;  // output columns per chunk of the down product
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_mlp_kernel(const T* __restrict__ x, const int8_t* __restrict__ wg,
                     const float* __restrict__ sg, const int8_t* __restrict__ wu,
                     const float* __restrict__ su, const int8_t* __restrict__ wd,
                     float* __restrict__ part, int M, int K, int F) {
  // sX (BM x BK+1) | sG, sU (BK x BF+1 each), reused as sD (BF x BC+1) | sH (BM x BF+1)
  __shared__ float smem[BM * (BK + 1) + 2 * BK * (BF + 1) + BM * (BF + 1)];
  float (*sX)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(smem);
  float (*sG)[BF + 1] = reinterpret_cast<float (*)[BF + 1]>(smem + BM * (BK + 1));
  float (*sU)[BF + 1] = reinterpret_cast<float (*)[BF + 1]>(smem + BM * (BK + 1) + BK * (BF + 1));
  float (*sD)[BC + 1] = reinterpret_cast<float (*)[BC + 1]>(smem + BM * (BK + 1));
  float (*sH)[BF + 1] =
      reinterpret_cast<float (*)[BF + 1]>(smem + BM * (BK + 1) + 2 * BK * (BF + 1));
  static_assert(BF * (BC + 1) <= 2 * BK * (BF + 1), "sD must fit in sG and sU");

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int f0 = blockIdx.x * BF, m0 = blockIdx.y * BM;

  float acc_g[4][4], acc_u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_g[i][j] = acc_u[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK, gm = m0 + r;
      sX[r][c] = gm < M ? to_f32(x[(long long)gm * K + k0 + c]) : 0.f;
    }
    for (int e = tid; e < BK * BF; e += THREADS) {
      const int r = e / BF, c = e % BF;
      const long long at = (long long)(k0 + r) * F + f0 + c;
      sG[r][c] = static_cast<float>(wg[at]);
      sU[r][c] = static_cast<float>(wu[at]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float xv[4], gv[4], uv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sX[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        gv[j] = sG[kk][tx + 16 * j];
        uv[j] = sU[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_g[i][j] = fmaf(xv[i], gv[j], acc_g[i][j]);
          acc_u[i][j] = fmaf(xv[i], uv[j], acc_u[i][j]);
        }
    }
    __syncthreads();
  }

  // h = silu(g * sg) * (u * su), rounded to x's type (JAX's jax.nn.silu:
  // g * sigmoid(g), sigmoid = 1 / (1 + exp(-g)))
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    const float s_g = sg[f0 + c], s_u = su[f0 + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float g = acc_g[i][j] * s_g;
      const float u = acc_u[i][j] * s_u;
      sH[ty + 16 * i][c] = round_to(g * (1.f / (1.f + expf(-g))) * u, static_cast<T*>(nullptr));
    }
  }

  float* out_part = part + (long long)blockIdx.x * M * K;
  for (int c0 = 0; c0 < K; c0 += BC) {
    __syncthreads();  // sH written; sD free for the next chunk
    for (int e = tid; e < BF * BC; e += THREADS) {
      const int r = e / BC, c = e % BC;
      sD[r][c] = static_cast<float>(wd[(long long)(f0 + r) * K + c0 + c]);
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int f = 0; f < BF; ++f) {
      float hv[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = sH[ty + 16 * i][f];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = sD[f][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(hv[i], dv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out_part[(long long)row * K + c0 + tx + 16 * j] = acc[i][j];
    }
  }
}

// sum the d_ff tiles' partials in tile order, scale by sd, cast
template <typename T>
__global__ void fused_mlp_sum_kernel(const float* __restrict__ part,
                                     const float* __restrict__ sd, T* __restrict__ out, int M,
                                     int K, int tiles) {
  const long long total = (long long)M * K;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc += part[t * total + at];
    store(out + at, acc * sd[at % K]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wg, const float* sg, const int8_t* wu,
                   const float* su, const int8_t* wd, const float* sd, float* part, void* out,
                   int M, int K, int F, cudaStream_t stream) {
  const int tiles = F / BF;
  dim3 grid(tiles, (M + BM - 1) / BM);
  fused_mlp_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), wg, sg, wu, su, wd,
                                                    part, M, K, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)M * K;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 132 * 16));
  fused_mlp_sum_kernel<T><<<blocks, 256, 0, stream>>>(part, sd, static_cast<T*>(out), M, K,
                                                      tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fasn_fused_mlp_tiles(int F) { return F / BF; }

extern "C" int fasn_fused_mlp(const void* x, const void* wg, const float* sg, const void* wu,
                              const float* su, const void* wd, const float* sd, float* partial,
                              void* out, int M, int K, int F, int dtype,
                              cudaStream_t stream) {
  if (K % BC != 0 || F % BF != 0) return cudaErrorInvalidValue;
  const int8_t* g = static_cast<const int8_t*>(wg);
  const int8_t* u = static_cast<const int8_t*>(wu);
  const int8_t* d = static_cast<const int8_t*>(wd);
  if (dtype == 0) return launch<float>(x, g, sg, u, su, d, sd, partial, out, M, K, F, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, sg, u, su, d, sd, partial, out, M, K, F, stream);
  return cudaErrorInvalidValue;
}
