// K2: int8 lm_head matmul fused with a greedy argmax, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _qmm_argmax_kernel
// (flash_attention_softmax_n_tpu/kernels/quant_matmul.py:117):
//   idx[m] = argmax_n (x[m,:] . float(W[:,n])) * scale[n],  val[m] = that max,
// with the first index winning ties (a NaN logit wins over any number) and
// the (M, N) logits never written to device memory.
//
// Design: pass 1 gives each CTA one (64 rows x 64 columns) tile of the
// product, accumulated over K in 32-deep slices staged in shared memory
// (W's int8 values are cast to x's type, exact, and the products summed in
// f32); the per-column scale is applied after accumulation, columns past N
// are excluded, and the tile's per-row (max, first index) goes to a small
// (M, N/64) scratch. Pass 2 reduces each row's tile winners in column order.
// The function must stream all of W once (K*N bytes), so at decode batch
// sizes the bound is device-memory bytes; this first version computes with
// scalar f32 FMAs and is bound by their issue rate instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launchers.h"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BKS = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (v, i) beats (bv, bi): larger value, or equal value at a smaller index;
// NaN counts as the largest value, as in torch.max
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool v_nan = isnan(v), b_nan = isnan(bv);
  if (v_nan || b_nan) return v_nan && (!b_nan || i < bi);
  return v > bv || (v == bv && i < bi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    qmm_tile_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scales, float* __restrict__ part_val,
                    int* __restrict__ part_idx, int M, int K, int N, int n_tiles) {
  __shared__ float sX[BM][BKS + 1];
  __shared__ float sW[BKS][BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKS) {
    for (int e = tid; e < BM * BKS; e += THREADS) {
      const int r = e / BKS, c = e % BKS;
      const int gm = m0 + r, gk = k0 + c;
      sX[r][c] = (gm < M && gk < K) ? to_f32(x[(long long)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BKS * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      sW[r][c] = (gk < K && gn < N) ? (float)w[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKS; ++kk) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = sX[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = sW[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      const float val = col < N ? acc[i][j] * scales[col] : -INFINITY;
      if (col < N && better(val, col, bv, bi)) {
        bv = val;
        bi = col;
      }
    }
#pragma unroll
    for (int s = 8; s > 0; s >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int row = m0 + ty + 16 * i;
    if (tx == 0 && row < M) {
      part_val[(long long)row * n_tiles + blockIdx.x] = bv;
      part_idx[(long long)row * n_tiles + blockIdx.x] = bi;
    }
  }
}

// one warp per row: merge the row's tile winners
__global__ void qmm_reduce_kernel(const float* __restrict__ part_val,
                                  const int* __restrict__ part_idx, int* __restrict__ out_idx,
                                  float* __restrict__ out_val, int M, int n_tiles) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int t = lane; t < n_tiles; t += 32) {
    const float v = part_val[(long long)row * n_tiles + t];
    const int i = part_idx[(long long)row * n_tiles + t];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    out_idx[row] = bi;
    out_val[row] = bv;
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* w, const float* scales, float* part_val,
                   int* part_idx, int* out_idx, float* out_val, int M, int K, int N,
                   cudaStream_t stream) {
  const int n_tiles = (N + BN - 1) / BN;
  dim3 grid(n_tiles, (M + BM - 1) / BM);
  qmm_tile_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), w, scales, part_val,
                                                   part_idx, M, K, N, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int ROWS_PER_BLOCK = 8;
  qmm_reduce_kernel<<<(M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK, 0,
                      stream>>>(part_val, part_idx, out_idx, out_val, M, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fasn_qmm_tiles(int N) { return (N + BN - 1) / BN; }

extern "C" int fasn_qmm_argmax(const void* x, const void* w, const float* scales,
                               float* part_val, int* part_idx, int* out_idx, float* out_val,
                               int M, int K, int N, int dtype, cudaStream_t stream) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wq, scales, part_val, part_idx, out_idx, out_val, M, K, N,
                                 stream);
  if (dtype == 0)
    return launch<float>(x, wq, scales, part_val, part_idx, out_idx, out_val, M, K, N, stream);
  return cudaErrorInvalidValue;
}
