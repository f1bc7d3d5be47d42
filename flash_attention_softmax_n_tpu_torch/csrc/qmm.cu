// K7: x @ dequant(W) with the per-column scale applied after accumulation,
// for Hopper (sm_90a): int8 weights, grouped int4 weights, and W8A8 (int8
// activations with a per-row scale).
//
// Replaces the Pallas kernel _qmm_kernel
// (flash_attention_softmax_n_tpu/kernels/quant_matmul.py:65):
//   out[m,n] = (sum_k x[m,k] * W[k,n]) * scale[n]            (x bf16 or f32)
//   out[m,n] = ((sum_k xq[m,k] * W[k,n]) * scale[n]) * xs[m]  (W8A8)
// The first sums exact products in f32 (W's integers are exact in x's
// type); the second sums int8 x int8 products exactly in int32. Grouped
// int4: byte row i of group g (128 byte rows) holds logical rows 256g+i
// (low nibble) and 256g+128+i (high nibble); K % 256 == 0.
//
// Design: each CTA computes one (64 rows x 64 columns) tile of the product
// over a contiguous range of K, in 32-deep slices staged in shared memory
// (an int4 slice is 16 byte rows, each byte read once and unpacked into
// both of its logical rows). At decode batch sizes the function streams
// all of W once (K*N bytes, half for int4) and its bound is device-memory
// bytes; a narrow N (wk/wv: N = 256) makes only a few column tiles, so K
// is split too until about two CTAs per SM are in flight. Split partials
// (f32, or int32 under W8A8) go to a scratch buffer and a second kernel
// sums them in split order, then applies the scales and casts: no atomics,
// so repeated calls are bit-equal. This first version multiplies with
// scalar f32 FMAs (__dp4a under W8A8) and is bound by their issue rate,
// not by the bytes; at prefill sizes (M up to 2048) it is far from the
// tensor cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "launchers.h"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;  // logical K rows per slice (16 byte rows of int4)
constexpr int THREADS = 256;
constexpr int TARGET_CTAS = 264;  // two per SM of the H100's 132
constexpr int MIN_SLICES_PER_SPLIT = 2;
constexpr int MAX_SPLITS = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ int lo_nibble(int8_t b) {
  return static_cast<int>(static_cast<unsigned>(static_cast<uint8_t>(b)) << 28) >> 28;
}
__device__ __forceinline__ int hi_nibble(int8_t b) { return static_cast<int>(b) >> 4; }

// logical K row of row c (0..31) of slice t
template <int BITS>
__device__ __forceinline__ int slice_row(int t, int c) {
  if (BITS == 8) return t * BK + c;
  const int p = t * (BK / 2) + (c & 15);  // byte row; a slice never crosses a group
  return (p >> 7) * 256 + (p & 127) + (c >= 16 ? 128 : 0);
}

// one output element: scale after accumulation, then the row scale (W8A8)
template <typename OT>
__device__ __forceinline__ void epilogue(OT* out, long long at, float acc, float s,
                                         const float* x_scales, int row) {
  float v = acc * s;
  if (x_scales != nullptr) v = v * x_scales[row];
  store(out + at, v);
}

// XT: x's type (float or bf16; int8_t under W8A8, INTX). Writes the tile
// through the epilogue when there is one split, else its f32 (int32 under
// INTX) partial to part[split][M][N].
template <typename XT, int BITS, bool INTX, typename OT>
__global__ void __launch_bounds__(THREADS)
    qmm_splitk_kernel(const XT* __restrict__ x, const float* __restrict__ x_scales,
                      const int8_t* __restrict__ w, const float* __restrict__ scales,
                      void* __restrict__ part, OT* __restrict__ out, int M, int K, int N,
                      int slices_per_split) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_slices = (K + BK - 1) / BK;
  const int t_begin = blockIdx.z * slices_per_split;
  const int t_end = min(n_slices, t_begin + slices_per_split);

  using Acc = typename std::conditional<INTX, int, float>::type;
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  if constexpr (INTX) {
    // 4 consecutive slice rows packed into one word, for __dp4a
    __shared__ int sX[BM][BK / 4 + 1];
    __shared__ int sW[BN][BK / 4 + 1];
    for (int t = t_begin; t < t_end; ++t) {
      for (int e = tid; e < BM * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), kw = e % (BK / 4), gm = m0 + r;
        unsigned word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gk = slice_row<BITS>(t, 4 * kw + j);
          const int v = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0;
          word |= (static_cast<unsigned>(v) & 0xffu) << (8 * j);
        }
        sX[r][kw] = static_cast<int>(word);
      }
      if (BITS == 8) {
        for (int e = tid; e < BN * (BK / 4); e += THREADS) {
          const int c = e / (BK / 4), kw = e % (BK / 4), gn = n0 + c;
          unsigned word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gk = t * BK + 4 * kw + j;
            const int v = (gn < N && gk < K) ? w[(long long)gk * N + gn] : 0;
            word |= (static_cast<unsigned>(v) & 0xffu) << (8 * j);
          }
          sW[c][kw] = static_cast<int>(word);
        }
      } else {
        // byte rows 4*kw..4*kw+3 of the slice: low nibbles to word kw, high to kw + 4
        for (int e = tid; e < BN * (BK / 8); e += THREADS) {
          const int c = e / (BK / 8), kw = e % (BK / 8), gn = n0 + c;
          unsigned lo = 0, hi = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int8_t b =
                gn < N ? w[(long long)(t * (BK / 2) + 4 * kw + j) * N + gn] : int8_t(0);
            lo |= (static_cast<unsigned>(lo_nibble(b)) & 0xffu) << (8 * j);
            hi |= (static_cast<unsigned>(hi_nibble(b)) & 0xffu) << (8 * j);
          }
          sW[c][kw] = static_cast<int>(lo);
          sW[c][kw + BK / 8] = static_cast<int>(hi);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < BK / 4; ++kw) {
        int xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = sX[ty + 16 * i][kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = sW[tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
  } else {
    __shared__ float sX[BM][BK + 1];
    __shared__ float sW[BK][BN + 1];
    for (int t = t_begin; t < t_end; ++t) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK, gm = m0 + r;
        const int gk = slice_row<BITS>(t, c);
        sX[r][c] = (gm < M && gk < K) ? to_f32(x[(long long)gm * K + gk]) : 0.f;
      }
      if (BITS == 8) {
        for (int e = tid; e < BK * BN; e += THREADS) {
          const int r = e / BN, c = e % BN, gk = t * BK + r, gn = n0 + c;
          sW[r][c] = (gk < K && gn < N) ? static_cast<float>(w[(long long)gk * N + gn]) : 0.f;
        }
      } else {
        for (int e = tid; e < (BK / 2) * BN; e += THREADS) {
          const int r = e / BN, c = e % BN, gn = n0 + c;
          const int8_t b = gn < N ? w[(long long)(t * (BK / 2) + r) * N + gn] : int8_t(0);
          sW[r][c] = static_cast<float>(lo_nibble(b));
          sW[r + BK / 2][c] = static_cast<float>(hi_nibble(b));
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
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
  }

  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      const long long at = (long long)row * N + col;
      if (direct) {
        epilogue(out, at, static_cast<float>(acc[i][j]), scales[col], x_scales, row);
      } else {
        static_cast<Acc*>(part)[(long long)blockIdx.z * M * N + at] = acc[i][j];
      }
    }
  }
}

// sum the split partials in split order, then the epilogue
template <bool INTX, typename OT>
__global__ void qmm_splitk_sum_kernel(const void* __restrict__ part,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ x_scales, OT* __restrict__ out,
                                      int M, int N, int splits) {
  using Acc = typename std::conditional<INTX, int, float>::type;
  const Acc* p = static_cast<const Acc*>(part);
  const long long total = (long long)M * N;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    Acc acc = 0;
    for (int s = 0; s < splits; ++s) acc += p[s * total + at];
    epilogue(out, at, static_cast<float>(acc), scales[at % N], x_scales,
             static_cast<int>(at / N));
  }
}

int splits_for(int M, int K, int N) {
  const int tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int n_slices = (K + BK - 1) / BK;
  if (tiles >= TARGET_CTAS) return 1;
  int s = (TARGET_CTAS + tiles - 1) / tiles;
  s = std::min(s, std::max(1, n_slices / MIN_SLICES_PER_SPLIT));
  s = std::min(s, MAX_SPLITS);
  // no empty split: as many splits as ceil-sized ranges of slices
  const int per = (n_slices + s - 1) / s;
  return (n_slices + per - 1) / per;
}

template <typename XT, int BITS, bool INTX, typename OT>
cudaError_t launch(const void* x, const float* x_scales, const int8_t* w, const float* scales,
                   float* part, void* out, int M, int K, int N, cudaStream_t stream) {
  const int splits = splits_for(M, K, N);
  const int n_slices = (K + BK - 1) / BK;
  const int per = (n_slices + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_splitk_kernel<XT, BITS, INTX, OT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), x_scales, w, scales, part, static_cast<OT*>(out), M, K, N,
      per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)M * N;
  const int blocks = static_cast<int>(std::min<long long>((total + 255) / 256, 132 * 16));
  qmm_splitk_sum_kernel<INTX, OT><<<blocks, 256, 0, stream>>>(part, scales, x_scales,
                                                             static_cast<OT*>(out), M, N, splits);
  return cudaGetLastError();
}

template <typename XT, bool INTX>
cudaError_t by_bits(int bits, int out_dtype, const void* x, const float* x_scales,
                    const int8_t* w, const float* scales, float* part, void* out, int M, int K,
                    int N, cudaStream_t stream) {
  if (bits == 8 && out_dtype == 0)
    return launch<XT, 8, INTX, float>(x, x_scales, w, scales, part, out, M, K, N, stream);
  if (bits == 8 && out_dtype == 1)
    return launch<XT, 8, INTX, __nv_bfloat16>(x, x_scales, w, scales, part, out, M, K, N,
                                              stream);
  if (bits == 4 && out_dtype == 0)
    return launch<XT, 4, INTX, float>(x, x_scales, w, scales, part, out, M, K, N, stream);
  if (bits == 4 && out_dtype == 1)
    return launch<XT, 4, INTX, __nv_bfloat16>(x, x_scales, w, scales, part, out, M, K, N,
                                              stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fasn_qmm_splits(int M, int K, int N) { return splits_for(M, K, N); }

extern "C" int fasn_qmm(const void* x, const float* x_scales, const void* w, const float* scales,
                        float* partial, void* out, int M, int K, int N, int x_dtype, int bits,
                        int out_dtype, cudaStream_t stream) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (x_dtype == 0)
    return by_bits<float, false>(bits, out_dtype, x, nullptr, wq, scales, partial, out, M, K, N,
                                 stream);
  if (x_dtype == 1)
    return by_bits<__nv_bfloat16, false>(bits, out_dtype, x, nullptr, wq, scales, partial, out,
                                         M, K, N, stream);
  if (x_dtype == 2)
    return by_bits<int8_t, true>(bits, out_dtype, x, x_scales, wq, scales, partial, out, M, K, N,
                                 stream);
  return cudaErrorInvalidValue;
}
