// K7: x @ dequant(W) with the per-column scale applied after accumulation,
// for Hopper (sm_90a): int8 weights, grouped int4 weights, and W8A8 (int8
// activations with a per-row scale).
//
// Replaces the Pallas kernel _qmm_kernel
// (flash_attention_softmax_n_tpu/kernels/quant_matmul.py:65):
//   out[m,n] = (sum_k x[m,k] * W[k,n]) * scale[n]            (x bf16 or f32)
//   out[m,n] = ((sum_k xq[m,k] * W[k,n]) * scale[n]) * xs[m]  (W8A8)
// The first sums exact products in f32 (W's integers are exact in bf16);
// the second sums int8 x int8 products exactly in int32. Grouped int4: byte
// row i of group g (128 byte rows) holds logical rows 256g+i (low nibble)
// and 256g+128+i (high nibble); K % 256 == 0.
//
// What bounds it on the H100: at prefill sizes (M of 1024-2048 rows) the
// operations, 2*M*K*N at 989 TFLOP/s (bf16) or 1979 TOP/s (int8); at decode
// sizes (M <= 64) the bytes of W, read once (K*N, half that for int4) at
// 3.35 TB/s.
//
// qmm_wgmma_kernel (bf16 or int8 activations) multiplies on the tensor
// cores. Persistent CTAs, one per SM, walk the (BM x 128) output tiles (BM =
// 64 rows of x below M = 128, 128 from there; 256 for bf16 x where the plan
// finds that it takes fewer rounds of tiles), each over its range of K
// stages of one 128-byte row (64 logical K rows of bf16 x, 128 of int8 x):
// - a producer warp keeps a ring of 5-8 stages (as many as shared memory
//   holds) in flight with TMA, on into the next tile while the consumers
//   write the last one: x's (BM x 128-byte) box and the stage's W rows
//   (N-contiguous), both with the 128-byte swizzle. Rows past M and
//   columns past K or N arrive as zeros. A stage's x columns are
//   contiguous; under grouped int4 they lie in one half of one 256-row
//   group, so its W rows are one nibble of as many packed byte rows, each
//   loaded once per nibble (the second time mostly from L2): no permuted
//   copy of x is made.
// - bf16 x: out^T = W^T x^T. Each consumer warpgroup takes 64 of the 128
//   columns of W as wgmma's A operand in registers: ldmatrix.trans of the
//   stage's W bytes, converted to bf16 in registers (exact: |w| <= 127 fits
//   bf16's significand). x's stage is the B operand. Nothing is written
//   back to shared memory, and wgmma.m64n{256,128,64}k16.f32.bf16.bf16
//   keeps three k16 steps in flight while the next one converts.
// - int8 x (W8A8): wgmma.m64n128k32.s32.s8.s8 reads 8-bit operands from
//   shared memory K-major only, and its register fragments hold four
//   consecutive k, which ldmatrix's transposed 16-bit pairs do not give. So
//   x's stage is the A operand (one consumer warpgroup per 64 rows of x)
//   and the consumers rewrite W's stage transposed as the B operand; three
//   such tiles rotate so that one converts while wgmma reads another,
//   handed over by a proxy fence and a barrier of the consumers.
// Where a row stride is not a multiple of 16 bytes (TMA's requirement:
// bf16 x with K % 8, int8 x with K % 16, W with N % 16), the producer warp
// fills the same stage layout with predicated loads instead; the wrapper's
// plan (kernels/quant_matmul.py qmm_plan) chooses it from the shape before
// the launch. At decode sizes few tiles exist, so K is split until about one
// CTA per SM is in flight; the split partials (f32, or int32 under W8A8) go
// to a scratch buffer and qmm_splitk_sum_kernel sums them in split order,
// then applies the scales and casts: no atomics, so repeated calls are
// bit-equal. The ring, producer, consumers and kernel body live in
// qmm_tile.h, which K9 (fused_mlp.cu) builds on too.
//
// f32 activations take qmm_splitk_kernel, scalar f32 FMAs on 64x64 tiles:
// wgmma has no f32 x f32 product, and TF32 would not hold the f32
// tolerance. No serving path gives K7 f32 activations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "hopper.h"
#include "launchers.h"
#include "qmm_tile.h"

namespace {

using namespace qmm_tile;

// sum the split partials in split order, then the epilogue
template <bool INTX>
__global__ void qmm_splitk_sum_kernel(const void* __restrict__ part,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ x_scales, void* __restrict__ out,
                                      int out_bf16, int M, int N, int splits) {
  using Acc = typename std::conditional<INTX, int, float>::type;
  splitk_sum(static_cast<const Acc*>(part), scales, x_scales, out, out_bf16, M, N, splits);
}

cudaError_t launch_sum(bool intx, const void* part, const float* scales, const float* x_scales,
                       void* out, int out_bf16, int M, int N, int splits, cudaStream_t stream) {
  const int blocks = sum_blocks((long long)M * N);
  if (intx)
    qmm_splitk_sum_kernel<true>
        <<<blocks, 256, 0, stream>>>(part, scales, x_scales, out, out_bf16, M, N, splits);
  else
    qmm_splitk_sum_kernel<false>
        <<<blocks, 256, 0, stream>>>(part, scales, x_scales, out, out_bf16, M, N, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the f32 mode: scalar FMAs on (64 x 64) tiles, 32-deep K slices
// ---------------------------------------------------------------------------

constexpr int F32_BM = 64;
constexpr int F32_BN = 64;
constexpr int F32_BK = 32;  // logical K rows per slice (16 byte rows of int4)
constexpr int F32_THREADS = 256;

__device__ __forceinline__ float lo_nibble(int8_t b) {
  return static_cast<float>(static_cast<int>(static_cast<unsigned>(static_cast<uint8_t>(b))
                                             << 28) >> 28);
}
__device__ __forceinline__ float hi_nibble(int8_t b) {
  return static_cast<float>(static_cast<int>(b) >> 4);
}

// logical K row of row c (0..31) of slice t
template <int BITS>
__device__ __forceinline__ int f32_slice_row(int t, int c) {
  if (BITS == 8) return t * F32_BK + c;
  const int p = t * (F32_BK / 2) + (c & 15);  // byte row; a slice never crosses a group
  return (p >> 7) * 256 + (p & 127) + (c >= 16 ? 128 : 0);
}

// Writes the tile through the epilogue when there is one split, else its
// f32 partial to part[split][M][N].
template <int BITS>
__global__ void __launch_bounds__(F32_THREADS)
    qmm_splitk_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scales, float* __restrict__ part,
                      void* __restrict__ out, int out_bf16, int M, int K, int N,
                      int slices_per_split) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * F32_BN, m0 = blockIdx.y * F32_BM;
  const int n_slices = (K + F32_BK - 1) / F32_BK;
  const int t_begin = blockIdx.z * slices_per_split;
  const int t_end = min(n_slices, t_begin + slices_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  __shared__ float sX[F32_BM][F32_BK + 1];
  __shared__ float sW[F32_BK][F32_BN + 1];
  for (int t = t_begin; t < t_end; ++t) {
    for (int e = tid; e < F32_BM * F32_BK; e += F32_THREADS) {
      const int r = e / F32_BK, c = e % F32_BK, gm = m0 + r;
      const int gk = f32_slice_row<BITS>(t, c);
      sX[r][c] = (gm < M && gk < K) ? x[(long long)gm * K + gk] : 0.f;
    }
    if (BITS == 8) {
      for (int e = tid; e < F32_BK * F32_BN; e += F32_THREADS) {
        const int r = e / F32_BN, c = e % F32_BN, gk = t * F32_BK + r, gn = n0 + c;
        sW[r][c] = (gk < K && gn < N) ? static_cast<float>(w[(long long)gk * N + gn]) : 0.f;
      }
    } else {
      for (int e = tid; e < (F32_BK / 2) * F32_BN; e += F32_THREADS) {
        const int r = e / F32_BN, c = e % F32_BN, gn = n0 + c;
        const int8_t b =
            gn < N ? w[(long long)(t * (F32_BK / 2) + r) * N + gn] : int8_t(0);
        sW[r][c] = lo_nibble(b);
        sW[r + F32_BK / 2][c] = hi_nibble(b);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < F32_BK; ++kk) {
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
      if (direct)
        store_out(out, out_bf16, at, scaled(acc[i][j], scales[col], nullptr, row), 0.f, false);
      else
        part[(long long)blockIdx.z * M * N + at] = acc[i][j];
    }
  }
}

cudaError_t launch_f32(int bits, const float* x, const int8_t* w, const float* scales, float* part,
                       void* out, int out_bf16, int M, int K, int N, int splits, int per,
                       cudaStream_t stream) {
  dim3 grid((N + F32_BN - 1) / F32_BN, (M + F32_BM - 1) / F32_BM, splits);
  if (bits == 8)
    qmm_splitk_kernel<8><<<grid, F32_THREADS, 0, stream>>>(x, w, scales, part, out, out_bf16, M,
                                                           K, N, per);
  else
    qmm_splitk_kernel<4><<<grid, F32_THREADS, 0, stream>>>(x, w, scales, part, out, out_bf16, M,
                                                           K, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum(false, part, scales, nullptr, out, out_bf16, M, N, splits, stream);
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (qmm_tile.h): TMA ring, W converted on its way to wgmma
// ---------------------------------------------------------------------------

template <bool S8, int BITS, int BM>
__global__ void __launch_bounds__(Cfg<S8, BITS, BM>::THREADS, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Args g) {
  wgmma_body<S8, BITS, BM, false>(&xmap, &wmap, nullptr, g);
}

template <bool S8, int BITS, int BM>
cudaError_t launch_tc(Args g, cudaStream_t stream) {
  cudaError_t err = launch_wgmma<S8, BITS, BM, false>(qmm_wgmma_kernel<S8, BITS, BM>, g, stream);
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_sum(S8, g.part, g.scales, g.x_scales, g.out, g.out_bf16, g.M, g.N, g.splits,
                    stream);
}

template <bool S8, int BITS>
cudaError_t by_rows(int bm, const Args& g, cudaStream_t stream) {
  if (bm == 64) return launch_tc<S8, BITS, 64>(g, stream);
  if (bm == 128) return launch_tc<S8, BITS, 128>(g, stream);
  if constexpr (!S8)  // W8A8 would need four consumer warpgroups
    if (bm == 256) return launch_tc<S8, BITS, 256>(g, stream);
  return cudaErrorInvalidValue;
}

template <bool S8>
cudaError_t by_shape(int bits, int bm, const Args& g, cudaStream_t stream) {
  if (bits == 8) return by_rows<S8, 8>(bm, g, stream);
  if (bits == 4) return by_rows<S8, 4>(bm, g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fasn_qmm_stage_k(int x_dtype) {
  return x_dtype == 0 ? F32_BK : x_dtype == 1 ? Cfg<false, 8, 64>::BK : Cfg<true, 8, 64>::BK;
}

extern "C" int fasn_qmm(const void* x, const float* x_scales, const void* w, const float* scales,
                        void* partial, void* out, int M, int K, int N, int x_dtype, int bits,
                        int out_dtype, int bm, int splits, int slices_per_split,
                        int use_tma, cudaStream_t stream) {
  const int n_slices = (K + fasn_qmm_stage_k(x_dtype) - 1) / fasn_qmm_stage_k(x_dtype);
  // every slice in exactly one split, and no split empty
  if (splits < 1 || slices_per_split < 1 || (long long)splits * slices_per_split < n_slices ||
      (long long)(splits - 1) * slices_per_split >= n_slices)
    return cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (x_dtype == 0)
    return bm == F32_BM && !use_tma
               ? launch_f32(bits, static_cast<const float*>(x), wq, scales,
                            static_cast<float*>(partial), out, out_dtype, M, K, N, splits,
                            slices_per_split, stream)
               : cudaErrorInvalidValue;
  const Args g{x,   x_dtype == 2 ? x_scales : nullptr, wq, scales, nullptr, nullptr, partial,
               out, out_dtype, M, K, N, splits, slices_per_split, use_tma, 0};
  if (x_dtype == 1) return by_shape<false>(bits, bm, g, stream);
  if (x_dtype == 2) return by_shape<true>(bits, bm, g, stream);
  return cudaErrorInvalidValue;
}
