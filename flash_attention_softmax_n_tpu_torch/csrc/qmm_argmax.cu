// K2: int8 lm_head matmul fused with a greedy argmax, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _qmm_argmax_kernel
// (flash_attention_softmax_n_tpu/kernels/quant_matmul.py:117):
//   idx[m] = argmax_n (x[m,:] . float(W[:,n])) * scale[n],  val[m] = that max,
// summed in f32 with the per-column scale applied after accumulation,
// columns past N never winning, the first index winning ties (a NaN logit
// wins over any number, as in torch.max) and the (M, N) logits never
// written to device memory.
//
// What bounds it on the H100: for bf16 x at decode sizes (M64, K2048,
// N32000) the bytes of W, read once: 65.5 MB at 3.35 TB/s, 0.0197 ms; at
// M256 the operations, 2*M*K*N at 989 TFLOP/s (bf16), 0.0339 ms; for f32
// x the operations at 67 TFLOP/s (f32 outside the tensor cores), 0.125 ms
// at M64.
//
// bf16 x: qmm_argmax_wgmma_kernel, K7's tensor-core pieces (qmm_tile.h)
// with an argmax epilogue in place of K7's write. Persistent CTAs walk
// (BM x BN) tiles of out^T = W^T x^T: a producer warp keeps a ring of
// 5-8 stages in flight by TMA (x's BM x 64 box, zero past M; W's 64 rows
// of BN columns, each 128-column box with the 128-byte swizzle), and each
// consumer warpgroup takes 64 columns of W as wgmma's A operand, converted
// from int8 to bf16 in registers (exact), with x's stage as the B operand.
// The plan (kernels/quant_matmul.py qmm_argmax_plan) sets BM by M (64, 128
// or 256). BN is 256 columns at BM 64 (four consumer warpgroups, two W
// boxes a stage), which halves x's share of each stage's bytes at decode
// sizes, where x is re-read from L2 for every column tile while W streams
// from device memory once; 128 above. K is never split: an argmax of
// partial sums is not the argmax of the sum. The CTA count is a multiple
// of the row tiles, so each CTA keeps one row tile and walks its column
// tiles in order.
// Epilogue (ArgmaxTile): each finished tile's f32 sums are scaled, columns
// >= N dropped, and each x row's winner taken over the lanes that share it
// (shuffles); lane p keeps the running winner of every eighth row across
// the CTA's tiles, in registers. Once the walk ends, the 8 or 16 warps'
// winners meet in shared memory (the drained ring), and the CTA writes
// one (value, index) per row to a small scratch; qmm_argmax_merge_kernel
// reduces each row's slots. better() is a total order on (value, index),
// so the answer does not depend on the order of either reduction: no
// atomics, and repeated calls are bit-equal.
//
// f32 x: qmm_argmax_f32_kernel, K7's f32 tiles (qmm_tile.h f32_tile: f32
// FMAs, 8 x 8 outputs a thread, a TMA or cp.async ring of three 32-row
// stages, W converted to f32 once per CTA per stage) over the whole of K,
// bound by 2*M*K*N operations at 67 TFLOP/s (wgmma has no f32 x f32
// product, and one TF32 pass would not hold f32's tolerance). One CTA a
// (BM x 64) tile, BM 64 below M = 128 (four CTAs an SM: 500 CTAs, about one
// wave, at M64 N32000), else 128 (three). Its epilogue scales each sum,
// drops columns >= N and takes each row's winner over the 8 threads that
// share the row (shuffles), and writes one (value, index) slot a row for
// each column tile; the same merge kernel reduces the slots. No serving
// route gives K2 f32 x.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.h"
#include "launchers.h"
#include "qmm_tile.h"

namespace {

using namespace qmm_tile;

// (v, i) beats (bv, bi): larger value, or equal value at a smaller index;
// NaN counts as the largest value, as in torch.max
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool v_nan = isnan(v), b_nan = isnan(bv);
  if (v_nan || b_nan) return v_nan && (!b_nan || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take_better(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// ---------------------------------------------------------------------------
// bf16 x: the tensor-core kernel (qmm_tile.h) with the argmax epilogue
// ---------------------------------------------------------------------------

// The bf16-x consumer's epilogue for K2 (qmm_tile.h consume_bf16). A
// thread's accumulators d[4j + 2i + c] are column n + i (n = n0 + 64 wg +
// 16 warp + 2p, p = lane / 4) of x row 8j + 2q + c (q = lane % 4), so the
// 8 lanes of one q share a row's 16 columns of the warp. Row slot r = 2j +
// c of a thread; after the shuffles over p, lane p keeps the running
// winner of slots p, p + 8, ... (BM / 32 of them).
template <int BM>
struct ArgmaxTile {
  static constexpr int KEEP = BM / 32;
  float* part_val;
  int* part_idx;
  int slots;  // scratch (value, index) pairs per row: the CTAs of a row tile
  float kv[KEEP];
  int ki[KEEP];

  __device__ ArgmaxTile(float* pv, int* pi, int s) : part_val(pv), part_idx(pi), slots(s) {
#pragma unroll
    for (int k = 0; k < KEEP; ++k) {
      kv[k] = -INFINITY;  // with index INT_MAX: loses to every column
      ki[k] = INT_MAX;
    }
  }

  template <int R>
  __device__ __forceinline__ void tile(const Args& g, const Tile& tile, const float (&d)[R],
                                       int wg, int warp, int lane) {
    static_assert(R == BM / 2, "one accumulator per (column pair, row) a thread");
    const int p = lane / 4;
    const int n = tile.n0 + 64 * wg + 16 * warp + 2 * p;
    const bool in0 = n < g.N, in1 = n + 1 < g.N;
    const float s0 = in0 ? g.scales[n] : 0.f, s1 = in1 ? g.scales[n + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < BM / 4; ++r) {
      const int j = r / 2, c = r % 2;
      float bv = in0 ? d[4 * j + c] * s0 : -INFINITY;
      int bi = in0 ? n : INT_MAX;
      if (in1) take_better(d[4 * j + 2 + c] * s1, n + 1, bv, bi);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        take_better(ov, oi, bv, bi);
      }
      if (r % 8 == p) take_better(bv, bi, kv[r / 8], ki[r / 8]);
    }
  }

  // The CTA's walk is done (every wgmma has read its stage, every stage has
  // landed): the warps' winners meet in the ring's first bytes, and one
  // thread a row writes the CTA's (value, index) to its slot.
  template <int CONSUMERS>
  __device__ __forceinline__ void finish(const Args& g, uint8_t* smem) {
    constexpr int WARPS = CONSUMERS / 32;
    float* red_v = reinterpret_cast<float*>(smem);
    int* red_i = reinterpret_cast<int*>(smem + WARPS * BM * 4);
    const int ct = threadIdx.x, w = ct / 32, p = (ct % 32) / 4, q = ct % 4;
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
    for (int k = 0; k < KEEP; ++k) {
      const int r = 8 * k + p, row = 8 * (r / 2) + 2 * q + r % 2;
      red_v[w * BM + row] = kv[k];
      red_i[w * BM + row] = ki[k];
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
    const int tiles_m = (g.M + BM - 1) / BM;
    const int m0 = (blockIdx.x % tiles_m) * BM, slot = blockIdx.x / tiles_m;
    for (int row = ct; row < BM && m0 + row < g.M; row += CONSUMERS) {
      float bv = red_v[row];
      int bi = red_i[row];
      for (int o = 1; o < WARPS; ++o) take_better(red_v[o * BM + row], red_i[o * BM + row], bv, bi);
      part_val[(long long)(m0 + row) * slots + slot] = bv;
      part_idx[(long long)(m0 + row) * slots + slot] = bi;
    }
  }
};

template <int BM, int WIDE>
__global__ void __launch_bounds__(Cfg<false, 8, BM, false, WIDE>::THREADS, 1)
    qmm_argmax_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap, const Args g,
                            float* __restrict__ part_val, int* __restrict__ part_idx, int slots) {
  wgmma_body<false, 8, BM, false, WIDE>(&xmap, &wmap, nullptr, g,
                                        ArgmaxTile<BM>(part_val, part_idx, slots));
}

// ---------------------------------------------------------------------------
// f32 x: K7's f32 tiles (qmm_tile.h f32_tile) with an argmax epilogue
// ---------------------------------------------------------------------------

// A (BM x 64) tile over the whole of K, then each row's winner among the
// tile's columns: thread (tx, ty) holds columns n0 + 4 tx + 32 h + [0, 4)
// of rows m0 + ty + TY i, scaled after accumulation, columns >= N dropped;
// the row's 8 threads (tx: 8 consecutive lanes of one warp) meet by shuffles,
// and tx 0 writes the row's (value, index) to slot blockIdx.x (a slot per
// column tile).
template <int BM>
__device__ __forceinline__ void argmax_f32_tile(const F32Args& g, const F32Sums& t,
                                                float* __restrict__ part_val,
                                                int* __restrict__ part_idx) {
  using C = F32Cfg<BM>;
  const int tx = t.tx, ty = t.ty, n0 = t.n0, m0 = t.m0, slots = gridDim.x;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + 32 * (j / 4) + 4 * tx + j % 4;
    s[j] = n < g.N ? g.scales[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float bv = -INFINITY;  // with index INT_MAX: loses to every column
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 32 * (j / 4) + 4 * tx + j % 4;
      if (n < g.N) take_better(t.acc[i][j] * s[j], n, bv, bi);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      take_better(ov, oi, bv, bi);
    }
    const int m = m0 + ty + C::TY * i;
    if (tx == 0 && m < g.M) {
      part_val[(long long)m * slots + blockIdx.x] = bv;
      part_idx[(long long)m * slots + blockIdx.x] = bi;
    }
  }
}

template <int BM, bool TMA>
__global__ void __launch_bounds__(F32Cfg<BM>::THREADS, F32Cfg<BM>::MIN_BLOCKS)
    qmm_argmax_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, const F32Args g,
                          float* __restrict__ part_val, int* __restrict__ part_idx) {
  F32Sums t;
  f32_tile<8, BM, TMA>(&xmap, &wmap, nullptr, g, nullptr, t);
  argmax_f32_tile<BM>(g, t, part_val, part_idx);
}

template <int BM, bool TMA>
cudaError_t launch_f32_tiles(const F32Args& g, float* part_val, int* part_idx,
                             cudaStream_t stream) {
  const auto kernel = qmm_argmax_f32_kernel<BM, TMA>;
  cudaError_t err = f32_smem<BM>(kernel);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{};  // left zero for the cp.async loader, which reads none
  if (TMA && !f32_maps<8, BM>(&xmap, &wmap, nullptr, g)) return cudaErrorInvalidValue;
  const dim3 grid((g.N + F32_BN - 1) / F32_BN, (g.M + BM - 1) / BM);
  kernel<<<grid, F32Cfg<BM>::THREADS, F32Cfg<BM>::SMEM, stream>>>(xmap, wmap, g, part_val,
                                                                  part_idx);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_f32_loader(bool tma, const F32Args& g, float* part_val, int* part_idx,
                              cudaStream_t stream) {
  return tma ? launch_f32_tiles<BM, true>(g, part_val, part_idx, stream)
             : launch_f32_tiles<BM, false>(g, part_val, part_idx, stream);
}

// ---------------------------------------------------------------------------
// the merge: one warp per row over the row's slots
// ---------------------------------------------------------------------------

__global__ void qmm_argmax_merge_kernel(const float* __restrict__ part_val,
                                        const int* __restrict__ part_idx, int* __restrict__ out_idx,
                                        float* __restrict__ out_val, int M, int slots) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int t = lane; t < slots; t += 32)
    take_better(part_val[(long long)row * slots + t], part_idx[(long long)row * slots + t], bv,
                bi);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, s);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
    take_better(ov, oi, bv, bi);
  }
  if (lane == 0) {
    out_idx[row] = bi;
    out_val[row] = bv;
  }
}

cudaError_t launch_merge(const float* part_val, const int* part_idx, int* out_idx, float* out_val,
                         int M, int slots, cudaStream_t stream) {
  constexpr int ROWS_PER_BLOCK = 8;
  qmm_argmax_merge_kernel<<<(M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, 32 * ROWS_PER_BLOCK, 0,
                            stream>>>(part_val, part_idx, out_idx, out_val, M, slots);
  return cudaGetLastError();
}

// the tensor-core kernel on `ctas` persistent CTAs (a multiple of the row
// tiles, at most the tiles: the operator checks the plan), then the merge
template <int BM, int WIDE>
cudaError_t launch_tc(Args g, float* part_val, int* part_idx, int* out_idx, float* out_val,
                      int ctas, cudaStream_t stream) {
  using C = Cfg<false, 8, BM, false, WIDE>;
  const int tiles_m = (g.M + BM - 1) / BM;
  g.tiles = tiles_m * ((g.N + C::BN - 1) / C::BN);
  const auto kernel = qmm_argmax_wgmma_kernel<BM, WIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{};  // left zero for the predicated producer, which reads none
  if (g.use_tma &&
      !(encode_2d(&xmap, g.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g.M, g.K, C::BK, BM,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode_2d(&wmap, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, g.K, g.N, ROW, C::BK,
                  CU_TENSOR_MAP_SWIZZLE_128B)))
    return cudaErrorInvalidValue;
  const int slots = ctas / tiles_m;
  kernel<<<ctas, C::THREADS, C::SMEM, stream>>>(xmap, wmap, g, part_val, part_idx, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge(part_val, part_idx, out_idx, out_val, g.M, slots, stream);
}

}  // namespace

extern "C" int fasn_qmm_argmax(const void* x, const void* w, const float* scales,
                               float* part_val, int* part_idx, int* out_idx, float* out_val,
                               int M, int K, int N, int dtype, int bm, int ctas, int use_tma,
                               cudaStream_t stream) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (dtype == 0) {
    // every K stage in the one split: an argmax of partial sums is not the
    // argmax of the sum
    const F32Args f{static_cast<const float*>(x), wq, scales, nullptr, nullptr, 0, M, K, N,
                    (K + F32_BK - 1) / F32_BK};
    const bool tma = use_tma != 0;
    cudaError_t err = bm == 64    ? launch_f32_loader<64>(tma, f, part_val, part_idx, stream)
                      : bm == 128 ? launch_f32_loader<128>(tma, f, part_val, part_idx, stream)
                                  : cudaErrorInvalidValue;
    if (err != cudaSuccess) return err;
    return launch_merge(part_val, part_idx, out_idx, out_val, M, (N + F32_BN - 1) / F32_BN,
                        stream);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const int n_slices = (K + Cfg<false, 8, 64>::BK - 1) / Cfg<false, 8, 64>::BK;
  const Args g{x,       nullptr, wq,      scales,   nullptr, nullptr, nullptr, nullptr,
               0,       M,       K,       N,        1,       n_slices, use_tma, 0};
  if (bm == 64) return launch_tc<64, 2>(g, part_val, part_idx, out_idx, out_val, ctas, stream);
  if (bm == 128) return launch_tc<128, 1>(g, part_val, part_idx, out_idx, out_val, ctas, stream);
  if (bm == 256) return launch_tc<256, 1>(g, part_val, part_idx, out_idx, out_val, ctas, stream);
  return cudaErrorInvalidValue;
}
