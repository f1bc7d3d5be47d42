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
// qmm_tile.h, which K9 (fused_mlp.cu) and K2 (qmm_argmax.cu) build on too.
//
// f32 activations take qmm_f32_kernel, f32 FMAs outside the tensor cores:
// wgmma has no f32 x f32 product, and one TF32 pass would not hold the f32
// tolerance, so it is bound by 2*M*K*N operations at 67 TFLOP/s. No serving
// path gives it f32 x; an int4 BERT or XLNet in f32 (models/bert.py _mm)
// does. A CTA of BM threads computes a (BM x 64) tile, 8 x 8 outputs a
// thread, BM 128 (three CTAs an SM: 384 tiles fill the SMs' slots at
// BERT-base's M4096 N768) or, below M = 128, 64:
// - each stage is 32 logical K rows: x's (BM x 128-byte) box with the
//   128-byte swizzle and W's bytes (32 rows, one nibble of 32 packed rows
//   under grouped int4, the tensor-core kernel's stage order), in a ring of
//   three stages loaded ahead of the FMAs by TMA (x with K % 4 == 0 and W
//   with N % 16 == 0) or, for other shapes, predicated 4-byte cp.async into
//   the same x layout and W rows as aligned words;
// - when a stage lands, the CTA converts its W bytes once into an f32
//   (32 x 64) tile in logical K order, instead of once per use; two tiles
//   alternate, so that stage s + 1 converts while stage s multiplies, with
//   one barrier a stage;
// - a thread reads its 8 rows of x along K as float4 (its rows share one
//   swizzle phase, so a warp's reads do not conflict) and 2 float4 of the
//   W tile a k: 4 shared-memory vector reads for 64 FMAs a k;
// - the epilogue scales the f32 sums and stores 4 outputs at a time; with
//   split K (decode sizes) the f32 partials go to qmm_splitk_sum_kernel.
// These f32 pieces live in qmm_tile.h too (F32Cfg, f32_tile), where K2's
// and K9's f32-x kernels take them with epilogues of their own.

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
// the f32 mode: FMAs on (BM x 64) tiles (qmm_tile.h f32_body)
// ---------------------------------------------------------------------------

template <int BITS, int BM, bool TMA>
__global__ void __launch_bounds__(F32Cfg<BM>::THREADS, F32Cfg<BM>::MIN_BLOCKS)
    qmm_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const F32Args g) {
  f32_body<BITS, BM, TMA>(&xmap, &wmap, g);
}

template <int BITS, int BM, bool TMA>
cudaError_t launch_f32_tiles(const F32Args& g, int splits, cudaStream_t stream) {
  const auto kernel = qmm_f32_kernel<BITS, BM, TMA>;
  cudaError_t err = f32_smem<BM>(kernel);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{};  // left zero for the cp.async loader, which reads none
  if (TMA && !f32_maps<BITS, BM>(&xmap, &wmap, nullptr, g)) return cudaErrorInvalidValue;
  const dim3 grid((g.N + F32_BN - 1) / F32_BN, (g.M + BM - 1) / BM, splits);
  kernel<<<grid, F32Cfg<BM>::THREADS, F32Cfg<BM>::SMEM, stream>>>(xmap, wmap, g);
  return cudaGetLastError();
}

template <int BITS, int BM>
cudaError_t launch_f32_loader(bool tma, const F32Args& g, int splits, cudaStream_t stream) {
  return tma ? launch_f32_tiles<BITS, BM, true>(g, splits, stream)
             : launch_f32_tiles<BITS, BM, false>(g, splits, stream);
}

template <int BITS>
cudaError_t launch_f32_rows(int bm, bool tma, const F32Args& g, int splits, cudaStream_t stream) {
  if (bm == 64) return launch_f32_loader<BITS, 64>(tma, g, splits, stream);
  if (bm == 128) return launch_f32_loader<BITS, 128>(tma, g, splits, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(int bits, int bm, bool tma, const F32Args& g, int splits,
                       cudaStream_t stream) {
  cudaError_t err = bits == 8   ? launch_f32_rows<8>(bm, tma, g, splits, stream)
                    : bits == 4 ? launch_f32_rows<4>(bm, tma, g, splits, stream)
                                : cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum(false, g.part, g.scales, nullptr, g.out, g.out_bf16, g.M, g.N, splits,
                    stream);
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

extern "C" int fasn_qmm_f32_layout(int bm, int dual, int* stages) {
  if (bm != 64 && bm != 128) return -1;
  *stages = F32Cfg<64>::STAGES;
  if (dual) return bm == 64 ? F32Cfg<64, true>::SMEM : F32Cfg<128, true>::SMEM;
  return bm == 64 ? F32Cfg<64>::SMEM : F32Cfg<128>::SMEM;
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
  if (x_dtype == 0) {
    const F32Args f{static_cast<const float*>(x), wq, scales, static_cast<float*>(partial), out,
                    out_dtype, M, K, N, slices_per_split};
    return launch_f32(bits, bm, use_tma != 0, f, splits, stream);
  }
  const Args g{x,   x_dtype == 2 ? x_scales : nullptr, wq, scales, nullptr, nullptr, partial,
               out, out_dtype, M, K, N, splits, slices_per_split, use_tma, 0};
  if (x_dtype == 1) return by_shape<false>(bits, bm, g, stream);
  if (x_dtype == 2) return by_shape<true>(bits, bm, g, stream);
  return cudaErrorInvalidValue;
}
