// K9: the SwiGLU MLP of a decode step over int8 weights, for Hopper (sm_90a):
//   out = ((silu(g) * u) @ Wd) * sd,  g = (x @ Wg) * sg,  u = (x @ Wu) * su,
// with g and u accumulated in f32 and scaled before the silu, h = silu(g)*u
// rounded to x's type before the down product, and the down product's
// per-column scale applied after its accumulation.
//
// Replaces the Pallas kernel _mlp_kernel
// (flash_attention_softmax_n_tpu/kernels/fused_mlp.py:44), which walks the
// d_ff axis in order inside one accumulator so that v5e's pipeline warms up
// once. That reason does not carry over to Hopper, and the function is the
// same if h (M x F, x's type) goes through device memory between two
// products: at decode sizes it is 2*M*F*2 bytes (1.4 MB at M64 F5632),
// against the 3*K*F weight bytes (34.6 MB) that bound the function.
//
// bf16 x: two phases, each on K7's tensor-core pieces (qmm_tile.h: TMA
// ring and producer warp, persistent CTAs, out^T = W^T x^T with W's int8
// columns converted to bf16 in registers as wgmma's A operand):
// 1. fused_mlp_gateup_kernel: a tile is 64 d_ff columns of both Wg and Wu
//    (one ring stage carries both, 64-byte rows with the 64-byte swizzle)
//    by 64, 128 or 256 rows of x; consumer warpgroup 0 multiplies Wg,
//    warpgroup 1 Wu, and the epilogue forms h = silu(g * sg) * (u * su) in
//    bf16 (u handed over in shared memory). At M64 F5632 that is 88 tiles,
//    one round over the SMs with no split. Where the tiles fill less than
//    half the SMs, K is split as K7's plan does; the partials of g and u
//    then go to a scratch buffer and fused_mlp_swiglu_sum_kernel sums them
//    in split order and forms h, since the silu is not linear.
// 2. fused_mlp_down_kernel: h @ Wd with sd after accumulation, K7's int8
//    bf16-x kernel under K9's name, launched from here (not through K7's
//    operator, so K7's launch count does not move), with at most 4 K splits
//    summed in split order by fused_mlp_down_sum_kernel: at M64 K2048 their
//    round trip is 4.2 MB.
// Device-memory traffic at M64 K2048 F5632: weights 34.6 MB, x and out
// 0.5 MB, h 1.4 MB, down partials 4.2 MB: 40.8 MB, 1.18x the weights. No
// atomics: repeated calls are bit-equal. The plan (kernels/fused_mlp.py
// fused_mlp_plan) chooses both phases' tiles, rings, splits and producers
// (TMA, or predicated loads where a row stride is not a multiple of 16
// bytes) before the launch; the launcher checks it.
//
// f32 x: the same two phases on K7's f32 tiles (qmm_tile.h f32_tile: f32
// FMAs, 8 x 8 outputs a thread, a TMA or cp.async ring of three 32-row
// stages, W converted to f32 once per CTA per stage), bound by 6*M*K*F
// operations at 67 TFLOP/s: wgmma has no f32 x f32 product, and TF32 would
// not hold 1e-5.
// 1. fused_mlp_gateup_f32_kernel: a tile is 32 d_ff columns of both Wg and
//    Wu (a stage carries both matrices' rows, converted once per CTA into
//    one 64-column f32 tile) by 64 rows of x below M = 128, else 128; each
//    thread holds g and u of the same (row, column) pairs, and the epilogue
//    forms h = silu(g * sg) * (u * su) in f32 (x's type: h is never
//    rounded). Where the tiles fill less than half the CTA slots (four CTAs
//    an SM at 64 rows, three at 128), K is split into as many ranges as
//    fill them (176 tiles, 3 splits at M64 F5632); the partials go to a
//    scratch buffer and fused_mlp_swiglu_sum_f32_kernel sums them in split
//    order and forms h.
// 2. fused_mlp_down_f32_kernel: h @ Wd with sd after accumulation, K7's f32
//    kernel under K9's name (launched from here, so K7's launch count does
//    not move), split as K7's f32 plan splits it and summed in split order
//    by fused_mlp_down_sum_f32_kernel.
// Any K and F: the cp.async loader takes rows off 16 bytes. No serving
// path gives K9 f32 x.

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

// ---------------------------------------------------------------------------
// bf16 x: the tensor-core phases
// ---------------------------------------------------------------------------

template <int BM>
__global__ void __launch_bounds__(Cfg<false, 8, BM, true>::THREADS, 1)
    fused_mlp_gateup_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const __grid_constant__ CUtensorMap umap, const Args g) {
  wgmma_body<false, 8, BM, true>(&xmap, &wmap, &umap, g);
}

template <int BM>
__global__ void __launch_bounds__(Cfg<false, 8, BM>::THREADS, 1)
    fused_mlp_down_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap, const Args g) {
  wgmma_body<false, 8, BM, false>(&xmap, &wmap, nullptr, g);
}

// h[m][f] = silu(g * sg) * (u * su) in H (bf16 or f32), g and u summed
// over the splits' partials (part[2s][m][f] and part[2s + 1][m][f]) in
// split order
template <typename H>
__device__ __forceinline__ void swiglu_sum(const float* __restrict__ part,
                                           const float* __restrict__ sg,
                                           const float* __restrict__ su, H* __restrict__ h, int M,
                                           int F, int splits) {
  const long long total = (long long)M * F;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    float gs = 0.f, us = 0.f;
    for (int s = 0; s < splits; ++s) {
      gs += part[2 * s * total + at];
      us += part[(2 * s + 1) * total + at];
    }
    const int f = static_cast<int>(at % F);
    const float v = swiglu(gs * sg[f], us * su[f]);
    if constexpr (std::is_same<H, float>::value)
      h[at] = v;
    else
      h[at] = __float2bfloat16(v);
  }
}

__global__ void fused_mlp_swiglu_sum_kernel(const float* __restrict__ part,
                                            const float* __restrict__ sg,
                                            const float* __restrict__ su,
                                            __nv_bfloat16* __restrict__ h, int M, int F,
                                            int splits) {
  swiglu_sum(part, sg, su, h, M, F, splits);
}

__global__ void fused_mlp_down_sum_kernel(const float* __restrict__ part,
                                          const float* __restrict__ sd, void* __restrict__ out,
                                          int M, int K, int splits) {
  splitk_sum(part, sd, nullptr, out, 1, M, K, splits);
}

template <int BM>
cudaError_t gate_up(Args g, int stages, cudaStream_t stream) {
  if (stages != Cfg<false, 8, BM, true>::STAGES) return cudaErrorInvalidValue;  // not the build's
  cudaError_t err = launch_wgmma<false, 8, BM, true>(fused_mlp_gateup_kernel<BM>, g, stream);
  if (err != cudaSuccess || g.splits == 1) return err;
  fused_mlp_swiglu_sum_kernel<<<sum_blocks((long long)g.M * g.N), 256, 0, stream>>>(
      static_cast<const float*>(g.part), g.scales, g.scales2,
      static_cast<__nv_bfloat16*>(g.out), g.M, g.N, g.splits);
  return cudaGetLastError();
}

template <int BM>
cudaError_t down(Args g, int stages, cudaStream_t stream) {
  if (stages != Cfg<false, 8, BM, false>::STAGES) return cudaErrorInvalidValue;  // not the build's
  cudaError_t err = launch_wgmma<false, 8, BM, false>(fused_mlp_down_kernel<BM>, g, stream);
  if (err != cudaSuccess || g.splits == 1) return err;
  fused_mlp_down_sum_kernel<<<sum_blocks((long long)g.M * g.N), 256, 0, stream>>>(
      static_cast<const float*>(g.part), g.scales, g.out, g.M, g.N, g.splits);
  return cudaGetLastError();
}

template <int BM>
cudaError_t phase(bool gate_up_phase, const Args& g, int stages, cudaStream_t stream) {
  return gate_up_phase ? gate_up<BM>(g, stages, stream) : down<BM>(g, stages, stream);
}

cudaError_t by_rows(int bm, bool gate_up_phase, const Args& g, int stages, cudaStream_t stream) {
  if (bm == 64) return phase<64>(gate_up_phase, g, stages, stream);
  if (bm == 128) return phase<128>(gate_up_phase, g, stages, stream);
  if (bm == 256) return phase<256>(gate_up_phase, g, stages, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 x: K7's f32 tiles (qmm_tile.h f32_tile), the same two phases
// ---------------------------------------------------------------------------

// (a) BM rows of x by 32 d_ff columns of both Wg and Wu (DUAL): thread (tx,
// ty) holds g (acc[i][j]) and u (acc[i][4 + j]) of d_ff columns f0 + 4 tx +
// j, j < 4, of rows m0 + ty + TY i. One split: h = silu(g * sg) * (u * su)
// in f32; several: the split's g and u partials to part[2z] and part[2z + 1].
template <int BM>
__device__ __forceinline__ void swiglu_f32_tile(const F32Args& g, const float* __restrict__ su,
                                                const F32Sums& t) {
  using C = F32Cfg<BM, true>;
  const float(&acc)[8][8] = t.acc;
  const int f = t.n0 + 4 * t.tx, ty = t.ty, m0 = t.m0;
  if (f >= g.N) return;
  const int count = min(4, g.N - f);
  const bool vec = g.N % 4 == 0, split = gridDim.z > 1;
  const long long total = (long long)g.M * g.N;
  float s_g[4], s_u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s_g[j] = j < count ? g.scales[f + j] : 0.f;
    s_u[j] = j < count ? su[f + j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + C::TY * i;
    if (m >= g.M) continue;
    const long long at = (long long)m * g.N + f;
    if (split) {
      const float gp[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
      const float up[4] = {acc[i][4], acc[i][5], acc[i][6], acc[i][7]};
      store4(g.part + 2 * blockIdx.z * total, false, at, gp, count, vec);
      store4(g.part + (2 * blockIdx.z + 1) * total, false, at, up, count, vec);
    } else {
      float h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = swiglu(acc[i][j] * s_g[j], acc[i][4 + j] * s_u[j]);
      store4(g.out, false, at, h, count, vec);
    }
  }
}

template <int BM, bool TMA>
__global__ void __launch_bounds__(F32Cfg<BM, true>::THREADS, F32Cfg<BM, true>::MIN_BLOCKS)
    fused_mlp_gateup_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                                const __grid_constant__ CUtensorMap wmap,
                                const __grid_constant__ CUtensorMap umap, const F32Args g,
                                const int8_t* __restrict__ wu, const float* __restrict__ su) {
  F32Sums t;
  f32_tile<8, BM, TMA, true>(&xmap, &wmap, &umap, g, wu, t);
  swiglu_f32_tile<BM>(g, su, t);
}

__global__ void fused_mlp_swiglu_sum_f32_kernel(const float* __restrict__ part,
                                                const float* __restrict__ sg,
                                                const float* __restrict__ su,
                                                float* __restrict__ h, int M, int F,
                                                int splits) {
  swiglu_sum(part, sg, su, h, M, F, splits);
}

// (b) h @ Wd with sd after accumulation: K7's f32 kernel under K9's name
template <int BM, bool TMA>
__global__ void __launch_bounds__(F32Cfg<BM>::THREADS, F32Cfg<BM>::MIN_BLOCKS)
    fused_mlp_down_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap wmap, const F32Args g) {
  f32_body<8, BM, TMA>(&xmap, &wmap, g);
}

__global__ void fused_mlp_down_sum_f32_kernel(const float* __restrict__ part,
                                              const float* __restrict__ sd,
                                              void* __restrict__ out, int M, int K, int splits) {
  splitk_sum(part, sd, nullptr, out, 0, M, K, splits);
}

template <int BM, bool TMA>
cudaError_t gate_up_f32(const F32Args& g, const int8_t* wu, const float* su, int splits,
                        cudaStream_t stream) {
  const auto kernel = fused_mlp_gateup_f32_kernel<BM, TMA>;
  cudaError_t err = f32_smem<BM, true>(kernel);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{}, umap{};  // left zero for the cp.async loader, which reads none
  if (TMA && !f32_maps<8, BM, true>(&xmap, &wmap, &umap, g, wu)) return cudaErrorInvalidValue;
  const dim3 grid((g.N + F32Cfg<BM, true>::BN - 1) / F32Cfg<BM, true>::BN, (g.M + BM - 1) / BM,
                  splits);
  kernel<<<grid, F32Cfg<BM, true>::THREADS, F32Cfg<BM, true>::SMEM, stream>>>(xmap, wmap, umap,
                                                                              g, wu, su);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  fused_mlp_swiglu_sum_f32_kernel<<<sum_blocks((long long)g.M * g.N), 256, 0, stream>>>(
      g.part, g.scales, su, static_cast<float*>(g.out), g.M, g.N, splits);
  return cudaGetLastError();
}

template <int BM, bool TMA>
cudaError_t down_f32(const F32Args& g, int splits, cudaStream_t stream) {
  const auto kernel = fused_mlp_down_f32_kernel<BM, TMA>;
  cudaError_t err = f32_smem<BM>(kernel);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{};  // left zero for the cp.async loader, which reads none
  if (TMA && !f32_maps<8, BM>(&xmap, &wmap, nullptr, g)) return cudaErrorInvalidValue;
  const dim3 grid((g.N + F32_BN - 1) / F32_BN, (g.M + BM - 1) / BM, splits);
  kernel<<<grid, F32Cfg<BM>::THREADS, F32Cfg<BM>::SMEM, stream>>>(xmap, wmap, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  fused_mlp_down_sum_f32_kernel<<<sum_blocks((long long)g.M * g.N), 256, 0, stream>>>(
      g.part, g.scales, g.out, g.M, g.N, splits);
  return cudaGetLastError();
}

template <int BM, bool TMA>
cudaError_t phase_f32(bool gate_up_phase, const F32Args& g, const int8_t* wu, const float* su,
                      int splits, cudaStream_t stream) {
  return gate_up_phase ? gate_up_f32<BM, TMA>(g, wu, su, splits, stream)
                       : down_f32<BM, TMA>(g, splits, stream);
}

// one phase of the f32 plan: 64 or 128 rows a tile, the ring F32Cfg builds
cudaError_t by_rows_f32(int bm, bool tma, bool gate_up_phase, const F32Args& g,
                        const int8_t* wu, const float* su, int stages, int splits,
                        cudaStream_t stream) {
  if (stages != F32Cfg<64>::STAGES) return cudaErrorInvalidValue;  // not the build's
  if (bm == 64)
    return tma ? phase_f32<64, true>(gate_up_phase, g, wu, su, splits, stream)
               : phase_f32<64, false>(gate_up_phase, g, wu, su, splits, stream);
  if (bm == 128)
    return tma ? phase_f32<128, true>(gate_up_phase, g, wu, su, splits, stream)
               : phase_f32<128, false>(gate_up_phase, g, wu, su, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fasn_fused_mlp(const FasnMlp* a, const FasnMlpPlan* plan, cudaStream_t stream) {
  const int8_t* wg = static_cast<const int8_t*>(a->wg);
  const int8_t* wu = static_cast<const int8_t*>(a->wu);
  const int8_t* wd = static_cast<const int8_t*>(a->wd);
  if (a->dtype == 0) {
    // x (M x K) times Wg and Wu (K x F) -> h (M x F, f32)
    const F32Args gu{static_cast<const float*>(a->x), wg, a->sg, a->gu_part, a->h, 0, a->M, a->K,
                     a->F, plan->gu_per};
    cudaError_t err = by_rows_f32(plan->gu_bm, plan->gu_tma, true, gu, wu, a->su,
                                  plan->gu_stages, plan->gu_splits, stream);
    if (err != cudaSuccess) return err;
    // h (M x F) times Wd (F x K) -> out (M x K)
    const F32Args dn{static_cast<const float*>(a->h), wd, a->sd, a->dn_part, a->out, 0, a->M,
                     a->F, a->K, plan->dn_per};
    return by_rows_f32(plan->dn_bm, plan->dn_tma, false, dn, nullptr, nullptr, plan->dn_stages,
                       plan->dn_splits, stream);
  }
  if (a->dtype != 1) return cudaErrorInvalidValue;
  // x (M x K) times Wg and Wu (K x F) -> h (M x F)
  const Args gu{a->x, nullptr, wg, a->sg, wu, a->su, a->gu_part, a->h, 1, a->M, a->K, a->F,
                plan->gu_splits, plan->gu_per, plan->gu_tma, 0};
  cudaError_t err = by_rows(plan->gu_bm, true, gu, plan->gu_stages, stream);
  if (err != cudaSuccess) return err;
  // h (M x F) times Wd (F x K) -> out (M x K)
  const Args dn{a->h, nullptr, wd, a->sd, nullptr, nullptr, a->dn_part, a->out, 1, a->M, a->F,
                a->K, plan->dn_splits, plan->dn_per, plan->dn_tma, 0};
  return by_rows(plan->dn_bm, false, dn, plan->dn_stages, stream);
}
