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
// f32 x keeps the scalar kernel, as K7's f32 mode does: wgmma has no f32 x
// f32 product, and TF32 would not hold 1e-5. Each CTA takes one (64 rows x
// 64 d_ff columns) tile: it accumulates g and u over K in 32-deep slices
// staged in shared memory, forms its h tile, and writes its partial down
// product (64 rows x K, f32) to a scratch buffer; fused_mlp_sum_kernel sums
// the d_ff tiles' partials in tile order, applies sd and casts. No serving
// path gives K9 f32 x.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

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

// h[m][f] = silu(g * sg) * (u * su) in bf16, g and u summed over the splits'
// partials (part[2s][m][f] and part[2s + 1][m][f]) in split order
__global__ void fused_mlp_swiglu_sum_kernel(const float* __restrict__ part,
                                            const float* __restrict__ sg,
                                            const float* __restrict__ su,
                                            __nv_bfloat16* __restrict__ h, int M, int F,
                                            int splits) {
  const long long total = (long long)M * F;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    float gs = 0.f, us = 0.f;
    for (int s = 0; s < splits; ++s) {
      gs += part[2 * s * total + at];
      us += part[(2 * s + 1) * total + at];
    }
    const int f = static_cast<int>(at % F);
    h[at] = __float2bfloat16(swiglu(gs * sg[f], us * su[f]));
  }
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
// f32 x: the scalar kernel
// ---------------------------------------------------------------------------

constexpr int S_BM = 64;
constexpr int S_BF = 64;  // d_ff columns per CTA
constexpr int S_BK = 32;  // K rows per slice of the gate/up products
constexpr int S_BC = 64;  // output columns per chunk of the down product
constexpr int S_THREADS = 256;

__global__ void __launch_bounds__(S_THREADS)
    fused_mlp_kernel(const float* __restrict__ x, const int8_t* __restrict__ wg,
                     const float* __restrict__ sg, const int8_t* __restrict__ wu,
                     const float* __restrict__ su, const int8_t* __restrict__ wd,
                     float* __restrict__ part, int M, int K, int F) {
  // sX (S_BM x S_BK+1) | sG, sU (S_BK x S_BF+1 each), reused as sD
  // (S_BF x S_BC+1) | sH (S_BM x S_BF+1)
  __shared__ float smem[S_BM * (S_BK + 1) + 2 * S_BK * (S_BF + 1) + S_BM * (S_BF + 1)];
  float (*sX)[S_BK + 1] = reinterpret_cast<float (*)[S_BK + 1]>(smem);
  float (*sG)[S_BF + 1] = reinterpret_cast<float (*)[S_BF + 1]>(smem + S_BM * (S_BK + 1));
  float (*sU)[S_BF + 1] =
      reinterpret_cast<float (*)[S_BF + 1]>(smem + S_BM * (S_BK + 1) + S_BK * (S_BF + 1));
  float (*sD)[S_BC + 1] = reinterpret_cast<float (*)[S_BC + 1]>(smem + S_BM * (S_BK + 1));
  float (*sH)[S_BF + 1] =
      reinterpret_cast<float (*)[S_BF + 1]>(smem + S_BM * (S_BK + 1) + 2 * S_BK * (S_BF + 1));
  static_assert(S_BF * (S_BC + 1) <= 2 * S_BK * (S_BF + 1), "sD must fit in sG and sU");

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int f0 = blockIdx.x * S_BF, m0 = blockIdx.y * S_BM;

  float acc_g[4][4], acc_u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_g[i][j] = acc_u[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += S_BK) {
    for (int e = tid; e < S_BM * S_BK; e += S_THREADS) {
      const int r = e / S_BK, c = e % S_BK, gm = m0 + r;
      sX[r][c] = gm < M ? x[(long long)gm * K + k0 + c] : 0.f;
    }
    for (int e = tid; e < S_BK * S_BF; e += S_THREADS) {
      const int r = e / S_BF, c = e % S_BF;
      const long long at = (long long)(k0 + r) * F + f0 + c;
      sG[r][c] = static_cast<float>(wg[at]);
      sU[r][c] = static_cast<float>(wu[at]);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < S_BK; ++kk) {
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

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = tx + 16 * j;
    const float s_g = sg[f0 + c], s_u = su[f0 + c];
#pragma unroll
    for (int i = 0; i < 4; ++i) sH[ty + 16 * i][c] = swiglu(acc_g[i][j] * s_g, acc_u[i][j] * s_u);
  }

  float* out_part = part + (long long)blockIdx.x * M * K;
  for (int c0 = 0; c0 < K; c0 += S_BC) {
    __syncthreads();  // sH written; sD free for the next chunk
    for (int e = tid; e < S_BF * S_BC; e += S_THREADS) {
      const int r = e / S_BC, c = e % S_BC;
      sD[r][c] = static_cast<float>(wd[(long long)(f0 + r) * K + c0 + c]);
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int f = 0; f < S_BF; ++f) {
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

// sum the d_ff tiles' partials in tile order, scale by sd
__global__ void fused_mlp_sum_kernel(const float* __restrict__ part, const float* __restrict__ sd,
                                     float* __restrict__ out, int M, int K, int tiles) {
  const long long total = (long long)M * K;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int t = 0; t < tiles; ++t) acc += part[t * total + at];
    out[at] = acc * sd[at % K];
  }
}

cudaError_t launch_f32(const float* x, const int8_t* wg, const float* sg, const int8_t* wu,
                       const float* su, const int8_t* wd, const float* sd, float* part,
                       float* out, int M, int K, int F, cudaStream_t stream) {
  if (K % S_BC != 0 || F % S_BF != 0) return cudaErrorInvalidValue;
  const int tiles = F / S_BF;
  dim3 grid(tiles, (M + S_BM - 1) / S_BM);
  fused_mlp_kernel<<<grid, S_THREADS, 0, stream>>>(x, wg, sg, wu, su, wd, part, M, K, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_mlp_sum_kernel<<<sum_blocks((long long)M * K), 256, 0, stream>>>(part, sd, out, M, K,
                                                                          tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fasn_fused_mlp_tiles(int F) { return F / S_BF; }

extern "C" int fasn_fused_mlp(const FasnMlp* a, const FasnMlpPlan* plan, cudaStream_t stream) {
  const int8_t* wg = static_cast<const int8_t*>(a->wg);
  const int8_t* wu = static_cast<const int8_t*>(a->wu);
  const int8_t* wd = static_cast<const int8_t*>(a->wd);
  if (a->dtype == 0)
    return launch_f32(static_cast<const float*>(a->x), wg, a->sg, wu, a->su, wd, a->sd,
                      a->gu_part, static_cast<float*>(a->out), a->M, a->K, a->F, stream);
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
