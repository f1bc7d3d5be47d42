// K10: the prefill-phase ablation kernel for Hopper (sm_90a). Per (b, h),
// with q, k, v (B, H, L, D):
//   s = q k^T in f32 (no scale, no +n);
//   p = s (dots_only), exp(s) (exp_only), softmax(s) (softmax), or softmax
//       of s with keys past the query masked to -1e30 (mask_softmax);
//   o = round(p) v, p rounded to v's type, f32 sums, o in q's type.
//
// Replaces the Pallas kernel _mini_kernel
// (scripts/profile_prefill_phases.py:45), which takes 512 query rows and
// all L keys into one block and materialises the (512, L) f32 scores.
//
// What bounds it on the H100: the operations, 4 D per (query, key) pair at
// 989 TFLOP/s (bf16): 0.0695 ms at B2 H32 L2048 hd64, half that causal
// (mask_softmax); the second pass of the softmax modes adds 2 D per pair
// that the bound does not count.
//
// bf16: prefill_phase_wgmma_kernel, K1's attention tile (attn_tile.h) with
// the mode as a template parameter: TMA brings Q once and K/V tiles of 128
// keys; two consumer warpgroups run QK^T and PV with wgmma, P passed in
// registers. dots_only and exp_only take one pass (exp_only with K1's exp,
// so that it times what K1 spends on exponentials). The softmax modes take
// two: pass 1 loads K alone and keeps each row's max m and sum l; pass 2
// recomputes s, forms p = exp(s - m) / l, rounds it and accumulates PV, so
// p is rounded from the final (m, l) as in the plain version, which
// materialises p; they keep expf and an IEEE division per element, so that
// p's bf16 rounding stays within mini_tolerance of the plain version's.
// mask_softmax stops at the tile holding the diagonal: keys past it would
// add exp(-1e30 - m) = 0.
//
// f32: prefill_phase_kernel, scalar f32 FMAs from shared memory, one CTA
// per 64 query rows (flash_common.h's tile and thread layout, as K1's f32
// kernel), the same two passes.

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

constexpr float MASKED = -1e30f;  // the Pallas kernel's mask value

enum Mode { DOTS_ONLY = 0, EXP_ONLY = 1, SOFTMAX = 2, MASK_SOFTMAX = 3 };

template <int D>
constexpr size_t mini_smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D + size_t(BQ) * (BK + 1));
}

// the thread's 4 x 4 scores of the tile (rows ty + 16 i, keys k0 + tx + 16 j)
// from sQ and sK, masked: keys past L score NEG_INF in every mode that takes
// a max (and p = 0 in the others), keys past the query -1e30 when causal
template <int D>
__device__ __forceinline__ void tile_scores(const float* sQ, const float* sK, int ty, int tx,
                                            int q0, int k0, int L, bool causal,
                                            float (&s)[R4][R4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < R4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[R4], kv[R4];
#pragma unroll
    for (int i = 0; i < R4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < R4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < R4; ++j) {
      const int qi = q0 + ty + 16 * i, kj = k0 + tx + 16 * j;
      if (kj >= L) s[i][j] = NEG_INF;
      else if (causal && kj > qi) s[i][j] = MASKED;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    prefill_phase_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o, int H, int L, int mode) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x DP
  float* sK = sQ + BQ * DP;  // BK x DP
  float* sV = sK + BK * DP;  // BK x D
  float* sP = sV + BK * D;   // BQ x BKP

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * H + h;
  const T* qb = q + bh * L * D;
  const T* kb = k + bh * L * D;
  const T* vb = v + bh * L * D;
  const bool causal = mode == MASK_SOFTMAX;
  const bool normalise = mode == SOFTMAX || mode == MASK_SOFTMAX;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    sQ[r * DP + c] = q0 + r < L ? to_f32(qb[(long long)(q0 + r) * D + c]) : 0.f;
  }
  // keys at or below the tile's last row are all a causal row can see
  const int kv_end = causal ? min(L, q0 + BQ) : L;

  // pass 1 (softmax modes): each row's max m and sum l = sum exp(s - m)
  float m[R4], l[R4];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  if (normalise) {
    for (int k0 = 0; k0 < kv_end; k0 += BK) {
      __syncthreads();
      for (int i = tid; i < BK * D; i += THREADS) {
        const int r = i / D, c = i % D;
        sK[r * DP + c] = k0 + r < L ? to_f32(kb[(long long)(k0 + r) * D + c]) : 0.f;
      }
      __syncthreads();
      float s[R4][R4];
      tile_scores<D>(sQ, sK, ty, tx, q0, k0, L, causal, s);
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        float rmax = NEG_INF;
#pragma unroll
        for (int j = 0; j < R4; ++j) rmax = fmaxf(rmax, s[i][j]);
        const float m_new = fmaxf(m[i], row_max16(rmax));
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < R4; ++j) rsum += expf(s[i][j] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + row_sum16(rsum);
        m[i] = m_new;
      }
    }
  }

  // pass 2: p from the final (m, l) or from s alone, rounded to T, then PV
  float acc[R4][CD];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < L) {
        kv = to_f32(kb[(long long)(k0 + r) * D + c]);
        vv = to_f32(vb[(long long)(k0 + r) * D + c]);
      }
      sK[r * DP + c] = kv;
      sV[r * D + c] = vv;
    }
    __syncthreads();
    float s[R4][R4];
    tile_scores<D>(sQ, sK, ty, tx, q0, k0, L, causal, s);
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        float p;
        if (normalise) p = expf(s[i][j] - m[i]) / l[i];
        else if (k0 + tx + 16 * j >= L) p = 0.f;
        else p = mode == EXP_ONLY ? expf(s[i][j]) : s[i][j];
        sP[(ty + 16 * i) * BKP + tx + 16 * j] = round_to<T>(p);
      }
    __syncthreads();
    const int kn = min(BK, L - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        const float p = sP[(ty + 16 * i) * BKP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= L) continue;
    T* orow = o + (bh * L + qi) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA and wgmma (attn_tile.h)
// ---------------------------------------------------------------------------

template <int D, int MODE>
__global__ void __launch_bounds__(attn::THREADS, 1)
    prefill_phase_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               __nv_bfloat16* __restrict__ o, int L) {
  using namespace attn;
  constexpr bool CAUSAL = MODE == MASK_SOFTMAX;
  constexpr bool NORMALISE = MODE == SOFTMAX || MODE == MASK_SOFTMAX;
  extern __shared__ uint8_t smem_raw[];
  const Ring<D> r = make_ring<D>(smem_raw);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  // keys at or below the tile's last row are all a causal row can see
  const int kv_end = CAUSAL ? min(L, q0 + TQ) : L;
  const int n_k = (kv_end + TK - 1) / TK;
  const int k_only = NORMALISE ? n_k : 0;  // pass 1 needs no V
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[1] = {&qmap};
      produce<D, 1>(r, res, q0, &kmap, &vmap, bh, 0, k_only + n_k, k_only);
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  mbar_wait(r.q_full(), 0);
  int stage = 0;
  uint32_t phase = 0;

  // the tile's scores: keys past L score NEG_INF, keys past the query
  // MASKED when causal (checked only on tiles that reach either)
  auto scores = [&](float (&s)[64], int k0) {
    qk<D>(s, r.q(), r.k(stage), wg);
    if (k0 + TK > L || (CAUSAL && k0 + TK - 1 > row0)) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int qi = row0 + g + 8 * ((e / 2) % 2), kj = k0 + 8 * (e / 4) + c0 + e % 2;
        if (kj >= L) s[e] = NEG_INF;
        else if (CAUSAL && kj > qi) s[e] = MASKED;
      }
    }
  };
  auto release = [&]() {
    if (t == 0) mbar_arrive(r.empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };

  // pass 1 (softmax modes): each row's max m and sum l = sum exp(s - m)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int it = 0; it < k_only; ++it) {
    const int k0 = it * TK;
    const bool active = row0 < L && (!CAUSAL || k0 <= row0 + 63);
    mbar_wait(r.full_k(stage), phase);
    if (active) {
      float s[64];
      scores(s, k0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], row_max(s, i));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          sum += expf(s[4 * j + 2 * i] - m_new) + expf(s[4 * j + 2 * i + 1] - m_new);
        l[i] = l[i] * expf(m[i] - m_new) + sum;
        m[i] = m_new;
      }
    }
    release();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = quad_sum(l[i]);

  // pass 2: p from the final (m, l) or from s alone, rounded to bf16, then PV
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_k; ++it) {
    const int k0 = it * TK;
    const bool active = row0 < L && (!CAUSAL || k0 <= row0 + 63);
    mbar_wait(r.full_k(stage), phase);
    if (active) {
      float s[64];
      scores(s, k0);
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int i = (e / 2) % 2, kj = k0 + 8 * (e / 4) + c0 + e % 2;
        if (NORMALISE) s[e] = expf(s[e] - m[i]) / l[i];
        else if (kj >= L) s[e] = 0.f;
        else if (MODE == EXP_ONLY) s[e] = exp_fast(s[e]);  // K1's exp
      }
      uint32_t p[TK / 16][4];
      to_a_frags(s, p);
      mbar_wait(r.full_v(stage), phase);
      pv<D>(acc, p, r.v(stage));
    } else {
      mbar_wait(r.full_v(stage), phase);  // the slot is refilled only once V has landed
    }
    release();
  }

  if (L - row0 > 0)
    store_rows<D>(acc, o + ((long long)bh * L + row0) * D, L - row0,
                  [](int, float x) { return x; });
}

template <int D, int MODE>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, long long heads,
                         int L, cudaStream_t stream) {
  using namespace attn;
  auto kernel = prefill_phase_wgmma_kernel<D, MODE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<D>::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap qm{}, km{}, vm{};
  if (!encode_rows(&qm, q, heads, L, D) || !encode_rows(&km, k, heads, L, D) ||
      !encode_rows(&vm, v, heads, L, D))
    return cudaErrorInvalidValue;
  kernel<<<tile_grid(heads, L), attn::THREADS, Ring<D>::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), L);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_mode(int mode, const void* q, const void* k, const void* v, void* o,
                    long long heads, int L, cudaStream_t stream) {
  switch (mode) {
    case DOTS_ONLY:
      return launch_wgmma<D, DOTS_ONLY>(q, k, v, o, heads, L, stream);
    case EXP_ONLY:
      return launch_wgmma<D, EXP_ONLY>(q, k, v, o, heads, L, stream);
    case SOFTMAX:
      return launch_wgmma<D, SOFTMAX>(q, k, v, o, heads, L, stream);
    default:
      return launch_wgmma<D, MASK_SOFTMAX>(q, k, v, o, heads, L, stream);
  }
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_prefill_phase(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int L, int D, int dtype, int mode, cudaStream_t stream) {
  using namespace fasn;
  if (mode < DOTS_ONLY || mode > MASK_SOFTMAX || L < 1) return cudaErrorInvalidValue;
  if (dtype == 1) {
    const long long heads = (long long)B * H;
    switch (D) {
      case 32:
        return by_mode<32>(mode, q, k, v, o, heads, L, stream);
      case 64:
        return by_mode<64>(mode, q, k, v, o, heads, L, stream);
      case 128:
        return by_mode<128>(mode, q, k, v, o, heads, L, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  auto f32 = [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int Dc = decltype(d)::value;
    return launch(prefill_phase_kernel<T, Dc>, grid, mini_smem_bytes<Dc>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), H, L, mode);
  };
  return dispatch_d<float>(D, f32);
}
