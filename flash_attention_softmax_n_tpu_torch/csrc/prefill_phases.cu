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
// Here one CTA takes 64 query rows (flash_common.h's tile and thread
// layout, as K1) and walks K/V in 64-key tiles, so the scores never leave
// the SM. The two softmax modes walk K twice: the first pass keeps each
// row's running max and sum, the second forms p = exp(s - m) / l, rounds it
// and accumulates PV, so p is rounded from the same final (m, l) as in the
// plain version, which materialises p. mask_softmax stops at the tile
// holding the diagonal: keys past it would add exp(-1e30 - m) = 0. The
// function is bound by operations (4 D per (query, key) pair at L 2048);
// like K1 this first version computes with scalar f32 FMAs from shared
// memory, not tensor cores.

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

}  // namespace
}  // namespace fasn

extern "C" int fasn_prefill_phase(const void* q, const void* k, const void* v, void* o, int B,
                                  int H, int L, int D, int dtype, int mode, cudaStream_t stream) {
  using namespace fasn;
  if (mode < DOTS_ONLY || mode > MASK_SOFTMAX || L < 1) return cudaErrorInvalidValue;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  return dispatch(dtype, D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int Dc = decltype(d)::value;
    return launch(prefill_phase_kernel<T, Dc>, grid, mini_smem_bytes<Dc>(), stream,
                  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(o), H, L, mode);
  });
}
