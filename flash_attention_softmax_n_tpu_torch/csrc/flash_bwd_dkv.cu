// K6: softmax-N flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _bwd_dkv_kernel (flash_attention_softmax_n_tpu/
// kernels/flash_attention.py:777), which also serves
// flash_attention_block_grads. With p = exp(s - lse) the softmax-N
// probabilities (flash_bwd_dq.cu):
//   dv = (p * dropmult)^T dout,
//   dk = (p (dp * dropmult - delta))^T (q * scale)   (q arrives scaled).
//
// Design: one CTA per (KV tile of 64 keys, head, batch) loops over the
// query tiles of 64 rows, from the first one that can see the tile
// causally, so dk and dv accumulate in registers with no reduction across
// CTAs and no atomics. 256 threads: thread (ty, tx) owns key rows ty + 16 i,
// query columns tx + 16 j of the transposed score tile, and dk/dv columns
// tx + 16 c. Each score tile is recomputed as K1 forms it
// (flash_common.h); the dropped p (rounded to dout's dtype) and ds
// (rounded to q's dtype) go through shared memory for the two transposed
// products. Scalar f32 FMAs from shared memory (no tensor cores yet): bound
// by shared-memory bandwidth and f32 issue rate, far from the card's bf16
// tensor-core bound of 8 D operations per visible (query, key) pair.
//
// lse is clamped at DEAD_LSE as in K5, so dead rows (n == 0, L > S) add
// nothing; query rows past L and keys past S are masked in the tile.

#include "flash_common.h"

namespace fasn {
namespace {

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         (size_t(2 * BK + 2 * BQ) * (D + 1) + size_t(2 * BK) * (BQ + 1) + size_t(2 * BQ));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const FasnAttn a, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv) {
  constexpr int DP = D + 1;
  constexpr int BQP = BQ + 1;
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;            // BK x DP
  float* sV = sK + BK * DP;    // BK x DP
  float* sQ = sV + BK * DP;    // BQ x DP, q * scale_q rounded to T
  float* sDO = sQ + BQ * DP;   // BQ x DP
  float* sPD = sDO + BQ * DP;  // BK x BQP, dropped p rounded to T
  float* sDS = sPD + BK * BQP; // BK x BQP, ds rounded to T
  float* sL = sDS + BK * BQP;  // BQ, clamped lse
  float* sD = sL + BQ;         // BQ, delta

  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, S = a.S;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * a.H + h;
  const T* qb = static_cast<const T*>(a.q) + bh * L * D;
  const T* kb = static_cast<const T*>(a.k) + bh * S * D;
  const T* vb = static_cast<const T*>(a.v) + bh * S * D;
  const T* dob = dout + bh * L * D;
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);

  for (int i = tid; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float kv = 0.f, vv = 0.f;
    if (k0 + r < S) {
      kv = to_f32(kb[(long long)(k0 + r) * D + c]);
      vv = to_f32(vb[(long long)(k0 + r) * D + c]);
    }
    sK[r * DP + c] = kv;
    sV[r * DP + c] = vv;
  }

  float acc_k[R4][CD], acc_v[R4][CD];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the first query row that sees key k0 is k0 - (S - L)
  int q_begin = 0;
  if (mods.causal) q_begin = max(0, k0 - mods.off) / BQ * BQ;

  for (int q0 = q_begin; q0 < L; q0 += BQ) {
    __syncthreads();
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float qv = 0.f, dv_ = 0.f;
      if (q0 + r < L) {
        qv = round_to<T>(to_f32(qb[(long long)(q0 + r) * D + c]) * a.scale_q);
        dv_ = to_f32(dob[(long long)(q0 + r) * D + c]);
      }
      sQ[r * DP + c] = qv;
      sDO[r * DP + c] = dv_;
    }
    if (tid < BQ) {
      const int qi = q0 + tid;
      sL[tid] = qi < L ? fmaxf(lse[bh * L + qi], DEAD_LSE) : 0.f;
      sD[tid] = qi < L ? delta[bh * L + qi] : 0.f;
    }
    __syncthreads();

    // transposed tiles: row = key ty + 16 i, column = query tx + 16 j
    float s[R4][R4], dp[R4][R4];
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[R4], vv[R4], qv[R4], dov[R4];
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        kv[i] = sK[(ty + 16 * i) * DP + d];
        vv[i] = sV[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * DP + d];
        dov[j] = sDO[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < R4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const int qc = tx + 16 * j, qi = q0 + qc;
        const float p = expf(mods(s[i][j], qi, kj) - sL[qc]);
        float pd = p, d = dp[i][j];
        if (drop.on) {
          const float mult = drop(b, h, qi, kj);
          pd = p * mult;
          d *= mult;
        }
        sPD[(ty + 16 * i) * BQP + qc] = round_to<T>(pd);
        sDS[(ty + 16 * i) * BQP + qc] = round_to<T>(p * (d - sD[qc]));
      }
    }
    __syncthreads();

    const int qn = min(BQ, L - q0);
    for (int qq = 0; qq < qn; ++qq) {
      float dov[CD], qv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dov[c] = sDO[qq * DP + tx + 16 * c];
        qv[c] = sQ[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        const float pd = sPD[(ty + 16 * i) * BQP + qq];
        const float ds = sDS[(ty + 16 * i) * BQP + qq];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          acc_v[i][c] = fmaf(pd, dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds, qv[c], acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
    T* dkrow = dk + (bh * S + kj) * D;
    T* dvrow = dv + (bh * S + kj) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dkrow[tx + 16 * c] = from_f32<T>(acc_k[i][c]);
      dvrow[tx + 16 * c] = from_f32<T>(acc_v[i][c]);
    }
  }
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dkv(const FasnAttn* a, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, cudaStream_t stream) {
  using namespace fasn;
  const dim3 grid((a->S + BK - 1) / BK, a->H, a->B);
  return dispatch(a->dtype, a->D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    return launch(flash_bwd_dkv_kernel<T, D>, grid, dkv_smem_bytes<D>(), stream, *a,
                  static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
                  static_cast<T*>(dv));
  });
}
