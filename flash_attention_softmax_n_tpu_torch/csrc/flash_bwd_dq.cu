// K5: softmax-N flash-attention backward, dq (with dbias and dslope), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel _bwd_dq_kernel (flash_attention_softmax_n_tpu/
// kernels/flash_attention.py:685). With lse = log(n + sum_j exp(s_j)) from
// the forward, p = exp(s - lse) are the softmax-N probabilities and the
// backward is the standard one:
//   dp = (dout v^T) * dropmult,  ds = p (dp - delta),  delta = rowsum(dout o),
//   dq = scale * ds k,  dbias = ds,  dslope_h = sum ds * -|q + S - L - k|.
//
// Design: one CTA per (q tile of 64 rows, head, batch) loops over the KV
// tiles of 64 keys that the tile can see (causally invisible tiles are
// skipped, as _block_visible does), recomputing each score tile exactly as
// K1 forms it (flash_common.h). 256 threads in K1's layout: thread
// (ty, tx) owns tile rows ty + 16 i, key columns tx + 16 j and dq columns
// tx + 16 c, so dq accumulates in registers across the KV sweep; ds goes
// through shared memory, rounded to k's dtype, for the ds k product. The
// TPU's dslope accumulates over a sequential grid; here each thread sums
// its rows' terms over the sweep and the CTA writes one partial per query
// row, which the wrapper sums in a fixed order: no atomics, so two calls
// give bit-identical results. Skipped tiles get zero dbias. Scalar f32
// FMAs from shared memory (no tensor cores yet): bound, like K1, by
// shared-memory bandwidth and f32 issue rate, far from the card's bf16
// tensor-core bound of 6 D operations per visible (query, key) pair.
//
// lse is clamped at DEAD_LSE, so a row with no visible key (n == 0, L > S,
// lse == NEG_INF) gets p = 0 and zero gradients. Query rows past L and keys
// past S are masked in the tile, so nothing is padded, and a caller's
// global lse (flash_attention_block_grads) works the same way.

#include "flash_common.h"

namespace fasn {
namespace {

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t(2 * BQ + 2 * BK) * (D + 1) + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const FasnAttn a, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float scale, T* __restrict__ dq, float* __restrict__ dbias,
                        float* __restrict__ dslope_rows) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x DP, q * scale_q rounded to T
  float* sDO = sQ + BQ * DP;   // BQ x DP
  float* sK = sDO + BQ * DP;   // BK x DP
  float* sV = sK + BK * DP;    // BK x DP
  float* sDS = sV + BK * DP;   // BQ x BKP, ds rounded to T

  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * a.H + h;
  const T* qb = static_cast<const T*>(a.q) + bh * L * D;
  const T* kb = static_cast<const T*>(a.k) + bh * S * D;
  const T* vb = static_cast<const T*>(a.v) + bh * S * D;
  const T* dob = dout + bh * L * D;
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float qv = 0.f, dv = 0.f;
    if (q0 + r < L) {
      qv = round_to<T>(to_f32(qb[(long long)(q0 + r) * D + c]) * a.scale_q);
      dv = to_f32(dob[(long long)(q0 + r) * D + c]);
    }
    sQ[r * DP + c] = qv;
    sDO[r * DP + c] = dv;
  }

  float lse_r[R4], delta_r[R4], dsl[R4], acc[R4][CD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lse_r[i] = qi < L ? fmaxf(lse[bh * L + qi], DEAD_LSE) : 0.f;
    delta_r[i] = qi < L ? delta[bh * L + qi] : 0.f;
    dsl[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int kv_end = S;
  if (mods.causal) {
    const int last_row = min(q0 + BQ, L) - 1;
    kv_end = min(S, last_row + mods.off + 1);
  }

  int k0 = 0;
  for (; k0 < kv_end; k0 += BK) {
    __syncthreads();
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
    __syncthreads();

    float s[R4][R4], dp[R4][R4];
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[R4], dov[R4], kv[R4], vv[R4];
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        qv[i] = sQ[(ty + 16 * i) * DP + d];
        dov[i] = sDO[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        kv[j] = sK[(tx + 16 * j) * DP + d];
        vv[j] = sV[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < R4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p = expf(mods(s[i][j], qi, kj) - lse_r[i]);
        float d = dp[i][j];
        if (drop.on) d *= drop(b, h, qi, kj);
        const float ds = p * (d - delta_r[i]);
        if (dbias && qi < L && kj < S) dbias[(bh * L + qi) * S + kj] = ds;
        if (mods.alibi) dsl[i] += ds * -fabsf((float)(qi + mods.off - kj));
        sDS[(ty + 16 * i) * BKP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = sK[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        const float ds = sDS[(ty + 16 * i) * BKP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  // causally invisible tiles were skipped: their dbias is zero
  if (dbias) {
    const int width = S - min(k0, S);
    for (int i = tid; i < BQ * width; i += THREADS) {
      const int r = i / width, c = k0 + i % width;
      if (q0 + r < L) dbias[(bh * L + q0 + r) * S + c] = 0.f;
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int qi = q0 + ty + 16 * i;
    const float row = row_sum16(dsl[i]);
    if (qi >= L) continue;
    if (dslope_rows && tx == 0) dslope_rows[bh * L + qi] = row;
    T* dqrow = dq + (bh * L + qi) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) dqrow[tx + 16 * c] = from_f32<T>(scale * acc[i][c]);
  }
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dq(const FasnAttn* a, const void* dout, const float* lse,
                                 const float* delta, float scale, void* dq, float* dbias,
                                 float* dslope_rows, cudaStream_t stream) {
  using namespace fasn;
  const dim3 grid((a->L + BQ - 1) / BQ, a->H, a->B);
  return dispatch(a->dtype, a->D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    return launch(flash_bwd_dq_kernel<T, D>, grid, dq_smem_bytes<D>(), stream, *a,
                  static_cast<const T*>(dout), lse, delta, scale, static_cast<T*>(dq), dbias,
                  dslope_rows);
  });
}
