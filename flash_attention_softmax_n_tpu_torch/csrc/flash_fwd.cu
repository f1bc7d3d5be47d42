// K1: softmax-N flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas forward kernels _fwd_single_kernel, _fwd_kernel and
// _fwd_pipeline_kernel (flash_attention_softmax_n_tpu/kernels/
// flash_attention.py:345, :279, :501): three TPU tilings of one function,
//   o = dropout(softmax_n(q k^T * scale + bias - alibi)) v,
//   lse = log(n + sum_j exp(s_j)).
// The +n enters as a phantom key with score 0 and value 0: the online
// softmax starts from m = 0, l = n (n > 0) instead of m = NEG_INF, l = 0.
//
// Design: one CTA per (q tile of 64 rows, head, batch); the CTA loops over
// KV tiles of 64 keys with an f32 online softmax, so scores never reach
// device memory. 256 threads; thread (ty, tx) owns rows ty + 16 i (i < 4)
// of the tile, score columns tx + 16 j and output columns tx + 16 j, so the
// row statistics (m, l) and the rescale factor live in registers and a row
// reduction is a shuffle across 16 lanes. Products are scalar f32 FMAs from
// shared memory (no tensor cores yet), so at long sequences the kernel is
// bound by shared-memory bandwidth and f32 issue rate, far from the card's
// bf16 tensor-core bound; at serving prefill shapes it is small next to the
// matmuls around it.
//
// Numerics follow the Pallas kernel: the scale is folded into q in q's
// dtype, scores and statistics are f32, the f32 bias and then the ALiBi term
// are added before masking (flash_common.h), l sums the undropped p, p is
// then multiplied by the dropout multiplier of its global (b, h, q, k) and
// rounded to v's dtype before the PV product, and at n == 0 a row with no
// visible key (rectangular causal with L > S) gives o = 0, lse = NEG_INF.

#include "flash_common.h"

namespace fasn {
namespace {

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const FasnAttn a, float n, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x DP
  float* sK = sQ + BQ * DP;  // BK x DP
  float* sV = sK + BK * DP;  // BK x D
  float* sP = sV + BK * D;   // BQ x BKP

  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * a.H + h;
  const T* qb = static_cast<const T*>(a.q) + bh * L * D;
  const T* kb = static_cast<const T*>(a.k) + bh * S * D;
  const T* vb = static_cast<const T*>(a.v) + bh * S * D;
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < L) val = round_to<T>(to_f32(qb[(long long)(q0 + r) * D + c]) * a.scale_q);
    sQ[r * DP + c] = val;
  }

  float m[R4], l[R4], acc[R4][CD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = n > 0.f ? 0.f : NEG_INF;
    l[i] = n;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int kv_end = S;
  if (mods.causal) {
    const int last_row = min(q0 + BQ, L) - 1;
    kv_end = min(S, last_row + mods.off + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < S) {
        kv = to_f32(kb[(long long)(k0 + r) * D + c]);
        vv = to_f32(vb[(long long)(k0 + r) * D + c]);
      }
      sK[r * DP + c] = kv;
      sV[r * D + c] = vv;
    }
    __syncthreads();

    float s[R4][R4];
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
    for (int i = 0; i < R4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        s[i][j] = mods(s[i][j], qi, k0 + tx + 16 * j);
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        float p = expf(s[i][j] - m_new);
        rsum += p;  // the denominator takes the undropped p
        if (drop.on) p *= drop(b, h, qi, k0 + tx + 16 * j);
        sP[(ty + 16 * i) * BKP + tx + 16 * j] = round_to<T>(p);
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
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
    const bool dead = n == 0.f && (l[i] == 0.f || m[i] == NEG_INF);
    T* orow = o + (bh * L + qi) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = from_f32<T>(dead ? 0.f : acc[i][c] / l[i]);
    if (tx == 0) lse[bh * L + qi] = dead ? NEG_INF : m[i] + logf(l[i]);
  }
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_fwd(const FasnAttn* a, float n, void* o, float* lse,
                              cudaStream_t stream) {
  using namespace fasn;
  const dim3 grid((a->L + BQ - 1) / BQ, a->H, a->B);
  return dispatch(a->dtype, a->D, [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    return launch(flash_fwd_kernel<T, D>, grid, fwd_smem_bytes<D>(), stream, *a, n,
                  static_cast<T*>(o), lse);
  });
}
