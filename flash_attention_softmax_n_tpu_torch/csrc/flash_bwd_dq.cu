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
// What bounds it on the H100: 6 D operations per visible (query, key) pair
// (S = Q K^T, dP = dO V^T, dQ += dS K) at 989 TFLOP/s (bf16): 0.052 ms at
// the training shape B2 H32 L=S=2048 d64 causal.
//
// bf16: flash_bwd_dq_wgmma_kernel, on the attention tile of attn_tile.h
// with Q and dO resident. One CTA takes 128 query rows of one (b, h); the
// producer warp loads Q and dO once, then keeps K and V tiles of 128 keys
// in flight with TMA, and two consumer warpgroups of 64 rows each walk
// every tile in two chunks of 64 keys: S = Q K^T and dP = dO V^T as two
// wgmma groups in flight together (A and B both K-major), the element-wise
// backward on the accumulator fragments, then dQ += dS K with dS passed
// from the fragment to A-operand registers (rounded to bf16, as the plain
// version rounds ds to k's dtype) and K read MN-major with the transpose
// bit, as K1 reads V. 64-key chunks keep S, dP (32 floats each) and dQ (16
// to 64) within the 168 registers a thread of 288 gets (ptxas: no spills
// at D 32 and 64, 96 bytes at D 128). A causal CTA walks
// only the key tiles at or left of its diagonal, masks only the chunks that
// cross it (or S, or carry a bias or ALiBi), and the heaviest query tiles
// launch first. Inputs must start on 16 bytes (TMA); the operator raises
// otherwise.
//
// f32: flash_bwd_dq_kernel, scalar f32 FMAs from shared memory on 64 x 64
// tiles (wgmma has no f32 x f32 product, and TF32 would not hold f32's
// tolerance): 256 threads in K1's scalar layout, thread (ty, tx) owning
// tile rows ty + 16 i, key columns tx + 16 j and dq columns tx + 16 c; ds
// goes through shared memory, rounded to k's dtype, for the ds k product.
//
// Both: the TPU's dslope accumulates over a sequential grid; here each
// thread sums its rows' terms over the sweep and the kernel writes one
// partial per query row, which the wrapper sums in a fixed order: no
// atomics, so two calls give bit-identical results. Keys a row never
// visits (causally invisible tiles) get zero dbias. Scores are formed
// exactly as K1 forms them (flash_common.h), q scaled in q's dtype.
//
// lse is clamped at DEAD_LSE, so a row with no visible key (n == 0, L > S,
// lse == NEG_INF) gets p = 0 and zero gradients. Query rows past L and keys
// past S are masked in the tile, so nothing is padded, and a caller's
// global lse (flash_attention_block_grads) works the same way.

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: TMA and wgmma (attn_tile.h)
// ---------------------------------------------------------------------------

constexpr int KC = 64;  // keys of a chunk

template <int D>
__global__ void __launch_bounds__(attn::THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float scale, __nv_bfloat16* __restrict__ dq,
                              float* __restrict__ dbias, float* __restrict__ dslope_rows) {
  using namespace attn;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<D, 2> r = make_ring<D, 2>(smem_raw);  // resident: Q, dO
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + TQ, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + TK - 1) / TK : 0;
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[2] = {&qmap, &domap};
      produce<D, 2>(r, res, q0, &kmap, &vmap, bh, 0, tiles, 0);
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;

  // per fragment row: lse (clamped) in log2 units, delta, the dslope sum
  float lse2[2], dl[2], dsl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + g + 8 * i;
    lse2[i] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
    dl[i] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
    dsl[i] = 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (tiles > 0) {
    mbar_wait(r.q_full(), 0);
    scale_q_rows<D>(r.mem, wg, a.scale_q);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }

  // the chunks a warpgroup computes are a prefix of the keys: `done` ends it
  int done = 0, stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    mbar_wait(r.full_k(stage), phase);
    mbar_wait(r.full_v(stage), phase);
#pragma unroll 1
    for (int c = 0; c < TK / KC; ++c) {
      const int k0 = it * TK + c * KC;
      // no row of the warpgroup sees a key of this chunk: skip it
      if (row0 >= L || k0 >= S || (mods.causal && k0 > row0 + 63 + off)) continue;
      done = k0 + KC;
      const uint32_t kc = r.k(stage) + c * KC * T::ROW, vc = r.v(stage) + c * KC * T::ROW;
      float s[KC / 2], dp[KC / 2];
      qk_async<D>(s, r.q() + wg * 64 * T::ROW, kc);
      qk_async<D>(dp, r.res(1) + wg * 64 * T::ROW, vc);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // masks, bias and ALiBi only where a key is past S or a diagonal
      if (!plain || k0 + KC > S || (mods.causal && k0 + KC - 1 > row0 + off)) {
#pragma unroll
        for (int e = 0; e < KC / 2; ++e)
          s[e] = mods(s[e], row0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
      }
#pragma unroll
      for (int e = 0; e < KC / 2; ++e) {
        const int i = (e / 2) % 2, qi = row0 + g + 8 * i, kj = k0 + 8 * (e / 4) + c0 + e % 2;
        const float p = exp2f(fmaf(s[e], LOG2E, -lse2[i]));
        const float d = drop.on ? dp[e] * drop(b, h, qi, kj) : dp[e];
        const float ds = p * (d - dl[i]);
        if (dbias && qi < L && kj < S) dbias[((long long)bh * L + qi) * S + kj] = ds;
        if (mods.alibi) dsl[i] += ds * -fabsf((float)(qi + off - kj));
        s[e] = ds;
      }
      uint32_t f[KC / 16][4];
      to_a_frags(s, f);
      pv_async<D>(acc, f, kc);
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (t == 0) mbar_arrive(r.empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = min(64, L - row0);
  if (valid <= 0) return;
  // keys the warpgroup never visited are causally invisible: zero dbias
  if (dbias) {
    const int from = min(done, S), width = S - from;
    for (int e = t; e < valid * width; e += 128)
      dbias[((long long)bh * L + row0 + e / width) * S + from + e % width] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float row = quad_sum(dsl[i]);
    if (dslope_rows && t % 4 == 0 && g + 8 * i < valid)
      dslope_rows[(long long)bh * L + row0 + g + 8 * i] = row;
  }
  store_rows<D>(acc, dq + ((long long)bh * L + row0) * D, valid,
                [&](int, float x) { return scale * x; });
}

template <int D>
cudaError_t launch_wgmma(const FasnAttn& a, const void* dout, const float* lse,
                         const float* delta, float scale, void* dq, float* dbias,
                         float* dslope_rows, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<D, 2>::SMEM);
  if (err != cudaSuccess) return err;
  AttnMaps m{};
  if (!encode_attn(&m, a, D, dout)) return cudaErrorInvalidValue;
  kernel<<<tile_grid((long long)a.B * a.H, a.L), attn::THREADS, Ring<D, 2>::SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, scale, static_cast<__nv_bfloat16*>(dq), dbias,
      dslope_rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dq(const FasnAttn* a, const void* dout, const float* lse,
                                 const float* delta, float scale, void* dq, float* dbias,
                                 float* dslope_rows, cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype == 1) {
    switch (a->D) {
      case 32:
        return launch_wgmma<32>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
      case 64:
        return launch_wgmma<64>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
      case 128:
        return launch_wgmma<128>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (a->dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid((a->L + BQ - 1) / BQ, a->H, a->B);
  auto f32 = [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    return launch(flash_bwd_dq_kernel<T, D>, grid, dq_smem_bytes<D>(), stream, *a,
                  static_cast<const T*>(dout), lse, delta, scale, static_cast<T*>(dq), dbias,
                  dslope_rows);
  };
  return dispatch_d<float>(a->D, f32);
}
