// K6: softmax-N flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas kernel _bwd_dkv_kernel (flash_attention_softmax_n_tpu/
// kernels/flash_attention.py:777), which also serves
// flash_attention_block_grads. With p = exp(s - lse) the softmax-N
// probabilities (flash_bwd_dq.cu):
//   dv = (p * dropmult)^T dout,
//   dk = (p (dp * dropmult - delta))^T (q * scale)   (q arrives scaled).
//
// What bounds it on the H100: 8 D operations per visible (query, key) pair
// (S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q) at 989 TFLOP/s
// (bf16): 0.070 ms at the training shape B2 H32 L=S=2048 d64 causal.
//
// bf16: flash_bwd_dkv_wgmma_kernel, on the attention tile of attn_tile.h
// with K and V resident. One CTA takes 128 keys of one (b, h); the producer
// warp loads K and V once, then keeps Q and dO tiles of 128 query rows in
// flight with TMA, from the first tile that sees the CTA's keys. Two
// consumer warpgroups of 64 keys each walk every tile in chunks of 64
// query rows (32 at D 128), so that S^T, dP^T, dK and dV nearly fit the 168
// registers a thread of 288 gets (ptxas spills 40, 56 and 1008 bytes at D
// 32, 64 and 128): S^T = K Q_s^T and dP^T = V dO^T as two
// wgmma groups in flight together, with the fragment's rows keys and its
// columns queries (lse and delta per column, the dropout hash at (b, h,
// column, row)); then dV += (P mult)^T dO and dK += dS^T Q_s with the
// dropped p (rounded to dout's dtype) and ds (rounded to q's) passed from
// the fragments to A-operand registers, dO and Q_s read MN-major. Q_s, q *
// scale rounded to bf16, is formed in shared memory: each warpgroup
// rewrites half of the Q tile, then the consumers synchronise once a tile,
// which also publishes the tile's lse and delta that each warpgroup copies
// into its own shared buffer. dk and dv accumulate in registers over the
// sweep: no reduction across CTAs, no atomics, repeat calls bit-equal. The
// low key tiles, which causal rows see most, launch first. Inputs must
// start on 16 bytes (TMA); the operator raises otherwise.
//
// f32: flash_bwd_dkv_kernel, scalar f32 FMAs from shared memory on 64 x 64
// tiles (wgmma has no f32 x f32 product): one CTA per (KV tile of 64 keys,
// head, batch) loops over the query tiles of 64 rows; thread (ty, tx) owns
// key rows ty + 16 i, query columns tx + 16 j of the transposed score tile,
// and dk/dv columns tx + 16 c; the dropped p and ds go through shared
// memory for the two transposed products.
//
// lse is clamped at DEAD_LSE as in K5, so dead rows (n == 0, L > S) add
// nothing; query rows past L and keys past S are masked in the tile.

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

// ---------------------------------------------------------------------------
// f32: scalar FMAs
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16: TMA and wgmma (attn_tile.h)
// ---------------------------------------------------------------------------

template <int D>
struct DkvShape {
  static constexpr int QC = D <= 64 ? 64 : 32;  // query rows of a chunk
  // after the ring's barriers: per warpgroup two buffers (by tile parity)
  // of a tile's clamped lse in log2 units and its delta
  static constexpr int ROWS_AT = attn::Ring<D, 2>::BAR_AT + 64;
  static constexpr int SMEM = attn::Ring<D, 2>::SMEM + 64 + 2 * 2 * 2 * attn::TQ * 4;
};

template <int D>
__global__ void __launch_bounds__(attn::THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  using namespace attn;
  using T = Tile<D>;
  constexpr int QC = DkvShape<D>::QC;
  extern __shared__ uint8_t smem_raw[];
  // resident: K, V; each ring slot: Q (as "k") and dO (as "v")
  const Ring<D, 2> r = make_ring<D, 2>(smem_raw);
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * TK;
  const int L = a.L, S = a.S, off = S - L;
  // the first query tile with a row that sees key k0 (row >= k0 - off)
  const int first = a.causal ? max(0, k0 - off) / TQ : 0;
  const int tiles = max(0, (L + TQ - 1) / TQ - first);
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[2] = {&kmap, &vmap};
      produce<D, 2>(r, res, k0, &qmap, &domap, bh, first, tiles, 0);
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int kw0 = k0 + 64 * wg;  // the warpgroup's first key
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;
  float* rows = reinterpret_cast<float*>(r.mem + DkvShape<D>::ROWS_AT) + wg * 2 * 2 * TQ;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // thread t carries query row t of the next tile: lse (clamped, log2
  // units) and delta, loaded a tile ahead
  auto row_vals = [&](int it, float& l2, float& dl) {
    const int qi = (first + it) * TQ + t;
    l2 = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
    dl = qi < L ? delta[(long long)bh * L + qi] : 0.f;
  };
  float next_l2 = 0.f, next_dl = 0.f;
  if (tiles > 0) {
    row_vals(0, next_l2, next_dl);
    mbar_wait(r.q_full(), 0);
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = (first + it) * TQ;
    float* buf = rows + (it % 2) * 2 * TQ;  // [0, TQ) lse, [TQ, 2 TQ) delta
    buf[t] = next_l2;
    buf[TQ + t] = next_dl;
    if (it + 1 < tiles) row_vals(it + 1, next_l2, next_dl);
    mbar_wait(r.full_k(stage), phase);
    mbar_wait(r.full_v(stage), phase);
    // Q_s: this warpgroup's half of the Q tile, then both warpgroups meet
    scale_q_rows<D>(r.mem + (r.k(stage) - r.base), wg, a.scale_q);
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll 1
    for (int c = 0; c < TQ / QC; ++c) {
      const int qc0 = q0 + c * QC;
      // no key of the warpgroup is seen by a row of this chunk: skip it
      if (kw0 >= S || qc0 >= L || (mods.causal && qc0 + QC - 1 + off < kw0)) continue;
      const uint32_t qc = r.k(stage) + c * QC * T::ROW, doc = r.v(stage) + c * QC * T::ROW;
      float s[QC / 2], dp[QC / 2];
      qk_async<D>(s, r.res(0) + wg * 64 * T::ROW, qc);
      qk_async<D>(dp, r.res(1) + wg * 64 * T::ROW, doc);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // fragment row: key kw0 + g + 8 i; column: query qc0 + 8 j + c0 + cc
      if (!plain || qc0 + QC > L || kw0 + 64 > S || (mods.causal && qc0 + off < kw0 + 63)) {
#pragma unroll
        for (int e = 0; e < QC / 2; ++e)
          s[e] = mods(s[e], qc0 + 8 * (e / 4) + c0 + e % 2, kw0 + g + 8 * ((e / 2) % 2));
      }
#pragma unroll
      for (int e = 0; e < QC / 2; ++e) {
        const int col = c * QC + 8 * (e / 4) + c0 + e % 2;
        const float p = exp2f(fmaf(s[e], LOG2E, -buf[col]));
        if (drop.on) {
          const float mult = drop(b, h, q0 + col, kw0 + g + 8 * ((e / 2) % 2));
          s[e] = p * mult;
          dp[e] = p * (dp[e] * mult - buf[TQ + col]);
        } else {
          s[e] = p;
          dp[e] = p * (dp[e] - buf[TQ + col]);
        }
      }
      uint32_t fp[QC / 16][4], fs[QC / 16][4];
      to_a_frags(s, fp);
      pv_async<D>(dv_acc, fp, doc);
      to_a_frags(dp, fs);
      pv_async<D>(dk_acc, fs, qc);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    if (t == 0) mbar_arrive(r.empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = min(64, S - kw0);
  if (valid <= 0) return;
  const auto same = [](int, float x) { return x; };
  store_rows<D>(dk_acc, dk + ((long long)bh * S + kw0) * D, valid, same);
  store_rows<D>(dv_acc, dv + ((long long)bh * S + kw0) * D, valid, same);
}

template <int D>
cudaError_t launch_wgmma(const FasnAttn& a, const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  constexpr int smem = DkvShape<D>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  AttnMaps m{};
  if (!encode_attn(&m, a, D, dout)) return cudaErrorInvalidValue;
  // x the (b, h) pair, y the key tile: the low tiles, which causal rows see
  // most, first
  const dim3 grid(static_cast<unsigned>((long long)a.B * a.H),
                  static_cast<unsigned>((a.S + TK - 1) / TK));
  kernel<<<grid, attn::THREADS, smem, stream>>>(m.q, m.k, m.v, m.dout, a, lse, delta,
                                                static_cast<__nv_bfloat16*>(dk),
                                                static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dkv(const FasnAttn* a, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype == 1) {
    switch (a->D) {
      case 32:
        return launch_wgmma<32>(*a, dout, lse, delta, dk, dv, stream);
      case 64:
        return launch_wgmma<64>(*a, dout, lse, delta, dk, dv, stream);
      case 128:
        return launch_wgmma<128>(*a, dout, lse, delta, dk, dv, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (a->dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid((a->S + BK - 1) / BK, a->H, a->B);
  auto f32 = [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    return launch(flash_bwd_dkv_kernel<T, D>, grid, dkv_smem_bytes<D>(), stream, *a,
                  static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
                  static_cast<T*>(dv));
  };
  return dispatch_d<float>(a->D, f32);
}
