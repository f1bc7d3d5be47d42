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
// bf16 at D 256: flash_bwd_dkv_d256_kernel. dK and dV of 64 keys x 256
// columns are 128 + 128 floats a thread of a warpgroup, more than its
// registers, so the CTA splits the work by product: it takes 64 keys (K
// and V resident, 32 KB each) and walks the query tiles of 64 rows (Q and
// dO through a two-stage ring, 64 KB a slot; 208 KB with P) as the kernel
// above does. Warpgroup 0 computes S^T = K Q_s^T and P, hands P (f32, 16
// KB) to warpgroup 1 through shared memory under a named barrier, and
// accumulates dV += (P mult)^T dO; warpgroup 1 computes dP^T = V dO^T,
// then dS from P, and accumulates dK += dS^T Q_s. Each accumulates 128
// floats over all 256 columns and no product is done twice (8 D
// operations a pair), at the price of two barriers a tile (the Q_s one
// and P's). Splitting by columns instead (each warpgroup dK and dV for 128
// columns) needs no hand-over but forms S^T and dP^T in both (12 D a pair)
// and keeps 192 floats live beside the fragments. A producer warpgroup at
// 24 registers (setmaxnreg) leaves 240 to each consumer (at 40 and 232,
// K1's split, ptxas spilled 8 bytes), and the waits give up instead of
// trapping (hopper.h mbar_wait<false>), as in K1's D 256 kernel
// (flash_fwd.cu). Each tile's dV or dK product runs on through the next
// tile's Q_s rewrite and barrier before the warpgroup waits for it and
// frees the slot. The CTAs of one head run side by side (a flat grid), so
// the Q and dO tiles they all stream come from L2.
//
// f32 at D 32, 64 and 128: flash_bwd_dkv_tf32x3_kernel (flash_bwd_f32.cu,
// entered through fasn_flash_bwd_dkv_tf32x3): split-TF32 wgmma products,
// three TF32 passes on each operand's head and rest, which hold f32's
// tolerance (that file's header). f32 at D 256 and above:
// flash_bwd_dkv_tf32x3_wide_kernel (flash_bwd_f32_wide.cu, entered through
// fasn_flash_bwd_dkv_tf32x3_wide): the same split after a pre-pass, one CTA
// per 64 keys and up to 256 columns of dk and dv, split by product as the
// bf16 D 256 kernel is, S^T and dP^T formed once per 256 columns.
//
// bf16 above 256 (D a multiple of 128, as the wrapper pads it):
// flash_bwd_dkv_wide_wgmma_kernel. K and V of 64 keys over all of D would
// grow with D (128 KB at D 512), so D streams: one CTA takes 64 keys and
// 128 columns of dk and dv (the column chunks of one key tile side by side
// in a flat grid, then the head's key tiles, low ones first) and splits the
// work by product as the D 256 kernel does. A producer warpgroup at 40
// registers keeps a four-slot ring of 64-column chunks in flight with TMA,
// each slot one chunk of the CTA's K and V rows and of the query tile's Q
// and dO rows (32 KB), beside two buffers of the query tile's Q and dO at
// the CTA's 128 columns (32 KB each) and P (16 KB): 210 KB in all,
// whatever D. Warpgroup 0 scales each Q chunk in place (Q_s) while the
// previous chunk's product runs and sums S^T += K Q_s^T over the chunks,
// forms P, hands it to warpgroup 1 through shared memory (named barrier 3;
// barrier 4 frees it for the next tile) and accumulates dV += (P mult)^T dO
// at its 128 columns; warpgroup 1 sums dP^T += V dO^T, scales Q at the
// output columns, forms dS from P and accumulates dK += dS^T Q_s. Each
// accumulates 64 floats (m64n128). S^T and dP^T are formed D / 128 times
// over, once per column chunk (issued products per causal pair: 16 d at D
// 384, 20 d at 512, against 8 d needed).
//
// lse is clamped at DEAD_LSE as in K5, so dead rows (n == 0, L > S) add
// nothing; query rows past L and keys past S are masked in the tile.

#include <climits>

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

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

// ---------------------------------------------------------------------------
// bf16 at D 256: 64-row tiles split by product, a producer warpgroup,
// setmaxnreg
// ---------------------------------------------------------------------------

constexpr int D256_ROWS = 64;  // rows of every tile: the CTA's keys, a query tile
constexpr int D256_THREADS = attn::CONSUMERS + 128;
using D256Ring = attn::Ring<256, 2, D256_ROWS>;  // resident: K, V; each slot: Q and dO
// after the ring's barriers: warpgroup 0's P (f32, 64 x 64), each thread's
// 32 values as 8 float4s 128 threads apart; then per warpgroup two buffers
// (by tile parity) of a tile's per-query values
constexpr int D256_P_AT = D256Ring::BAR_AT + 64;
constexpr int D256_ROWS_AT = D256_P_AT + D256_ROWS * D256_ROWS * 4;
constexpr int D256_SMEM = D256Ring::SMEM + 64 + D256_ROWS * D256_ROWS * 4 + 2 * 2 * D256_ROWS * 4;

__global__ void __launch_bounds__(D256_THREADS, 1)
    flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv) {
  using namespace attn;
  constexpr int D = 256, QT = D256_ROWS;
  using T = Tile<D, QT>;
  extern __shared__ uint8_t smem_raw[];
  const D256Ring r = make_ring<D, 2, QT>(smem_raw);
  // a flat grid, a head's key tiles side by side (the low ones, which
  // causal rows see most, first): CTAs that run together stream the same
  // Q and dO tiles, which L2 then serves
  const int n_k = (a.S + QT - 1) / QT;
  const int bh = blockIdx.x / n_k, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x % n_k * QT;
  const int L = a.L, S = a.S, off = S - L;
  // the first query tile with a row that sees key k0 (row >= k0 - off);
  // every tile from there on sees it
  const int first = a.causal ? max(0, k0 - off) / QT : 0;
  const int tiles = max(0, (L + QT - 1) / QT - first);
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[2] = {&kmap, &vmap};
      produce<D, 2, QT, false>(r, res, k0, &qmap, &domap, bh, first, tiles, 0);
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128;
    const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
    const ScoreMods mods = score_mods(a, b, h);
    const Dropout drop = dropout_of(a);
    const bool plain = mods.bias == nullptr && !mods.alibi;
    // written and read in the same fragment order: no bank conflicts
    float4* pbuf = reinterpret_cast<float4*>(r.mem + D256_P_AT) + t;
    float acc[D / 2];  // warpgroup 0: dV; 1: dK
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // thread t < 64 carries query t's value of the next tile (warpgroup 0:
    // lse, then clamped and in log2 units; 1: delta; 0 past L) into the
    // warpgroup's buffer
    float* rows = reinterpret_cast<float*>(r.mem + D256_ROWS_AT) + wg * 2 * QT;
    const float* row_src = (wg == 0 ? lse : delta) + (long long)bh * L;
    const int qt = first * QT + t;  // query t of the first tile
    float next = tiles > 0 && t < QT && qt < L ? row_src[qt] : 0.f;
    if (tiles > 0) mbar_wait<false>(r.q_full(), 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < tiles; ++it) {
      const int q0 = (first + it) * QT;
      // fragment row i: key k0 + g + 8 i; column: query q0 + 8 j + c0 + c,
      // whose value is cv[8 j + c0 + c] (published by the barrier below)
      float* cv = rows + (it % 2) * QT;
      if (t < QT) {
        cv[t] = wg == 0 ? fmaxf(next, DEAD_LSE) * LOG2E : next;
        const int qn = qt + (it + 1) * QT;
        next = it + 1 < tiles && qn < L ? row_src[qn] : 0.f;
      }
      mbar_wait<false>(r.full_k(stage), phase);
      mbar_wait<false>(r.full_v(stage), phase);
      // Q_s: each warpgroup rewrites two of the Q tile's four 64-column
      // boxes, then both meet (which also frees P for this tile and
      // publishes the tile's per-query values)
      scale_q_rows<D / 2, QT>(r.mem + (r.k(stage) - r.base) + wg * 2 * T::BOX, 0, a.scale_q);
      fence_proxy_async();
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
      // the previous tile's dV or dK product ran on through the above: wait
      // for it, then free its slot
      if (it > 0) {
        wgmma_wait<0>();
        fence_regs(acc);
        if (t == 0) mbar_arrive(r.empty(stage ^ 1));
      }
      float s[QT / 2];
      uint32_t f[QT / 16][4];
      if (wg == 0) {
        // S^T = K Q_s^T, P, then dV += (P mult)^T dO
        qk_async<D, QT / 2, QT>(s, r.res(0), r.k(stage));
        wgmma_wait<0>();
        fence_regs(s);
        if (!plain || q0 + QT > L || k0 + QT > S || (mods.causal && q0 + off < k0 + QT - 1)) {
#pragma unroll
          for (int e = 0; e < QT / 2; ++e)
            s[e] = mods(s[e], q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
        }
#pragma unroll
        for (int e = 0; e < QT / 2; ++e)
          s[e] = exp2f(fmaf(s[e], LOG2E, -cv[8 * (e / 4) + c0 + e % 2]));
#pragma unroll
        for (int v4 = 0; v4 < QT / 8; ++v4)
          pbuf[v4 * 128] = make_float4(s[4 * v4], s[4 * v4 + 1], s[4 * v4 + 2], s[4 * v4 + 3]);
        asm volatile("bar.arrive 2, %0;" ::"n"(CONSUMERS) : "memory");
        if (drop.on) {
#pragma unroll
          for (int e = 0; e < QT / 2; ++e)
            s[e] *= drop(b, h, q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
        }
        to_a_frags(s, f);
        pv_async<D, QT / 16, QT>(acc, f, r.v(stage));
      } else {
        // dP^T = V dO^T, then with warpgroup 0's P: dS, dK += dS^T Q_s
        qk_async<D, QT / 2, QT>(s, r.res(1), r.v(stage));
        wgmma_wait<0>();
        fence_regs(s);
        asm volatile("bar.sync 2, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
        for (int v4 = 0; v4 < QT / 8; ++v4) {
          const float4 p4 = pbuf[v4 * 128];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = 4 * v4 + c;
            const float d =
                drop.on ? s[e] * drop(b, h, q0 + 8 * v4 + c0 + c % 2, k0 + g + 8 * (c / 2))
                        : s[e];
            s[e] = p[c] * (d - cv[8 * v4 + c0 + c % 2]);
          }
        }
        to_a_frags(s, f);
        pv_async<D, QT / 16, QT>(acc, f, r.k(stage));
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (tiles > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
    }
    const int valid = min(QT, S - k0);
    if (valid > 0)
      store_rows<D>(acc, (wg == 0 ? dv : dk) + ((long long)bh * S + k0) * D, valid,
                    [](int, float x) { return x; });
  }
}

cudaError_t launch_d256(const FasnAttn& a, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dkv_d256_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D256_SMEM);
  if (err != cudaSuccess) return err;
  AttnMaps m{};
  if (!encode_attn(&m, a, 256, dout, D256_ROWS)) return cudaErrorInvalidValue;
  const long long ctas = (long long)a.B * a.H * ((a.S + D256_ROWS - 1) / D256_ROWS);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ctas), D256_THREADS, D256_SMEM, stream>>>(m.q, m.k, m.v, m.dout, a, lse, delta,
                                                    static_cast<__nv_bfloat16*>(dk),
                                                    static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 above D 256: D in 64-column chunks through a ring, one CTA per 64
// keys and 128 columns of dk and dv, split by product
// ---------------------------------------------------------------------------

constexpr int WIDE_ROWS = 64;    // the CTA's keys; query rows of a tile
constexpr int WIDE_STAGES = 4;   // ring slots, each one 64-column chunk
constexpr int WIDE_THREADS = attn::CONSUMERS + 128;

// Shared memory: each slot holds one 64-column chunk of the CTA's 64 K and V
// rows and of the query tile's 64 Q and dO rows (8 KB each); then two
// buffers (by query tile parity) of the tile's Q and dO at the CTA's 128
// output columns (two 64-column boxes each, 32 KB a buffer); warpgroup 0's
// P (f32, 64 x 64, each thread's 32 values as 8 float4s 128 threads apart);
// per warpgroup two buffers (by tile parity) of a tile's per-query values;
// then the barriers: full and empty per slot, ocfull and ocempty per
// column buffer.
struct DkvWide {
  static constexpr int K = 0, V = WIDE_ROWS * 128, Q = 2 * V, DO = 3 * V, SLOT = 4 * V;
  static constexpr int OC_AT = WIDE_STAGES * SLOT;
  static constexpr int QOC = 0, DOOC = WIDE_ROWS * 2 * 128, OC = 2 * DOOC;
  static constexpr int P_AT = OC_AT + 2 * OC;
  static constexpr int ROWS_AT = P_AT + WIDE_ROWS * WIDE_ROWS * 4;
  static constexpr int BAR_AT = ROWS_AT + 2 * 2 * WIDE_ROWS * 4;
  static constexpr int SMEM = BAR_AT + 8 * (2 * WIDE_STAGES + 4) + 1024;
};
static_assert(DkvWide::SMEM <= 232448, "K6's wide ring passes the H100's 227 KB");

__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv) {
  using namespace attn;
  using W = DkvWide;
  constexpr int QT = WIDE_ROWS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* const mem = smem_raw + pad;
  const uint32_t base = raw + pad, bars = base + W::BAR_AT;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (WIDE_STAGES + s); };
  const auto ocfull = [&](int i) { return bars + 8 * (2 * WIDE_STAGES + i); };
  const auto ocempty = [&](int i) { return bars + 8 * (2 * WIDE_STAGES + 2 + i); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIDE_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(ocfull(i), 1);
      mbar_init(ocempty(i), CONSUMERS / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a flat grid: a key tile's column chunks side by side, then the head's
  // key tiles (the low ones, which causal rows see most, first), so that
  // the CTAs that run together stream the same chunks, which L2 then serves
  const int D = a.D, NC = D / 64, chunks = D / 128;
  const int n_k = (a.S + QT - 1) / QT;
  const int oc = blockIdx.x % chunks * 128;  // the CTA's first column of dk and dv
  const int bh = blockIdx.x / chunks / n_k, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x / chunks % n_k * QT;
  const int L = a.L, S = a.S, off = S - L;
  // the first query tile with a row that sees key k0 (row >= k0 - off);
  // every tile from there on sees it
  const int first = a.causal ? max(0, k0 - off) / QT : 0;
  const int tiles = max(0, (L + QT - 1) / QT - first);
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < tiles; ++it) {
        const int q0 = (first + it) * QT, ob = it % 2;
        // Q and dO at the CTA's output columns, for dK and dV
        const uint32_t ocb = base + W::OC_AT + ob * W::OC;
        mbar_wait<false>(ocempty(ob), ((it / 2) & 1) ^ 1);
        mbar_expect_tx(ocfull(ob), W::OC);
        for (int x = 0; x < 2; ++x) {
          tma_3d(ocb + W::QOC + x * (W::OC / 4), &qmap, ocfull(ob), oc + 64 * x, q0, bh);
          tma_3d(ocb + W::DOOC + x * (W::OC / 4), &domap, ocfull(ob), oc + 64 * x, q0, bh);
        }
        // the query tile's chunks over D, with the CTA's K and V rows
        for (int c = 0; c < NC; ++c) {
          mbar_wait<false>(empty(stage), phase ^ 1);
          const uint32_t slot = base + stage * W::SLOT;
          mbar_expect_tx(full(stage), W::SLOT);
          tma_3d(slot + W::K, &kmap, full(stage), 64 * c, k0, bh);
          tma_3d(slot + W::V, &vmap, full(stage), 64 * c, k0, bh);
          tma_3d(slot + W::Q, &qmap, full(stage), 64 * c, q0, bh);
          tma_3d(slot + W::DO, &domap, full(stage), 64 * c, q0, bh);
          if (++stage == WIDE_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
    const ScoreMods mods = score_mods(a, b, h);
    const Dropout drop = dropout_of(a);
    const bool plain = mods.bias == nullptr && !mods.alibi;
    // written and read in the same fragment order: no bank conflicts
    float4* pbuf = reinterpret_cast<float4*>(mem + W::P_AT) + t;
    float acc[64];  // warpgroup 0: dV, 1: dK, at the CTA's 128 columns
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // thread t < 64 carries query t's value of the next tile (warpgroup 0:
    // lse, then clamped and in log2 units; 1: delta; 0 past L) into the
    // warpgroup's buffer
    float* rows = reinterpret_cast<float*>(mem + W::ROWS_AT) + wg * 2 * QT;
    const float* row_src = (wg == 0 ? lse : delta) + (long long)bh * L;
    const int qt = first * QT + t;  // query t of the first tile
    float next = tiles > 0 && t < QT && qt < L ? row_src[qt] : 0.f;

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < tiles; ++it) {
      const int q0 = (first + it) * QT, ob = it % 2;
      const uint32_t ocb = base + W::OC_AT + ob * W::OC;
      // fragment row i: key k0 + g + 8 i; column: query q0 + 8 j + c0 + c,
      // whose value is cv[8 j + c0 + c] (published by the warpgroup's
      // barrier below)
      float* cv = rows + ob * QT;
      if (t < QT) {
        cv[t] = wg == 0 ? fmaxf(next, DEAD_LSE) * LOG2E : next;
        const int qn = qt + (it + 1) * QT;
        next = it + 1 < tiles && qn < L ? row_src[qn] : 0.f;
      }
      // warpgroup 0: S^T += K Q_s^T; 1: dP^T += V dO^T, chunk after chunk
      float s[QT / 2];
      int prev = 0;
      for (int c = 0; c < NC; ++c) {
        mbar_wait<false>(full(stage), phase);
        const uint32_t slot = base + stage * W::SLOT;
        if (wg == 0) {
          // Q_s: the chunk's q * scale_q rounded to bf16, while the
          // previous chunk's product runs
          scale_q_rows<64, QT>(mem + stage * W::SLOT + W::Q, 0, a.scale_q);
          fence_proxy_async();
          asm volatile("bar.sync 1, 128;" ::: "memory");
        }
        // one wgmma sequence for both roles, the operands chosen by role:
        // with a sequence in each branch (here and for dV/dK below) ptxas
        // serialised the products (its C7515): 3.89 ms against 3.20 at B32
        // H16 L=S=512 d512 causal on an NVIDIA H100 80GB HBM3
        wgmma_fence();
        chunk_dots(s, slot + (wg == 0 ? W::K : W::V), slot + (wg == 0 ? W::Q : W::DO), c == 0);
        wgmma_commit();
        // the previous chunk's group is done: free its slot
        if (c > 0) {
          wgmma_wait<1>();
          if (t == 0) mbar_arrive(empty(prev));
        }
        prev = stage;
        if (++stage == WIDE_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (wg == 1) {
        // Q_s at the output columns, while the last chunk's product runs
        // (the barrier also publishes the tile's delta)
        mbar_wait<false>(ocfull(ob), (it / 2) & 1);
        scale_q_rows<128, QT>(mem + W::OC_AT + ob * W::OC + W::QOC, 0, a.scale_q);
        fence_proxy_async();
        asm volatile("bar.sync 2, 128;" ::: "memory");
      }
      wgmma_wait<0>();
      fence_regs(s);
      if (t == 0) mbar_arrive(empty(prev));
      if (wg == 0) {
        // P from S^T, handed to warpgroup 1, then the dropout
        if (!plain || q0 + QT > L || k0 + QT > S || (mods.causal && q0 + off < k0 + QT - 1)) {
#pragma unroll
          for (int e = 0; e < QT / 2; ++e)
            s[e] = mods(s[e], q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
        }
#pragma unroll
        for (int e = 0; e < QT / 2; ++e)
          s[e] = exp2f(fmaf(s[e], LOG2E, -cv[8 * (e / 4) + c0 + e % 2]));
        // warpgroup 1 has read the previous tile's P
        if (it > 0) asm volatile("bar.sync 4, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
        for (int v4 = 0; v4 < QT / 8; ++v4)
          pbuf[v4 * 128] = make_float4(s[4 * v4], s[4 * v4 + 1], s[4 * v4 + 2], s[4 * v4 + 3]);
        asm volatile("bar.arrive 3, %0;" ::"n"(CONSUMERS) : "memory");
        if (drop.on) {
#pragma unroll
          for (int e = 0; e < QT / 2; ++e)
            s[e] *= drop(b, h, q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
        }
      } else {
        // dS^T from warpgroup 0's P
        asm volatile("bar.sync 3, %0;" ::"n"(CONSUMERS) : "memory");
#pragma unroll
        for (int v4 = 0; v4 < QT / 8; ++v4) {
          const float4 p4 = pbuf[v4 * 128];
          const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int e = 4 * v4 + c;
            const float d =
                drop.on ? s[e] * drop(b, h, q0 + 8 * v4 + c0 + c % 2, k0 + g + 8 * (c / 2))
                        : s[e];
            s[e] = p[c] * (d - cv[8 * v4 + c0 + c % 2]);
          }
        }
        if (it + 1 < tiles) asm volatile("bar.arrive 4, %0;" ::"n"(CONSUMERS) : "memory");
      }
      // warpgroup 0: dV += (P mult)^T dO; 1: dK += dS^T Q_s; one wgmma
      // sequence for both roles, B chosen by role (as above)
      uint32_t f[QT / 16][4];
      to_a_frags(s, f);
      mbar_wait<false>(ocfull(ob), (it / 2) & 1);
      pv_async<128, QT / 16, QT>(acc, f, ocb + (wg == 0 ? W::DOOC : W::QOC));
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(ocempty(ob));
    }

    const int valid = min(QT, S - k0);
    if (valid > 0)
      store_cols<128>(acc, (wg == 0 ? dv : dk) + ((long long)bh * S + k0) * D + oc, D, valid,
                      [](float x) { return x; });
  }
}

cudaError_t launch_wide(const FasnAttn& a, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dkv_wide_wgmma_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DkvWide::SMEM);
  if (err != cudaSuccess) return err;
  // every map in 64-row boxes of 64 columns
  AttnMaps m{};
  if (!encode_attn(&m, a, a.D, dout, WIDE_ROWS)) return cudaErrorInvalidValue;
  const long long ctas =
      (long long)a.B * a.H * ((a.S + WIDE_ROWS - 1) / WIDE_ROWS) * (a.D / 128);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), WIDE_THREADS, DkvWide::SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dkv(const FasnAttn* a, const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv, void* scratch,
                                  cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 0 && a->dtype != 1) return cudaErrorInvalidValue;
  if (a->dtype == 0) {
    if (a->D >= 256)
      return fasn_flash_bwd_dkv_tf32x3_wide(a, dout, lse, delta, dk, dv, scratch, stream);
    return fasn_flash_bwd_dkv_tf32x3(a, dout, lse, delta, dk, dv, stream);
  }
  if (wide_d(a->D)) return launch_wide(*a, dout, lse, delta, dk, dv, stream);
  switch (a->D) {
    case 32:
      return launch_wgmma<32>(*a, dout, lse, delta, dk, dv, stream);
    case 64:
      return launch_wgmma<64>(*a, dout, lse, delta, dk, dv, stream);
    case 128:
      return launch_wgmma<128>(*a, dout, lse, delta, dk, dv, stream);
    case 256:
      return launch_d256(*a, dout, lse, delta, dk, dv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
