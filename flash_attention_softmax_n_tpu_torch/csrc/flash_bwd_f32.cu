// K5 and K6 in f32 at head dims 32, 64 and 128, for Hopper (sm_90a): the
// split-TF32 ("3xTF32") TMA + wgmma kernels flash_bwd_dq_tf32x3_kernel (dq,
// dbias, dslope) and flash_bwd_dkv_tf32x3_kernel (dk, dv). They replace, for
// f32 inputs at those head dims, the Pallas kernels _bwd_dq_kernel and
// _bwd_dkv_kernel (flash_attention_softmax_n_tpu/kernels/flash_attention.py
// :685, :777) and compute what the bf16 kernels of flash_bwd_dq.cu and
// flash_bwd_dkv.cu compute (their headers): p = exp(s - lse) with the +n in
// lse, ds = p (dp * dropmult - delta), dq = scale * ds k, dbias = ds, the
// dslope row partials, dv = (p * dropmult)^T dout, dk = ds^T (q * scale);
// bias, ALiBi, dropout, causal and rectangular causal from flash_common.h,
// dead rows (lse at DEAD_LSE) with zero gradients. fasn_flash_bwd_dq and
// fasn_flash_bwd_dkv call fasn_flash_bwd_dq_tf32x3 and
// fasn_flash_bwd_dkv_tf32x3 for f32 at D 32, 64 and 128 (f32 at D 256 and
// above takes flash_bwd_f32_wide.cu's kernels); the kernels have a
// translation unit of their own so that the instructions of those
// files' kernels stay the ones measured before them.
//
// The split and the transposed layout are tf32x3.h's: three TF32 passes a
// product on each operand's rounded head and rest.
//
// What bounds it on the H100: 3 x 6 D (K5) and 3 x 8 D (K6) TF32 operations
// per visible (query, key) pair at 495 TFLOP/s: K5 0.078 ms and K6 0.104 at
// train_agreement's B2 H32 L=S=1024 d64 causal (f32 FMAs: 0.193, 0.257).
//
// The layout (tf32x3.h). S = Q_s K^T and dP = dO V^T (K5), S^T = K Q_s^T
// and dP^T = V dO^T (K6) read their tiles as TMA lands them. dQ += dS K, dV
// += P^T dO and dK += dS^T Q_s contract over keys or query rows, so their B
// (K, dO, Q_s) is written transposed into shared memory by the consumers,
// once per tile, in the same pass that writes the rests (design (a): no
// device-memory copies; K5 writes 2 KT D x 4 bytes of K^T head and rest a
// key tile, K6 4 QT D x 4 of Q_s^T and dO^T). A (dS, P^T, dS^T) comes from
// the accumulator fragments in registers (split_frags), its rest
// beside it. An f32 tile and its rest are twice a bf16 tile's bytes each,
// so a CTA is one consumer warpgroup of 64 rows (Q and dO, or K and V,
// resident with their rests: 64 D x 16 bytes, 128 KB at D 128) and a
// producer warp that keeps the other pair's tiles in flight with TMA:
//   K5 (flash_bwd_dq_tf32x3_kernel): KT-key K and V tiles, KT 64 / 16 / 32
//     at D 32 / 64 / 128, a ring of 2 / 2 / 1 stages; 96 / 96 / 224 KB, so
//     that at D 64 two CTAs share an SM (5% faster on an H100 than one CTA
//     with 32-key tiles; K6 with 16-row tiles at D 64 ran 4% slower).
//   K6 (flash_bwd_dkv_tf32x3_kernel): QT-row Q and dO tiles, QT 32 / 32 /
//     16 and 2 stages; 72 / 144 / 208 KB.
// (16 keys or rows make 64-byte rows for the transposes: 64-byte swizzle.)
// Per tile the warpgroup splits the landed tiles (heads in place, rests,
// the transposes), issues the S and dP products (3 x D / 8 k8 steps each:
// the heads' into S and dP, the cross products into accumulators of their
// own, added in f32 after) as one group, frees the ring slot as soon as
// they are done (the transposes and rests are copies), forms dS (and P) on
// the fragments as the bf16 kernels do, and takes dQ (or dV, then dK) per
// 64 output columns into a fresh accumulator that f32 adds then carry into
// the sweep's sum (add_tile_product: one accumulator over all of a long
// sweep drifted 10x past the split's own error). Two warpgroup barriers a
// tile: one before the split (every warp is done with the previous tile's
// copies), one after it. The grid is flat with a head's tiles side by side
// (K5: the heaviest query tile first; K6: the low key tiles first), so
// that L2 serves the tiles they all stream. dq, dk and dv sum in registers
// over the sweep: no atomics, no split over the keys, repeat calls
// bit-equal; dbias and the dslope partials as the bf16 kernel writes them.
// Registers a thread (ptxas, sm_90a), D 32 / 64 / 128: K5 209 / 134 / 240,
// no spills; K6 174 / 232 / 255, and at D 128 480 bytes spilled (dK and dV
// alone take 128; taking the tile products 32 columns at a time, or
// forming descriptors inside the tile, left it within 24 bytes of that).
// Inputs must start on 16 bytes (TMA); the operators raise otherwise.

#include <climits>

#include "tf32x3.h"
#include "flash_common.h"

namespace fasn {
namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// K5: dq (dbias, dslope)
// ---------------------------------------------------------------------------

// Shared memory: resident Q_s, its rest, dO, its rest (64 rows each); the
// ring's slots of a K and a V tile (KT keys each; K and V heads as landed);
// K's and V's rests and K^T's head and rest (one set: they are rewritten
// each tile); the barriers: q_full, full and empty per slot.
template <int D, int KT, int STAGES>
struct DqTf32 {
  using Res = F32Tile<D, 64>;
  using KV = F32Tile<D, KT>;
  using KTr = F32Tile<KT, D>;
  static constexpr int Q = 0, Q_LO = Res::TILE, DO = 2 * Res::TILE, DO_LO = 3 * Res::TILE;
  static constexpr int RING = 4 * Res::TILE, SLOT = 2 * KV::TILE;
  static constexpr int K_LO = RING + STAGES * SLOT, V_LO = K_LO + KV::TILE;
  static constexpr int KT_HI = V_LO + KV::TILE, KT_LO = KT_HI + KTr::TILE;
  static constexpr int BAR_AT = KT_LO + KTr::TILE;
  static constexpr int BASE_AT = BAR_AT + 8 * (1 + 2 * STAGES);  // the tiles' base (shared_word)
  static constexpr int SMEM = BASE_AT + 8 + 1024;
  static_assert(SMEM <= 232448, "K5's split-TF32 tiles pass the H100's 227 KB");
};

template <int D, int KT, int STAGES, int CTAS>
__global__ void __launch_bounds__(TF_THREADS, CTAS)
    flash_bwd_dq_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float scale, float* __restrict__ dq, float* __restrict__ dbias,
                               float* __restrict__ dslope_rows) {
  using Y = DqTf32<D, KT, STAGES>;
  using Res = typename Y::Res;
  using KV = typename Y::KV;
  using KTr = typename Y::KTr;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* const mem = smem_raw + pad;
  const uint32_t base = raw + pad, bars = base + Y::BAR_AT;
  const uint32_t q_full = bars;
  const auto full = [&](int s) { return bars + 8 * (1 + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  if (threadIdx.x == 0) {
    *reinterpret_cast<uint32_t*>(mem + Y::BASE_AT) = base;
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // each consumer warp, once past the S and dP products
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a flat grid, a head's query tiles side by side (the heaviest, last, first)
  const int n_q = (a.L + 63) / 64;
  const int bh = blockIdx.x / n_q, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * 64;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + 64, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + KT - 1) / KT : 0;
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128 && tiles > 0) {
      mbar_expect_tx(q_full, 2 * Res::TILE);
      for (int x = 0; x < Res::BOXES; ++x) {
        tma_3d(base + Y::Q + x * Res::BOX, &qmap, q_full, 32 * x, q0, bh);
        tma_3d(base + Y::DO + x * Res::BOX, &domap, q_full, 32 * x, q0, bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < tiles; ++it) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t slot = base + Y::RING + stage * Y::SLOT;
        mbar_expect_tx(full(stage), Y::SLOT);
        for (int x = 0; x < KV::BOXES; ++x) {
          tma_3d(slot + x * KV::BOX, &kmap, full(stage), 32 * x, it * KT, bh);
          tma_3d(slot + KV::TILE + x * KV::BOX, &vmap, full(stage), 32 * x, it * KT, bh);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;

  // per fragment row: lse (clamped) in log2 units, delta, the dslope sum
  float lse2[2], dl[2], dsl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + g + 8 * i;
    lse2[i] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
    dl[i] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
    dsl[i] = 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (tiles > 0) {
    // Q_s = q * scale_q in place and its rest, dO's rest (published by the
    // first tile's barrier)
    mbar_wait(q_full, 0);
    split_tile<D, 64, false, true>(mem + Y::Q, mem + Y::Q_LO, nullptr, nullptr, a.scale_q, t);
    split_tile<D, 64, false, false>(mem + Y::DO, mem + Y::DO_LO, nullptr, nullptr, 1.f, t);
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * KT;
    const uint32_t tb = shared_word(base + Y::BASE_AT);  // = base
    const uint32_t kt = tb + Y::RING + stage * Y::SLOT, vt = kt + KV::TILE;
    mbar_wait(full(stage), phase);
    // every warp is done with the previous tile's rests and K^T
    consumers_sync();
    split_tile<D, KT, true, false>(mem + (kt - tb), mem + Y::K_LO, mem + Y::KT_HI,
                                   mem + Y::KT_LO, 1.f, t);
    split_tile<D, KT, false, false>(mem + (vt - tb), mem + Y::V_LO, nullptr, nullptr, 1.f, t);
    fence_proxy_async();
    consumers_sync();

    // S = Q_s K^T and dP = dO V^T: the heads' products, and the cross
    // products in accumulators of their own, added in f32
    float s[KT / 2], dp[KT / 2], s_x[KT / 2], dp_x[KT / 2];
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) s[e] = dp[e] = s_x[e] = dp_x[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 8; ++st) {
      wgmma_tf32(s_x, Res::desc(tb + Y::Q_LO, st), KV::desc(kt, st));
      wgmma_tf32(s_x, Res::desc(tb + Y::Q, st), KV::desc(tb + Y::K_LO, st));
      wgmma_tf32(dp_x, Res::desc(tb + Y::DO_LO, st), KV::desc(vt, st));
      wgmma_tf32(dp_x, Res::desc(tb + Y::DO, st), KV::desc(tb + Y::V_LO, st));
    }
#pragma unroll
    for (int st = 0; st < D / 8; ++st) {
      wgmma_tf32(s, Res::desc(tb + Y::Q, st), KV::desc(kt, st));
      wgmma_tf32(dp, Res::desc(tb + Y::DO, st), KV::desc(vt, st));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(s_x);
    fence_regs(dp_x);
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) {
      s[e] += s_x[e];
      dp[e] += dp_x[e];
    }
    // the slot is free: the rests and K^T are copies
    if (t % 32 == 0) mbar_arrive(empty(stage));

    // masks, bias and ALiBi only where a key is past S or a diagonal
    if (!plain || k0 + KT > S || (mods.causal && k0 + KT - 1 > q0 + off)) {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        s[e] = mods(s[e], q0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
    }
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) {
      const int i = (e / 2) % 2, qi = q0 + g + 8 * i, kj = k0 + 8 * (e / 4) + c0 + e % 2;
      const float p = exp2f(fmaf(s[e], LOG2E, -lse2[i]));
      const float d = drop.on ? dp[e] * drop(b, h, qi, kj) : dp[e];
      const float ds = p * (d - dl[i]);
      if (dbias && qi < L && kj < S) dbias[((long long)bh * L + qi) * S + kj] = ds;
      if (mods.alibi) dsl[i] += ds * -fabsf((float)(qi + off - kj));
      s[e] = ds;
    }

    // dQ += dS K: dS from the fragment (A), K^T's head and rest (B)
    uint32_t fh[KT / 8][4], fl[KT / 8][4];
    split_frags(s, fh, fl);
    add_tile_product<D, KT>(acc, fh, fl, tb + Y::KT_HI, tb + Y::KT_LO);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = min(64, L - q0);
  // keys past the last tile are causally invisible: zero dbias
  if (dbias) {
    const int from = min(tiles * KT, S), width = S - from;
    for (int e = t; e < valid * width; e += 128)
      dbias[((long long)bh * L + q0 + e / width) * S + from + e % width] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float row = quad_sum(dsl[i]);
    if (dslope_rows && t % 4 == 0 && g + 8 * i < valid)
      dslope_rows[(long long)bh * L + q0 + g + 8 * i] = row;
  }
  store_f32_rows(acc, dq + ((long long)bh * L + q0) * D, valid, scale);
}

// CTAS: the CTAs an SM holds, which caps the registers a thread (2: 168)
template <int D, int KT, int STAGES, int CTAS>
cudaError_t launch_dq(const FasnAttn& a, const void* dout, const float* lse, const float* delta,
                      float scale, void* dq, float* dbias, float* dslope_rows,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_tf32x3_kernel<D, KT, STAGES, CTAS>;
  constexpr int smem = DqTf32<D, KT, STAGES>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // q and dout in 64-row boxes, k and v in KT-row ones, 32 columns each
  AttnMaps m{};
  const long long heads = (long long)a.B * a.H;
  if (!encode_rows(&m.q, a.q, heads, a.L, D, 64, true) ||
      !encode_rows(&m.dout, dout, heads, a.L, D, 64, true) ||
      !encode_rows(&m.k, a.k, heads, a.S, D, KT, true) ||
      !encode_rows(&m.v, a.v, heads, a.S, D, KT, true))
    return cudaErrorInvalidValue;
  const long long ctas = heads * ((a.L + 63) / 64);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), TF_THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, scale, static_cast<float*>(dq), dbias, dslope_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K6: dk, dv
// ---------------------------------------------------------------------------

// Shared memory: resident K, its rest, V, its rest (64 keys each); the
// ring's slots of a Q and a dO tile (QT rows each; Q_s written in place,
// dO's head as landed); Q_s's and dO's rests, then Q_s^T's and dO^T's heads
// and rests (one set); two buffers (by tile parity) of the tile's lse
// (clamped, log2 units) and delta; the barriers: q_full (the resident
// tiles), full and empty per slot.
template <int D, int QT, int STAGES>
struct DkvTf32 {
  using Res = F32Tile<D, 64>;
  using QD = F32Tile<D, QT>;
  using Tr = F32Tile<QT, D>;
  static constexpr int K = 0, K_LO = Res::TILE, V = 2 * Res::TILE, V_LO = 3 * Res::TILE;
  static constexpr int RING = 4 * Res::TILE, SLOT = 2 * QD::TILE;
  static constexpr int Q_LO = RING + STAGES * SLOT, DO_LO = Q_LO + QD::TILE;
  static constexpr int QT_HI = DO_LO + QD::TILE, QT_LO = QT_HI + Tr::TILE;
  static constexpr int DOT_HI = QT_LO + Tr::TILE, DOT_LO = DOT_HI + Tr::TILE;
  static constexpr int ROWS_AT = DOT_LO + Tr::TILE;
  static constexpr int BAR_AT = ROWS_AT + 2 * 2 * QT * 4;
  static constexpr int BASE_AT = BAR_AT + 8 * (1 + 2 * STAGES);  // the tiles' base (shared_word)
  static constexpr int SMEM = BASE_AT + 8 + 1024;
  static_assert(SMEM <= 232448, "K6's split-TF32 tiles pass the H100's 227 KB");
};

template <int D, int QT, int STAGES>
__global__ void __launch_bounds__(TF_THREADS, 1)
    flash_bwd_dkv_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap,
                                const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv) {
  using Y = DkvTf32<D, QT, STAGES>;
  using Res = typename Y::Res;
  using QD = typename Y::QD;
  using Tr = typename Y::Tr;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* const mem = smem_raw + pad;
  const uint32_t base = raw + pad, bars = base + Y::BAR_AT;
  const uint32_t q_full = bars;
  const auto full = [&](int s) { return bars + 8 * (1 + s); };
  const auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  if (threadIdx.x == 0) {
    *reinterpret_cast<uint32_t*>(mem + Y::BASE_AT) = base;
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // each consumer warp, once past the S^T and dP^T products
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a flat grid, a head's key tiles side by side (the low ones, which
  // causal rows see most, first)
  const int n_k = (a.S + 63) / 64;
  const int bh = blockIdx.x / n_k, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x % n_k * 64;
  const int L = a.L, S = a.S, off = S - L;
  // the first query tile with a row that sees key k0 (row >= k0 - off);
  // every tile from there on sees it
  const int first = a.causal ? max(0, k0 - off) / QT : 0;
  const int tiles = max(0, (L + QT - 1) / QT - first);
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128 && tiles > 0) {
      mbar_expect_tx(q_full, 2 * Res::TILE);
      for (int x = 0; x < Res::BOXES; ++x) {
        tma_3d(base + Y::K + x * Res::BOX, &kmap, q_full, 32 * x, k0, bh);
        tma_3d(base + Y::V + x * Res::BOX, &vmap, q_full, 32 * x, k0, bh);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < tiles; ++it) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t slot = base + Y::RING + stage * Y::SLOT;
        const int row = (first + it) * QT;
        mbar_expect_tx(full(stage), Y::SLOT);
        for (int x = 0; x < QD::BOXES; ++x) {
          tma_3d(slot + x * QD::BOX, &qmap, full(stage), 32 * x, row, bh);
          tma_3d(slot + QD::TILE + x * QD::BOX, &domap, full(stage), 32 * x, row, bh);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;
  float* const rows = reinterpret_cast<float*>(mem + Y::ROWS_AT);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (tiles > 0) {
    // K's and V's rests (published by the first tile's barrier)
    mbar_wait(q_full, 0);
    split_tile<D, 64, false, false>(mem + Y::K, mem + Y::K_LO, nullptr, nullptr, 1.f, t);
    split_tile<D, 64, false, false>(mem + Y::V, mem + Y::V_LO, nullptr, nullptr, 1.f, t);
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = (first + it) * QT;
    const uint32_t tb = shared_word(base + Y::BASE_AT);  // = base
    const uint32_t qt = tb + Y::RING + stage * Y::SLOT, dot = qt + QD::TILE;
    // fragment column 8 j + c0 + c is query q0 + that; its clamped lse (log2
    // units) is cv[column], its delta cv[QT + column]
    float* const cv = rows + (it % 2) * 2 * QT;
    if (t < QT) {
      const int qi = q0 + t;
      cv[t] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
      cv[QT + t] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
    }
    mbar_wait(full(stage), phase);
    // every warp is done with the previous tile's rests and transposes
    consumers_sync();
    split_tile<D, QT, true, true>(mem + (qt - tb), mem + Y::Q_LO, mem + Y::QT_HI,
                                  mem + Y::QT_LO, a.scale_q, t);
    split_tile<D, QT, true, false>(mem + (dot - tb), mem + Y::DO_LO, mem + Y::DOT_HI,
                                   mem + Y::DOT_LO, 1.f, t);
    fence_proxy_async();
    consumers_sync();

    // S^T = K Q_s^T and dP^T = V dO^T: the heads' products, and the cross
    // products in accumulators of their own, added in f32
    float s[QT / 2], dp[QT / 2], s_x[QT / 2], dp_x[QT / 2];
#pragma unroll
    for (int e = 0; e < QT / 2; ++e) s[e] = dp[e] = s_x[e] = dp_x[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 8; ++st) {
      wgmma_tf32(s_x, Res::desc(tb + Y::K_LO, st), QD::desc(qt, st));
      wgmma_tf32(s_x, Res::desc(tb + Y::K, st), QD::desc(tb + Y::Q_LO, st));
      wgmma_tf32(dp_x, Res::desc(tb + Y::V_LO, st), QD::desc(dot, st));
      wgmma_tf32(dp_x, Res::desc(tb + Y::V, st), QD::desc(tb + Y::DO_LO, st));
    }
#pragma unroll
    for (int st = 0; st < D / 8; ++st) {
      wgmma_tf32(s, Res::desc(tb + Y::K, st), QD::desc(qt, st));
      wgmma_tf32(dp, Res::desc(tb + Y::V, st), QD::desc(dot, st));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    fence_regs(s_x);
    fence_regs(dp_x);
#pragma unroll
    for (int e = 0; e < QT / 2; ++e) {
      s[e] += s_x[e];
      dp[e] += dp_x[e];
    }
    // the slot is free: the rests and transposes are copies
    if (t % 32 == 0) mbar_arrive(empty(stage));

    // fragment row i: key k0 + g + 8 i; column: query q0 + 8 j + c0 + c
    if (!plain || q0 + QT > L || k0 + 64 > S || (mods.causal && q0 + off < k0 + 63)) {
#pragma unroll
      for (int e = 0; e < QT / 2; ++e)
        s[e] = mods(s[e], q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
    }
#pragma unroll
    for (int e = 0; e < QT / 2; ++e) {
      const int col = 8 * (e / 4) + c0 + e % 2;
      const float p = exp2f(fmaf(s[e], LOG2E, -cv[col]));
      if (drop.on) {
        const float mult = drop(b, h, q0 + col, k0 + g + 8 * ((e / 2) % 2));
        s[e] = p * mult;
        dp[e] = p * (dp[e] * mult - cv[QT + col]);
      } else {
        s[e] = p;
        dp[e] = p * (dp[e] - cv[QT + col]);
      }
    }

    // dV += (P mult)^T dO and dK += dS^T Q_s: P and dS from the fragments
    // (A), dO^T's and Q_s^T's heads and rests (B)
    uint32_t fh[QT / 8][4], fl[QT / 8][4];
    split_frags(s, fh, fl);
    add_tile_product<D, QT>(dv_acc, fh, fl, tb + Y::DOT_HI, tb + Y::DOT_LO);
    split_frags(dp, fh, fl);
    add_tile_product<D, QT>(dk_acc, fh, fl, tb + Y::QT_HI, tb + Y::QT_LO);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = min(64, S - k0);
  store_f32_rows(dk_acc, dk + ((long long)bh * S + k0) * D, valid, 1.f);
  store_f32_rows(dv_acc, dv + ((long long)bh * S + k0) * D, valid, 1.f);
}

template <int D, int QT, int STAGES>
cudaError_t launch_dkv(const FasnAttn& a, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_tf32x3_kernel<D, QT, STAGES>;
  constexpr int smem = DkvTf32<D, QT, STAGES>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // k and v in 64-row boxes, q and dout in QT-row ones, 32 columns each
  AttnMaps m{};
  const long long heads = (long long)a.B * a.H;
  if (!encode_rows(&m.k, a.k, heads, a.S, D, 64, true) ||
      !encode_rows(&m.v, a.v, heads, a.S, D, 64, true) ||
      !encode_rows(&m.q, a.q, heads, a.L, D, QT, true) ||
      !encode_rows(&m.dout, dout, heads, a.L, D, QT, true))
    return cudaErrorInvalidValue;
  const long long ctas = heads * ((a.S + 63) / 64);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), TF_THREADS, smem, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv));
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dq_tf32x3(const FasnAttn* a, const void* dout, const float* lse,
                                        const float* delta, float scale, void* dq, float* dbias,
                                        float* dslope_rows, cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 0) return cudaErrorInvalidValue;
  switch (a->D) {
    case 32:
      return launch_dq<32, 64, 2, 1>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
    case 64:
      return launch_dq<64, 16, 2, 2>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
    case 128:
      return launch_dq<128, 32, 1, 1>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int fasn_flash_bwd_dkv_tf32x3(const FasnAttn* a, const void* dout, const float* lse,
                                         const float* delta, void* dk, void* dv,
                                         cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 0) return cudaErrorInvalidValue;
  switch (a->D) {
    case 32:
      return launch_dkv<32, 32, 2>(*a, dout, lse, delta, dk, dv, stream);
    case 64:
      return launch_dkv<64, 32, 2>(*a, dout, lse, delta, dk, dv, stream);
    case 128:
      return launch_dkv<128, 16, 2>(*a, dout, lse, delta, dk, dv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
