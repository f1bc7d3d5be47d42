// K5 and K6 in f32 at head dims 256 and above, for Hopper (sm_90a): the
// split-TF32 ("3xTF32") TMA + wgmma kernels flash_bwd_dq_tf32x3_wide_kernel
// (dq, dbias, dslope) and flash_bwd_dkv_tf32x3_wide_kernel (dk, dv), each
// after a pre-pass of its own (flash_bwd_dq_tf32x3_split_kernel,
// flash_bwd_dkv_tf32x3_split_kernel). They replace, for f32 inputs at D 256
// and at every multiple of 128 above it (the D the wrappers pad to), the
// Pallas kernels _bwd_dq_kernel and _bwd_dkv_kernel
// (flash_attention_softmax_n_tpu/kernels/flash_attention.py:685, :777), and
// compute what flash_bwd_f32.cu's kernels compute at D <= 128 (its header):
// p = exp(s - lse) with the +n in lse, ds = p (dp * dropmult - delta), dq =
// scale * ds k, dbias = ds, the dslope row partials, dv = (p * dropmult)^T
// dout, dk = ds^T (q * scale); bias, ALiBi, dropout, causal and rectangular
// causal from flash_common.h, dead rows (lse at DEAD_LSE) with zero
// gradients. fasn_flash_bwd_dq and fasn_flash_bwd_dkv call
// fasn_flash_bwd_dq_tf32x3_wide and fasn_flash_bwd_dkv_tf32x3_wide for f32
// at D >= 256; the kernels have a translation unit of their own so that the
// instructions of the other files' kernels stay the ones measured before.
//
// The split is tf32x3.h's: three TF32 passes a product on each operand's
// rounded head and rest, rest x head and head x rest first.
//
// What bounds it on the H100: 3 x 6 D (K5) and 3 x 8 D (K6) TF32 operations
// per visible (query, key) pair at 495 TFLOP/s; at B2 H8 L=S=1024 causal K5
// 0.156 ms and K6 0.208 at D 512 (f32 FMAs at 67 TFLOP/s: 0.385, 0.513).
//
// The layout. An f32 operand and its rest are 8 bytes an element, so at D
// 256-512 neither side of the products fits a CTA (Q and dO of 64 rows
// with their rests are 256 KB at D 256): both stream through a TMA ring in
// 32-column chunks of D. TF32 has no transpose bit, so dQ += dS K, dV +=
// P^T dO and dK += dS^T Q_s need K, dO and Q_s transposed over all of D,
// which no CTA holds. A pre-pass kernel a call (design (b)) writes those
// transposes once to device scratch that the operator allocates, the
// heads (q times scale_q, rounded to TF32) and rests as two planes of (2
// BH, D, rows rounded up to 32), row j of each 8 at position k8_slot(j)
// (tf32x3.h: the order in which the accumulator fragments pass as A
// operands), zeros past the rows: K^T for K5, Q_s^T and dO^T for K6. The
// score products read q, k, v and dout as TMA lands them from the inputs,
// and each consumer warpgroup splits its own tiles of a chunk in shared
// memory (design (a), split_tile) behind a barrier of its own. On an
// NVIDIA H100 80GB HBM3 at 700 W (B2 H8 L=S=1024 causal; the pair with
// delta in device ms, chip_smoke.py's train_kernel_lines, four builds in
// one call, each twice) this ran 1.251-1.253 / 2.005-2.006 / 2.691-2.705 at
// D 256 / 384 / 512 where a pre-pass that also wrote every operand's head
// and rest for the score products (twice the kernels' bytes from memory,
// none of their splitting) ran 1.352-1.353 / 2.197-2.205 / 3.052-3.055;
// overlapping each chunk's split with the previous chunk's products
// (tile_scores) brought it to 1.133-1.146 / 1.791 / 2.347-2.351. (Two
// chunks' products in flight instead, with two accumulators, ran 1.193-1.205
// / 1.849-1.881 / 2.516-2.583 and spilled 60 and 144 bytes.)
//
// The kernels. A CTA is two consumer warpgroups (232 registers each,
// setmaxnreg) and a producer warpgroup (40; one lane issues every TMA load)
// around a four-stage ring of 48 KB slots. It owns 64 rows (K5: query rows;
// K6: keys) and walks tiles of WT = 32 rows of the other side (K5: keys;
// K6: query rows). Per tile:
//   - phase 1, the scores: D / 32 units, each a slot holding 32 columns of
//     D of warpgroup 0's pair (K5: Q and K; K6: K and Q) and warpgroup 1's
//     (K5: dO and V; K6: V and dO), each tile with room for its rest.
//     Warpgroup 0 forms S (K6: S^T) and warpgroup 1 dP (dP^T) over all of
//     D, each unit's three passes (12 m64n32k8 products) into a fresh
//     accumulator that f32 adds (at D 512 one accumulator would take 192
//     products; one over a sweep of 1024 rows drifted 10x past the split's
//     error, flash_bwd_f32.cu);
//   - the exchange: K5's warpgroups trade S and dP through shared memory
//     (one barrier) and both form the same dS bit for bit; K6's warpgroup 0
//     forms P, hands it to warpgroup 1, which forms dS;
//   - phase 2, the products: one unit a 64 output columns, each slot holding
//     the transposed tiles (heads and rests) of both warpgroups, taken into a
//     fresh accumulator a unit and tile (tf32x3.h add_tile_product), A from
//     the fragments in registers (split_frags).
// S and dP are formed once per 512 output columns in K5 (its warpgroups each
// own half of dq's columns: at most 4 x 64, 128 floats a thread) and once
// per 256 in K6 (warpgroup 0 owns dV's columns, warpgroup 1 dK's). Above
// those widths a CTA takes one of ceil(D / 512) (K5) or ceil(D / 256) (K6)
// column groups, the 64-column chunks dealt out evenly, and forms S and dP
// again. The grid is flat: a head's CTAs side by side (K5: the heaviest
// query tile first, a tile's column groups together; K6: the low key tiles
// first), so that L2 serves the chunks they all stream. dq, dk and dv sum in
// registers over the sweep: no atomics, repeat calls bit-equal; dbias and
// the dslope partials as flash_bwd_f32.cu writes them, by the CTAs of the
// first column group. The exchange buffers are single: a warpgroup writes
// the next tile's only after D / 32 >= 8 ring units, more than the ring
// holds, so the other warpgroup has freed a slot after its read.
// Shared memory 214,080 bytes (K5), 205,888 (K6); ptxas (sm_90a): 0 bytes
// spilled (the launch's count of 168 registers is what it reports for
// kernels that trade registers with setmaxnreg).
// Inputs must start on 16 bytes (TMA); the operators raise otherwise.

#include <climits>
#include <cstddef>

#include "tf32x3.h"
#include "flash_common.h"

namespace fasn {
namespace {

using namespace attn;

constexpr int WT = 32;           // rows of a streamed tile: K5's keys, K6's query rows
constexpr int W_THREADS = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int W_STAGES = 4;
using RowT = F32Tile<32, 64>;    // the CTA's 64 rows x 32 columns of D
using StrT = F32Tile<32, WT>;    // WT streamed rows x 32 columns of D
using TrT = F32Tile<WT, 64>;     // 64 output columns x WT streamed rows (transposed)
// a phase-1 unit: warpgroup w's A (its 64 rows) and B (the streamed rows)
// as TMA lands them (their heads once split in place), each with room for
// its rest, at w * HALF
constexpr int A_HI = 0, A_LO = RowT::TILE, B_HI = 2 * RowT::TILE, B_LO = B_HI + StrT::TILE;
constexpr int HALF = 2 * RowT::TILE + 2 * StrT::TILE;
constexpr int SLOT = 2 * HALF;  // 48 KB
// a phase-2 unit: warpgroup w's transposed tile, head then rest, at w * T_HALF
constexpr int T_HALF = 2 * TrT::TILE;
static_assert(2 * T_HALF <= SLOT, "a phase-2 unit fits a slot");
constexpr int X_BYTES = 64 * WT * 4;  // one 64 x WT f32 exchange buffer

// the ring, XB exchange buffers after it, the barriers (full, empty per slot)
template <int XB>
struct WideTf32 {
  static constexpr int X_AT = W_STAGES * SLOT;
  static constexpr int BAR_AT = X_AT + XB * X_BYTES;
  static constexpr int SMEM = BAR_AT + 8 * 2 * W_STAGES + 1024;
  static_assert(SMEM <= 232448, "the wide split-TF32 ring passes the H100's 227 KB");
};

struct WRing {
  uint8_t* mem;  // the generic address of `base`
  uint32_t base, bars;
  __device__ uint32_t slot(int s) const { return base + s * SLOT; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (W_STAGES + s); }
};

struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == W_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int XB>
__device__ __forceinline__ WRing make_wring(uint8_t* smem_raw) {
  WRing r;
  const uint32_t raw = smem_u32(smem_raw), pad = (1024 - (raw & 1023)) & 1023;
  r.mem = smem_raw + pad;
  r.base = raw + pad;
  r.bars = r.base + WideTf32<XB>::BAR_AT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 8);  // each consumer warp, once done with the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer (one lane). For each of `tiles` tiles (streamed rows brow0 +
// it WT): D / 32 phase-1 units, warpgroup w's A rows `arow` of amap[w] and
// B rows of bmap[w] at columns 32 u, f32 as the inputs hold them (head bh);
// then `units2` phase-2 units, unit j warpgroup w's transposed tile of
// tmap[w] at output columns tcol[w] + 64 j where j < tn[w], heads (map head
// bh) and rests (bh + heads).
__device__ __forceinline__ void produce_wide(const WRing& r, const CUtensorMap* const (&amap)[2],
                                             const CUtensorMap* const (&bmap)[2],
                                             const CUtensorMap* const (&tmap)[2], int arow,
                                             int brow0, int tiles, int D, int units2,
                                             const int (&tcol)[2], const int (&tn)[2], int bh,
                                             int heads) {
  RingPos pos;
  for (int it = 0; it < tiles; ++it) {
    const int brow = brow0 + it * WT;
    for (int c = 0; c < D; c += 32) {
      mbar_wait<false>(r.empty(pos.stage), pos.phase ^ 1);
      const uint32_t slot = r.slot(pos.stage), bar = r.full(pos.stage);
      mbar_expect_tx(bar, 2 * (RowT::TILE + StrT::TILE));
      for (int w = 0; w < 2; ++w) {
        const uint32_t h = slot + w * HALF;
        tma_3d(h + A_HI, amap[w], bar, c, arow, bh);
        tma_3d(h + B_HI, bmap[w], bar, c, brow, bh);
      }
      pos.next();
    }
    for (int j = 0; j < units2; ++j) {
      mbar_wait<false>(r.empty(pos.stage), pos.phase ^ 1);
      const uint32_t slot = r.slot(pos.stage), bar = r.full(pos.stage);
      mbar_expect_tx(bar, (j < tn[0] ? T_HALF : 0) + (j < tn[1] ? T_HALF : 0));
      for (int w = 0; w < 2; ++w) {
        if (j >= tn[w]) continue;
        const uint32_t h = slot + w * T_HALF;
        tma_3d(h, tmap[w], bar, brow, tcol[w] + 64 * j, bh);
        tma_3d(h + TrT::TILE, tmap[w], bar, brow, tcol[w] + 64 * j, heads + bh);
      }
      pos.next();
    }
  }
}

// waits for the phase-1 unit at `pos` and splits warpgroup w's A and B
// tiles there (times a_mul and b_mul: heads in place, rests beside them;
// tf32x3.h split_tile), published to wgmma behind the warpgroup's own
// barrier; returns the address of its half of the slot
__device__ __forceinline__ uint32_t unit_split(const WRing& r, const RingPos& pos, int w,
                                               float a_mul, float b_mul) {
  const int t = threadIdx.x % 128;
  mbar_wait<false>(r.full(pos.stage), pos.phase);
  const uint32_t h = r.slot(pos.stage) + w * HALF;
  uint8_t* const hm = r.mem + (h - r.base);
  split_tile<32, 64, false, true>(hm + A_HI, hm + A_LO, nullptr, nullptr, a_mul, t);
  split_tile<32, WT, false, true>(hm + B_HI, hm + B_LO, nullptr, nullptr, b_mul, t);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  return h;
}

// issues part = A B^T over a unit's 32 columns (its half at h), three
// passes into a fresh accumulator, as one wgmma group
__device__ __forceinline__ void unit_products(float (&part)[WT / 2], uint32_t h) {
#pragma unroll
  for (int e = 0; e < WT / 2; ++e) part[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    wgmma_tf32(part, RowT::desc(h + A_LO, st), StrT::desc(h + B_HI, st));
    wgmma_tf32(part, RowT::desc(h + A_HI, st), StrT::desc(h + B_LO, st));
  }
#pragma unroll
  for (int st = 0; st < 4; ++st)
    wgmma_tf32(part, RowT::desc(h + A_HI, st), StrT::desc(h + B_HI, st));
  wgmma_commit();
}

// once a unit's group is done (fence_regs by the caller): its slot is free
// (the rests are in it, and copies), its part added in f32 to s
__device__ __forceinline__ void unit_done(float (&s)[WT / 2], const float (&part)[WT / 2],
                                          const WRing& r, int stage) {
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(stage));
#pragma unroll
  for (int e = 0; e < WT / 2; ++e) s[e] += part[e];
}

// s = (a_mul A) (b_mul B)^T over all of D for warpgroup w's pair, a unit
// (32 columns of D) at a time in fresh accumulators that f32 adds to s in
// order; each unit's split runs while the previous unit's products do
__device__ __forceinline__ void tile_scores(float (&s)[WT / 2], const WRing& r, RingPos& pos,
                                            int D, int w, float a_mul, float b_mul) {
#pragma unroll
  for (int e = 0; e < WT / 2; ++e) s[e] = 0.f;
  float part[WT / 2];
  int done = pos.stage;  // the slot of the unit whose products are in flight
  unit_products(part, unit_split(r, pos, w, a_mul, b_mul));
  pos.next();
  for (int c = 32; c < D; c += 32) {
    const int stage = pos.stage;
    const uint32_t h = unit_split(r, pos, w, a_mul, b_mul);
    pos.next();
    wgmma_wait<0>();
    fence_regs(part);
    unit_done(s, part, r, done);
    unit_products(part, h);
    done = stage;
  }
  wgmma_wait<0>();
  fence_regs(part);
  unit_done(s, part, r, done);
}

// acc[j] += A B_j for the `units` phase-2 units of a tile, j < mine: A the
// fragments of the tile's dS or P (heads fh, rests fl), B_j warpgroup w's
// transposed tile in unit j
__device__ __forceinline__ void tile_products(float (&acc)[4][32],
                                              const uint32_t (&fh)[WT / 8][4],
                                              const uint32_t (&fl)[WT / 8][4], const WRing& r,
                                              RingPos& pos, int units, int mine, int w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < units) {
      mbar_wait<false>(r.full(pos.stage), pos.phase);
      const uint32_t b = r.slot(pos.stage) + w * T_HALF;
      if (j < mine) add_tile_product<64, WT>(acc[j], fh, fl, b, b + TrT::TILE);
      if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(pos.stage));
      pos.next();
    }
  }
}

// the 64 fragment rows of acc's first `mine` 64-column chunks (chunk j at
// column col0 + 64 j of rows `rows`, ld apart), times `mul`, where the row
// is below `valid`
__device__ __forceinline__ void store_chunks(const float (&acc)[4][32], float* rows, long long ld,
                                             int col0, int mine, int valid, float mul) {
  const int t = threadIdx.x % 128, r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= mine) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= valid) continue;
      float* row = rows + (long long)r * ld + col0 + 64 * j;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<float2*>(row + 8 * jj + c0) =
            make_float2(mul * acc[j][4 * jj + 2 * i], mul * acc[j][4 * jj + 2 * i + 1]);
    }
  }
}

// s's fragment (m64nWT) to this thread's float4s of a 64 x WT buffer, and
// back
__device__ __forceinline__ void put_frag(const float (&s)[WT / 2], float4* x) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int c = 0; c < WT / 8; ++c)
    x[c * 128 + t] = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
}
__device__ __forceinline__ void get_frag(float (&s)[WT / 2], const float4* x) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int c = 0; c < WT / 8; ++c) {
    const float4 o = x[c * 128 + t];
    s[4 * c] = o.x;
    s[4 * c + 1] = o.y;
    s[4 * c + 2] = o.z;
    s[4 * c + 3] = o.w;
  }
}

__device__ __forceinline__ void consumers_pair_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// the first of the 64-column chunks of column group `grp` of `groups`, of n
__host__ __device__ __forceinline__ int group_chunk(int n, int grp, int groups) {
  return n * grp / groups;
}

// ---------------------------------------------------------------------------
// the pre-pass (tf32x3.h split_pass)
// ---------------------------------------------------------------------------

// one kernel a backward kernel, so that the profiler's names give K5's and
// K6's device time each with its own pre-pass
__global__ void __launch_bounds__(256)
    flash_bwd_dq_tf32x3_split_kernel(const __grid_constant__ SplitJobs js) {
  split_pass(js);
}
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_tf32x3_split_kernel(const __grid_constant__ SplitJobs js) {
  split_pass(js);
}

// ---------------------------------------------------------------------------
// K5: dq (dbias, dslope)
// ---------------------------------------------------------------------------

using DqW = WideTf32<2>;  // exchange: S (warpgroup 0), dP (1)

__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_dq_tf32x3_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                                    const __grid_constant__ CUtensorMap domap,
                                    const __grid_constant__ CUtensorMap kmap,
                                    const __grid_constant__ CUtensorMap vmap,
                                    const __grid_constant__ CUtensorMap ktmap, const FasnAttn a,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, float scale,
                                    float* __restrict__ dq, float* __restrict__ dbias,
                                    float* __restrict__ dslope_rows) {
  extern __shared__ uint8_t smem_raw[];
  const WRing r = make_wring<2>(smem_raw);
  // a flat grid: a query tile's column groups side by side, then the head's
  // query tiles (the heaviest, last, first)
  const int D = a.D, n_c = D / 64, groups = (n_c + 7) / 8;
  const int n_q = (a.L + 63) / 64;
  const int grp = blockIdx.x % groups;
  const int bh = blockIdx.x / groups / n_q, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x / groups % n_q) * 64;
  const int L = a.L, S = a.S, off = S - L;
  const long long heads = (long long)a.B * a.H;
  // dq's chunks: warpgroup 0 the first m0 of the group's, warpgroup 1 the rest
  const int ch0 = group_chunk(n_c, grp, groups), m = group_chunk(n_c, grp + 1, groups) - ch0;
  const int m0 = (m + 1) / 2;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + 64, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + WT - 1) / WT : 0;
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const CUtensorMap* const am[2] = {&qmap, &domap};
      const CUtensorMap* const bm[2] = {&kmap, &vmap};
      const CUtensorMap* const tm[2] = {&ktmap, &ktmap};
      const int tcol[2] = {64 * ch0, 64 * (ch0 + m0)}, tn[2] = {m0, m - m0};
      produce_wide(r, am, bm, tm, q0, 0, tiles, D, m0, tcol, tn, (int)bh, (int)heads);
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int t = threadIdx.x % 128;
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;
  const bool writes = wg == 0 && grp == 0;  // dbias and dslope
  float4* const x_mine = reinterpret_cast<float4*>(r.mem + DqW::X_AT + wg * X_BYTES);
  const float4* const x_other =
      reinterpret_cast<const float4*>(r.mem + DqW::X_AT + (1 - wg) * X_BYTES);

  // per fragment row: lse (clamped) in log2 units, delta, the dslope sum
  float lse2[2], dl[2], dsl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + g + 8 * i;
    lse2[i] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
    dl[i] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
    dsl[i] = 0.f;
  }
  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  RingPos pos;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * WT;
    // warpgroup 0: S = Q_s K^T; 1: dP = dO V^T; traded, so both hold both
    float mine[WT / 2], other[WT / 2];
    tile_scores(mine, r, pos, D, wg, wg == 0 ? a.scale_q : 1.f, 1.f);
    put_frag(mine, x_mine);
    consumers_pair_sync();
    get_frag(other, x_other);
    float s[WT / 2], dp[WT / 2];
#pragma unroll
    for (int e = 0; e < WT / 2; ++e) {
      s[e] = wg == 0 ? mine[e] : other[e];
      dp[e] = wg == 0 ? other[e] : mine[e];
    }

    // masks, bias and ALiBi only where a key is past S or a diagonal
    if (!plain || k0 + WT > S || (mods.causal && k0 + WT - 1 > q0 + off)) {
#pragma unroll
      for (int e = 0; e < WT / 2; ++e)
        s[e] = mods(s[e], q0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
    }
#pragma unroll
    for (int e = 0; e < WT / 2; ++e) {
      const int i = (e / 2) % 2, qi = q0 + g + 8 * i, kj = k0 + 8 * (e / 4) + c0 + e % 2;
      const float p = exp2f(fmaf(s[e], LOG2E, -lse2[i]));
      const float d = drop.on ? dp[e] * drop(b, h, qi, kj) : dp[e];
      const float ds = p * (d - dl[i]);
      if (writes && dbias && qi < L && kj < S) dbias[((long long)bh * L + qi) * S + kj] = ds;
      if (mods.alibi) dsl[i] += ds * -fabsf((float)(qi + off - kj));
      s[e] = ds;
    }

    // dQ += dS K at the warpgroup's chunks: dS from the fragment (A), K^T's
    // heads and rests (B)
    uint32_t fh[WT / 8][4], fl[WT / 8][4];
    split_frags(s, fh, fl);
    tile_products(acc, fh, fl, r, pos, m0, wg == 0 ? m0 : m - m0, wg);
  }

  const int valid = min(64, L - q0);
  if (writes) {
    // keys past the last tile are causally invisible: zero dbias
    if (dbias) {
      const int from = min(tiles * WT, S), width = S - from;
      for (int e = t; e < valid * width; e += 128)
        dbias[((long long)bh * L + q0 + e / width) * S + from + e % width] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float row = quad_sum(dsl[i]);
      if (dslope_rows && t % 4 == 0 && g + 8 * i < valid)
        dslope_rows[(long long)bh * L + q0 + g + 8 * i] = row;
    }
  }
  store_chunks(acc, dq + ((long long)bh * L + q0) * D, D, 64 * (ch0 + (wg == 0 ? 0 : m0)),
               wg == 0 ? m0 : m - m0, valid, scale);
}

// ---------------------------------------------------------------------------
// K6: dk, dv
// ---------------------------------------------------------------------------

using DkvW = WideTf32<1>;  // exchange: P (warpgroup 0 to 1)

__global__ void __launch_bounds__(W_THREADS, 1)
    flash_bwd_dkv_tf32x3_wide_kernel(const __grid_constant__ CUtensorMap kmap,
                                     const __grid_constant__ CUtensorMap vmap,
                                     const __grid_constant__ CUtensorMap qmap,
                                     const __grid_constant__ CUtensorMap domap,
                                     const __grid_constant__ CUtensorMap dotmap,
                                     const __grid_constant__ CUtensorMap qtmap, const FasnAttn a,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta, float* __restrict__ dk,
                                     float* __restrict__ dv) {
  extern __shared__ uint8_t smem_raw[];
  const WRing r = make_wring<1>(smem_raw);
  // a flat grid: a key tile's column groups side by side, then the head's
  // key tiles (the low ones, which causal rows see most, first)
  const int D = a.D, n_c = D / 64, groups = (n_c + 3) / 4;
  const int n_k = (a.S + 63) / 64;
  const int grp = blockIdx.x % groups;
  const int bh = blockIdx.x / groups / n_k, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x / groups % n_k * 64;
  const int L = a.L, S = a.S, off = S - L;
  const long long heads = (long long)a.B * a.H;
  // dv's (warpgroup 0) and dk's (1) chunks: the group's
  const int ch0 = group_chunk(n_c, grp, groups), m = group_chunk(n_c, grp + 1, groups) - ch0;
  // the first query tile with a row that sees key k0 (row >= k0 - off);
  // every tile from there on sees it
  const int first = a.causal ? max(0, k0 - off) / WT : 0;
  const int tiles = max(0, (L + WT - 1) / WT - first);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const CUtensorMap* const am[2] = {&kmap, &vmap};
      const CUtensorMap* const bm[2] = {&qmap, &domap};
      const CUtensorMap* const tm[2] = {&dotmap, &qtmap};
      const int tcol[2] = {64 * ch0, 64 * ch0}, tn[2] = {m, m};
      produce_wide(r, am, bm, tm, k0, first * WT, tiles, D, m, tcol, tn, (int)bh, (int)heads);
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int t = threadIdx.x % 128;
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;
  float4* const x = reinterpret_cast<float4*>(r.mem + DkvW::X_AT);

  float acc[4][32];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  RingPos pos;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = (first + it) * WT;
    // fragment row i: key k0 + g + 8 i; column 8 (e / 4) + c0 + e % 2:
    // query q0 + that, whose lse (clamped, log2 units) or delta is cv[2 (e
    // / 4) + e % 2]
    float cv[WT / 4];
#pragma unroll
    for (int n = 0; n < WT / 4; ++n) {
      const int qi = q0 + 8 * (n / 2) + c0 + n % 2;
      cv[n] = qi >= L ? 0.f
              : wg == 0 ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E
                        : delta[(long long)bh * L + qi];
    }
    // warpgroup 0: S^T = K Q_s^T; 1: dP^T = V dO^T
    float s[WT / 2];
    tile_scores(s, r, pos, D, wg, 1.f, wg == 0 ? a.scale_q : 1.f);
    if (wg == 0) {
      if (!plain || q0 + WT > L || k0 + 64 > S || (mods.causal && q0 + off < k0 + 63)) {
#pragma unroll
        for (int e = 0; e < WT / 2; ++e)
          s[e] = mods(s[e], q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
      }
#pragma unroll
      for (int e = 0; e < WT / 2; ++e) s[e] = exp2f(fmaf(s[e], LOG2E, -cv[2 * (e / 4) + e % 2]));
      put_frag(s, x);  // P, to warpgroup 1
      if (drop.on) {
#pragma unroll
        for (int e = 0; e < WT / 2; ++e)
          s[e] *= drop(b, h, q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2));
      }
      consumers_pair_sync();
    } else {
      consumers_pair_sync();
      float p[WT / 2];
      get_frag(p, x);
#pragma unroll
      for (int e = 0; e < WT / 2; ++e) {
        const float mult =
            drop.on ? drop(b, h, q0 + 8 * (e / 4) + c0 + e % 2, k0 + g + 8 * ((e / 2) % 2))
                    : 1.f;
        s[e] = p[e] * ((drop.on ? s[e] * mult : s[e]) - cv[2 * (e / 4) + e % 2]);
      }
    }

    // warpgroup 0: dV += (P mult)^T dO; 1: dK += dS^T Q_s; A from the
    // fragments, B dO^T's or Q_s^T's heads and rests
    uint32_t fh[WT / 8][4], fl[WT / 8][4];
    split_frags(s, fh, fl);
    tile_products(acc, fh, fl, r, pos, m, m, wg);
  }

  const int valid = min(64, S - k0);
  store_chunks(acc, (wg == 0 ? dv : dk) + ((long long)bh * S + k0) * D, D, 64 * ch0, m, valid,
               1.f);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

long long dq_scratch_floats(const FasnAttn& a) {
  return plane_t_floats((long long)a.B * a.H, a.S, a.D);
}

long long dkv_scratch_floats(const FasnAttn& a) {
  return 2 * plane_t_floats((long long)a.B * a.H, a.L, a.D);
}

bool takes(const FasnAttn& a) { return a.dtype == 0 && a.D >= 256 && a.D % 64 == 0; }

}  // namespace
}  // namespace fasn

extern "C" size_t fasn_flash_bwd_tf32x3_wide_scratch(const FasnAttn* a, int dkv) {
  using namespace fasn;
  if (!takes(*a)) return 0;
  return sizeof(float) * static_cast<size_t>(dkv ? dkv_scratch_floats(*a) : dq_scratch_floats(*a));
}

extern "C" int fasn_flash_bwd_dq_tf32x3_wide(const FasnAttn* a, const void* dout,
                                             const float* lse, const float* delta, float scale,
                                             void* dq, float* dbias, float* dslope_rows,
                                             void* scratch, cudaStream_t stream) {
  using namespace fasn;
  if (!takes(*a) || scratch == nullptr) return cudaErrorInvalidValue;
  const FasnAttn& A = *a;
  const long long BH = (long long)A.B * A.H;
  const int D = A.D;
  // scratch: K^T's heads and rests
  float* const kts = static_cast<float*>(scratch);
  SplitJobs js{};
  js.jobs = 1;
  js.BH = static_cast<int>(BH);
  js.D = D;
  if ((long long)js.BH != BH) return cudaErrorInvalidValue;
  js.j[0] = {static_cast<const float*>(A.k), kts, A.S, 1.f};
  cudaError_t err = launch_split(flash_bwd_dq_tf32x3_split_kernel, js, A.S, stream);
  if (err != cudaSuccess) return err;

  auto kernel = flash_bwd_dq_tf32x3_wide_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqW::SMEM);
  if (err != cudaSuccess) return err;
  // q and dout in 64-row boxes, k and v in WT-row ones, 32 columns each
  CUtensorMap qm, dom, km, vm, ktm;
  if (!encode_rows(&qm, A.q, BH, A.L, D, 64, true) ||
      !encode_rows(&dom, dout, BH, A.L, D, 64, true) ||
      !encode_rows(&km, A.k, BH, A.S, D, WT, true) ||
      !encode_rows(&vm, A.v, BH, A.S, D, WT, true) || !encode_split_t(&ktm, kts, BH, A.S, D))
    return cudaErrorInvalidValue;
  const int n_c = D / 64;
  const long long ctas = BH * ((A.L + 63) / 64) * ((n_c + 7) / 8);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), W_THREADS, DqW::SMEM, stream>>>(
      qm, dom, km, vm, ktm, A, lse, delta, scale, static_cast<float*>(dq), dbias, dslope_rows);
  return cudaGetLastError();
}

extern "C" int fasn_flash_bwd_dkv_tf32x3_wide(const FasnAttn* a, const void* dout,
                                              const float* lse, const float* delta, void* dk,
                                              void* dv, void* scratch, cudaStream_t stream) {
  using namespace fasn;
  if (!takes(*a) || scratch == nullptr) return cudaErrorInvalidValue;
  const FasnAttn& A = *a;
  const long long BH = (long long)A.B * A.H;
  const int D = A.D;
  // scratch: Q_s^T's and dO^T's heads and rests
  float* const qts = static_cast<float*>(scratch);
  float* const dots = qts + plane_t_floats(BH, A.L, D);
  SplitJobs js{};
  js.jobs = 2;
  js.BH = static_cast<int>(BH);
  js.D = D;
  if ((long long)js.BH != BH) return cudaErrorInvalidValue;
  js.j[0] = {static_cast<const float*>(A.q), qts, A.L, A.scale_q};
  js.j[1] = {static_cast<const float*>(dout), dots, A.L, 1.f};
  cudaError_t err = launch_split(flash_bwd_dkv_tf32x3_split_kernel, js, A.L, stream);
  if (err != cudaSuccess) return err;

  auto kernel = flash_bwd_dkv_tf32x3_wide_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DkvW::SMEM);
  if (err != cudaSuccess) return err;
  // k and v in 64-row boxes, q and dout in WT-row ones, 32 columns each
  CUtensorMap km, vm, qm, dom, dotm, qtm;
  if (!encode_rows(&km, A.k, BH, A.S, D, 64, true) ||
      !encode_rows(&vm, A.v, BH, A.S, D, 64, true) ||
      !encode_rows(&qm, A.q, BH, A.L, D, WT, true) ||
      !encode_rows(&dom, dout, BH, A.L, D, WT, true) ||
      !encode_split_t(&dotm, dots, BH, A.L, D) || !encode_split_t(&qtm, qts, BH, A.L, D))
    return cudaErrorInvalidValue;
  const int n_c = D / 64;
  const long long ctas = BH * ((A.S + 63) / 64) * ((n_c + 3) / 4);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), W_THREADS, DkvW::SMEM, stream>>>(
      km, vm, qm, dom, dotm, qtm, A, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv));
  return cudaGetLastError();
}
