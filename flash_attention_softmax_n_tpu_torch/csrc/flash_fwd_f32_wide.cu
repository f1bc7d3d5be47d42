// K1 in f32 at head dims 256 and above, for Hopper (sm_90a): the split-TF32
// ("3xTF32") TMA + wgmma kernel flash_fwd_tf32x3_wide_kernel, after its
// pre-pass flash_fwd_tf32x3_split_kernel. It replaces, for f32 inputs at D
// 256 and at every multiple of 128 above it (the D the wrappers pad to),
// the Pallas forward kernels _fwd_single_kernel, _fwd_kernel and
// _fwd_pipeline_kernel (flash_attention_softmax_n_tpu/kernels/
// flash_attention.py:345, :279, :501), and computes what flash_fwd.cu's
// kernels compute (its header): the scale folded into q in f32, the f32
// bias and then the ALiBi term added before causal or rectangular causal
// masking (flash_common.h), the +n as a phantom key (m = 0, l = n), l
// summing the undropped p, p then times the dropout multiplier of its
// global (b, h, q, k), o and lse out, and at n == 0 a row with no visible
// key o = 0, lse = NEG_INF. fasn_flash_fwd calls fasn_flash_fwd_tf32x3_wide
// for f32 at D >= 256; the kernel has a translation unit of its own so that
// the instructions of the other files' kernels stay the ones measured
// before.
//
// The split is tf32x3.h's: three TF32 passes a product on each operand's
// rounded head and rest, rest x head and head x rest first.
//
// What bounds it on the H100: 3 x 4 D TF32 operations per visible (query,
// key) pair at 495 TFLOP/s; at B2 H8 L=S=1024 causal 0.052 / 0.078 / 0.104
// ms at D 256 / 384 / 512 (f32 FMAs at 67 TFLOP/s: 0.128 / 0.193 / 0.257).
//
// The layout. Q of 64 rows with its rest is 128 KB at D 256, so Q and K
// stream through a TMA ring in 32-column chunks of D, as in K5's and K6's
// wide kernels (flash_bwd_f32_wide.cu). O += P V contracts over keys and
// TF32 wgmma has no transpose bit, so V must arrive K-major over keys: the
// pre-pass (tf32x3.h split_pass, at scale 1) writes V^T's TF32 heads and
// rests once a call to device scratch that the operator allocates, (2 BH,
// D, S rounded up to 32), key j of each 8 at position k8_slot(j), the order
// in which P's accumulator fragments pass as A operands.
//
// The kernel. A CTA is two consumer warpgroups (232 registers each,
// setmaxnreg) and a producer warpgroup (40; one lane issues every TMA load)
// around a ring of three 64 KB slots; it owns 64 query rows of one (b, h)
// and walks tiles of KT = 64 keys. Per tile:
//   - the scores: D / 64 units, each a slot holding one 32-column chunk of
//     Q and K for each warpgroup (warpgroup 0 the first half of D, 1 the
//     second), each with room for its rest. Each warpgroup splits its own
//     chunk in shared memory (Q times scale_q) while its previous chunk's
//     products run, and takes each chunk's three passes (12 m64nKTk8
//     products) into a fresh accumulator that f32 adds to its partial S;
//   - the exchange: each warpgroup writes its partial S to shared memory
//     and reads the other's (one named barrier), and both add the two (f32
//     addition commutes, so both hold the same S bit for bit, and so the
//     same m, l and p);
//   - the online softmax of flash_fwd_f32.cu on the fragment (masks, bias
//     and ALiBi only on tiles that cross S or the diagonal), o rescaled;
//   - O += P V: P's heads and rests from the fragment as A operands
//     (split_frags), V^T's from the ring, one unit a 64 columns of o, each
//     unit and tile into a fresh accumulator that f32 adds to o
//     (add_tile_product; one accumulator over a sweep drifted 10x past the
//     split's error, flash_bwd_f32.cu).
// Each warpgroup owns half of o's columns, up to 4 x 64 (an m64n256
// accumulator, 128 floats a thread). Above D 512 a CTA takes one of ceil(D
// / 512) column groups, the 64-column chunks dealt out evenly, and forms S
// again; the CTA of group 0 writes lse. The grid is flat: a head's CTAs
// side by side, the heaviest (last, under the causal mask) query tile
// first, a tile's column groups together, so that L2 serves the chunks
// they all stream. o sums in registers over the sweep: no atomics, no
// split over the keys, repeat calls bit-equal. The exchange buffers are
// single: a warpgroup writes the next tile's only after D / 64 + 2 >= 6
// ring units, more than the ring holds, so the other warpgroup has read
// them and freed a slot since. Shared memory 230,448 bytes; ptxas (sm_90a)
// reports the launch's 168 registers (setmaxnreg) and spills nothing at D
// 256 and 384, 132 bytes at 512 and above (o is 128 floats a thread there,
// P's heads and rests 64).
//
// The tile. On an NVIDIA H100 80GB HBM3 at 700 W (B2 H8 L=S=1024 causal, n
// 1; K1 with its pre-pass, device ms, utils/flash_lines.py, both layouts
// built in one call, each timed twice) 64-key tiles in three 64 KB slots
// ran 0.232 / 0.317 / 0.420-0.424 at D 256 / 384 / 512, where 32-key tiles
// in four 48 KB slots (214,080 bytes, no spills) ran 0.295 / 0.421-0.430 /
// 0.542-0.548: each tile streams Q's chunks again, and 64 keys halve that.
// Inputs must start on 16 bytes (TMA, the pre-pass's vector loads); the
// operator raises otherwise.

#include <climits>
#include <cstddef>

#include "tf32x3.h"
#include "flash_common.h"

namespace fasn {
namespace {

using namespace attn;

constexpr int F_THREADS = 384;  // two consumer warpgroups and a producer warpgroup
// keys of a tile
constexpr int KT = 64;

// The ring of STAGES slots, the two exchange buffers after it, the
// barriers (full, empty per slot). A score unit holds, at w * HALF,
// warpgroup w's chunk of Q (A) and of K (B) as TMA lands them, each with
// room for its rest; a product unit, at w * T_HALF, warpgroup w's chunk of
// V^T, heads then rests.
struct FwdWide {
  using RowT = F32Tile<32, 64>;  // 64 query rows x 32 columns of D
  using StrT = F32Tile<32, KT>;  // KT keys x 32 columns of D
  using TrT = F32Tile<KT, 64>;   // 64 columns of o x KT keys (V^T)
  static constexpr int A_HI = 0, A_LO = RowT::TILE, B_HI = 2 * RowT::TILE;
  static constexpr int B_LO = B_HI + StrT::TILE;
  static constexpr int HALF = 2 * RowT::TILE + 2 * StrT::TILE;
  static constexpr int SLOT = 2 * HALF;  // 48 KB at KT 32, 64 KB at 64
  static constexpr int T_HALF = 2 * TrT::TILE;
  static constexpr int STAGES = KT == 32 ? 4 : 3;
  static constexpr int X_BYTES = 64 * KT * 4;  // one 64 x KT f32 exchange buffer
  static constexpr int X_AT = STAGES * SLOT;
  static constexpr int BAR_AT = X_AT + 2 * X_BYTES;
  static constexpr int SMEM = BAR_AT + 8 * 2 * STAGES + 1024;
  static_assert(2 * T_HALF <= SLOT, "a product unit fits a slot");
  static_assert(SMEM <= 232448, "K1's wide split-TF32 ring passes the H100's 227 KB");
};
using Y = FwdWide;

struct FRing {
  uint8_t* mem;  // the generic address of `base`
  uint32_t base, bars;
  __device__ uint32_t slot(int s) const { return base + s * Y::SLOT; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (Y::STAGES + s); }
};

struct FPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == Y::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ FRing make_fring(uint8_t* smem_raw) {
  FRing r;
  const uint32_t raw = smem_u32(smem_raw), pad = (1024 - (raw & 1023)) & 1023;
  r.mem = smem_raw + pad;
  r.base = raw + pad;
  r.bars = r.base + Y::BAR_AT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Y::STAGES; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), 8);  // each consumer warp, once done with the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer (one lane). For each of `tiles` tiles of KT keys: D / 64
// score units, unit u warpgroup w's chunk of Q (rows q0) and of K at
// columns w D / 2 + 32 u; then `units` product units, unit j warpgroup w's
// V^T heads (map head bh) and rests (bh + heads) at o's columns tcol[w] +
// 64 j where j < tn[w].
__device__ __forceinline__ void produce(const FRing& r, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vtmap, int q0,
                                        int tiles, int D, int units, const int (&tcol)[2],
                                        const int (&tn)[2], int bh, int heads) {
  FPos pos;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * KT;
    for (int c = 0; c < D / 2; c += 32) {
      mbar_wait<false>(r.empty(pos.stage), pos.phase ^ 1);
      const uint32_t slot = r.slot(pos.stage), bar = r.full(pos.stage);
      mbar_expect_tx(bar, 2 * (Y::RowT::TILE + Y::StrT::TILE));
      for (int w = 0; w < 2; ++w) {
        const uint32_t h = slot + w * Y::HALF;
        tma_3d(h + Y::A_HI, qmap, bar, w * D / 2 + c, q0, bh);
        tma_3d(h + Y::B_HI, kmap, bar, w * D / 2 + c, k0, bh);
      }
      pos.next();
    }
    for (int j = 0; j < units; ++j) {
      mbar_wait<false>(r.empty(pos.stage), pos.phase ^ 1);
      const uint32_t slot = r.slot(pos.stage), bar = r.full(pos.stage);
      mbar_expect_tx(bar, (j < tn[0] ? Y::T_HALF : 0) + (j < tn[1] ? Y::T_HALF : 0));
      for (int w = 0; w < 2; ++w) {
        if (j >= tn[w]) continue;
        const uint32_t h = slot + w * Y::T_HALF;
        for (int x = 0; x < Y::TrT::BOXES; ++x) {
          tma_3d(h + x * Y::TrT::BOX, vtmap, bar, k0 + 32 * x, tcol[w] + 64 * j, bh);
          tma_3d(h + Y::TrT::TILE + x * Y::TrT::BOX, vtmap, bar, k0 + 32 * x, tcol[w] + 64 * j,
                 heads + bh);
        }
      }
      pos.next();
    }
  }
}

// waits for the score unit at `pos` and splits warpgroup w's chunks there
// (Q times scale_q; heads in place, rests beside them; tf32x3.h
// split_tile), published to wgmma behind the warpgroup's own barrier;
// returns the address of its half of the slot
__device__ __forceinline__ uint32_t unit_split(const FRing& r, const FPos& pos, int w,
                                               float scale_q) {
  const int t = threadIdx.x % 128;
  mbar_wait<false>(r.full(pos.stage), pos.phase);
  const uint32_t h = r.slot(pos.stage) + w * Y::HALF;
  uint8_t* const hm = r.mem + (h - r.base);
  split_tile<32, 64, false, true>(hm + Y::A_HI, hm + Y::A_LO, nullptr, nullptr, scale_q, t);
  split_tile<32, KT, false, false>(hm + Y::B_HI, hm + Y::B_LO, nullptr, nullptr, 1.f, t);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  return h;
}

// issues part = Q_s K^T over a unit's 32 columns (its half at h), three
// passes into a fresh accumulator, as one wgmma group
__device__ __forceinline__ void unit_products(float (&part)[KT / 2], uint32_t h) {
#pragma unroll
  for (int e = 0; e < KT / 2; ++e) part[e] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    wgmma_tf32(part, Y::RowT::desc(h + Y::A_LO, st), Y::StrT::desc(h + Y::B_HI, st));
    wgmma_tf32(part, Y::RowT::desc(h + Y::A_HI, st), Y::StrT::desc(h + Y::B_LO, st));
  }
#pragma unroll
  for (int st = 0; st < 4; ++st)
    wgmma_tf32(part, Y::RowT::desc(h + Y::A_HI, st), Y::StrT::desc(h + Y::B_HI, st));
  wgmma_commit();
}

// once a unit's group is done (fence_regs by the caller): its slot is free
// (the rests are in it, and copies), its part added in f32 to s
__device__ __forceinline__ void unit_done(float (&s)[KT / 2], const float (&part)[KT / 2],
                                          const FRing& r, int stage) {
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(stage));
#pragma unroll
  for (int e = 0; e < KT / 2; ++e) s[e] += part[e];
}

// s = Q_s K^T over warpgroup w's half of D, a unit (32 columns) at a time
// in fresh accumulators that f32 adds to s in order; each unit's split
// runs while the previous unit's products do
__device__ __forceinline__ void half_scores(float (&s)[KT / 2], const FRing& r, FPos& pos, int D,
                                            int w, float scale_q) {
#pragma unroll
  for (int e = 0; e < KT / 2; ++e) s[e] = 0.f;
  float part[KT / 2];
  int done = pos.stage;  // the slot of the unit whose products are in flight
  unit_products(part, unit_split(r, pos, w, scale_q));
  pos.next();
  for (int c = 32; c < D / 2; c += 32) {
    const int stage = pos.stage;
    const uint32_t h = unit_split(r, pos, w, scale_q);
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

// s's fragment (m64nKT) to this thread's float4s of a 64 x KT buffer, and
// back
__device__ __forceinline__ void put_frag(const float (&s)[KT / 2], float4* x) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int c = 0; c < KT / 8; ++c)
    x[c * 128 + t] = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2], s[4 * c + 3]);
}
__device__ __forceinline__ void get_frag(float (&s)[KT / 2], const float4* x) {
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int c = 0; c < KT / 8; ++c) {
    const float4 o = x[c * 128 + t];
    s[4 * c] = o.x;
    s[4 * c + 1] = o.y;
    s[4 * c + 2] = o.z;
    s[4 * c + 3] = o.w;
  }
}

// acc[j] += P V_j for the `units` product units of a tile, j < mine: P the
// fragments' heads fh and rests fl, V_j warpgroup w's V^T chunk in unit j
template <int UNITS>
__device__ __forceinline__ void tile_products(float (&acc)[UNITS][32],
                                              const uint32_t (&fh)[KT / 8][4],
                                              const uint32_t (&fl)[KT / 8][4], const FRing& r,
                                              FPos& pos, int units, int mine, int w) {
#pragma unroll
  for (int j = 0; j < UNITS; ++j) {
    if (j < units) {
      mbar_wait<false>(r.full(pos.stage), pos.phase);
      const uint32_t b = r.slot(pos.stage) + w * Y::T_HALF;
      if (j < mine) add_tile_product<64, KT>(acc[j], fh, fl, b, b + Y::TrT::TILE);
      if (threadIdx.x % 32 == 0) mbar_arrive(r.empty(pos.stage));
      pos.next();
    }
  }
}

// an m64n64 fragment's rows g and g + 8 to 64 columns of `rows` (the
// first of 64, ld apart), where the row is below `valid`
__device__ __forceinline__ void store_unit(const float (&o)[32], float* rows, long long ld,
                                           int valid) {
  const int t = threadIdx.x % 128, r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= valid) continue;
    float* row = rows + r * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + c0) =
          make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
  }
}

// the first of the 64-column chunks of column group `grp` of `groups`, of n
__host__ __device__ __forceinline__ int group_chunk(int n, int grp, int groups) {
  return n * grp / groups;
}

// UNITS: the most 64-column units of o a warpgroup owns (2 at D 256, 3 at
// 384, 4 above), the size of its accumulator
template <int UNITS>
__global__ void __launch_bounds__(F_THREADS, 1)
    flash_fwd_tf32x3_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vtmap, const FasnAttn a,
                                 float n, float* __restrict__ o, float* __restrict__ lse) {
  extern __shared__ uint8_t smem_raw[];
  const FRing r = make_fring(smem_raw);
  // a flat grid: a query tile's column groups side by side, then the head's
  // query tiles (the heaviest, last, first)
  const int D = a.D, n_c = D / 64, groups = (n_c + 7) / 8;
  const int n_q = (a.L + 63) / 64;
  const int grp = blockIdx.x % groups;
  const int bh = blockIdx.x / groups / n_q, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x / groups % n_q) * 64;
  const int L = a.L, S = a.S, off = S - L;
  // o's chunks: warpgroup 0 the first m0 of the group's, warpgroup 1 the rest
  const int ch0 = group_chunk(n_c, grp, groups), m = group_chunk(n_c, grp + 1, groups) - ch0;
  const int m0 = (m + 1) / 2;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + 64, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + KT - 1) / KT : 0;
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      const int tcol[2] = {64 * ch0, 64 * (ch0 + m0)}, tn[2] = {m0, m - m0};
      produce(r, &qmap, &kmap, &vtmap, q0, tiles, D, m0, tcol, tn, bh, a.B * a.H);
    }
    return;
  }
  setmaxnreg_inc<232>();
  const int t = threadIdx.x % 128;
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;
  const int mine_units = wg == 0 ? m0 : m - m0;
  float4* const x_mine = reinterpret_cast<float4*>(r.mem + Y::X_AT + wg * Y::X_BYTES);
  const float4* const x_other =
      reinterpret_cast<const float4*>(r.mem + Y::X_AT + (1 - wg) * Y::X_BYTES);

  float m_row[2], l[2], acc[UNITS][32];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_row[i] = n > 0.f ? 0.f : NEG_INF;
    l[i] = t % 4 == 0 ? n : 0.f;  // the quad's partial sums; n counted once
  }
#pragma unroll
  for (int j = 0; j < UNITS; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  FPos pos;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * KT;
    // the warpgroup's partial S over its half of D, traded for the other's
    float s[KT / 2], other[KT / 2];
    half_scores(s, r, pos, D, wg, a.scale_q);
    put_frag(s, x_mine);
    asm volatile("bar.sync 3, 256;" ::: "memory");
    get_frag(other, x_other);
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) s[e] += other[e];

    // masks, bias and ALiBi only where a key is past S or a diagonal
    if (!plain || k0 + KT > S || (mods.causal && k0 + KT - 1 > q0 + off)) {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        s[e] = mods(s[e], q0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + g + 8 * i;
      const float m_new = fmaxf(m_row[i], row_max(s, i));
      const float alpha = exp_fast(m_row[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p = exp_fast(s[4 * j + 2 * i + c] - m_new);
          sum += p;  // the denominator takes the undropped p
          if (drop.on) p *= drop(b, h, qi, k0 + 8 * j + c0 + c);
          s[4 * j + 2 * i + c] = p;
        }
      l[i] = l[i] * alpha + sum;
      m_row[i] = m_new;
#pragma unroll
      for (int u = 0; u < UNITS; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[u][4 * j + 2 * i] *= alpha;
          acc[u][4 * j + 2 * i + 1] *= alpha;
        }
    }

    // O += P V at the warpgroup's chunks: P from the fragment (A), V^T's
    // heads and rests (B)
    uint32_t fh[KT / 8][4], fl[KT / 8][4];
    split_frags(s, fh, fl);
    tile_products<UNITS>(acc, fh, fl, r, pos, m0, mine_units, wg);
  }

  const int valid = min(64, L - q0);
  float lf[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lf[i] = quad_sum(l[i]);
    dead[i] = n == 0.f && (lf[i] == 0.f || m_row[i] == NEG_INF);
  }
  float* const rows = o + ((long long)bh * L + q0) * D + 64 * (ch0 + (wg == 0 ? 0 : m0));
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    if (u >= mine_units) continue;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e / 2) % 2;
      acc[u][e] = dead[i] ? 0.f : acc[u][e] / lf[i];
    }
    store_unit(acc[u], rows + 64 * u, D, valid);
  }
  if (wg == 0 && grp == 0 && t % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (g + 8 * i < valid)
        lse[(long long)bh * L + q0 + g + 8 * i] = dead[i] ? NEG_INF : m_row[i] + logf(lf[i]);
  }
}

// one kernel for the forward's pre-pass, so that the profiler's names give
// K1's device time with it
__global__ void __launch_bounds__(256)
    flash_fwd_tf32x3_split_kernel(const __grid_constant__ SplitJobs js) {
  split_pass(js);
}

template <int UNITS>
cudaError_t launch_wide(const FasnAttn& A, float n, void* o, float* lse, float* vts,
                        cudaStream_t stream) {
  const long long BH = (long long)A.B * A.H;
  const int D = A.D;
  auto kernel = flash_fwd_tf32x3_wide_kernel<UNITS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Y::SMEM);
  if (err != cudaSuccess) return err;
  // q in 64-row boxes, k in KT-row ones, 32 columns each; V^T's planes
  CUtensorMap qm, km, vtm;
  if (!encode_rows(&qm, A.q, BH, A.L, D, 64, true) ||
      !encode_rows(&km, A.k, BH, A.S, D, KT, true) || !encode_split_t(&vtm, vts, BH, A.S, D))
    return cudaErrorInvalidValue;
  const long long ctas = BH * ((A.L + 63) / 64) * ((D / 64 + 7) / 8);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), F_THREADS, Y::SMEM, stream>>>(
      qm, km, vtm, A, n, static_cast<float*>(o), lse);
  return cudaGetLastError();
}

bool takes(const FasnAttn& a) { return a.dtype == 0 && a.D >= 256 && a.D % 128 == 0; }

}  // namespace
}  // namespace fasn

extern "C" size_t fasn_flash_fwd_tf32x3_wide_scratch(const FasnAttn* a) {
  using namespace fasn;
  if (!takes(*a)) return 0;
  return sizeof(float) *
         static_cast<size_t>(plane_t_floats((long long)a->B * a->H, a->S, a->D));
}

extern "C" int fasn_flash_fwd_tf32x3_wide(const FasnAttn* a, float n, void* o, float* lse,
                                          void* scratch, cudaStream_t stream) {
  using namespace fasn;
  if (!takes(*a) || scratch == nullptr) return cudaErrorInvalidValue;
  const FasnAttn& A = *a;
  const long long BH = (long long)A.B * A.H;
  // scratch: V^T's heads and rests
  float* const vts = static_cast<float*>(scratch);
  SplitJobs js{};
  js.jobs = 1;
  js.BH = static_cast<int>(BH);
  js.D = A.D;
  if ((long long)js.BH != BH) return cudaErrorInvalidValue;
  js.j[0] = {static_cast<const float*>(A.v), vts, A.S, 1.f};
  const cudaError_t err = launch_split(flash_fwd_tf32x3_split_kernel, js, A.S, stream);
  if (err != cudaSuccess) return err;
  switch (A.D) {
    case 256:
      return launch_wide<2>(A, n, o, lse, vts, stream);
    case 384:
      return launch_wide<3>(A, n, o, lse, vts, stream);
    default:
      return launch_wide<4>(A, n, o, lse, vts, stream);
  }
}
