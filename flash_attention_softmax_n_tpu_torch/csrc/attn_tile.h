// The Hopper attention tile that K1 (flash_fwd.cu) and K10
// (prefill_phases.cu) share for bf16 inputs: one CTA takes TQ = 128 query
// rows of one (b, h) and walks its keys in tiles of TK = 128. The backward
// kernels K5 (flash_bwd_dq.cu) and K6 (flash_bwd_dkv.cu) take the same
// ring with two resident tiles (Q and dO, or K and V) and walk the other
// pair; they cut each ring tile into chunks of 64 (or 32) rows, so that
// two score fragments and their accumulators fit the registers.
//
// - Threads: two consumer warpgroups, each owning 64 of the query rows,
//   and one producer warp whose first lane issues every TMA load (288
//   threads; ptxas gives each at most 168 registers, and K1 at D 128
//   spills 12 bytes). The two warpgroups run independently, so one's
//   softmax overlaps the other's products. (Issuing tile j's QK^T before
//   tile j - 1's PV inside one warpgroup, with setmaxnreg for the
//   registers, ran slower: it spilled, and ptxas serialised the wgmma.)
// - Loads: Q once, then K and V tiles into a ring of STAGES slots with
//   mbarriers full_k, full_v and empty per slot. Every tile is loaded by a
//   3-D tensor map over (D, rows, B*H): rows past L or S of a head arrive
//   as zeros, never as the next head's rows. A tile row is 64 bytes (D 32,
//   64-byte swizzle) or 128 bytes (D 64, 128-byte swizzle); D 128 is two
//   boxes of 64 columns, each 128-byte swizzled.
// - S = Q K^T: wgmma m64n128k16 with Q (A) and K (B) both K-major in shared
//   memory; the accumulator's fragment is 64 floats a thread.
// - O += P V: P goes from the S fragment straight into A-operand registers
//   (the fragment of m64nN maps onto the A fragments of its k16 slices);
//   V's tile (keys x D, D contiguous) is MN-major, read with the transpose
//   bit and a descriptor of its own.
// Fragment layout (m64nN, f32): thread t of a warpgroup holds, in s[4j +
// 2i + c], row 16 (t / 32) + (t % 32) / 4 + 8i and column 8j + 2 (t % 4)
// + c. A row's values are spread over the 4 lanes of a quad, so row
// reductions are two shuffles.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>

#include "flash_common.h"
#include "hopper.h"

namespace fasn {
namespace attn {

using namespace hopper;

constexpr int TQ = 128;  // query rows of a CTA
constexpr int TK = 128;  // keys of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BOX_COLS = D < 64 ? D : 64;
  static constexpr int BOXES = D / BOX_COLS;
  static constexpr int ROW = BOX_COLS * 2;       // bytes of one box row: 64 or 128
  static constexpr int LAYOUT = ROW == 128 ? 1 : 2;  // descriptor layout: 128- or 64-byte swizzle
  static constexpr int GROUP = 8 * ROW;          // bytes of 8 rows: one swizzle repeat
  static constexpr int BOX = TQ * ROW;           // one 128-row box (TQ == TK)
  static constexpr int TILE = BOXES * BOX;       // a whole 128-row tile of q, k or v
  static_assert(TQ == TK, "one box shape serves q, k and v");
};

// RES resident tiles at the base (K1, K10: Q; K5: Q, dO; K6: K, V), then
// slot s's two ring tiles (K and V; K6: Q and dO); the barriers after them.
template <int D, int RES = 1>
struct Ring {
  using T = Tile<D>;
  static constexpr int BAR_AT = T::TILE * (RES + 2 * STAGES);
  // q_full, full_k[STAGES], full_v[STAGES], empty[STAGES]; + room to align
  static constexpr int SMEM = BAR_AT + 8 * (1 + 3 * STAGES) + 1024;
  uint8_t* mem;  // the generic address of `base`
  uint32_t base, bars;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t res(int i) const { return base + T::TILE * i; }
  __device__ uint32_t k(int s) const { return base + T::TILE * (RES + 2 * s); }
  __device__ uint32_t v(int s) const { return k(s) + T::TILE; }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t full_k(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const { return bars + 8 * (1 + STAGES + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + 2 * STAGES + s); }
};

// The ring in dynamic shared memory, aligned to 1 KB; barriers initialised
// by thread 0, then the whole CTA synchronises once.
template <int D, int RES = 1>
__device__ __forceinline__ Ring<D, RES> make_ring(uint8_t* smem_raw) {
  Ring<D, RES> r;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  r.mem = smem_raw + pad;
  r.base = raw + pad;
  r.bars = r.base + Ring<D, RES>::BAR_AT;
  if (threadIdx.x == 0) {
    mbar_init(r.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full_k(s), 1);
      mbar_init(r.full_v(s), 1);
      mbar_init(r.empty(s), CONSUMERS / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// one 128-row tile (all its boxes) of head bh from row `row0`
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int bh) {
#pragma unroll
  for (int b = 0; b < Tile<D>::BOXES; ++b)
    tma_3d(dst + b * Tile<D>::BOX, map, bar, b * Tile<D>::BOX_COLS, row0, bh);
}

// The producer (one lane): the RES resident tiles from row `res_row` on
// q_full, then `tiles` ring tiles in order from tile `first`; the first
// `k_only` of them bring K alone (full_v is then arrived on without bytes,
// so its phases stay those of the slot), the rest K and V from row (first
// + i - k_only) * TK.
template <int D, int RES>
__device__ __forceinline__ void produce(const Ring<D, RES>& r,
                                        const CUtensorMap* const (&res_maps)[RES], int res_row,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap, int bh,
                                        int first, int tiles, int k_only) {
  using T = Tile<D>;
  if (tiles == 0) return;
  mbar_expect_tx(r.q_full(), RES * T::TILE);
#pragma unroll
  for (int i = 0; i < RES; ++i) load_tile<D>(r.res(i), res_maps[i], r.q_full(), res_row, bh);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < tiles; ++i) {
    mbar_wait(r.empty(stage), phase ^ 1);
    const int row = (first + (i < k_only ? i : i - k_only)) * TK;
    mbar_expect_tx(r.full_k(stage), T::TILE);
    load_tile<D>(r.k(stage), kmap, r.full_k(stage), row, bh);
    if (i < k_only) {
      mbar_arrive(r.full_v(stage));
    } else {
      mbar_expect_tx(r.full_v(stage), T::TILE);
      load_tile<D>(r.v(stage), vmap, r.full_v(stage), row, bh);
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// issues s = A B^T over the D / 16 k16 steps as one wgmma group, without
// waiting: A the 64 rows at `a`, B the 2 M rows at `b` (M = 64, 32 or 16
// floats: 128, 64 or 32 rows), both K-major tiles of the ring's layout
template <int D, int M>
__device__ __forceinline__ void qk_async(float (&s)[M], uint32_t a, uint32_t b) {
  using T = Tile<D>;
  constexpr int PER_BOX = T::BOX_COLS / 16;
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    const uint32_t off = (st / PER_BOX) * T::BOX + (st % PER_BOX) * 32;
    wgmma_ss(s, desc_of(a + off, 16, T::GROUP, T::LAYOUT), desc_of(b + off, 16, T::GROUP, T::LAYOUT),
             st > 0);
  }
  wgmma_commit();
}

// s = Q_wg K^T: Q's rows 64 wg .. 64 wg + 63 (A) and the slot's 128 keys (B)
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k, int wg) {
  qk_async<D>(s, q + wg * 64 * Tile<D>::ROW, k);
  wgmma_wait<0>();
  fence_regs(s);
}

// issues o += P V over STEPS k16 steps as one wgmma group, without waiting:
// p[kk] the A fragment of rows 16 kk .. 16 kk + 15 of V (rows x D, D
// contiguous, from `v`), read MN-major: 8-row groups GROUP bytes apart, D's
// 64-column boxes BOX bytes apart
template <int D, int STEPS>
__device__ __forceinline__ void pv_async(float (&o)[D / 2], const uint32_t (&p)[STEPS][4],
                                         uint32_t v) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma<1>(o, p[kk], desc_of(v + kk * 16 * T::ROW, T::BOX, T::GROUP, T::LAYOUT));
  wgmma_commit();
}

// o += P V over the tile's 8 k16 steps
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[TK / 16][4],
                                   uint32_t v) {
  pv_async<D>(o, p, v);
  wgmma_wait<0>();
  fence_regs(o);
}

// exp(x) as K1's softmax takes it: one multiply and the exp2 unit (a few
// f32 ulps from expf)
__device__ __forceinline__ float exp_fast(float x) { return exp2f(x * LOG2E); }

__device__ __forceinline__ uint32_t bf16_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an m64nN fragment (M = N / 2 floats), rounded to bf16, as the A
// fragments of its N / 16 k16 slices: slice kk holds columns 16 kk + [0, 8)
// (j = 2 kk) and 16 kk + [8, 16) (j = 2 kk + 1), rows g (i = 0) and g + 8
// (i = 1)
template <int M>
__device__ __forceinline__ void to_a_frags(const float (&s)[M], uint32_t (&p)[M / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < M / 8; ++kk) {
    const int j0 = 8 * kk, j1 = 8 * kk + 4;
    p[kk][0] = bf16_bits(s[j0], s[j0 + 1]);
    p[kk][1] = bf16_bits(s[j0 + 2], s[j0 + 3]);
    p[kk][2] = bf16_bits(s[j1], s[j1 + 1]);
    p[kk][3] = bf16_bits(s[j1 + 2], s[j1 + 3]);
  }
}

// x * scale_q rounded to bf16, in place over rows 64 wg .. 64 wg + 63 of
// the 128-row tile at `tile` (generic address): each thread of the
// warpgroup rewrites 16-byte chunks; the caller then fences the async proxy
// and synchronises before wgmma reads the rows
template <int D>
__device__ __forceinline__ void scale_q_rows(uint8_t* tile, int wg, float scale_q) {
  using T = Tile<D>;
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int b = 0; b < T::BOXES; ++b) {
    uint4* rows = reinterpret_cast<uint4*>(tile + b * T::BOX + wg * 64 * T::ROW);
    for (int c = t; c < 64 * T::ROW / 16; c += 128) {
      uint4 w = rows[c];
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[e]));
        u[e] = bf16_bits(f.x * scale_q, f.y * scale_q);
      }
      rows[c] = w;
    }
  }
}

// reductions over the 4 lanes of a quad (one fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// the 4-thread-quad row max of fragment row i (0: g, 1: g + 8)
__device__ __forceinline__ float row_max(const float (&s)[64], int i) {
  float m = NEG_INF;
#pragma unroll
  for (int j = 0; j < 16; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
  return quad_max(m);
}

// o (fragment of m64nD) rows in q's bf16 at o_rows (the wg's row 0 of this
// head, D apart), where the row is below `valid`; v(i, x) maps row i's value
template <int D, typename F>
__device__ __forceinline__ void store_rows(const float (&o)[D / 2], __nv_bfloat16* o_rows,
                                           int valid, F v) {
  const int t = threadIdx.x % 128, r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= valid) continue;
    __nv_bfloat16* row = o_rows + (long long)r * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) =
          __floats2bfloat162_rn(v(i, o[4 * j + 2 * i]), v(i, o[4 * j + 2 * i + 1]));
  }
}

// host: the 3-D map of a contiguous bf16 (B*H, rows, D) tensor with a
// (box columns x 128 rows x 1 head) box, swizzled as the tile expects
inline bool encode_rows(CUtensorMap* map, const void* base, long long heads, int rows, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const int box_cols = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols), TQ, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// host: the maps of q (L rows), k and v (S rows) and, for the backward
// kernels, of dout (L rows)
struct AttnMaps {
  CUtensorMap q, k, v, dout;
};
inline bool encode_attn(AttnMaps* m, const FasnAttn& a, int D, const void* dout = nullptr) {
  const long long heads = (long long)a.B * a.H;
  return encode_rows(&m->q, a.q, heads, a.L, D) && encode_rows(&m->k, a.k, heads, a.S, D) &&
         encode_rows(&m->v, a.v, heads, a.S, D) &&
         (dout == nullptr || encode_rows(&m->dout, dout, heads, a.L, D));
}

// grid: x the (b, h) pair, y the query tile, heaviest (last) first
inline dim3 tile_grid(long long heads, int L) {
  return dim3(static_cast<unsigned>(heads), static_cast<unsigned>((L + TQ - 1) / TQ));
}

}  // namespace attn
}  // namespace fasn
