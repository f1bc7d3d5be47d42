// The Hopper attention tile that K1 (flash_fwd.cu) and K10
// (prefill_phases.cu) share for bf16 inputs: one CTA takes TQ = 128 query
// rows of one (b, h) and walks its keys in tiles of TK = 128.
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
  static constexpr int BAR_AT = TILE * (1 + 2 * STAGES);
  // q_full, full_k[STAGES], full_v[STAGES], empty[STAGES]; + room to align
  static constexpr int SMEM = BAR_AT + 8 * (1 + 3 * STAGES) + 1024;
  static_assert(TQ == TK, "one box shape serves q, k and v");
};

// Q at the base, then slot s's K and V tiles; the barriers after them.
template <int D>
struct Ring {
  using T = Tile<D>;
  uint8_t* mem;  // the generic address of `base`
  uint32_t base, bars;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const { return base + T::TILE * (1 + 2 * s); }
  __device__ uint32_t v(int s) const { return k(s) + T::TILE; }
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t full_k(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t full_v(int s) const { return bars + 8 * (1 + STAGES + s); }
  __device__ uint32_t empty(int s) const { return bars + 8 * (1 + 2 * STAGES + s); }
};

// The ring in dynamic shared memory, aligned to 1 KB; barriers initialised
// by thread 0, then the whole CTA synchronises once.
template <int D>
__device__ __forceinline__ Ring<D> make_ring(uint8_t* smem_raw) {
  Ring<D> r;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  r.mem = smem_raw + pad;
  r.base = raw + pad;
  r.bars = r.base + Tile<D>::BAR_AT;
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

// The producer (one lane): Q, then `tiles` key tiles from row 0 in order;
// the first `k_only` of them bring K alone (full_v is then arrived on
// without bytes, so its phases stay those of the slot), the rest K and V
// from row (i - k_only) * TK.
template <int D>
__device__ __forceinline__ void produce(const Ring<D>& r, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap, int bh,
                                        int q0, int tiles, int k_only) {
  using T = Tile<D>;
  if (tiles == 0) return;
  mbar_expect_tx(r.q_full(), T::TILE);
  load_tile<D>(r.q(), qmap, r.q_full(), q0, bh);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < tiles; ++i) {
    mbar_wait(r.empty(stage), phase ^ 1);
    const int row = (i < k_only ? i : i - k_only) * TK;
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

// s = Q_wg K^T over the D / 16 k16 steps: Q's rows 64 wg .. 64 wg + 63 (A)
// and the slot's 128 keys (B), both K-major
template <int D>
__device__ __forceinline__ void qk(float (&s)[64], uint32_t q, uint32_t k, int wg) {
  using T = Tile<D>;
  constexpr int PER_BOX = T::BOX_COLS / 16;
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    const uint32_t off = (st / PER_BOX) * T::BOX + (st % PER_BOX) * 32;
    wgmma_ss(s, desc_of(q + wg * 64 * T::ROW + off, 16, T::GROUP, T::LAYOUT),
             desc_of(k + off, 16, T::GROUP, T::LAYOUT), st > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// o += P V over the tile's 8 k16 steps: p[kk] the A fragment of keys 16 kk
// .. 16 kk + 15, V (keys x D, D contiguous) MN-major: 8-key groups GROUP
// bytes apart, D's 64-column boxes BOX bytes apart
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[TK / 16][4],
                                   uint32_t v) {
  using T = Tile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma<1>(o, p[kk], desc_of(v + kk * 16 * T::ROW, T::BOX, T::GROUP, T::LAYOUT));
  wgmma_commit();
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

// the S fragment, rounded to bf16, as the A fragments of its 8 k16 slices:
// slice kk holds columns 16 kk + [0, 8) (j = 2 kk) and 16 kk + [8, 16) (j =
// 2 kk + 1), rows g (i = 0) and g + 8 (i = 1)
__device__ __forceinline__ void to_a_frags(const float (&s)[64], uint32_t (&p)[TK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    const int j0 = 8 * kk, j1 = 8 * kk + 4;
    p[kk][0] = bf16_bits(s[j0], s[j0 + 1]);
    p[kk][1] = bf16_bits(s[j0 + 2], s[j0 + 3]);
    p[kk][2] = bf16_bits(s[j1], s[j1 + 1]);
    p[kk][3] = bf16_bits(s[j1 + 2], s[j1 + 3]);
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

// grid: x the (b, h) pair, y the query tile, heaviest (last) first
inline dim3 tile_grid(long long heads, int L) {
  return dim3(static_cast<unsigned>(heads), static_cast<unsigned>((L + TQ - 1) / TQ));
}

}  // namespace attn
}  // namespace fasn
