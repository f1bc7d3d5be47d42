// K7's tensor-core dequant matmul as pieces, shared by K7 (qmm.cu), K9
// (fused_mlp.cu) and K2 (qmm_argmax.cu): the TMA ring with its producer
// warp, persistent CTAs over (row tile, K split, column tile), the bf16-x
// consumer that multiplies out^T = W^T x^T with W's int8 columns converted
// to bf16 in registers, the W8A8 consumer, and the fixed-order split-K sum.
// qmm.cu's header comment describes the design; this file holds the code.
//
// The bf16-x consumer hands each finished tile's accumulators to an
// epilogue object (Epi): K7's and K9's down phase take WriteTile, which
// writes the tile (write_pair); K2 takes its running argmax. WIDE (K2, bf16
// x and int8 W only): a stage carries WIDE boxes of 128 columns of W, and
// 2 * WIDE consumer warpgroups take 64 columns each.
//
// DUAL (K9's gate/up phase, bf16 x and int8 W only): a stage carries 64
// columns of each of two weight matrices (Wg and Wu, the same columns),
// each as 64-byte rows with the 64-byte swizzle; consumer warpgroup 0
// multiplies Wg, warpgroup 1 Wu, so each thread of one holds the same
// (row, column) elements as the same thread of the other. With one split
// the epilogue forms h = silu(g * sg) * (u * su) in bf16 (warpgroup 1 hands
// its u over through shared memory); with several, each warpgroup writes
// its f32 partial and a sum kernel forms h in split order.
//
// Device code: only the .cu files, compiled by nvcc, include it.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "hopper.h"

namespace qmm_tile {

using namespace hopper;

constexpr int ROW = 128;          // bytes of K in one x tile row (one 128-byte swizzle row)
constexpr int B_BUFS = 3;         // W8A8: converted W tiles in rotation (see consume_s8)
constexpr int SMEM_MAX = 232448;  // shared memory one block may use on the H100
constexpr int MAX_STAGES = 8;

// out[at], out[at + 1] (pair) or out[at] alone, in bf16 or f32
__device__ __forceinline__ void store_out(void* out, bool bf16, long long at, float v0, float v1,
                                          bool pair) {
  if (bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + at;
    if (pair)
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    else
      *o = __float2bfloat16(v0);
  } else {
    float* o = static_cast<float*>(out) + at;
    if (pair)
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    else
      *o = v0;
  }
}

// one output element: scale after accumulation, then the row scale (W8A8)
__device__ __forceinline__ float scaled(float acc, float s, const float* x_scales, int row) {
  float v = acc * s;
  if (x_scales != nullptr) v = v * x_scales[row];
  return v;
}

// JAX's SwiGLU on scaled sums: silu(g) * u, silu(g) = g * sigmoid(g) with
// sigmoid = 1 / (1 + exp(-g)) (jax.nn.silu)
__device__ __forceinline__ float swiglu(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

// the body of a split-K sum: the split partials of out (M x N) in split
// order, then the epilogue
template <typename Acc>
__device__ __forceinline__ void splitk_sum(const Acc* __restrict__ p,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ x_scales,
                                           void* __restrict__ out, int out_bf16, int M, int N,
                                           int splits) {
  const long long total = (long long)M * N;
  for (long long at = blockIdx.x * (long long)blockDim.x + threadIdx.x; at < total;
       at += (long long)gridDim.x * blockDim.x) {
    Acc acc = 0;
    for (int s = 0; s < splits; ++s) acc += p[s * total + at];
    const int row = static_cast<int>(at / N);
    store_out(out, out_bf16, at, scaled(static_cast<float>(acc), scales[at % N], x_scales, row),
              0.f, false);
  }
}

// blocks of 256 threads for an elementwise pass over `total` outputs
inline int sum_blocks(long long total) {
  return static_cast<int>(std::min<long long>((total + 255) / 256, 132 * 16));
}

// S8: int8 x (W8A8), else bf16 x. BITS: 8 or 4 (grouped int4). BM: x rows
// per CTA (64, 128 or, for bf16 x, 256). DUAL: K9's gate/up stage (above).
// WIDE: 128-column boxes of W a stage (above).
template <bool S8, int BITS, int BM, bool DUAL = false, int WIDE = 1>
struct Cfg {
  static_assert(!DUAL || (!S8 && BITS == 8), "the dual stage takes bf16 x and int8 W");
  static_assert(WIDE == 1 || (WIDE == 2 && !S8 && !DUAL && BITS == 8),
                "wide stages take bf16 x and int8 W");
  static constexpr int BN = DUAL ? 64 : 128 * WIDE;  // output columns per tile
  static constexpr int BK = S8 ? 128 : 64;    // logical K rows per stage: one 128-byte x row
  static constexpr int X_STAGE = BM * ROW;
  static constexpr int W_HALF = BK * 64;      // DUAL: one matrix's 64-byte rows
  static constexpr int W_STAGE = DUAL ? 2 * W_HALF : BK * BN;  // W byte rows (one nibble, int4)
  static constexpr int B_BYTES = S8 ? B_BUFS * BN * ROW : 0;
  // DUAL: warpgroup 1's accumulators, handed to warpgroup 0 (BM / 2 floats a thread)
  static constexpr int XCH_BYTES = DUAL ? 128 * (BM / 2) * 4 : 0;
  // as deep a ring as shared memory holds, so that loads stay in flight
  // for several stages' worth of wgmma (2 KB kept for alignment and barriers)
  static constexpr int FIT = (SMEM_MAX - B_BYTES - XCH_BYTES - 2048) / (X_STAGE + W_STAGE);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int RING = STAGES * (X_STAGE + W_STAGE);
  static constexpr int BAR_AT = RING + B_BYTES + XCH_BYTES;  // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR_AT + 2 * STAGES * 8 + 1024;  // + room to align to 1 KB
  static_assert(SMEM <= SMEM_MAX, "the ring does not fit");
  // consumer warpgroups: bf16 x, one per 64 of the BN columns (DUAL: one
  // per matrix); int8 x, one per 64 rows of x
  static constexpr int CONSUMERS = S8 ? 2 * BM : 256 * WIDE;
  static constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
  static constexpr int TX_BYTES = X_STAGE + W_STAGE;
};

// four 8x8 matrices of 16-bit elements, each delivered transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the 64-byte swizzle of a byte offset in a 512-byte-aligned tile of
// 64-byte rows: the 16-byte chunk index (bits 4-5) XOR bits 7-8
__device__ __forceinline__ uint32_t sw64(uint32_t off) { return off ^ ((off >> 3) & 0x30u); }

// Stage t is x's columns [t * BK, (t + 1) * BK). For int8 W they are W's
// rows too. For grouped int4 they lie in one half of one 256-row group g
// (BK divides 128): the low nibbles (h = 0) or the high ones (h = 1) of
// byte rows 128g + (the columns' offset in the half); each byte row is thus
// loaded once per nibble, the second time mostly from L2.
template <int BITS, int BK>
__device__ __forceinline__ int w_row(int t) {
  const int k = t * BK;
  return BITS == 8 ? k : (k / 256) * 128 + k % 128;
}

template <int BITS, int BK>
__device__ __forceinline__ int nibble_of(int t) {
  return BITS == 4 && (t * BK) % 256 >= 128;
}

// the sign-extended low (h = 0) or high (h = 1) nibble of each byte
__device__ __forceinline__ uint32_t nibbles(uint32_t v, int h) {
  const uint32_t n = (h ? v >> 4 : v) & 0x0F0F0F0Fu;
  return n | ((n & 0x08080808u) * 0x1Eu);
}

// byte b of a word of int8 values each biased by +128, as f32: the bits
// 0x4B0000xx are 2^23 + xx exactly
__device__ __forceinline__ float biased_byte_f32(uint32_t biased, uint32_t b) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | b)) - 8388736.0f;
}

// two small integers held in f32 as a bf16 pair: the upper halves are exact
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// One output tile: its first row and column, and its range of K slices.
struct Tile {
  int m0, n0, split, t_begin, nk;
};

// tile u: row tiles fastest, then splits, then column tiles
template <int BM, int BK, int BN>
__device__ __forceinline__ Tile tile_of(int u, int M, int K, int splits, int per) {
  const int tiles_m = (M + BM - 1) / BM, rest = u / tiles_m;
  Tile tile;
  tile.m0 = (u % tiles_m) * BM;
  tile.split = rest % splits;
  tile.n0 = (rest / splits) * BN;
  tile.t_begin = tile.split * per;
  tile.nk = min((K + BK - 1) / BK, tile.t_begin + per) - tile.t_begin;
  return tile;
}

// The shared-memory ring: stages of x and W, and their full and empty barriers.
template <bool S8, int BITS, int BM, bool DUAL, int WIDE = 1>
struct Ring {
  using C = Cfg<S8, BITS, BM, DUAL, WIDE>;
  uint8_t* smem;
  uint32_t bars;
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (C::STAGES + s); }
  __device__ uint8_t* x_stage(int s) const { return smem + s * (C::X_STAGE + C::W_STAGE); }
  __device__ uint8_t* w_stage(int s) const { return x_stage(s) + C::X_STAGE; }
};

// w and scales: W (K x N, or K/2 x N packed int4) and its column scales;
// DUAL: also w2 and scales2 (Wu and su), and out is h (M x N, bf16).
// part: the split partials, f32 (int32 under W8A8), [splits][M][N]
// ([2 * split + matrix][M][N] under DUAL).
struct Args {
  const void* x;
  const float* x_scales;
  const int8_t* w;
  const float* scales;
  const int8_t* w2;
  const float* scales2;
  void* part;
  void* out;
  int out_bf16, M, K, N, splits, per, use_tma, tiles;
};

// the producer warp's fallback where TMA cannot go: element loads into the
// layout TMA would have written (zeros past M, K and N)
template <bool S8, int BITS, int BM, bool DUAL, int WIDE>
__device__ __forceinline__ void load_stage_predicated(uint8_t* xs, uint8_t* ws, const Args& g,
                                                      int m0, int n0, int t, int lane) {
  using C = Cfg<S8, BITS, BM, DUAL, WIDE>;
  constexpr int ES = S8 ? 1 : 2;  // bytes of one x element
  for (int e = lane; e < BM * C::BK; e += 32) {
    const int r = e / C::BK, c = e % C::BK, gm = m0 + r, gk = t * C::BK + c;
    uint8_t* dst = xs + sw128(r * ROW + c * ES);
    const bool in = gm < g.M && gk < g.K;
    if (S8)
      *reinterpret_cast<int8_t*>(dst) =
          in ? static_cast<const int8_t*>(g.x)[(long long)gm * g.K + gk] : int8_t(0);
    else
      *reinterpret_cast<uint16_t*>(dst) =
          in ? static_cast<const uint16_t*>(g.x)[(long long)gm * g.K + gk] : uint16_t(0);
  }
  const int w_rows = BITS == 4 ? g.K / 2 : g.K;
  if constexpr (DUAL) {
    for (int e = lane; e < C::W_STAGE; e += 32) {
      const int half = e / C::W_HALF, o = e % C::W_HALF;
      const int r = w_row<BITS, C::BK>(t) + o / 64, gn = n0 + o % 64;
      const int8_t* w = half ? g.w2 : g.w;
      ws[half * C::W_HALF + sw64(o)] =
          (r < w_rows && gn < g.N) ? static_cast<uint8_t>(w[(long long)r * g.N + gn]) : uint8_t(0);
    }
  } else if constexpr (WIDE == 1) {
    for (int e = lane; e < C::W_STAGE; e += 32) {
      const int r = w_row<BITS, C::BK>(t) + e / C::BN, gn = n0 + e % C::BN;
      ws[sw128(e)] = (r < w_rows && gn < g.N) ? static_cast<uint8_t>(g.w[(long long)r * g.N + gn])
                                              : uint8_t(0);
    }
  } else {  // box b: columns n0 + 128 b + [0, 128), as TMA would write it
    for (int e = lane; e < C::W_STAGE; e += 32) {
      const int b = e / (C::BK * ROW), o = e % (C::BK * ROW);
      const int r = w_row<BITS, C::BK>(t) + o / ROW, gn = n0 + ROW * b + o % ROW;
      ws[b * C::BK * ROW + sw128(o)] =
          (r < w_rows && gn < g.N) ? static_cast<uint8_t>(g.w[(long long)r * g.N + gn])
                                   : uint8_t(0);
    }
  }
}

// The producer warp: every tile's stages, in the consumers' order, by TMA
// (x's box and W's rows, with the 128-byte swizzle; DUAL: Wg's and Wu's
// 64-byte rows with the 64-byte swizzle; WIDE 2: a second box of W's rows,
// left out where its columns all lie past N, whose logits the epilogue
// drops) or predicated loads.
template <bool S8, int BITS, int BM, bool DUAL, int WIDE>
__device__ __forceinline__ void produce(const Ring<S8, BITS, BM, DUAL, WIDE>& ring,
                                        const Args& g, const CUtensorMap* xmap,
                                        const CUtensorMap* wmap, const CUtensorMap* umap) {
  using C = Cfg<S8, BITS, BM, DUAL, WIDE>;
  const int lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < g.tiles; u += gridDim.x) {
    const Tile tile = tile_of<BM, C::BK, C::BN>(u, g.M, g.K, g.splits, g.per);
    for (int it = 0; it < tile.nk; ++it) {
      const int t = tile.t_begin + it;
      mbar_wait(ring.empty(stage), phase ^ 1);
      if (g.use_tma) {
        if (lane == 0) {
          const bool second = WIDE == 2 && tile.n0 + ROW < g.N;
          if constexpr (WIDE == 1)
            mbar_expect_tx(ring.full(stage), C::TX_BYTES);
          else
            mbar_expect_tx(ring.full(stage), C::TX_BYTES - (second ? 0 : C::BK * ROW));
          tma_2d(smem_u32(ring.x_stage(stage)), xmap, ring.full(stage), t * C::BK, tile.m0);
          tma_2d(smem_u32(ring.w_stage(stage)), wmap, ring.full(stage), tile.n0,
                 w_row<BITS, C::BK>(t));
          if constexpr (DUAL)
            tma_2d(smem_u32(ring.w_stage(stage) + C::W_HALF), umap, ring.full(stage), tile.n0,
                   w_row<BITS, C::BK>(t));
          if (second)
            tma_2d(smem_u32(ring.w_stage(stage) + C::BK * ROW), wmap, ring.full(stage),
                   tile.n0 + ROW, w_row<BITS, C::BK>(t));
        }
      } else {
        load_stage_predicated<S8, BITS, BM, DUAL, WIDE>(ring.x_stage(stage), ring.w_stage(stage),
                                                        g, tile.m0, tile.n0, t, lane);
        fence_proxy_async();
        mbar_arrive(ring.full(stage));
      }
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// out[m][n], out[m][n + 1] (where n + 1 < N) from two f32 values: through
// the epilogue with one split, else as the split's partial in `slab`
template <typename Acc>
__device__ __forceinline__ void write_pair(const Args& g, int slab, int m, int n, Acc v0, Acc v1,
                                           float s0, float s1) {
  const long long at = (long long)m * g.N + n;
  const bool two = n + 1 < g.N;
  if (g.splits == 1) {
    const float o0 = scaled(static_cast<float>(v0), s0, g.x_scales, m);
    const float o1 = scaled(static_cast<float>(v1), s1, g.x_scales, m);
    if (g.N % 2 == 0) {  // n is even: an aligned pair
      store_out(g.out, g.out_bf16, at, o0, o1, true);
    } else {
      store_out(g.out, g.out_bf16, at, o0, 0.f, false);
      if (two) store_out(g.out, g.out_bf16, at + 1, o1, 0.f, false);
    }
  } else {
    Acc* p = static_cast<Acc*>(g.part) + (long long)slab * g.M * g.N + at;
    p[0] = v0;
    if (two) p[1] = v1;
  }
}

// The bf16-x consumer's epilogue for K7 and K9's down phase: each tile's
// accumulators d (R = BM / 2 a thread; the layout is consume_bf16's)
// through write_pair. finish() runs once a CTA's tiles are done.
struct WriteTile {
  template <int R>
  __device__ __forceinline__ void tile(const Args& g, const Tile& tile, const float (&d)[R],
                                       int wg, int warp, int lane) {
    const int p = lane / 4, q = lane % 4;
    const int n = tile.n0 + 64 * wg + 16 * warp + 2 * p;
    if (n >= g.N) return;
    const float s0 = g.scales[n], s1 = n + 1 < g.N ? g.scales[n + 1] : 0.f;
#pragma unroll
    for (int j = 0; j < R / 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int m = tile.m0 + 8 * j + 2 * q + c;
        if (m < g.M) write_pair(g, tile.split, m, n, d[4 * j + c], d[4 * j + 2 + c], s0, s1);
      }
  }

  template <int CONSUMERS>
  __device__ __forceinline__ void finish(const Args&, uint8_t*) {}
};

// bf16 x: out^T = W^T x^T. Warpgroup wg owns 64 columns of W (columns n0 +
// 64 wg + [0, 64), the (wg % 2)-th half of box wg / 2; DUAL: columns n0 +
// [0, 64) of Wg for wg 0 and of Wu for wg 1), 16 per warp, as wgmma's A
// operand in registers: each warp takes
// its W bytes from the stage with ldmatrix (16-bit pairs of columns,
// transposed: a thread gets rows 2q, 2q + 1 of columns 2p, 2p + 1),
// converts them to bf16 in registers, and feeds A row p from column 2p and
// row p + 8 from column 2p + 1. x's stage is the B operand (BM x 64,
// K-major). Nothing is written back to shared memory, and the warpgroups
// never wait for each other in the main loop; three wgmma stay in flight
// while the next k16 step converts. Each finished tile goes to epi.tile
// (DUAL: the SwiGLU epilogue below), and epi.finish ends the CTA's walk.
template <int BITS, int BM, bool DUAL, int WIDE, typename Epi>
__device__ __forceinline__ void consume_bf16(const Ring<false, BITS, BM, DUAL, WIDE>& ring,
                                             const Args& g, Epi& epi) {
  using C = Cfg<false, BITS, BM, DUAL, WIDE>;
  const int ct = threadIdx.x, wg = ct / 128, warp = (ct % 128) / 32, lane = ct % 32;
  // the warp's 16 columns: a 16-byte chunk of a W row of box wg / 2
  const uint32_t chunk = WIDE == 1 ? 4 * wg + warp : 4 * (wg % 2) + warp;
  const uint32_t box = WIDE == 1 ? 0 : (wg / 2) * C::BK * ROW;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < g.tiles; u += gridDim.x) {
    const Tile tile = tile_of<BM, C::BK, C::BN>(u, g.M, g.K, g.splits, g.per);
    float d[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) d[i] = 0.f;
    int prev = -1;
    for (int it = 0; it < tile.nk; ++it) {
      mbar_wait(ring.full(stage), phase);
      const uint32_t wb = smem_u32(ring.w_stage(stage)), xb = smem_u32(ring.x_stage(stage));
      // W rows 32c + lane: matrix j of call c is k rows 32c + 8j .. + 7
      uint32_t raw[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t k = 32 * c + lane;
        const uint32_t at = DUAL ? wb + wg * C::W_HALF + k * 64 + ((warp ^ ((k >> 1) & 3)) << 4)
                                 : wb + box + k * ROW + ((chunk ^ (k & 7)) << 4);
        ldmatrix_x4_trans(raw[c], at);
      }
      const int h = nibble_of<BITS, C::BK>(tile.t_begin + it);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // the k16 step s: k rows 16s .. 16s + 7 (lo) and 16s + 8 .. 16s + 15 (hi)
        uint32_t lo = raw[s / 2][2 * (s % 2)], hi = raw[s / 2][2 * (s % 2) + 1];
        if (BITS == 4) {
          lo = nibbles(lo, h);
          hi = nibbles(hi, h);
        }
        lo ^= 0x80808080u;
        hi ^= 0x80808080u;
        // bytes: (k 2q, col 2p), (2q, 2p + 1), (2q + 1, 2p), (2q + 1, 2p + 1)
        const uint32_t a[4] = {
            bf16_pair(biased_byte_f32(lo, 0), biased_byte_f32(lo, 2)),
            bf16_pair(biased_byte_f32(lo, 1), biased_byte_f32(lo, 3)),
            bf16_pair(biased_byte_f32(hi, 0), biased_byte_f32(hi, 2)),
            bf16_pair(biased_byte_f32(hi, 1), biased_byte_f32(hi, 3))};
        wgmma_fence();
        wgmma(d, a, desc_sw128(xb + 32 * s));
        wgmma_commit();
        // at most three steps stay in flight: step s - 3's A registers are free
        wgmma_wait<3>();
      }
      fence_regs(d);
      // every step of the previous stage is done: its x and W can be refilled
      if (prev >= 0 && ct % 128 == 0) mbar_arrive(ring.empty(prev));
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (ct % 128 == 0) mbar_arrive(ring.empty(prev));

    // d[4j + 2i + c]: A row 16 warp + p + 8i (column 2p + i of the warp's
    // 16), B column 8j + 2q + c (row of x)
    if constexpr (DUAL) {
      const int p = lane / 4, q = lane % 4;
      const int n = tile.n0 + 16 * warp + 2 * p;
      if (g.splits > 1) {  // each matrix's partial; the sum kernel forms h
        if (n >= g.N) continue;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int m = tile.m0 + 8 * j + 2 * q + c;
            if (m < g.M)
              write_pair(g, 2 * tile.split + wg, m, n, d[4 * j + c], d[4 * j + 2 + c], 0.f, 0.f);
          }
        continue;
      }
      // warpgroup 1 hands u to the same thread of warpgroup 0, which forms h
      float* xch = reinterpret_cast<float*>(ring.smem + C::RING);
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < BM / 2; ++i) xch[i * 128 + ct % 128] = d[i];
      }
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (wg == 0 && n < g.N) {
        const bool two = n + 1 < g.N;
        const float sg0 = g.scales[n], sg1 = two ? g.scales[n + 1] : 0.f;
        const float su0 = g.scales2[n], su1 = two ? g.scales2[n + 1] : 0.f;
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int m = tile.m0 + 8 * j + 2 * q + c;
            if (m >= g.M) continue;
            const float h0 = swiglu(d[4 * j + c] * sg0, xch[(4 * j + c) * 128 + ct] * su0);
            const float h1 =
                swiglu(d[4 * j + 2 + c] * sg1, xch[(4 * j + 2 + c) * 128 + ct] * su1);
            const long long at = (long long)m * g.N + n;
            if (g.N % 2 == 0) {
              store_out(g.out, true, at, h0, h1, true);
            } else {
              store_out(g.out, true, at, h0, 0.f, false);
              if (two) store_out(g.out, true, at + 1, h1, 0.f, false);
            }
          }
      }
      // warpgroup 0 has read the hand-over: the next tile may overwrite it
      asm volatile("bar.sync 2, 256;" ::: "memory");
    } else {
      epi.tile(g, tile, d, wg, warp, lane);
    }
  }
  epi.template finish<C::CONSUMERS>(g, ring.smem);
}

// W's stage (BK rows x 128 bytes, N-contiguous, 128-byte swizzle) into
// wgmma's B operand for W8A8: (128 columns x 128 bytes of K), int8, K-major
// with the 128-byte swizzle (8-bit operands must be K-major). One task is 4
// columns by one 16-byte chunk q of K: its W words are one column word of
// 16 rows (a warp reads whole rows, free of bank conflicts), and it stores
// 4 chunks. Task c stores its columns rotated by (c >> 1) & 3, so each 8
// lanes of a 16-byte store hit 8 distinct bank groups.
template <int BITS, int BM>
__device__ __forceinline__ void convert_stage_s8(const uint8_t* wst, uint8_t* bbuf, int nibble,
                                                 int ct) {
  for (int task = ct; task < 256; task += Cfg<true, BITS, BM>::CONSUMERS) {
    const int c = task % 32, q = task / 32;
    uint32_t u[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t v =
          *reinterpret_cast<const uint32_t*>(wst + sw128((q * 16 + j) * ROW + 4 * c));
      u[j] = BITS == 4 ? nibbles(v, nibble) : v;
    }
    const uint32_t rot = (c >> 1) & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t b = (i + rot) & 3;  // column 4c + b
      const uint32_t sel = b | ((b + 4) << 4);
      uint32_t o[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        o[m] = __byte_perm(__byte_perm(u[4 * m], u[4 * m + 1], sel),
                           __byte_perm(u[4 * m + 2], u[4 * m + 3], sel), 0x5410);
      *reinterpret_cast<uint4*>(bbuf + sw128((4 * c + b) * ROW + q * 16)) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// int8 x (W8A8): x's stage is wgmma's A operand (warpgroup wg owns its rows
// 64 wg + [0, 64)), and the consumers rewrite W's stage as the B operand in
// shared memory (convert_stage_s8). Three converted tiles rotate so that the
// conversion of stage g + 1 overlaps the wgmma of stage g; a proxy fence
// and a barrier of the consumers hand each tile to wgmma.
template <int BITS, int BM>
__device__ __forceinline__ void consume_s8(const Ring<true, BITS, BM, false>& ring,
                                           const Args& g) {
  using C = Cfg<true, BITS, BM>;
  const int ct = threadIdx.x, wg = ct / 128, lane = ct % 32;
  int stage = 0, gs = 0;  // gs: stages consumed, over all tiles
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < g.tiles; u += gridDim.x) {
    const Tile tile = tile_of<BM, C::BK, C::BN>(u, g.M, g.K, g.splits, g.per);
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    int prev = -1;
    for (int it = 0; it < tile.nk; ++it, ++gs) {
      mbar_wait(ring.full(stage), phase);
      // Both warpgroups' wgmma of stage gs - 3 read this buffer last; each
      // finished it (wait_group 1 after stage gs - 2, or 0 at a tile's end)
      // before reaching the barrier of stage gs - 1, which this thread passed.
      uint8_t* bb = ring.smem + C::RING + (gs % B_BUFS) * C::BN * ROW;
      convert_stage_s8<BITS, BM>(ring.w_stage(stage), bb,
                                 nibble_of<BITS, C::BK>(tile.t_begin + it), ct);
      fence_proxy_async();
      asm volatile("bar.sync 1, %0;" ::"n"(C::CONSUMERS) : "memory");
      fence_regs(d);
      wgmma_fence();
      const uint32_t a0 = smem_u32(ring.x_stage(stage)) + wg * 64 * ROW, b0 = smem_u32(bb);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma(d, desc_sw128(a0 + 32 * s), desc_sw128(b0 + 32 * s));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(d);
      // the wgmma of the previous stage is done: its x and W can be refilled
      if (prev >= 0 && ct % 128 == 0) mbar_arrive(ring.empty(prev));
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(d);
    if (ct % 128 == 0) mbar_arrive(ring.empty(prev));

    // d[4j + 2i + c]: row 16 warp + lane / 4 + 8i, column 8j + 2 (lane % 4) + c
    const int row0 = tile.m0 + wg * 64 + ((ct % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = tile.n0 + 8 * j + 2 * (lane % 4);
      if (col >= g.N) continue;
      const float s0 = g.scales[col], s1 = col + 1 < g.N ? g.scales[col + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < g.M)
          write_pair(g, tile.split, row, col, d[4 * j + 2 * i], d[4 * j + 2 * i + 1], s0, s1);
      }
    }
  }
}

// The body of a persistent tensor-core kernel: CTA b takes tiles b, b +
// grid, ... (tile_of's order), and its producer runs on into the next tile
// while the consumers write the last one. A tile goes through the epilogue
// when there is one split, else its partial goes to `part`; bf16 x hands
// it to `epi` (WriteTile: the same).
template <bool S8, int BITS, int BM, bool DUAL, int WIDE = 1, typename Epi = WriteTile>
__device__ __forceinline__ void wgmma_body(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                           const CUtensorMap* umap, const Args& g,
                                           Epi epi = Epi()) {
  using C = Cfg<S8, BITS, BM, DUAL, WIDE>;
  extern __shared__ uint8_t smem_raw[];
  Ring<S8, BITS, BM, DUAL, WIDE> ring;
  ring.smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  ring.bars = smem_u32(ring.smem + C::BAR_AT);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(ring.full(s), g.use_tma ? 1 : 32);
      mbar_init(ring.empty(s), C::CONSUMERS / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS)
    produce<S8, BITS, BM, DUAL, WIDE>(ring, g, xmap, wmap, umap);
  else if constexpr (S8)
    consume_s8<BITS, BM>(ring, g);
  else
    consume_bf16<BITS, BM, DUAL, WIDE>(ring, g, epi);
}

// a 2-D row-major (rows x cols) byte or bf16 map with a (box_cols x box_rows) box
inline bool encode_2d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                      int elem_bytes, int rows, int cols, int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch `kernel` (a __global__ wrapper of wgmma_body<S8, BITS, BM, DUAL>,
// taking (xmap, wmap, g), or (xmap, wmap, umap, g) under DUAL) with one
// persistent CTA per SM at most, its ring Cfg::STAGES deep. Sets g.tiles.
// The split-K sum is the caller's.
template <bool S8, int BITS, int BM, bool DUAL, typename Kernel>
cudaError_t launch_wgmma(Kernel kernel, Args& g, cudaStream_t stream) {
  using C = Cfg<S8, BITS, BM, DUAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{}, umap{};  // left zero for the predicated producer, which reads none
  if (g.use_tma) {
    const int w_rows = BITS == 4 ? g.K / 2 : g.K;
    const CUtensorMapSwizzle wsw = DUAL ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
    bool ok =
        encode_2d(&xmap, g.x, S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  S8 ? 1 : 2, g.M, g.K, C::BK, BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
        encode_2d(&wmap, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_rows, g.N, C::BN, C::BK, wsw);
    if (DUAL)
      ok = ok && encode_2d(&umap, g.w2, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_rows, g.N, C::BN,
                           C::BK, wsw);
    if (!ok) return cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  g.tiles = ((g.M + BM - 1) / BM) * ((g.N + C::BN - 1) / C::BN) * g.splits;
  const int grid = std::min(g.tiles, sms);
  if constexpr (DUAL)
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(xmap, wmap, umap, g);
  else
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(xmap, wmap, g);
  return cudaGetLastError();
}

}  // namespace qmm_tile
