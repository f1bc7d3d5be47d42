// K7's tensor-core dequant matmul as pieces, shared by K7 (qmm.cu), K9
// (fused_mlp.cu) and K2 (qmm_argmax.cu): the TMA ring with its producer
// warp, persistent CTAs over (row tile, K split, column tile), the bf16-x
// consumer that multiplies out^T = W^T x^T with W's int8 columns converted
// to bf16 in registers, the W8A8 consumer, and the fixed-order split-K sum;
// and K7's f32 mode (F32Cfg, f32_tile: f32 FMAs fed by a TMA or cp.async
// ring), on which K2's and K9's f32-x kernels run too. qmm.cu's header
// comment describes the design; this file holds the code.
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


// ---------------------------------------------------------------------------
// The f32 mode (qmm.cu's header describes it): f32 FMAs on (BM x 64) tiles,
// 8 x 8 outputs a thread, fed by an asynchronous ring of 32-row K stages.
// f32_tile leaves a tile's sums in registers for an epilogue: K7's
// qmm_f32_kernel and K9's down phase write them (F32Write, f32_body); K2's
// qmm_argmax_f32_kernel takes each row's winner and K9's gate/up phase
// forms h from them (F32Sums).
// DUAL (K9's gate/up phase, int8 W): a tile is 32 d_ff columns of each of
// two weight matrices (Wg and Wu, the same columns). A stage carries both
// matrices' 32-byte rows, and the converted tile's columns 0-31 are Wg's,
// 32-63 Wu's, so that a thread's outputs j and 4 + j (j < 4) are g and u of
// one (row, column), and fma_f32_stage serves both modes unchanged.
// ---------------------------------------------------------------------------

constexpr int F32_BK = 32;  // logical K rows per stage: one 128-byte row of x
constexpr int F32_BN = 64;  // output columns per tile
// cp.async: the aligned words that cover a W row's 64 bytes
constexpr int F32_WORDS = F32_BN / 4 + 1;
// bytes of one W row in a stage: TMA writes 64, cp.async its 17 words
template <bool TMA>
constexpr int F32_W_PITCH = TMA ? F32_BN : 80;
// DUAL: one matrix's 32-byte rows (cp.async: the 9 words that cover them),
// Wu's after Wg's
constexpr int F32_DUAL_WORDS = F32_BN / 8 + 1;
template <bool TMA>
constexpr int F32_DUAL_PITCH = TMA ? F32_BN / 2 : 48;
template <bool TMA>
constexpr int F32_DUAL_U_AT = F32_BK * F32_DUAL_PITCH<TMA>;

// BM 128: three CTAs an SM (12 warps); BM 64 (below M = 128): four (8
// warps). Shared memory: the ring's x stages (BM x 128 bytes, 128-byte
// swizzle), its W stages, two converted W tiles (32 x 64 f32) and the
// ring's full barriers.
template <int BM, bool DUAL = false>
struct F32Cfg {
  static constexpr int THREADS = BM;  // BM / 8 rows of threads by 8 columns
  static constexpr int TY = BM / 8;   // a thread's rows: ty + TY i, i < 8
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = BM == 128 ? 3 : 4;
  // 4-k blocks a pass of the FMA loop, half a stage: warps of several CTAs
  // drift apart and run faster from less code than from a whole stage
  static constexpr int UNROLL = 4;
  static constexpr int BN = DUAL ? F32_BN / 2 : F32_BN;  // a tile's columns of each matrix
  static constexpr int X_STAGE = BM * 128;
  static constexpr int W_STAGE = DUAL ? 2 * F32_DUAL_U_AT<false> : F32_BK * F32_W_PITCH<false>;
  static constexpr int WF = F32_BK * F32_BN * 4;
  static constexpr int W_AT = STAGES * X_STAGE;
  static constexpr int WF_AT = W_AT + STAGES * W_STAGE;
  static constexpr int BAR_AT = WF_AT + 2 * WF;
  static constexpr int SMEM = BAR_AT + 8 * STAGES + 1024;  // + room to align to 1 KB
  static_assert(TY % 8 == 0, "a thread's rows share their swizzle phase");
  static_assert(W_STAGE % 128 == 0 && X_STAGE % 1024 == 0, "TMA writes 128-byte aligned boxes");
  // MIN_BLOCKS CTAs an SM, each with its 1 KB the card reserves
  static_assert(MIN_BLOCKS * (SMEM + 1024) <= 233472, "the CTAs do not fit an SM");
};

// x (M x K f32), W (K x N, or K/2 x N packed int4) and its column scales;
// part: the split partials, f32, [splits][M][N] ([2 * split + matrix][M][N]
// under DUAL); out: M x N, f32 or bf16; per: K stages a split
struct F32Args {
  const float* x;
  const int8_t* w;
  const float* scales;
  float* part;
  void* out;
  int out_bf16, M, K, N, per;
};

// 4 bytes from global to shared memory, `bytes` of them read and the rest zero
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the bytes of a W row in [4 word, 4 word + 4) that lie in W (total bytes)
__device__ __forceinline__ int word_bytes(long long total, long long word) {
  const long long left = total - 4 * word;
  return left >= 4 ? 4 : left > 0 ? static_cast<int>(left) : 0;
}

// the cp.async loader: stage t into the layout TMA writes for x (zeros past
// M and K), and each W row's 64 bytes from column n0 as the 17 aligned words
// that cover them (zeros past the array), so that any N works; DUAL: each
// matrix's 32 bytes as 9 words, Wg's rows (g.w) then Wu's (w2)
template <int BITS, int BM, bool DUAL = false>
__device__ __forceinline__ void load_f32_stage(uint8_t* xs, uint8_t* ws, const F32Args& g,
                                               int m0, int n0, int t, int tid,
                                               const int8_t* w2 = nullptr) {
  using C = F32Cfg<BM, DUAL>;
#pragma unroll 4
  for (int u = 0; u < BM * F32_BK / C::THREADS; ++u) {
    const int e = tid + C::THREADS * u;
    const int r = e / F32_BK, c = e % F32_BK, gm = m0 + r, gk = t * F32_BK + c;
    const bool in = gm < g.M && gk < g.K;
    cp_async4(smem_u32(xs + sw128(r * 128 + 4 * c)), in ? g.x + (long long)gm * g.K + gk : g.x,
              in ? 4 : 0);
  }
  const long long total = (long long)(BITS == 4 ? g.K / 2 : g.K) * g.N;
  const int wr = w_row<BITS, F32_BK>(t);
  if constexpr (DUAL) {
    static_assert(BITS == 8, "the dual stage takes int8 W");
    constexpr int ONE = F32_BK * F32_DUAL_WORDS;  // one matrix's words
    for (int e = tid; e < 2 * ONE; e += C::THREADS) {
      const int mat = e / ONE, r = e % ONE / F32_DUAL_WORDS, c = e % F32_DUAL_WORDS;
      const long long word = (((long long)(wr + r) * g.N + n0) >> 2) + c;
      const int bytes = word_bytes(total, word);
      const int8_t* w = mat ? w2 : g.w;
      cp_async4(smem_u32(ws + mat * F32_DUAL_U_AT<false> + r * F32_DUAL_PITCH<false> + 4 * c),
                bytes ? w + 4 * word : w, bytes);
    }
  } else {
    for (int e = tid; e < F32_BK * F32_WORDS; e += C::THREADS) {
      const int r = e / F32_WORDS, c = e % F32_WORDS;
      const long long word = (((long long)(wr + r) * g.N + n0) >> 2) + c;
      const int bytes = word_bytes(total, word);
      cp_async4(smem_u32(ws + r * F32_W_PITCH<false> + 4 * c), bytes ? g.w + 4 * word : g.w,
                bytes);
    }
  }
}

// W's stage into f32 in logical K order (nibbles sign-extended), once per
// CTA: a warp reads two rows' words and writes their 128 values; each
// thread converts the same column word of THREADS / 16-row-apart rows,
// unrolled, so that the step costs little beside the stage's FMAs. DUAL:
// words 0-7 of a converted row are Wg's, 8-15 Wu's; the Wu half of a warp
// takes rows 2 apart from its Wg half's (r0 ^ 2), so that the warp's four
// 32-byte rows fall in 32 different banks.
template <int BITS, int BM, bool TMA, bool DUAL = false>
__device__ __forceinline__ void convert_f32_stage(const uint8_t* ws, float* wf, const F32Args& g,
                                                  int n0, int t, int tid) {
  constexpr int STEP = F32Cfg<BM, DUAL>::THREADS / 16;
  static_assert(F32_BN / 4 == 16 && F32_BK % STEP == 0, "half a warp a row, a thread a word");
  static_assert(!DUAL || STEP >= 4, "r0 ^ 2 stays among the first STEP rows");
  constexpr int PITCH = DUAL ? F32_DUAL_PITCH<TMA> : F32_W_PITCH<TMA>;
  const int h = nibble_of<BITS, F32_BK>(t), c = tid % 16;
  const int r0 = DUAL && c >= 8 ? (tid / 16) ^ 2 : tid / 16;
  const uint8_t* src = DUAL ? ws + (c / 8) * F32_DUAL_U_AT<TMA> : ws;
  const int cw = DUAL ? c % 8 : c;
  // cp.async: row r's first byte sat (its offset in W) % 4 into its first word
  const long long first = (long long)(w_row<BITS, F32_BK>(t) + r0) * g.N + n0;
#pragma unroll
  for (int u = 0; u < F32_BK / STEP; ++u) {
    const int r = r0 + STEP * u;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(src + r * PITCH);
    uint32_t v = row[cw];
    if (!TMA)
      v = __funnelshift_r(v, row[cw + 1],
                          8 * static_cast<int>((first + (long long)STEP * u * g.N) & 3));
    if (BITS == 4) v = nibbles(v, h);
    v ^= 0x80808080u;
    *reinterpret_cast<float4*>(wf + r * F32_BN + 4 * c) =
        make_float4(biased_byte_f32(v, 0), biased_byte_f32(v, 1), biased_byte_f32(v, 2),
                    biased_byte_f32(v, 3));
  }
}

// acc[i][j] += x[row i][k] * w[k][column j] over the stage's 32 k: x read
// along K from its swizzled stage (a thread's rows share one swizzle phase),
// W from its converted tile (a warp's 8 columns of threads read 128
// contiguous bytes); 4 shared-memory vector reads a k for 64 FMAs.
template <int BM>
__device__ __forceinline__ void fma_f32_stage(const uint8_t* xs, const float* wf, int tx, int ty,
                                              float (&acc)[8][8]) {
  using C = F32Cfg<BM>;
  const uint8_t* xrow = xs + ty * 128;
  const float* wcol = wf + 4 * tx;
#pragma unroll C::UNROLL
  for (int q = 0; q < F32_BK / 4; ++q) {
    const int chunk = (q ^ (ty & 7)) << 4;
    float4 xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xrow + C::TY * 128 * i + chunk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(wcol + (4 * q + kk) * F32_BN);
      const float4 w1 = *reinterpret_cast<const float4*>(wcol + (4 * q + kk) * F32_BN + 32);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = kk == 0 ? xv[i].x : kk == 1 ? xv[i].y : kk == 2 ? xv[i].z : xv[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
  }
}

// four consecutive outputs of a row from `at`, `count` of them in range;
// vector stores where N % 4 == 0 keeps them aligned
__device__ __forceinline__ void store4(void* out, bool bf16, long long at, const float (&v)[4],
                                       int count, bool vec) {
  if (vec && count == 4) {
    if (bf16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + at) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + at) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
  for (int j = 0; j < count && j < 4; ++j) store_out(out, bf16, at + j, v[j], 0.f, false);
}

// f32_tile's default epilogue, K7's write: the tile's sums scaled and
// written, 4 outputs at a time, with one split; else its f32 partial to
// part[split][M][N]. It is written out in f32_tile itself, beside the
// accumulators: called through a function instead, it reorders K7's
// registers in the SASS.
struct F32Write {};

// The other epilogue: a tile's sums and where they lie, taken out of
// f32_tile for the caller's epilogue after it. With K2's epilogue called
// inside f32_tile instead, its 128-row kernel's main loop compiled slower
// (M256 K2048 N32000 on an H100: 0.88-0.98 against 0.85 ms).
struct F32Sums {
  float acc[8][8];
  int tx, ty, n0, m0;
  __device__ __forceinline__ void operator()(const float (&a)[8][8], int x, int y, int n,
                                             int m) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = a[i][j];
    tx = x;
    ty = y;
    n0 = n;
    m0 = m;
  }
};

// One tile's sums over its split's K stages, then K7's write (F32Write)
// or epi(acc, tx, ty, n0, m0) (F32Sums). The CTA's tile: columns n0 = blockIdx.x * BN
// (of each matrix under DUAL), rows m0 = blockIdx.y * BM, split
// blockIdx.z. Thread (tx, ty) = (tid % 8, tid / 8) holds rows m0 + ty +
// TY i and columns n0 + 4 tx + 32 h + [0, 4) (DUAL: h = 0 Wg's, h = 1
// Wu's columns n0 + 4 tx + [0, 4)). Stage j goes to ring slot j % STAGES,
// STAGES - 1 stages ahead of the FMAs; W's stage j + 1 converts into one W
// tile while the FMAs read stage j's in the other; one barrier a stage.
// umap and w2: Wu's map and rows under DUAL.
template <int BITS, int BM, bool TMA, bool DUAL = false, typename Epi = F32Write>
__device__ __forceinline__ void f32_tile(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                         const CUtensorMap* umap, const F32Args& g,
                                         const int8_t* w2, Epi&& epi = Epi()) {
  using C = F32Cfg<BM, DUAL>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + C::BAR_AT);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * BM;
  const int t0 = blockIdx.z * g.per;
  const int nk = min((g.K + F32_BK - 1) / F32_BK, t0 + g.per) - t0;
  auto x_stage = [&](int j) { return smem + (j % C::STAGES) * C::X_STAGE; };
  auto w_stage = [&](int j) { return smem + C::W_AT + (j % C::STAGES) * C::W_STAGE; };
  auto w_tile = [&](int j) { return reinterpret_cast<float*>(smem + C::WF_AT + (j & 1) * C::WF); };

  if (TMA && tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // issue stage j (cp.async: every thread commits one group a call, so that
  // the groups count stages)
  auto load = [&](int j) {
    if (TMA) {
      if (tid == 0 && j < nk) {
        const uint32_t bar = bars + 8 * (j % C::STAGES);
        mbar_expect_tx(bar, C::X_STAGE + F32_BK * F32_BN);
        tma_2d(smem_u32(x_stage(j)), xmap, bar, (t0 + j) * F32_BK, m0);
        tma_2d(smem_u32(w_stage(j)), wmap, bar, n0, w_row<BITS, F32_BK>(t0 + j));
        if (DUAL)
          tma_2d(smem_u32(w_stage(j) + F32_DUAL_U_AT<true>), umap, bar, n0,
                 w_row<BITS, F32_BK>(t0 + j));
      }
    } else {
      if (j < nk)
        load_f32_stage<BITS, BM, DUAL>(x_stage(j), w_stage(j), g, m0, n0, t0 + j, tid, w2);
      cp_async_commit();
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int j = 0; j < C::STAGES - 1; ++j) load(j);
  if (TMA)
    mbar_wait(bars, 0);
  else
    cp_async_wait<C::STAGES - 2>();
  __syncthreads();
  convert_f32_stage<BITS, BM, TMA, DUAL>(w_stage(0), w_tile(0), g, n0, t0, tid);
  for (int it = 0; it < nk; ++it) {
    // stage it + 1 has landed: for cp.async, this thread's groups up to it
    if (it + 1 < nk) {
      if (TMA)
        mbar_wait(bars + 8 * ((it + 1) % C::STAGES), ((it + 1) / C::STAGES) & 1);
      else
        cp_async_wait<C::STAGES - 3>();
    }
    // every thread's copies of stage it + 1 and W tile it are visible, and
    // stage it - 1's slot and W tile it - 1 are read
    __syncthreads();
    load(it + C::STAGES - 1);
    if (it + 1 < nk)
      convert_f32_stage<BITS, BM, TMA, DUAL>(w_stage(it + 1), w_tile(it + 1), g, n0, t0 + it + 1,
                                             tid);
    fma_f32_stage<BM>(x_stage(it), w_tile(it), tx, ty, acc);
  }
  if constexpr (!std::is_same<Epi, F32Write>::value) {  // F32Sums&
    epi(acc, tx, ty, n0, m0);
  } else {
    const bool direct = gridDim.z == 1, vec = g.N % 4 == 0;
    void* dst = direct ? g.out : static_cast<void*>(g.part + (long long)blockIdx.z * g.M * g.N);
    const bool bf16 = direct && g.out_bf16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 32 * h + 4 * tx;
      if (n >= g.N) continue;
      const int count = min(4, g.N - n);
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = direct && j < count ? g.scales[n + j] : 1.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + ty + C::TY * i;
        if (m >= g.M) continue;
        // the scale after accumulation, as scaled() applies it
        const float v[4] = {acc[i][4 * h] * s[0], acc[i][4 * h + 1] * s[1],
                            acc[i][4 * h + 2] * s[2], acc[i][4 * h + 3] * s[3]};
        store4(dst, bf16, (long long)m * g.N + n, v, count, vec);
      }
    }
  }
}

// the body of K7's f32 kernel and of K9's f32 down phase: f32_tile with
// K7's write
template <int BITS, int BM, bool TMA>
__device__ __forceinline__ void f32_body(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                         const F32Args& g) {
  f32_tile<BITS, BM, TMA>(xmap, wmap, nullptr, g, nullptr);
}

// The f32 mode's tensor maps for TMA: x's (BM x 32) f32 box with the
// 128-byte swizzle; W's (32 x BN) byte box (a nibble's packed rows under
// int4), and under DUAL Wu's (w2) too. False where the encoder fails.
template <int BITS, int BM, bool DUAL = false>
bool f32_maps(CUtensorMap* xmap, CUtensorMap* wmap, CUtensorMap* umap, const F32Args& g,
              const int8_t* w2 = nullptr) {
  using C = F32Cfg<BM, DUAL>;
  const int w_rows = BITS == 4 ? g.K / 2 : g.K;
  bool ok = encode_2d(xmap, g.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g.M, g.K, F32_BK, BM,
                      CU_TENSOR_MAP_SWIZZLE_128B) &&
            encode_2d(wmap, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_rows, g.N, C::BN, F32_BK,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (DUAL)
    ok = ok && encode_2d(umap, w2, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w_rows, g.N, C::BN, F32_BK,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  return ok;
}

// the shared memory of a kernel's f32 tiles (F32Cfg::SMEM), set as the
// kernel's dynamic limit
template <int BM, bool DUAL = false, typename Kernel>
cudaError_t f32_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              F32Cfg<BM, DUAL>::SMEM);
}

}  // namespace qmm_tile
