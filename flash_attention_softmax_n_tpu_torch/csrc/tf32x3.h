// The split-TF32 ("3xTF32") pieces of the f32 attention kernels: at head
// dims 32, 64 and 128 K1's flash_fwd_tf32x3_kernel (flash_fwd_f32.cu) and
// K5's and K6's flash_bwd_dq_tf32x3_kernel and flash_bwd_dkv_tf32x3_kernel
// (flash_bwd_f32.cu), one consumer warpgroup and a producer warp a CTA; at
// 256 and above K5's and K6's flash_bwd_dq_tf32x3_wide_kernel and
// flash_bwd_dkv_tf32x3_wide_kernel (flash_bwd_f32_wide.cu) and K1's
// flash_fwd_tf32x3_wide_kernel (flash_fwd_f32_wide.cu), two consumer
// warpgroups and a producer warpgroup, on operands split by a pre-pass.
//
// The split. wgmma has no f32 product, and one TF32 product keeps about 10
// of f32's 23 mantissa bits (a single pass misses chip_smoke's 1e-5 of the
// gradients' norm by about 300x, tests/test_torch_flash_backward_tf32x3.py,
// and K1's 2e-5 of o, tests/test_torch_flash_forward_tf32x3.py). The
// tensor cores read a TF32 operand from an f32 word and ignore its low 13
// bits. x's head is x rounded to nearest at those 19 bits (the rounding of
// cvt.rna.tf32.f32, by integer arithmetic) and its rest x - head is exact
// in f32 and at most 2^-11 of |x|; a product takes three TF32 passes, rest
// x head and head x rest (issued first), then head x head, and drops rest x
// rest and the rest's own low bits, about 2^-21 of the product. Heads
// truncated instead (x as TMA lands it, no rewrite) leave twice that: on
// the CPU emulation 1.3e-6 of the norm against 0.6e-6 rounded, and on an
// H100 the ALiBi slope gradient of one input (a sum over 105,600 ds of
// either sign) missed chip_smoke's 1e-5 of the norm by 5% truncated. TF32
// runs at 495 TFLOP/s dense, so three passes bound f32 work at 165, against
// 67 for f32 FMAs.
//
// The layout. TF32 wgmma takes no transpose bit: both shared-memory
// operands are K-major (K contiguous in a row). A product that contracts
// over keys or query rows takes its B written transposed into shared
// memory by the consumers (split_tile with TR), and its A from the
// accumulator fragments in registers: a fragment holds columns 2 t and 2 t
// + 1 of each 8 where TF32's A layout reads k t and t + 4, so the
// transposed tiles put key (or query) j of each 8 at K position k8_slot(j)
// and the fragment is passed as it stands, its rest beside it
// (split_frags).

#pragma once

#include <climits>

#include "attn_tile.h"

namespace fasn {
namespace attn {

constexpr int TF_THREADS = 128 + 32;  // one consumer warpgroup and the producer warp

// x's TF32 head, x rounded to its top 19 bits (to nearest, ties away from
// zero), and its rest x - head, exact in f32 and at most 2^-11 of |x|
__device__ __forceinline__ float tf32_head(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// the K position at which a transposed B tile holds key (or query row) j:
// within each 8, j = 2 t + c sits at t + 4 c, where A's layout reads the
// fragment's column 2 t + c (split_frags)
__device__ __forceinline__ int k8_slot(int j) {
  return (j & ~7) | ((j & 7) >> 1) | ((j & 1) << 2);
}

// an m64nN accumulator fragment (M = N / 2 floats) as the A fragments of
// its N / 8 k8 slices, heads and rests: slice kk
// takes s[4 kk + 0, 2, 1, 3], columns 8 kk + 2 t (k t) and 8 kk + 2 t + 1 (k
// t + 4) of rows g and g + 8
template <int M>
__device__ __forceinline__ void split_frags(const float (&s)[M], uint32_t (&hi)[M / 4][4],
                                            uint32_t (&lo)[M / 4][4]) {
#pragma unroll
  for (int kk = 0; kk < M / 4; ++kk) {
    const float v[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float h = tf32_head(v[r]);
      hi[kk][r] = __float_as_uint(h);
      lo[kk][r] = __float_as_uint(v[r] - h);
    }
  }
}

// The split of a tile of R rows x D columns as TMA landed it (F32Tile<D, R>
// at `src`, generic addresses): each value x (times scale_q where SCALE:
// q's tile) becomes its head in place and its rest at the same offset of
// `lo` and, where TR, both transposed into `thi` and `tlo` (F32Tile<R, D>:
// row = column of src, K position k8_slot(row of src)). Thread t of the
// warpgroup takes 16-byte chunks, a warp 32 rows (16 where R is 16) of one
// chunk column, so that no read or write meets a bank more than twice.
template <int D, int R, bool TR, bool SCALE>
__device__ __forceinline__ void split_tile(uint8_t* src, uint8_t* lo, uint8_t* thi, uint8_t* tlo,
                                           float scale_q, int t) {
  using T = F32Tile<D, R>;
  using TT = F32Tile<R, D>;
  constexpr int CHUNKS = R * D / 4;
  static_assert(CHUNKS % 128 == 0, "split_tile: whole chunks a thread");
#pragma unroll 4
  for (int n = 0; n < CHUNKS / 128; ++n) {
    const int i = t + 128 * n, r = i % R, c = i / R * 4;
    const uint32_t o = T::at(r, c);
    float4 x = *reinterpret_cast<const float4*>(src + o);
    if constexpr (SCALE) x = make_float4(x.x * scale_q, x.y * scale_q, x.z * scale_q, x.w * scale_q);
    const float4 h = make_float4(tf32_head(x.x), tf32_head(x.y), tf32_head(x.z), tf32_head(x.w));
    const float4 l = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
    *reinterpret_cast<float4*>(src + o) = h;
    *reinterpret_cast<float4*>(lo + o) = l;
    if constexpr (TR) {
      const int k = k8_slot(r);
      const float xs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t ot = TT::at(c + e, k);
        *reinterpret_cast<float*>(thi + ot) = xs[e];
        *reinterpret_cast<float*>(tlo + ot) = ls[e];
      }
    }
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// the word at shared address `at`, loaded anew each call: the tiles' base,
// read back each tile, is opaque to ptxas, which then forms the tiles'
// descriptors within the tile (K6 at D 64 ran 2.6% faster so on an H100,
// K5 the same)
__device__ __forceinline__ uint32_t shared_word(uint32_t at) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(at) : "memory");
  return v;
}

// m64nN fragment rows g and g + 8 (M = N / 2 floats) of `rows` (the first
// of 64, N apart), times `mul`, where the row is below `valid`
template <int M>
__device__ __forceinline__ void store_f32_rows(const float (&o)[M], float* rows, int valid,
                                               float mul) {
  const int t = threadIdx.x % 128, r0 = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= valid) continue;
    float* row = rows + (long long)r * 2 * M;
#pragma unroll
    for (int j = 0; j < M / 4; ++j)
      *reinterpret_cast<float2*>(row + 8 * j + c0) =
          make_float2(mul * o[4 * j + 2 * i], mul * o[4 * j + 2 * i + 1]);
  }
}

// acc (an m64nD fragment) += A B, A the fragments of a tile's dS or P (heads
// fh, rests fl; K = KC keys or query rows), B the heads and rests of the
// transposed tile (F32Tile<KC, D> at b_hi, b_lo): per 64 output columns
// the three passes sum into a fresh accumulator, which f32 adds then add to
// acc. The tensor cores' sums into an accumulator drift with the number of
// products they take (on an H100 one accumulator over L = 1024 rows left 1.2e-5
// of the norm, where the CPU's sums of the same split leave 1.2e-6): this
// way each takes 3 KC / 8, and the tiles add in f32.
template <int D, int KC>
__device__ __forceinline__ void add_tile_product(float (&acc)[D / 2],
                                                 const uint32_t (&fh)[KC / 8][4],
                                                 const uint32_t (&fl)[KC / 8][4], uint32_t b_hi,
                                                 uint32_t b_lo) {
  using Tr = F32Tile<KC, D>;
  constexpr int NC = D < 64 ? D : 64;
#pragma unroll
  for (int c = 0; c < D / NC; ++c) {
    float part[NC / 2];
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) part[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      wgmma_tf32(part, fl[kk], Tr::desc(b_hi, kk, c * NC));
      wgmma_tf32(part, fh[kk], Tr::desc(b_lo, kk, c * NC));
    }
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) wgmma_tf32(part, fh[kk], Tr::desc(b_hi, kk, c * NC));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[c * NC / 2 + i] += part[i];
  }
}

// The pre-pass of the wide kernels (K5's and K6's in flash_bwd_f32_wide.cu,
// K1's in flash_fwd_f32_wide.cu): the operands a product reads transposed
// over all of D, which no CTA holds, written once a call to device
// scratch that the operator allocates.

// one input (B*H, R, D) f32: its heads (x times mul, rounded to TF32) at
// head bh and rests at head BH + bh, transposed, (2 BH, D, R rounded up to
// 32), row j of each 8 at position k8_slot(j), zeros past R
struct SplitJob {
  const float* x;
  float* outT;
  int R;
  float mul;
};
struct SplitJobs {
  SplitJob j[2];
  int jobs, BH, D;
};

// a block: 32 rows x 32 columns of one job's head; 256 threads, a 16-byte
// vector each
__device__ __forceinline__ void split_pass(const SplitJobs& js) {
  __shared__ float th[32][33], tl[32][33];
  const int job = blockIdx.x % js.jobs, bh = blockIdx.x / js.jobs;
  const SplitJob& J = js.j[job];
  const int R = J.R, D = js.D, Rp = (R + 31) / 32 * 32;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.z * 32;
  if (r0 >= Rp) return;
  const long long BH = js.BH;
  const int t = threadIdx.x, r = t / 8, c = 4 * (t % 8);
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r0 + r < R) {
    x = *reinterpret_cast<const float4*>(J.x + ((long long)bh * R + r0 + r) * D + c0 + c);
    x = make_float4(x.x * J.mul, x.y * J.mul, x.z * J.mul, x.w * J.mul);
  }
  const float4 h = make_float4(tf32_head(x.x), tf32_head(x.y), tf32_head(x.z), tf32_head(x.w));
  const float4 l = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
  const float hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    th[r][c + e] = hs[e];
    tl[r][c + e] = ls[e];
  }
  __syncthreads();
  // position p of output row c0 + i holds row j of the block, k8_slot(j) = p
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int o = t + 256 * n, i = o / 32, p = o % 32;
    const int j = (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
    const long long ot = ((long long)bh * D + c0 + i) * Rp + r0 + p;
    J.outT[ot] = th[j][i];
    J.outT[BH * D * Rp + ot] = tl[j][i];
  }
}

// scratch floats of one operand's transposed heads and rests (R rows)
inline long long plane_t_floats(long long BH, int R, int D) {
  return 2 * BH * (long long)D * ((R + 31) / 32 * 32);
}

template <typename Kernel>
cudaError_t launch_split(Kernel kernel, const SplitJobs& js, int rows, cudaStream_t stream) {
  const long long bx = (long long)js.jobs * js.BH, by = (rows + 31) / 32;
  if (bx > INT_MAX || by > 65535 || js.D / 32 > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by), js.D / 32), 256, 0,
           stream>>>(js);
  return cudaGetLastError();
}

// host: the map of an operand's transposes (2 BH planes of D rows x Rp),
// boxes of 64 rows x 32
inline bool encode_split_t(CUtensorMap* m, const float* p, long long BH, int R, int D) {
  return encode_rows(m, p, 2 * BH, D, (R + 31) / 32 * 32, 64, true);
}

}  // namespace attn
}  // namespace fasn
