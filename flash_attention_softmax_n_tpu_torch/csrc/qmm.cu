// K7: x @ dequant(W) with the per-column scale applied after accumulation,
// for Hopper (sm_90a): int8 weights, grouped int4 weights, and W8A8 (int8
// activations with a per-row scale).
//
// Replaces the Pallas kernel _qmm_kernel
// (flash_attention_softmax_n_tpu/kernels/quant_matmul.py:65):
//   out[m,n] = (sum_k x[m,k] * W[k,n]) * scale[n]            (x bf16 or f32)
//   out[m,n] = ((sum_k xq[m,k] * W[k,n]) * scale[n]) * xs[m]  (W8A8)
// The first sums exact products in f32 (W's integers are exact in bf16);
// the second sums int8 x int8 products exactly in int32. Grouped int4: byte
// row i of group g (128 byte rows) holds logical rows 256g+i (low nibble)
// and 256g+128+i (high nibble); K % 256 == 0.
//
// What bounds it on the H100: at prefill sizes (M of 1024-2048 rows) the
// operations, 2*M*K*N at 989 TFLOP/s (bf16) or 1979 TOP/s (int8); at decode
// sizes (M <= 64) the bytes of W, read once (K*N, half that for int4) at
// 3.35 TB/s.
//
// qmm_wgmma_kernel (bf16 or int8 activations) multiplies on the tensor
// cores. Persistent CTAs, one per SM, walk the (BM x 128) output tiles (BM =
// 64 rows of x below M = 128, 128 from there; 256 for bf16 x where the plan
// finds that it takes fewer rounds of tiles), each over its range of K
// stages of one 128-byte row (64 logical K rows of bf16 x, 128 of int8 x):
// - a producer warp keeps a ring of 5-8 stages (as many as shared memory
//   holds) in flight with TMA, on into the next tile while the consumers
//   write the last one: x's (BM x 128-byte) box and the stage's W rows
//   (N-contiguous), both with the 128-byte swizzle. Rows past M and
//   columns past K or N arrive as zeros. A stage's x columns are
//   contiguous; under grouped int4 they lie in one half of one 256-row
//   group, so its W rows are one nibble of as many packed byte rows, each
//   loaded once per nibble (the second time mostly from L2): no permuted
//   copy of x is made.
// - bf16 x: out^T = W^T x^T. Each consumer warpgroup takes 64 of the 128
//   columns of W as wgmma's A operand in registers: ldmatrix.trans of the
//   stage's W bytes, converted to bf16 in registers (exact: |w| <= 127 fits
//   bf16's significand). x's stage is the B operand. Nothing is written
//   back to shared memory, and wgmma.m64n{256,128,64}k16.f32.bf16.bf16
//   keeps three k16 steps in flight while the next one converts.
// - int8 x (W8A8): wgmma.m64n128k32.s32.s8.s8 reads 8-bit operands from
//   shared memory K-major only, and its register fragments hold four
//   consecutive k, which ldmatrix's transposed 16-bit pairs do not give. So
//   x's stage is the A operand (one consumer warpgroup per 64 rows of x)
//   and the consumers rewrite W's stage transposed as the B operand; three
//   such tiles rotate so that one converts while wgmma reads another,
//   handed over by a proxy fence and a barrier of the consumers.
// Where a row stride is not a multiple of 16 bytes (TMA's requirement:
// bf16 x with K % 8, int8 x with K % 16, W with N % 16), the producer warp
// fills the same stage layout with predicated loads instead; the wrapper's
// plan (kernels/quant_matmul.py qmm_plan) chooses it from the shape before
// the launch. At decode sizes few tiles exist, so K is split until about one
// CTA per SM is in flight; the split partials (f32, or int32 under W8A8) go
// to a scratch buffer and qmm_splitk_sum_kernel sums them in split order,
// then applies the scales and casts: no atomics, so repeated calls are
// bit-equal. The ring, producer, consumers and kernel body live in
// qmm_tile.h, which K9 (fused_mlp.cu) builds on too.
//
// f32 activations take qmm_f32_kernel, f32 FMAs outside the tensor cores:
// wgmma has no f32 x f32 product, and one TF32 pass would not hold the f32
// tolerance, so it is bound by 2*M*K*N operations at 67 TFLOP/s. No serving
// path gives it f32 x; an int4 BERT or XLNet in f32 (models/bert.py _mm)
// does. A CTA of BM threads computes a (BM x 64) tile, 8 x 8 outputs a
// thread, BM 128 (three CTAs an SM: 384 tiles fill the SMs' slots at
// BERT-base's M4096 N768) or, below M = 128, 64:
// - each stage is 32 logical K rows: x's (BM x 128-byte) box with the
//   128-byte swizzle and W's bytes (32 rows, one nibble of 32 packed rows
//   under grouped int4, the tensor-core kernel's stage order), in a ring of
//   three stages loaded ahead of the FMAs by TMA (x with K % 4 == 0 and W
//   with N % 16 == 0) or, for other shapes, predicated 4-byte cp.async into
//   the same x layout and W rows as aligned words;
// - when a stage lands, the CTA converts its W bytes once into an f32
//   (32 x 64) tile in logical K order, instead of once per use; two tiles
//   alternate, so that stage s + 1 converts while stage s multiplies, with
//   one barrier a stage;
// - a thread reads its 8 rows of x along K as float4 (its rows share one
//   swizzle phase, so a warp's reads do not conflict) and 2 float4 of the
//   W tile a k: 4 shared-memory vector reads for 64 FMAs a k;
// - the epilogue scales the f32 sums and stores 4 outputs at a time; with
//   split K (decode sizes) the f32 partials go to qmm_splitk_sum_kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "hopper.h"
#include "launchers.h"
#include "qmm_tile.h"

namespace {

using namespace qmm_tile;

// sum the split partials in split order, then the epilogue
template <bool INTX>
__global__ void qmm_splitk_sum_kernel(const void* __restrict__ part,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ x_scales, void* __restrict__ out,
                                      int out_bf16, int M, int N, int splits) {
  using Acc = typename std::conditional<INTX, int, float>::type;
  splitk_sum(static_cast<const Acc*>(part), scales, x_scales, out, out_bf16, M, N, splits);
}

cudaError_t launch_sum(bool intx, const void* part, const float* scales, const float* x_scales,
                       void* out, int out_bf16, int M, int N, int splits, cudaStream_t stream) {
  const int blocks = sum_blocks((long long)M * N);
  if (intx)
    qmm_splitk_sum_kernel<true>
        <<<blocks, 256, 0, stream>>>(part, scales, x_scales, out, out_bf16, M, N, splits);
  else
    qmm_splitk_sum_kernel<false>
        <<<blocks, 256, 0, stream>>>(part, scales, x_scales, out, out_bf16, M, N, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the f32 mode: FMAs on (BM x 64) tiles, 8 x 8 outputs a thread, fed by an
// asynchronous ring of 32-row K stages
// ---------------------------------------------------------------------------

constexpr int F32_BK = 32;  // logical K rows per stage: one 128-byte row of x
constexpr int F32_BN = 64;  // output columns per tile
// cp.async: the aligned words that cover a W row's 64 bytes
constexpr int F32_WORDS = F32_BN / 4 + 1;
// bytes of one W row in a stage: TMA writes 64, cp.async its 17 words
template <bool TMA>
constexpr int F32_W_PITCH = TMA ? F32_BN : 80;

// BM 128: three CTAs an SM (12 warps); BM 64 (below M = 128): four (8
// warps). Shared memory: the ring's x stages (BM x 128 bytes, 128-byte
// swizzle), its W stages, two converted W tiles (32 x 64 f32) and the
// ring's full barriers.
template <int BM>
struct F32Cfg {
  static constexpr int THREADS = BM;  // BM / 8 rows of threads by 8 columns
  static constexpr int TY = BM / 8;   // a thread's rows: ty + TY i, i < 8
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = BM == 128 ? 3 : 4;
  // 4-k blocks a pass of the FMA loop, half a stage: warps of several CTAs
  // drift apart and run faster from less code than from a whole stage
  static constexpr int UNROLL = 4;
  static constexpr int X_STAGE = BM * 128;
  static constexpr int W_STAGE = F32_BK * F32_W_PITCH<false>;
  static constexpr int WF = F32_BK * F32_BN * 4;
  static constexpr int W_AT = STAGES * X_STAGE;
  static constexpr int WF_AT = W_AT + STAGES * W_STAGE;
  static constexpr int BAR_AT = WF_AT + 2 * WF;
  static constexpr int SMEM = BAR_AT + 8 * STAGES + 1024;  // + room to align to 1 KB
  static_assert(TY % 8 == 0, "a thread's rows share their swizzle phase");
};

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

// the cp.async loader: stage t into the layout TMA writes for x (zeros past
// M and K), and each W row's 64 bytes from column n0 as the 17 aligned words
// that cover them (zeros past the array), so that any N works
template <int BITS, int BM>
__device__ __forceinline__ void load_f32_stage(uint8_t* xs, uint8_t* ws, const F32Args& g,
                                               int m0, int n0, int t, int tid) {
  using C = F32Cfg<BM>;
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
  for (int e = tid; e < F32_BK * F32_WORDS; e += C::THREADS) {
    const int r = e / F32_WORDS, c = e % F32_WORDS;
    const long long word = (((long long)(wr + r) * g.N + n0) >> 2) + c;
    const long long left = total - 4 * word;
    const int bytes = left >= 4 ? 4 : left > 0 ? static_cast<int>(left) : 0;
    cp_async4(smem_u32(ws + r * F32_W_PITCH<false> + 4 * c), bytes ? g.w + 4 * word : g.w,
              bytes);
  }
}

// W's stage into f32 in logical K order (nibbles sign-extended), once per
// CTA: a warp reads two rows' words and writes their 128 values; each
// thread converts the same column word of THREADS / 16-row-apart rows,
// unrolled, so that the step costs little beside the stage's FMAs
template <int BITS, int BM, bool TMA>
__device__ __forceinline__ void convert_f32_stage(const uint8_t* ws, float* wf, const F32Args& g,
                                                  int n0, int t, int tid) {
  constexpr int STEP = F32Cfg<BM>::THREADS / 16;
  static_assert(F32_BN / 4 == 16 && F32_BK % STEP == 0, "half a warp a row, a thread a word");
  const int h = nibble_of<BITS, F32_BK>(t), c = tid % 16, r0 = tid / 16;
  // cp.async: row r's first byte sat (its offset in W) % 4 into its first word
  const long long first = (long long)(w_row<BITS, F32_BK>(t) + r0) * g.N + n0;
#pragma unroll
  for (int u = 0; u < F32_BK / STEP; ++u) {
    const int r = r0 + STEP * u;
    const uint32_t* row = reinterpret_cast<const uint32_t*>(ws + r * F32_W_PITCH<TMA>);
    uint32_t v = row[c];
    if (!TMA)
      v = __funnelshift_r(v, row[c + 1],
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

// One (BM x 64) output tile over its split's K stages. Thread (tx, ty)
// holds rows m0 + ty + TY i and columns n0 + 4 tx + 32 h + [0, 4). Stage j
// goes to ring slot j % STAGES, STAGES - 1 stages ahead of the FMAs; W's
// stage j + 1 converts into one W tile while the FMAs read stage j's in the
// other; one barrier a stage. Writes through the epilogue when there is one
// split, else its f32 partial to part[split][M][N].
template <int BITS, int BM, bool TMA>
__global__ void __launch_bounds__(F32Cfg<BM>::THREADS, F32Cfg<BM>::MIN_BLOCKS)
    qmm_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const F32Args g) {
  using C = F32Cfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + C::BAR_AT);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int n0 = blockIdx.x * F32_BN, m0 = blockIdx.y * BM;
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
        tma_2d(smem_u32(x_stage(j)), &xmap, bar, (t0 + j) * F32_BK, m0);
        tma_2d(smem_u32(w_stage(j)), &wmap, bar, n0, w_row<BITS, F32_BK>(t0 + j));
      }
    } else {
      if (j < nk) load_f32_stage<BITS, BM>(x_stage(j), w_stage(j), g, m0, n0, t0 + j, tid);
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
  convert_f32_stage<BITS, BM, TMA>(w_stage(0), w_tile(0), g, n0, t0, tid);
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
      convert_f32_stage<BITS, BM, TMA>(w_stage(it + 1), w_tile(it + 1), g, n0, t0 + it + 1, tid);
    fma_f32_stage<BM>(x_stage(it), w_tile(it), tx, ty, acc);
  }

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
      const float v[4] = {acc[i][4 * h] * s[0], acc[i][4 * h + 1] * s[1], acc[i][4 * h + 2] * s[2],
                          acc[i][4 * h + 3] * s[3]};
      store4(dst, bf16, (long long)m * g.N + n, v, count, vec);
    }
  }
}

template <int BITS, int BM, bool TMA>
cudaError_t launch_f32_tiles(const F32Args& g, int splits, cudaStream_t stream) {
  using C = F32Cfg<BM>;
  const auto kernel = qmm_f32_kernel<BITS, BM, TMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap xmap{}, wmap{};  // left zero for the cp.async loader, which reads none
  if (TMA && !(encode_2d(&xmap, g.x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, g.M, g.K, F32_BK, BM,
                         CU_TENSOR_MAP_SWIZZLE_128B) &&
               encode_2d(&wmap, g.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                         BITS == 4 ? g.K / 2 : g.K, g.N, F32_BN, F32_BK,
                         CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  const dim3 grid((g.N + F32_BN - 1) / F32_BN, (g.M + BM - 1) / BM, splits);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(xmap, wmap, g);
  return cudaGetLastError();
}

template <int BITS, int BM>
cudaError_t launch_f32_loader(bool tma, const F32Args& g, int splits, cudaStream_t stream) {
  return tma ? launch_f32_tiles<BITS, BM, true>(g, splits, stream)
             : launch_f32_tiles<BITS, BM, false>(g, splits, stream);
}

template <int BITS>
cudaError_t launch_f32_rows(int bm, bool tma, const F32Args& g, int splits, cudaStream_t stream) {
  if (bm == 64) return launch_f32_loader<BITS, 64>(tma, g, splits, stream);
  if (bm == 128) return launch_f32_loader<BITS, 128>(tma, g, splits, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_f32(int bits, int bm, bool tma, const F32Args& g, int splits,
                       cudaStream_t stream) {
  cudaError_t err = bits == 8   ? launch_f32_rows<8>(bm, tma, g, splits, stream)
                    : bits == 4 ? launch_f32_rows<4>(bm, tma, g, splits, stream)
                                : cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  return launch_sum(false, g.part, g.scales, nullptr, g.out, g.out_bf16, g.M, g.N, splits,
                    stream);
}

// ---------------------------------------------------------------------------
// the tensor-core kernel (qmm_tile.h): TMA ring, W converted on its way to wgmma
// ---------------------------------------------------------------------------

template <bool S8, int BITS, int BM>
__global__ void __launch_bounds__(Cfg<S8, BITS, BM>::THREADS, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Args g) {
  wgmma_body<S8, BITS, BM, false>(&xmap, &wmap, nullptr, g);
}

template <bool S8, int BITS, int BM>
cudaError_t launch_tc(Args g, cudaStream_t stream) {
  cudaError_t err = launch_wgmma<S8, BITS, BM, false>(qmm_wgmma_kernel<S8, BITS, BM>, g, stream);
  if (err != cudaSuccess || g.splits == 1) return err;
  return launch_sum(S8, g.part, g.scales, g.x_scales, g.out, g.out_bf16, g.M, g.N, g.splits,
                    stream);
}

template <bool S8, int BITS>
cudaError_t by_rows(int bm, const Args& g, cudaStream_t stream) {
  if (bm == 64) return launch_tc<S8, BITS, 64>(g, stream);
  if (bm == 128) return launch_tc<S8, BITS, 128>(g, stream);
  if constexpr (!S8)  // W8A8 would need four consumer warpgroups
    if (bm == 256) return launch_tc<S8, BITS, 256>(g, stream);
  return cudaErrorInvalidValue;
}

template <bool S8>
cudaError_t by_shape(int bits, int bm, const Args& g, cudaStream_t stream) {
  if (bits == 8) return by_rows<S8, 8>(bm, g, stream);
  if (bits == 4) return by_rows<S8, 4>(bm, g, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fasn_qmm_stage_k(int x_dtype) {
  return x_dtype == 0 ? F32_BK : x_dtype == 1 ? Cfg<false, 8, 64>::BK : Cfg<true, 8, 64>::BK;
}

extern "C" int fasn_qmm_f32_layout(int bm, int* stages) {
  if (bm == 64 || bm == 128) {
    *stages = bm == 64 ? F32Cfg<64>::STAGES : F32Cfg<128>::STAGES;
    return bm == 64 ? F32Cfg<64>::SMEM : F32Cfg<128>::SMEM;
  }
  return -1;
}

extern "C" int fasn_qmm(const void* x, const float* x_scales, const void* w, const float* scales,
                        void* partial, void* out, int M, int K, int N, int x_dtype, int bits,
                        int out_dtype, int bm, int splits, int slices_per_split,
                        int use_tma, cudaStream_t stream) {
  const int n_slices = (K + fasn_qmm_stage_k(x_dtype) - 1) / fasn_qmm_stage_k(x_dtype);
  // every slice in exactly one split, and no split empty
  if (splits < 1 || slices_per_split < 1 || (long long)splits * slices_per_split < n_slices ||
      (long long)(splits - 1) * slices_per_split >= n_slices)
    return cudaErrorInvalidValue;
  const int8_t* wq = static_cast<const int8_t*>(w);
  if (x_dtype == 0) {
    const F32Args f{static_cast<const float*>(x), wq, scales, static_cast<float*>(partial), out,
                    out_dtype, M, K, N, slices_per_split};
    return launch_f32(bits, bm, use_tma != 0, f, splits, stream);
  }
  const Args g{x,   x_dtype == 2 ? x_scales : nullptr, wq, scales, nullptr, nullptr, partial,
               out, out_dtype, M, K, N, splits, slices_per_split, use_tma, 0};
  if (x_dtype == 1) return by_shape<false>(bits, bm, g, stream);
  if (x_dtype == 2) return by_shape<true>(bits, bm, g, stream);
  return cudaErrorInvalidValue;
}
