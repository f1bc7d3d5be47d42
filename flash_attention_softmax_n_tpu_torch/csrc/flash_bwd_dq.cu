// K5: softmax-N flash-attention backward, dq (with dbias and dslope), for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel _bwd_dq_kernel (flash_attention_softmax_n_tpu/
// kernels/flash_attention.py:685). With lse = log(n + sum_j exp(s_j)) from
// the forward, p = exp(s - lse) are the softmax-N probabilities and the
// backward is the standard one:
//   dp = (dout v^T) * dropmult,  ds = p (dp - delta),  delta = rowsum(dout o),
//   dq = scale * ds k,  dbias = ds,  dslope_h = sum ds * -|q + S - L - k|.
//
// What bounds it on the H100: 6 D operations per visible (query, key) pair
// (S = Q K^T, dP = dO V^T, dQ += dS K) at 989 TFLOP/s (bf16): 0.052 ms at
// the training shape B2 H32 L=S=2048 d64 causal; at B32 H16 L=S=512 d512
// causal the bytes bound it (q, k, v, dO read and dq written once, 3.35
// TB/s): 0.40 ms.
//
// bf16: flash_bwd_dq_wgmma_kernel, on the attention tile of attn_tile.h
// with Q and dO resident. One CTA takes 128 query rows of one (b, h); the
// producer warp loads Q and dO once, then keeps K and V tiles of 128 keys
// in flight with TMA, and two consumer warpgroups of 64 rows each walk
// every tile in two chunks of 64 keys: S = Q K^T and dP = dO V^T as two
// wgmma groups in flight together (A and B both K-major), the element-wise
// backward on the accumulator fragments, then dQ += dS K with dS passed
// from the fragment to A-operand registers (rounded to bf16, as the plain
// version rounds ds to k's dtype) and K read MN-major with the transpose
// bit, as K1 reads V. 64-key chunks keep S, dP (32 floats each) and dQ (16
// to 64) within the 168 registers a thread of 288 gets (ptxas: no spills
// at D 32 and 64, 96 bytes at D 128). A causal CTA walks
// only the key tiles at or left of its diagonal, masks only the chunks that
// cross it (or S, or carry a bias or ALiBi), and the heaviest query tiles
// launch first. Inputs must start on 16 bytes (TMA); the operator raises
// otherwise.
//
// bf16 at D 256 (the wrapper pads D in (128, 256] to 256):
// flash_bwd_dq_d256_kernel. A 128-row tile of D 256 is 64 KB and dQ an
// m64n256 fragment, 128 floats a thread, so the kernel above does not fit;
// this one keeps its walk over key tiles with K1's D 256 design
// (flash_fwd.cu). Q and dO stay resident as 128-row tiles (64 KB each, the
// two warpgroups' 64 rows in each box); K and V come through a two-stage
// ring of 32-key tiles (Tile<256, 32>, 16 KB each; 192 KB in all), since
// 64-key ones would pass 227 KB. A producer warpgroup drops to 40
// registers (setmaxnreg) so that the two consumer warpgroups take 232:
// dQ (128 floats), S and dP as m64n32 (16 each) and dS's A fragments fit
// without spills, and the waits give up instead of trapping (hopper.h
// mbar_wait<false>). Per tile each warpgroup issues S = Q K^T and dP = dO
// V^T as two wgmma groups in flight, forms dS on the fragments, and adds
// dS K (m64n256, K read MN-major) to dQ. The CTAs of one head run side by
// side (a flat grid), so the K and V tiles they all stream come from L2.
//
// f32 at D 32, 64 and 128: flash_bwd_dq_tf32x3_kernel (flash_bwd_f32.cu,
// a translation unit of its own, entered through fasn_flash_bwd_dq_tf32x3).
// wgmma has no f32 x f32 product and one TF32 pass keeps about 10 mantissa
// bits, but three passes on each operand's TF32 head and rest (split-TF32)
// hold f32's tolerance at 2.5x the f32 FMA peak; that file's header says
// how. f32 at D 256 and above: flash_bwd_dq_tf32x3_wide_kernel
// (flash_bwd_f32_wide.cu, entered through fasn_flash_bwd_dq_tf32x3_wide):
// the same split after a pre-pass, one CTA per 64 query rows and up to 512
// columns of dq, S and dP formed once per 512 columns.
//
// bf16 above 256 (D a multiple of 128, as the wrapper pads it):
// flash_bwd_dq_wide_wgmma_kernel. A 128-row tile over all of D would pass
// 227 KB (Q and dO alone at D 512), so D streams: one CTA takes 128 query
// rows and 128 columns of dq (the column chunks of one query tile side by
// side in a flat grid, then the head's query tiles, heaviest first), and a
// producer warpgroup at 40 registers keeps a four-slot ring of 64-column
// chunks in flight with TMA, each slot one chunk of the CTA's Q and dO rows
// and of a 64-key K and V tile (48 KB), beside two buffers of the key
// tile's K at the CTA's 128 columns (16 KB each; 224 KB in all, whatever
// D). Each consumer warpgroup (232 registers) scales its 64 rows of the Q
// chunk in place while the previous chunk's products run, and issues S +=
// Q_s K^T and dP += dO V^T (m64n64, both operands K-major) chunk after
// chunk into the same fragments, freeing a slot once the next chunk's
// group is issued; then dS on the fragments and dQ += dS K at its 128
// columns (m64n128, K read MN-major). S and dP are formed D / 128 times
// over, once per column chunk (issued products per causal pair: 14 d at D
// 384, 18 d at 512, against 6 d needed); the CTA of the first column chunk
// writes dbias and the dslope partials.
//
// Every kernel: the TPU's dslope accumulates over a sequential grid; here
// each thread sums its rows' terms over the sweep and the kernel writes one
// partial per query row, which the wrapper sums in a fixed order: no
// atomics, so two calls give bit-identical results. Keys a row never
// visits (causally invisible tiles) get zero dbias. Scores are formed
// exactly as K1 forms them (flash_common.h), q scaled in q's dtype.
//
// lse is clamped at DEAD_LSE, so a row with no visible key (n == 0, L > S,
// lse == NEG_INF) gets p = 0 and zero gradients. Query rows past L and keys
// past S are masked in the tile, so nothing is padded, and a caller's
// global lse (flash_attention_block_grads) works the same way.

#include <climits>

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

// ---------------------------------------------------------------------------
// bf16: TMA and wgmma (attn_tile.h)
// ---------------------------------------------------------------------------

constexpr int KC = 64;  // keys of a chunk

template <int D>
__global__ void __launch_bounds__(attn::THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float scale, __nv_bfloat16* __restrict__ dq,
                              float* __restrict__ dbias, float* __restrict__ dslope_rows) {
  using namespace attn;
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const Ring<D, 2> r = make_ring<D, 2>(smem_raw);  // resident: Q, dO
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + TQ, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + TK - 1) / TK : 0;
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[2] = {&qmap, &domap};
      produce<D, 2>(r, res, q0, &kmap, &vmap, bh, 0, tiles, 0);
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
  const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);
  const bool plain = mods.bias == nullptr && !mods.alibi;

  // per fragment row: lse (clamped) in log2 units, delta, the dslope sum
  float lse2[2], dl[2], dsl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + g + 8 * i;
    lse2[i] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
    dl[i] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
    dsl[i] = 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (tiles > 0) {
    mbar_wait(r.q_full(), 0);
    scale_q_rows<D>(r.mem, wg, a.scale_q);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }

  // the chunks a warpgroup computes are a prefix of the keys: `done` ends it
  int done = 0, stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    mbar_wait(r.full_k(stage), phase);
    mbar_wait(r.full_v(stage), phase);
#pragma unroll 1
    for (int c = 0; c < TK / KC; ++c) {
      const int k0 = it * TK + c * KC;
      // no row of the warpgroup sees a key of this chunk: skip it
      if (row0 >= L || k0 >= S || (mods.causal && k0 > row0 + 63 + off)) continue;
      done = k0 + KC;
      const uint32_t kc = r.k(stage) + c * KC * T::ROW, vc = r.v(stage) + c * KC * T::ROW;
      float s[KC / 2], dp[KC / 2];
      qk_async<D>(s, r.q() + wg * 64 * T::ROW, kc);
      qk_async<D>(dp, r.res(1) + wg * 64 * T::ROW, vc);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // masks, bias and ALiBi only where a key is past S or a diagonal
      if (!plain || k0 + KC > S || (mods.causal && k0 + KC - 1 > row0 + off)) {
#pragma unroll
        for (int e = 0; e < KC / 2; ++e)
          s[e] = mods(s[e], row0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
      }
#pragma unroll
      for (int e = 0; e < KC / 2; ++e) {
        const int i = (e / 2) % 2, qi = row0 + g + 8 * i, kj = k0 + 8 * (e / 4) + c0 + e % 2;
        const float p = exp2f(fmaf(s[e], LOG2E, -lse2[i]));
        const float d = drop.on ? dp[e] * drop(b, h, qi, kj) : dp[e];
        const float ds = p * (d - dl[i]);
        if (dbias && qi < L && kj < S) dbias[((long long)bh * L + qi) * S + kj] = ds;
        if (mods.alibi) dsl[i] += ds * -fabsf((float)(qi + off - kj));
        s[e] = ds;
      }
      uint32_t f[KC / 16][4];
      to_a_frags(s, f);
      pv_async<D>(acc, f, kc);
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (t == 0) mbar_arrive(r.empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = min(64, L - row0);
  if (valid <= 0) return;
  // keys the warpgroup never visited are causally invisible: zero dbias
  if (dbias) {
    const int from = min(done, S), width = S - from;
    for (int e = t; e < valid * width; e += 128)
      dbias[((long long)bh * L + row0 + e / width) * S + from + e % width] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float row = quad_sum(dsl[i]);
    if (dslope_rows && t % 4 == 0 && g + 8 * i < valid)
      dslope_rows[(long long)bh * L + row0 + g + 8 * i] = row;
  }
  store_rows<D>(acc, dq + ((long long)bh * L + row0) * D, valid,
                [&](int, float x) { return scale * x; });
}

template <int D>
cudaError_t launch_wgmma(const FasnAttn& a, const void* dout, const float* lse,
                         const float* delta, float scale, void* dq, float* dbias,
                         float* dslope_rows, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<D, 2>::SMEM);
  if (err != cudaSuccess) return err;
  AttnMaps m{};
  if (!encode_attn(&m, a, D, dout)) return cudaErrorInvalidValue;
  kernel<<<tile_grid((long long)a.B * a.H, a.L), attn::THREADS, Ring<D, 2>::SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, scale, static_cast<__nv_bfloat16*>(dq), dbias,
      dslope_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D 256: 32-key ring tiles, a producer warpgroup, setmaxnreg
// ---------------------------------------------------------------------------

constexpr int D256_KT = 32;  // keys of a ring tile
constexpr int D256_THREADS = attn::CONSUMERS + 128;
// resident: Q and dO, 128 rows each (64 KB each); each slot: 32-key K and V
// tiles (16 KB each)
using D256Ring = attn::Ring<256, 2, D256_KT, attn::TQ>;

__global__ void __launch_bounds__(D256_THREADS, 1)
    flash_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float scale, __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ dbias, float* __restrict__ dslope_rows) {
  using namespace attn;
  constexpr int D = 256, KT = D256_KT;
  using RT = Tile<D>;  // Q's and dO's 128-row tiles
  extern __shared__ uint8_t smem_raw[];
  const D256Ring r = make_ring<D, 2, KT, TQ>(smem_raw);
  // a flat grid, a head's query tiles side by side (the heaviest, last,
  // first): CTAs that run together stream the same K and V tiles, which L2
  // then serves
  const int n_q = (a.L + TQ - 1) / TQ;
  const int bh = blockIdx.x / n_q, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * TQ;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + TQ, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + KT - 1) / KT : 0;
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[2] = {&qmap, &domap};
      produce<D, 2, KT, false>(r, res, q0, &kmap, &vmap, bh, 0, tiles, 0);
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
    const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
    const ScoreMods mods = score_mods(a, b, h);
    const Dropout drop = dropout_of(a);
    const bool plain = mods.bias == nullptr && !mods.alibi;

    // per fragment row: lse (clamped) in log2 units, delta, the dslope sum
    float lse2[2], dl[2], dsl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + g + 8 * i;
      lse2[i] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
      dl[i] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
      dsl[i] = 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (tiles > 0) {
      mbar_wait<false>(r.q_full(), 0);
      scale_q_rows<D>(r.mem, wg, a.scale_q);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }

    // the tiles a warpgroup computes are a prefix of the keys: `done` ends it
    int done = 0, stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * KT;
      // both loads land before the slot is released, whether used or not
      mbar_wait<false>(r.full_k(stage), phase);
      mbar_wait<false>(r.full_v(stage), phase);
      // no row of the warpgroup sees a key of this tile: skip it
      if (row0 < L && k0 < S && !(mods.causal && k0 > row0 + 63 + off)) {
        done = k0 + KT;
        float s[KT / 2], dp[KT / 2];
        qk_async<D, KT / 2, TQ, KT>(s, r.q() + wg * 64 * RT::ROW, r.k(stage));
        qk_async<D, KT / 2, TQ, KT>(dp, r.res(1) + wg * 64 * RT::ROW, r.v(stage));
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // masks, bias and ALiBi only where a key is past S or a diagonal
        if (!plain || k0 + KT > S || (mods.causal && k0 + KT - 1 > row0 + off)) {
#pragma unroll
          for (int e = 0; e < KT / 2; ++e)
            s[e] = mods(s[e], row0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
        }
#pragma unroll
        for (int e = 0; e < KT / 2; ++e) {
          const int i = (e / 2) % 2, qi = row0 + g + 8 * i, kj = k0 + 8 * (e / 4) + c0 + e % 2;
          const float p = exp2f(fmaf(s[e], LOG2E, -lse2[i]));
          const float d = drop.on ? dp[e] * drop(b, h, qi, kj) : dp[e];
          const float ds = p * (d - dl[i]);
          if (dbias && qi < L && kj < S) dbias[((long long)bh * L + qi) * S + kj] = ds;
          if (mods.alibi) dsl[i] += ds * -fabsf((float)(qi + off - kj));
          s[e] = ds;
        }
        uint32_t f[KT / 16][4];
        to_a_frags(s, f);
        pv_async<D, KT / 16, KT>(acc, f, r.k(stage));
        wgmma_wait<0>();
        fence_regs(acc);
      }
      if (t == 0) mbar_arrive(r.empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int valid = min(64, L - row0);
    if (valid > 0) {
      // keys the warpgroup never visited are causally invisible: zero dbias
      if (dbias) {
        const int from = min(done, S), width = S - from;
        for (int e = t; e < valid * width; e += 128)
          dbias[((long long)bh * L + row0 + e / width) * S + from + e % width] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float row = quad_sum(dsl[i]);
        if (dslope_rows && t % 4 == 0 && g + 8 * i < valid)
          dslope_rows[(long long)bh * L + row0 + g + 8 * i] = row;
      }
      store_rows<D>(acc, dq + ((long long)bh * L + row0) * D, valid,
                    [&](int, float x) { return scale * x; });
    }
  }
}

cudaError_t launch_d256(const FasnAttn& a, const void* dout, const float* lse,
                        const float* delta, float scale, void* dq, float* dbias,
                        float* dslope_rows, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dq_d256_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D256Ring::SMEM);
  if (err != cudaSuccess) return err;
  // q and dout in 128-row boxes, k and v in 32-row ones
  AttnMaps m{};
  const long long heads = (long long)a.B * a.H;
  if (!encode_rows(&m.q, a.q, heads, a.L, 256, TQ) ||
      !encode_rows(&m.dout, dout, heads, a.L, 256, TQ) ||
      !encode_rows(&m.k, a.k, heads, a.S, 256, D256_KT) ||
      !encode_rows(&m.v, a.v, heads, a.S, 256, D256_KT))
    return cudaErrorInvalidValue;
  const long long ctas = heads * ((a.L + TQ - 1) / TQ);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(ctas), D256_THREADS, D256Ring::SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, scale, static_cast<__nv_bfloat16*>(dq), dbias,
      dslope_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 above D 256: D in 64-column chunks through a ring, one CTA per 128
// columns of dq
// ---------------------------------------------------------------------------

constexpr int WIDE_KT = 64;      // keys of a key tile
constexpr int WIDE_STAGES = 4;   // ring slots, each one 64-column chunk
constexpr int WIDE_THREADS = attn::CONSUMERS + 128;

// Shared memory: each slot holds one 64-column chunk of the CTA's 128 Q and
// dO rows (16 KB each) and of the key tile's 64 K and V rows (8 KB each);
// then two buffers (by key tile parity) of the key tile's K at the CTA's
// 128 output columns (two 64-column boxes); then the barriers: full and
// empty per slot, kfull and kempty per K buffer.
struct DqWide {
  static constexpr int Q = 0, DO = 128 * 128, K = 2 * DO, V = K + WIDE_KT * 128;
  static constexpr int SLOT = V + WIDE_KT * 128;
  static constexpr int KOC_AT = WIDE_STAGES * SLOT, KOC = WIDE_KT * 2 * 128;
  static constexpr int BAR_AT = KOC_AT + 2 * KOC;
  static constexpr int SMEM = BAR_AT + 8 * (2 * WIDE_STAGES + 4) + 1024;
};
static_assert(DqWide::SMEM <= 232448, "K5's wide ring passes the H100's 227 KB");

__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const __grid_constant__ CUtensorMap vmap,
                                   const __grid_constant__ CUtensorMap domap, const FasnAttn a,
                                   const float* __restrict__ lse, const float* __restrict__ delta,
                                   float scale, __nv_bfloat16* __restrict__ dq,
                                   float* __restrict__ dbias, float* __restrict__ dslope_rows) {
  using namespace attn;
  using W = DqWide;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw), pad = (1024 - (raw & 1023)) & 1023;
  uint8_t* const mem = smem_raw + pad;
  const uint32_t base = raw + pad, bars = base + W::BAR_AT;
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (WIDE_STAGES + s); };
  const auto kfull = [&](int i) { return bars + 8 * (2 * WIDE_STAGES + i); };
  const auto kempty = [&](int i) { return bars + 8 * (2 * WIDE_STAGES + 2 + i); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIDE_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS / 128);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(kfull(i), 1);
      mbar_init(kempty(i), CONSUMERS / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a flat grid: a query tile's column chunks side by side, then the
  // head's query tiles (the heaviest, last, first), so that the CTAs that
  // run together stream the same chunks, which L2 then serves
  const int D = a.D, NC = D / 64, chunks = D / 128;
  const int n_q = (a.L + TQ - 1) / TQ;
  const int oc = blockIdx.x % chunks * 128;  // the CTA's first column of dq
  const int bh = blockIdx.x / chunks / n_q, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x / chunks % n_q) * TQ;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + TQ, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + WIDE_KT - 1) / WIDE_KT : 0;
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < tiles; ++it) {
        const int k0 = it * WIDE_KT, kb = it % 2;
        // K at the CTA's output columns, for dQ += dS K
        mbar_wait<false>(kempty(kb), ((it / 2) & 1) ^ 1);
        mbar_expect_tx(kfull(kb), W::KOC);
        for (int x = 0; x < 2; ++x)
          tma_3d(base + W::KOC_AT + kb * W::KOC + x * (W::KOC / 2), &kmap, kfull(kb),
                 oc + 64 * x, k0, bh);
        // the key tile's chunks over D, with the CTA's Q and dO rows
        for (int c = 0; c < NC; ++c) {
          mbar_wait<false>(empty(stage), phase ^ 1);
          const uint32_t slot = base + stage * W::SLOT;
          mbar_expect_tx(full(stage), W::SLOT);
          tma_3d(slot + W::Q, &qmap, full(stage), 64 * c, q0, bh);
          tma_3d(slot + W::DO, &domap, full(stage), 64 * c, q0, bh);
          tma_3d(slot + W::K, &kmap, full(stage), 64 * c, k0, bh);
          tma_3d(slot + W::V, &vmap, full(stage), 64 * c, k0, bh);
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
    const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
    const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
    const ScoreMods mods = score_mods(a, b, h);
    const Dropout drop = dropout_of(a);
    const bool plain = mods.bias == nullptr && !mods.alibi;
    const bool first = oc == 0;  // the column chunk that writes dbias and dslope

    // per fragment row: lse (clamped) in log2 units, delta, the dslope sum
    float lse2[2], dl[2], dsl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row0 + g + 8 * i;
      lse2[i] = qi < L ? fmaxf(lse[(long long)bh * L + qi], DEAD_LSE) * LOG2E : 0.f;
      dl[i] = qi < L ? delta[(long long)bh * L + qi] : 0.f;
      dsl[i] = 0.f;
    }
    float acc[64];  // dq at the CTA's 128 columns
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    // the tiles a warpgroup computes are a prefix of the keys: `done` ends it
    int done = 0, stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * WIDE_KT, kb = it % 2;
      // no row of the warpgroup sees a key of this tile: its chunks are
      // waited for (every load lands before its slot is released) and freed
      const bool live = row0 < L && k0 < S && !(mods.causal && k0 > row0 + 63 + off);
      if (!live) {
        for (int c = 0; c < NC; ++c) {
          mbar_wait<false>(full(stage), phase);
          if (t == 0) mbar_arrive(empty(stage));
          if (++stage == WIDE_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        mbar_wait<false>(kfull(kb), (it / 2) & 1);
        if (t == 0) mbar_arrive(kempty(kb));
        continue;
      }
      float s[WIDE_KT / 2], dp[WIDE_KT / 2];
      int prev = 0;
      for (int c = 0; c < NC; ++c) {
        mbar_wait<false>(full(stage), phase);
        const uint32_t slot = base + stage * W::SLOT;
        // Q_s: the warpgroup's 64 rows of the chunk, q * scale_q rounded to
        // bf16, while the previous chunk's products run
        scale_q_rows<64>(mem + stage * W::SLOT + W::Q, wg, a.scale_q);
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
        // S += Q_s K^T and dP += dO V^T over the chunk, one group
        wgmma_fence();
        chunk_dots(s, slot + W::Q + wg * 64 * 128, slot + W::K, c == 0);
        chunk_dots(dp, slot + W::DO + wg * 64 * 128, slot + W::V, c == 0);
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
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (t == 0) mbar_arrive(empty(prev));
      done = k0 + WIDE_KT;
      // masks, bias and ALiBi only where a key is past S or a diagonal
      if (!plain || k0 + WIDE_KT > S || (mods.causal && k0 + WIDE_KT - 1 > row0 + off)) {
#pragma unroll
        for (int e = 0; e < WIDE_KT / 2; ++e)
          s[e] = mods(s[e], row0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
      }
#pragma unroll
      for (int e = 0; e < WIDE_KT / 2; ++e) {
        const int i = (e / 2) % 2, qi = row0 + g + 8 * i, kj = k0 + 8 * (e / 4) + c0 + e % 2;
        const float p = exp2f(fmaf(s[e], LOG2E, -lse2[i]));
        const float d = drop.on ? dp[e] * drop(b, h, qi, kj) : dp[e];
        const float ds = p * (d - dl[i]);
        if (first && dbias && qi < L && kj < S) dbias[((long long)bh * L + qi) * S + kj] = ds;
        if (first && mods.alibi) dsl[i] += ds * -fabsf((float)(qi + off - kj));
        s[e] = ds;
      }
      // dQ += dS K at the CTA's columns: K read MN-major
      uint32_t f[WIDE_KT / 16][4];
      to_a_frags(s, f);
      mbar_wait<false>(kfull(kb), (it / 2) & 1);
      pv_async<128, WIDE_KT / 16, WIDE_KT>(acc, f, base + W::KOC_AT + kb * W::KOC);
      wgmma_wait<0>();
      fence_regs(acc);
      if (t == 0) mbar_arrive(kempty(kb));
    }

    const int valid = min(64, L - row0);
    if (valid > 0) {
      if (first) {
        // keys the warpgroup never visited are causally invisible: zero dbias
        if (dbias) {
          const int from = min(done, S), width = S - from;
          for (int e = t; e < valid * width; e += 128)
            dbias[((long long)bh * L + row0 + e / width) * S + from + e % width] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float row = quad_sum(dsl[i]);
          if (dslope_rows && t % 4 == 0 && g + 8 * i < valid)
            dslope_rows[(long long)bh * L + row0 + g + 8 * i] = row;
        }
      }
      store_cols<128>(acc, dq + ((long long)bh * L + row0) * D + oc, D, valid,
                      [&](float x) { return scale * x; });
    }
  }
}

cudaError_t launch_wide(const FasnAttn& a, const void* dout, const float* lse,
                        const float* delta, float scale, void* dq, float* dbias,
                        float* dslope_rows, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_bwd_dq_wide_wgmma_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DqWide::SMEM);
  if (err != cudaSuccess) return err;
  // q and dout in 128-row boxes, k and v in 64-row ones; 64 columns each
  AttnMaps m{};
  const long long heads = (long long)a.B * a.H;
  if (!encode_rows(&m.q, a.q, heads, a.L, a.D, TQ) ||
      !encode_rows(&m.dout, dout, heads, a.L, a.D, TQ) ||
      !encode_rows(&m.k, a.k, heads, a.S, a.D, WIDE_KT) ||
      !encode_rows(&m.v, a.v, heads, a.S, a.D, WIDE_KT))
    return cudaErrorInvalidValue;
  const long long ctas = heads * ((a.L + TQ - 1) / TQ) * (a.D / 128);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), WIDE_THREADS, DqWide::SMEM, stream>>>(
      m.q, m.k, m.v, m.dout, a, lse, delta, scale, static_cast<__nv_bfloat16*>(dq), dbias,
      dslope_rows);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_bwd_dq(const FasnAttn* a, const void* dout, const float* lse,
                                 const float* delta, float scale, void* dq, float* dbias,
                                 float* dslope_rows, void* scratch, cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 0 && a->dtype != 1) return cudaErrorInvalidValue;
  if (a->dtype == 0) {
    if (a->D >= 256)
      return fasn_flash_bwd_dq_tf32x3_wide(a, dout, lse, delta, scale, dq, dbias, dslope_rows,
                                           scratch, stream);
    return fasn_flash_bwd_dq_tf32x3(a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
  }
  if (wide_d(a->D)) return launch_wide(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
  switch (a->D) {
    case 32:
      return launch_wgmma<32>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
    case 64:
      return launch_wgmma<64>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
    case 128:
      return launch_wgmma<128>(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
    case 256:
      return launch_d256(*a, dout, lse, delta, scale, dq, dbias, dslope_rows, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
