// K1 in f32 at head dims 32, 64 and 128, for Hopper (sm_90a): the
// split-TF32 ("3xTF32") TMA + wgmma kernel flash_fwd_tf32x3_kernel. It
// replaces, for f32 inputs at those head dims, the Pallas forward kernels
// _fwd_single_kernel, _fwd_kernel and _fwd_pipeline_kernel
// (flash_attention_softmax_n_tpu/kernels/flash_attention.py:345, :279,
// :501) and computes what flash_fwd.cu's kernels compute (its header): the
// scale folded into q in f32, the f32 bias and then the ALiBi term added
// before causal or rectangular causal masking (flash_common.h), the +n as
// a phantom key (m = 0, l = n), l summing the undropped p, p then times the
// dropout multiplier of its global (b, h, q, k), o and lse out, and at n ==
// 0 a row with no visible key o = 0, lse = NEG_INF. fasn_flash_fwd calls
// fasn_flash_fwd_tf32x3 for f32 at D 32, 64 and 128 (f32 at D 256 and above
// takes flash_fwd_tf32x3_wide_kernel, flash_fwd_f32_wide.cu); the kernel has
// a translation unit of its own so that flash_fwd.cu's kernels compile as
// before.
//
// The split and the transposed layout are tf32x3.h's (K5's and K6's
// pieces): each product takes three TF32 passes on its operands' heads,
// rounded to nearest, and rests.
//
// What bounds it on the H100: 3 x 4 D TF32 operations per visible (query,
// key) pair at 495 TFLOP/s: 0.052 ms at train_agreement's B2 H32 L=S=1024
// d64 causal (f32 FMAs, 4 D at 67 TFLOP/s: 0.128).
//
// The design. A CTA is one consumer warpgroup of 64 query rows and a
// producer warp: Q_s (q times the scale) and its rest stay resident (64 D x
// 8 bytes), and the producer keeps KT-key K and V tiles in flight in a ring
// of STAGES slots with TMA. Per key tile the warpgroup
//   - splits K (head in place, rest beside it) and writes V's head and rest
//     transposed (F32Tile<KT, D>: TF32 wgmma has no transpose bit, and O +=
//     P V contracts over keys, so V takes the place of K5's transposed K);
//   - issues S = Q_s K^T as one group, both operands K-major as TMA lands
//     them: rest x head and head x rest into an accumulator of their own,
//     then head x head, added in f32; the ring slot is free once they are
//     done (the rests and V^T are copies);
//   - runs the online softmax on the S fragment, as the bf16 kernel does
//     (row statistics over a quad of lanes, masks and score modifiers only
//     on tiles that cross S or the diagonal), rescales o by alpha;
//   - passes P, head and rest, to the A operand from registers
//     (split_frags) and takes P V per 64 output columns into a fresh
//     accumulator that f32 adds to o (add_tile_product; one accumulator
//     over a whole sweep drifted 10x past the split's error in K5).
// Two warpgroup barriers a tile: one before the split (every warp is done
// with the previous tile's copies), one after it. At D 32 / 64 / 128: KT 64
// / 32 / 64 keys, 2 / 2 / 1 stages, 74,800 / 91,184 / 230,432 bytes, three /
// two / one CTAs an SM. On an H100 at B2 H32 L=S=1024 causal these ran
// 11% (D 32: three CTAs against two) and 15% (D 128: 64-key tiles, one
// stage, against 32-key tiles in two) faster than the other tilings tried;
// at D 64 64-key tiles (one CTA) and 16-key tiles (three) ran 39% and 19%
// slower, a third stage the same. The grid is flat, every head's heaviest
// (last, under the causal mask) query tile first. o sums in registers over
// the sweep: no atomics, no split over the keys, repeat calls bit-equal.
// Registers a thread (ptxas, sm_90a), D 32 / 64 / 128: 128 (8 bytes
// spilled) / 133 / 236.
// Inputs must start on 16 bytes (TMA); the operator raises otherwise.

#include <climits>

#include "tf32x3.h"
#include "flash_common.h"

namespace fasn {
namespace {

using namespace attn;

// V's tile of R keys x D columns as TMA landed it (F32Tile<D, R> at `src`,
// generic addresses), its heads and rests written transposed into `thi` and
// `tlo` (F32Tile<R, D>: row = column of src, K position k8_slot(key)), as
// split_tile writes them; `src` is left as it landed
template <int D, int R>
__device__ __forceinline__ void split_transposed(const uint8_t* src, uint8_t* thi, uint8_t* tlo,
                                                 int t) {
  using T = F32Tile<D, R>;
  using TT = F32Tile<R, D>;
  constexpr int CHUNKS = R * D / 4;
  static_assert(CHUNKS % 128 == 0, "split_transposed: whole chunks a thread");
#pragma unroll 4
  for (int n = 0; n < CHUNKS / 128; ++n) {
    const int i = t + 128 * n, r = i % R, c = i / R * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + T::at(r, c));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const int k = k8_slot(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_head(xs[e]);
      const uint32_t ot = TT::at(c + e, k);
      *reinterpret_cast<float*>(thi + ot) = h;
      *reinterpret_cast<float*>(tlo + ot) = xs[e] - h;
    }
  }
}

// Shared memory: resident Q_s and its rest (64 rows); the ring's slots of a
// K and a V tile (KT keys each, as landed; K's head written in place); K's
// rest and V^T's head and rest (one set: they are rewritten each tile); the
// barriers: q_full, full and empty per slot; the tiles' base (shared_word).
template <int D, int KT, int STAGES>
struct FwdTf32 {
  using Res = F32Tile<D, 64>;
  using KV = F32Tile<D, KT>;
  using VTr = F32Tile<KT, D>;
  static constexpr int Q = 0, Q_LO = Res::TILE;
  static constexpr int RING = 2 * Res::TILE, SLOT = 2 * KV::TILE;
  static constexpr int K_LO = RING + STAGES * SLOT;
  static constexpr int VT_HI = K_LO + KV::TILE, VT_LO = VT_HI + VTr::TILE;
  static constexpr int BAR_AT = VT_LO + VTr::TILE;
  static constexpr int BASE_AT = BAR_AT + 8 * (1 + 2 * STAGES);
  static constexpr int SMEM = BASE_AT + 8 + 1024;
  static_assert(SMEM <= 232448, "K1's split-TF32 tiles pass the H100's 227 KB");
};

template <int D, int KT, int STAGES, int CTAS>
__global__ void __launch_bounds__(TF_THREADS, CTAS)
    flash_fwd_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, const FasnAttn a, float n,
                            float* __restrict__ o, float* __restrict__ lse) {
  using Y = FwdTf32<D, KT, STAGES>;
  using Res = typename Y::Res;
  using KV = typename Y::KV;
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
      mbar_init(empty(s), 4);  // each consumer warp, once past the S products
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // a flat grid: every head's last query tile (the heaviest under the
  // causal mask) first, then every head's next
  const int heads = a.B * a.H, n_q = (a.L + 63) / 64;
  const int bh = blockIdx.x % heads, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x / heads) * 64;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + 64, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + KT - 1) / KT : 0;
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128 && tiles > 0) {
      mbar_expect_tx(q_full, Res::TILE);
      for (int x = 0; x < Res::BOXES; ++x)
        tma_3d(base + Y::Q + x * Res::BOX, &qmap, q_full, 32 * x, q0, bh);
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

  float m[2], l[2], acc[D / 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = n > 0.f ? 0.f : NEG_INF;
    l[i] = t % 4 == 0 ? n : 0.f;  // the quad's partial sums; n counted once
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (tiles > 0) {
    // Q_s = q * scale_q in place and its rest (published by the first
    // tile's barrier)
    mbar_wait(q_full, 0);
    split_tile<D, 64, false, true>(mem + Y::Q, mem + Y::Q_LO, nullptr, nullptr, a.scale_q, t);
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * KT;
    const uint32_t tb = shared_word(base + Y::BASE_AT);  // = base
    const uint32_t kt = tb + Y::RING + stage * Y::SLOT, vt = kt + KV::TILE;
    mbar_wait(full(stage), phase);
    // every warp is done with the previous tile's rest and V^T
    consumers_sync();
    split_tile<D, KT, false, false>(mem + (kt - tb), mem + Y::K_LO, nullptr, nullptr, 1.f, t);
    split_transposed<D, KT>(mem + (vt - tb), mem + Y::VT_HI, mem + Y::VT_LO, t);
    fence_proxy_async();
    consumers_sync();

    // S = Q_s K^T: the heads' product, and the cross products in an
    // accumulator of their own, added in f32
    float s[KT / 2], s_x[KT / 2];
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) s[e] = s_x[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int st = 0; st < D / 8; ++st) {
      wgmma_tf32(s_x, Res::desc(tb + Y::Q_LO, st), KV::desc(kt, st));
      wgmma_tf32(s_x, Res::desc(tb + Y::Q, st), KV::desc(tb + Y::K_LO, st));
    }
#pragma unroll
    for (int st = 0; st < D / 8; ++st) wgmma_tf32(s, Res::desc(tb + Y::Q, st), KV::desc(kt, st));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(s_x);
#pragma unroll
    for (int e = 0; e < KT / 2; ++e) s[e] += s_x[e];
    // the slot is free: K's rest and V^T are copies
    if (t % 32 == 0) mbar_arrive(empty(stage));

    // masks, bias and ALiBi only where a key is past S or a diagonal
    if (!plain || k0 + KT > S || (mods.causal && k0 + KT - 1 > q0 + off)) {
#pragma unroll
      for (int e = 0; e < KT / 2; ++e)
        s[e] = mods(s[e], q0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = q0 + g + 8 * i;
      const float m_new = fmaxf(m[i], row_max(s, i));
      const float alpha = exp_fast(m[i] - m_new);
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
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * i] *= alpha;
        acc[4 * j + 2 * i + 1] *= alpha;
      }
    }

    // O += P V: P from the fragment (A), V^T's head and rest (B)
    uint32_t fh[KT / 8][4], fl[KT / 8][4];
    split_frags(s, fh, fl);
    add_tile_product<D, KT>(acc, fh, fl, tb + Y::VT_HI, tb + Y::VT_LO);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = min(64, L - q0);
  float lf[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lf[i] = quad_sum(l[i]);
    dead[i] = n == 0.f && (lf[i] == 0.f || m[i] == NEG_INF);
  }
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    const int i = (e / 2) % 2;
    acc[e] = dead[i] ? 0.f : acc[e] / lf[i];
  }
  store_f32_rows(acc, o + ((long long)bh * L + q0) * D, valid, 1.f);
  if (t % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (g + 8 * i < valid)
        lse[(long long)bh * L + q0 + g + 8 * i] = dead[i] ? NEG_INF : m[i] + logf(lf[i]);
  }
}

// CTAS: the CTAs an SM holds, which caps the registers a thread
template <int D, int KT, int STAGES, int CTAS>
cudaError_t launch_fwd(const FasnAttn& a, float n, void* o, float* lse, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32x3_kernel<D, KT, STAGES, CTAS>;
  constexpr int smem = FwdTf32<D, KT, STAGES>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // q in 64-row boxes, k and v in KT-row ones, 32 columns each
  AttnMaps m{};
  const long long heads = (long long)a.B * a.H;
  if (!encode_rows(&m.q, a.q, heads, a.L, D, 64, true) ||
      !encode_rows(&m.k, a.k, heads, a.S, D, KT, true) ||
      !encode_rows(&m.v, a.v, heads, a.S, D, KT, true))
    return cudaErrorInvalidValue;
  const long long ctas = heads * ((a.L + 63) / 64);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), TF_THREADS, smem, stream>>>(m.q, m.k, m.v, a, n,
                                                                   static_cast<float*>(o), lse);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_fwd_tf32x3(const FasnAttn* a, float n, void* o, float* lse,
                                     cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 0) return cudaErrorInvalidValue;
  switch (a->D) {
    case 32:
      return launch_fwd<32, 64, 2, 3>(*a, n, o, lse, stream);
    case 64:
      return launch_fwd<64, 32, 2, 2>(*a, n, o, lse, stream);
    case 128:
      return launch_fwd<128, 64, 1, 1>(*a, n, o, lse, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
