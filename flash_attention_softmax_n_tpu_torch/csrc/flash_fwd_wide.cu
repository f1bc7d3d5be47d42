// K1's forward at head dims 384 and 512 in bf16 (sm_90a), for the Pallas
// forward kernels that flash_fwd.cu replaces (flash_attention_softmax_n_tpu/
// kernels/flash_attention.py:345 _fwd_single_kernel, :279 _fwd_kernel, :501
// _fwd_pipeline_kernel), with their numerics (flash_fwd.cu's header).
// flash_fwd.cu's fasn_flash_fwd calls fasn_flash_fwd_wide for bf16 at
// these D; the kernel has a translation unit of its own so that the
// instructions of flash_fwd.cu's kernels stay the ones measured before it.
//
// flash_fwd_wide_wgmma_kernel: one CTA takes 64 query rows of one (b, h)
// and all of D, so S is formed over all of D at once: 6 D operations a
// (query, key) pair over its two passes, where one CTA per 128 columns of o
// formed S D / 128 times over (10 D at D 512). A producer warpgroup (40
// registers, setmaxnreg) brings Q once (Tile<D, 64>, 48 or 64 KB) and K and
// V tiles of 32 keys through a two-stage ring (attn_tile.h WideRing:
// 181,312 / 230,464 bytes of shared memory). Two consumer warpgroups (232
// registers) work on the same 64 rows and each owns half of D: its O
// fragment is m64n192 or m64n256 (96 or 128 floats a thread, the budget
// flash_fwd_d256_kernel fits). Each scales and multiplies its own half of Q
// into a partial S (m64n32, 12 or 16 k16 steps), and the two add their
// partials through shared memory behind a named barrier (wide_scores), so
// both hold the same S and keep the same m, l and p. Masks, bias and ALiBi
// apply on the fragment as above. Two passes over the keys, as K10's
// softmax modes take them: pass 1 brings K alone and keeps each row's max,
// pass 2 forms p = exp(s - m) against the final max, sums l, drops p and
// runs O += P V over the warpgroup's half of V (one m64n{192|256}k16 wgmma
// per 16 keys, V read MN-major), then writes its columns of o; warpgroup 0
// writes lse. So p rounds to bf16 against the max the plain version rounds
// it against: an online softmax over 32-key tiles rounded more keys against
// a max that was not yet final, and on one B32 H16 L512 input at d300 its o
// lay 2.07e-3 past 2^-7 of the plain version's, where chip_smoke.check_flash
// allows 2e-3. The grid is flat, a head's query tiles side by side, so that
// L2 serves the K and V tiles they stream (with the heads side by side
// instead, each head's K and V came from device memory once for every query
// tile). What bounds it: the K and V tiles each 64-row CTA streams from L2
// (64 operations a byte, on the order of half the card's peak when every SM
// streams); 32-key tiles keep two stages in the 227 KB at D 512. (Issuing
// the next tile's S product behind the current PV in the one-pass kernel,
// with a slot's V freed apart from its K, ran 12% slower at D 384: ptxas
// serialised the wgmma.)

#include <climits>

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

// ---------------------------------------------------------------------------
// bf16 at D 384 and 512: 64 query rows and all of D a CTA, two passes
// (attn_tile.h WideRing, wide_scores)
// ---------------------------------------------------------------------------

static_assert(attn::WideRing<512>::SMEM <= 232448, "K1's wide ring passes the H100's 227 KB");

template <int D>
__global__ void __launch_bounds__(attn::WideRing<D>::THREADS, 1)
    flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                const __grid_constant__ CUtensorMap kmap,
                                const __grid_constant__ CUtensorMap vmap, const FasnAttn a,
                                float n, __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  using namespace attn;
  using W = WideRing<D>;
  constexpr int KT = W::KT, HALF = W::HALF;
  extern __shared__ uint8_t smem_raw[];
  const typename W::R r = make_ring<D, 1, KT, 64>(smem_raw);
  // a flat grid: a head's query tiles side by side (the heaviest, last,
  // first), so that the CTAs that run together stream the same K and V
  // tiles, which L2 then serves
  const int n_q = (a.L + 63) / 64;
  const int bh = blockIdx.x / n_q, b = bh / a.H, h = bh % a.H;
  const int q0 = (n_q - 1 - blockIdx.x % n_q) * 64;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + 64, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + KT - 1) / KT : 0;
  // the warpgroup's role, as a shuffled value: uniform across its warps,
  // as setmaxnreg needs
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[1] = {&qmap};
      // pass 1 brings K alone, pass 2 K and V
      produce<D, 1, KT, false, 64>(r, res, q0, &kmap, &vmap, bh, 0, 2 * tiles, tiles);
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
    const ScoreMods mods = score_mods(a, b, h);
    const Dropout drop = dropout_of(a);
    const bool plain = mods.bias == nullptr && !mods.alibi;

    if (tiles > 0) {
      // each warpgroup scales the columns of Q it multiplies
      mbar_wait<false>(r.q_full(), 0);
      scale_q_rows<HALF, 64>(r.mem + wg * W::Q_HALF, 0, a.scale_q);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
    int stage = 0, use = 0;  // use: the exchanges so far, whose parity picks the buffers
    uint32_t phase = 0;
    // the tile's scores over all of D, with masks, bias and ALiBi only where
    // a key is past S or a diagonal
    auto scores = [&](float (&s)[KT / 2], int k0) {
      wide_scores<D>(s, r.q(), r.k(stage), r.mem + W::X_AT, wg, use++ & 1);
      if (!plain || k0 + KT > S || (mods.causal && k0 + KT - 1 > q0 + off)) {
#pragma unroll
        for (int e = 0; e < KT / 2; ++e)
          s[e] = mods(s[e], q0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
      }
    };
    auto release = [&]() {
      if (t == 0) mbar_arrive(r.empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    // pass 1: each row's max over its keys (and the phantom key's 0 at n > 0)
    float m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = n > 0.f ? 0.f : NEG_INF;
    for (int it = 0; it < tiles; ++it) {
      mbar_wait<false>(r.full_k(stage), phase);
      float s[KT / 2];
      scores(s, it * KT);
#pragma unroll
      for (int i = 0; i < 2; ++i) m[i] = fmaxf(m[i], row_max(s, i));
      release();
    }

    // pass 2: p = exp(s - m) against the final max, l, dropout, O += P V
    float l[2], acc[HALF / 2];  // acc: o at the warpgroup's HALF columns
#pragma unroll
    for (int i = 0; i < 2; ++i)  // the phantom key's n exp(-m), counted once in the quad
      l[i] = t % 4 == 0 && n > 0.f ? n * exp_fast(-m[i]) : 0.f;
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * KT;
      mbar_wait<false>(r.full_k(stage), phase);
      float s[KT / 2];
      scores(s, k0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + g + 8 * i;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float p = exp_fast(s[4 * j + 2 * i + c] - m[i]);
            l[i] += p;  // the denominator takes the undropped p
            if (drop.on) p *= drop(b, h, qi, k0 + 8 * j + c0 + c);
            s[4 * j + 2 * i + c] = p;
          }
      }
      uint32_t p[KT / 16][4];
      to_a_frags(s, p);
      mbar_wait<false>(r.full_v(stage), phase);
      pv_async<HALF, KT / 16, KT>(acc, p, r.v(stage) + wg * W::KV_HALF);
      wgmma_wait<0>();
      fence_regs(acc);
      release();
    }

    const int valid = min(64, L - q0);
    float lf[2];
    bool dead[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lf[i] = quad_sum(l[i]);
      dead[i] = n == 0.f && (lf[i] == 0.f || m[i] == NEG_INF);
#pragma unroll
      for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[4 * j + 2 * i + c] = dead[i] ? 0.f : acc[4 * j + 2 * i + c] / lf[i];
    }
    store_cols<HALF>(acc, o + ((long long)bh * L + q0) * D + wg * HALF, D, valid,
                     [](float x) { return x; });
    if (wg == 0 && t % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (g + 8 * i < valid)
          lse[(long long)bh * L + q0 + g + 8 * i] = dead[i] ? NEG_INF : m[i] + logf(lf[i]);
    }
  }
}

template <int D>
cudaError_t launch_wide_wgmma(const FasnAttn& a, float n, void* o, float* lse,
                              cudaStream_t stream) {
  using W = attn::WideRing<D>;
  auto kernel = flash_fwd_wide_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W::SMEM);
  if (err != cudaSuccess) return err;
  // q in 64-row boxes, k and v in KT-row ones
  attn::AttnMaps m{};
  const long long heads = (long long)a.B * a.H;
  if (!attn::encode_rows(&m.q, a.q, heads, a.L, D, 64) ||
      !attn::encode_rows(&m.k, a.k, heads, a.S, D, W::KT) ||
      !attn::encode_rows(&m.v, a.v, heads, a.S, D, W::KT))
    return cudaErrorInvalidValue;
  const long long ctas = heads * ((a.L + 63) / 64);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (ctas == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(ctas), W::THREADS, W::SMEM, stream>>>(
      m.q, m.k, m.v, a, n, static_cast<__nv_bfloat16*>(o), lse);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_fwd_wide(const FasnAttn* a, float n, void* o, float* lse,
                                   cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 1) return cudaErrorInvalidValue;
  switch (a->D) {
    case 384:
      return launch_wide_wgmma<384>(*a, n, o, lse, stream);
    case 512:
      return launch_wide_wgmma<512>(*a, n, o, lse, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
