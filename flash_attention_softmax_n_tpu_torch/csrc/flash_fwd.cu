// K1: softmax-N flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas forward kernels _fwd_single_kernel, _fwd_kernel and
// _fwd_pipeline_kernel (flash_attention_softmax_n_tpu/kernels/
// flash_attention.py:345, :279, :501): three TPU tilings of one function,
//   o = dropout(softmax_n(q k^T * scale + bias - alibi)) v,
//   lse = log(n + sum_j exp(s_j)).
// The +n enters as a phantom key with score 0 and value 0: the online
// softmax starts from m = 0, l = n (n > 0) instead of m = NEG_INF, l = 0.
//
// What bounds it on the H100: 4 D operations per visible (query, key) pair
// at 989 TFLOP/s (bf16). At B2 H32 L=S=2048 d64 causal that is 0.0348 ms
// (the exp unit, 16 results a clock per SM, needs about 0.03 ms for the
// 134M exponentials: it co-limits at d64); at the serving prefill's B16
// H32 L=S=128 with the engine's f32 mask the bytes bound it, 0.0104 ms
// (the (B, 1, L, S) mask is most of them).
//
// bf16: flash_fwd_wgmma_kernel, on the attention tile of attn_tile.h. One
// CTA takes 128 query rows of one (b, h); a producer warp keeps K and V
// tiles of 128 keys in flight with TMA while two consumer warpgroups, 64
// rows each, run S = Q K^T and O += P V on the tensor cores (wgmma), with P
// passed from the S accumulator to the A operand in registers, so scores
// never leave the SM and shared memory holds only Q, K and V. The softmax
// runs on the accumulator fragment: row statistics reduce over a quad of
// lanes. The two warpgroups run independently, so one's softmax overlaps
// the other's products. A causal CTA walks only the key tiles at or left of
// its diagonal and masks only those that cross it; the heaviest query
// tiles launch first. Inputs must start on 16 bytes (TMA); the operator
// raises otherwise.
//
// bf16 at D 256: flash_fwd_d256_kernel. A 128-row tile of D 256 is 64 KB
// and an m64n256 O fragment 128 floats a thread, so attn_tile.h's ring of
// 128-row tiles and its 168-register threads do not fit. Every tile here
// has 64 rows (Tile<256, 64>: four 64-column boxes with the 128-byte
// swizzle, 32 KB): Q as the two warpgroups' tiles, then K and V tiles of 64
// keys in a two-stage ring (64 + 2 x 64 = 192 KB). The producer is a whole
// warpgroup that gives registers back with setmaxnreg (40 a thread) so
// that the two consumer warpgroups take 232 (2 x 128 x 232 + 128 x 40 =
// 64,512 of 65,536): O (128 floats), S = Q K^T as m64n64 (32) and P's A
// fragments (16) stay in registers, and ptxas spills nothing. (Its waits
// give up instead of trapping, hopper.h mbar_wait<false>: with a trap
// block shared by both roles ptxas held every thread at the launch's 168
// registers and spilled; and one m64n64 product for the tile's S ran
// faster than two m64n32 halves.) Each warpgroup
// walks the keys as K1's other bf16 kernel does (one wgmma group for S, the
// softmax on the fragment, one for O += P V with V read MN-major), and the
// two overlap each other.
//
// f32 at D 32, 64 and 128: flash_fwd_tf32x3_kernel (flash_fwd_f32.cu, a
// translation unit of its own, entered through fasn_flash_fwd_tf32x3):
// wgmma has no f32 x f32 product, but three TF32 passes on each operand's
// rounded head and rest hold f32's tolerance (tf32x3.h), as K5's and K6's
// f32 kernels showed. f32 at D 256 and above: flash_fwd_tf32x3_wide_kernel
// after its pre-pass (flash_fwd_f32_wide.cu, entered through
// fasn_flash_fwd_tf32x3_wide), 64 query rows a CTA, Q and K streamed in
// 32-column chunks of D, V^T's heads and rests from device scratch.
//
// Above 256 the wrapper pads D to a multiple of 128, as JAX does.
//
// bf16 at D 384 and 512: flash_fwd_wide_wgmma_kernel (flash_fwd_wide.cu,
// a translation unit of its own), 64 query rows and all of D a CTA.
//
// bf16 above 512 (an O fragment of D / 2 columns would not fit a
// warpgroup's registers) takes flash_fwd_wide_kernel: scalar FMAs from
// shared memory on 64 x 64 tiles with 16 x 16 threads, one CTA for 128
// columns of o, the scores accumulated over D in 64-column chunks
// (flash_common.h wide_dots), so that its shared memory (82,688 bytes)
// does not grow with D; the CTA of the first column chunk writes lse.
//
// Numerics follow the Pallas kernel: the scale is folded into q in q's
// dtype (each consumer rewrites its Q rows in shared memory once), scores
// and statistics are f32, the f32 bias and then the ALiBi term are added
// before masking (flash_common.h), l sums the undropped p, p is then
// multiplied by the dropout multiplier of its global (b, h, q, k) and
// rounded to v's dtype before the PV product, and at n == 0 a row with no
// visible key (rectangular causal with L > S) gives o = 0, lse = NEG_INF.

#include "attn_tile.h"
#include "flash_common.h"

namespace fasn {
namespace {

// ---------------------------------------------------------------------------
// bf16 above D 512: scalar FMAs
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_wide_kernel(const FasnAttn a, float n, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int BKP = BK + 1;
  constexpr int CD = WIDE_OC / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sV = smem + 2 * BQ * WIDE_KP;  // BK x WIDE_OC: the CTA's columns of v
  float* sP = sV + BK * WIDE_OC;        // BQ x BKP

  const int D = a.D, chunks = D / WIDE_OC;
  const int h = blockIdx.y, b = blockIdx.z / chunks, oc0 = blockIdx.z % chunks * WIDE_OC;
  const int L = a.L, S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * a.H + h;
  const T* qb = static_cast<const T*>(a.q) + bh * L * D;
  const T* kb = static_cast<const T*>(a.k) + bh * S * D;
  const T* vb = static_cast<const T*>(a.v) + bh * S * D;
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);

  float m[R4], l[R4], acc[R4][CD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = n > 0.f ? 0.f : NEG_INF;
    l[i] = n;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int kv_end = S;
  if (mods.causal) {
    const int last_row = min(q0 + BQ, L) - 1;
    kv_end = min(S, last_row + mods.off + 1);
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    float s[R4][R4];
    wide_dots<T, R4>(smem, D, qb, a.scale_q, q0, L, kb, 1.f, k0, S, s);
    wide_cols<T, BK>(sV, vb, k0, S, D, oc0, 1.f);

#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        s[i][j] = mods(s[i][j], qi, k0 + tx + 16 * j);
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max16(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        float p = expf(s[i][j] - m_new);
        rsum += p;  // the denominator takes the undropped p
        if (drop.on) p *= drop(b, h, qi, k0 + tx + 16 * j);
        sP[(ty + 16 * i) * BKP + tx + 16 * j] = round_to<T>(p);
      }
      rsum = row_sum16(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int kn = min(BK, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = sV[kk * WIDE_OC + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        const float p = sP[(ty + 16 * i) * BKP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= L) continue;
    const bool dead = n == 0.f && (l[i] == 0.f || m[i] == NEG_INF);
    T* orow = o + (bh * L + qi) * D + oc0;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = from_f32<T>(dead ? 0.f : acc[i][c] / l[i]);
    if (tx == 0 && oc0 == 0) lse[bh * L + qi] = dead ? NEG_INF : m[i] + logf(l[i]);
  }
}

constexpr size_t wide_smem_bytes() {
  return sizeof(float) *
         (size_t(2 * BQ) * WIDE_KP + size_t(BK) * WIDE_OC + size_t(BQ) * (BK + 1));
}

// ---------------------------------------------------------------------------
// bf16: TMA and wgmma (attn_tile.h)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(attn::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, const FasnAttn a, float n,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  using namespace attn;
  extern __shared__ uint8_t smem_raw[];
  const Ring<D> r = make_ring<D>(smem_raw);
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int L = a.L, S = a.S, off = S - L;
  // keys at or left of the tile's last row's diagonal
  const int kv_end = a.causal ? min(S, min(q0 + TQ, L) + off) : S;
  const int tiles = kv_end > 0 ? (kv_end + TK - 1) / TK : 0;
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      const CUtensorMap* const res[1] = {&qmap};
      produce<D, 1>(r, res, q0, &kmap, &vmap, bh, 0, tiles, 0);
    }
    return;
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
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
    mbar_wait(r.q_full(), 0);
    scale_q_rows<D>(r.mem, wg, a.scale_q);
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  }

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TK;
    // no row of the warpgroup sees a key of this tile: skip it
    const bool active = row0 < L && (!mods.causal || k0 <= row0 + 63 + off);
    mbar_wait(r.full_k(stage), phase);
    if (active) {
      float s[64];
      qk<D>(s, r.q(), r.k(stage), wg);
      // masks, bias and ALiBi only where a key is past S or a diagonal
      if (!plain || k0 + TK > S || (mods.causal && k0 + TK - 1 > row0 + off)) {
#pragma unroll
        for (int e = 0; e < 64; ++e)
          s[e] = mods(s[e], row0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = row0 + g + 8 * i;
        const float m_new = fmaxf(m[i], row_max(s, i));
        const float alpha = exp_fast(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
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
      uint32_t p[TK / 16][4];
      to_a_frags(s, p);
      mbar_wait(r.full_v(stage), phase);
      pv<D>(acc, p, r.v(stage));
    } else {
      mbar_wait(r.full_v(stage), phase);  // the slot is refilled only once V has landed
    }
    if (t == 0) mbar_arrive(r.empty(stage));
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const int valid = L - row0;
  if (valid <= 0) return;
  float lf[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lf[i] = quad_sum(l[i]);
    dead[i] = n == 0.f && (lf[i] == 0.f || m[i] == NEG_INF);
  }
  store_rows<D>(acc, o + ((long long)bh * L + row0) * D, valid,
                [&](int i, float x) { return dead[i] ? 0.f : x / lf[i]; });
  if (t % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (g + 8 * i < valid)
        lse[(long long)bh * L + row0 + g + 8 * i] = dead[i] ? NEG_INF : m[i] + logf(lf[i]);
  }
}

template <int D>
cudaError_t launch_wgmma(const FasnAttn& a, float n, void* o, float* lse, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<D>::SMEM);
  if (err != cudaSuccess) return err;
  AttnMaps m{};
  if (!encode_attn(&m, a, D)) return cudaErrorInvalidValue;
  kernel<<<tile_grid((long long)a.B * a.H, a.L), attn::THREADS, Ring<D>::SMEM, stream>>>(
      m.q, m.k, m.v, a, n, static_cast<__nv_bfloat16*>(o), lse);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at D 256: 64-row tiles, a producer warpgroup, setmaxnreg
// ---------------------------------------------------------------------------

constexpr int D256_ROWS = 64;  // rows of every tile: a warpgroup's queries, a key tile
constexpr int D256_THREADS = attn::CONSUMERS + 128;
using D256Ring = attn::Ring<256, 2, D256_ROWS>;  // resident: the two warpgroups' Q tiles

__global__ void __launch_bounds__(D256_THREADS, 1)
    flash_fwd_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const FasnAttn a, float n,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ lse) {
  using namespace attn;
  constexpr int D = 256, KT = D256_ROWS;
  extern __shared__ uint8_t smem_raw[];
  const D256Ring r = make_ring<D, 2, KT>(smem_raw);
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
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
      const CUtensorMap* const res[2] = {&qmap, &qmap};
      produce<D, 2, KT, false>(r, res, q0, &kmap, &vmap, bh, 0, tiles, 0, KT);
    }
  } else {
    setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128;
    const int row0 = q0 + 64 * wg;  // the warpgroup's first query row
    const int g = 16 * (t / 32) + (t % 32) / 4, c0 = 2 * (t % 4);
    const ScoreMods mods = score_mods(a, b, h);
    const Dropout drop = dropout_of(a);
    const bool plain = mods.bias == nullptr && !mods.alibi;
    const uint32_t q = r.res(wg);  // the warpgroup's own Q tile

    float m[2], l[2], acc[D / 2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = n > 0.f ? 0.f : NEG_INF;
      l[i] = t % 4 == 0 ? n : 0.f;  // the quad's partial sums; n counted once
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (tiles > 0) {
      mbar_wait<false>(r.q_full(), 0);
      scale_q_rows<D, KT>(r.mem + wg * Tile<D, KT>::TILE, 0, a.scale_q);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }

    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < tiles; ++it) {
      const int k0 = it * KT;
      // no row of the warpgroup sees a key of this tile: skip it
      const bool active = row0 < L && (!mods.causal || k0 <= row0 + 63 + off);
      mbar_wait<false>(r.full_k(stage), phase);
      if (active) {
        float s[KT / 2];
        qk_async<D, KT / 2, KT>(s, q, r.k(stage));
        wgmma_wait<0>();
        fence_regs(s);
        // masks, bias and ALiBi only where a key is past S or a diagonal
        if (!plain || k0 + KT > S || (mods.causal && k0 + KT - 1 > row0 + off)) {
#pragma unroll
          for (int e = 0; e < KT / 2; ++e)
            s[e] = mods(s[e], row0 + g + 8 * ((e / 2) % 2), k0 + 8 * (e / 4) + c0 + e % 2);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = row0 + g + 8 * i;
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
        uint32_t p[KT / 16][4];
        to_a_frags(s, p);
        mbar_wait<false>(r.full_v(stage), phase);
        pv_async<D, KT / 16, KT>(acc, p, r.v(stage));
        wgmma_wait<0>();
        fence_regs(acc);
      } else {
        mbar_wait<false>(r.full_v(stage), phase);  // the slot is refilled only once V has landed
      }
      if (t == 0) mbar_arrive(r.empty(stage));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const int valid = L - row0;
    if (valid > 0) {
      float lf[2];
      bool dead[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lf[i] = quad_sum(l[i]);
        dead[i] = n == 0.f && (lf[i] == 0.f || m[i] == NEG_INF);
      }
      store_rows<D>(acc, o + ((long long)bh * L + row0) * D, valid,
                    [&](int i, float x) { return dead[i] ? 0.f : x / lf[i]; });
      if (t % 4 == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (g + 8 * i < valid)
            lse[(long long)bh * L + row0 + g + 8 * i] = dead[i] ? NEG_INF : m[i] + logf(lf[i]);
      }
    }
  }
}

cudaError_t launch_d256(const FasnAttn& a, float n, void* o, float* lse, cudaStream_t stream) {
  using namespace attn;
  auto kernel = flash_fwd_d256_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D256Ring::SMEM);
  if (err != cudaSuccess) return err;
  AttnMaps m{};
  if (!encode_attn(&m, a, 256, nullptr, D256_ROWS)) return cudaErrorInvalidValue;
  kernel<<<tile_grid((long long)a.B * a.H, a.L), D256_THREADS, D256Ring::SMEM, stream>>>(
      m.q, m.k, m.v, a, n, static_cast<__nv_bfloat16*>(o), lse);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_fwd(const FasnAttn* a, float n, void* o, float* lse, void* scratch,
                              cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype != 0 && a->dtype != 1) return cudaErrorInvalidValue;
  if (a->dtype == 0) {
    if (a->D >= 256) return fasn_flash_fwd_tf32x3_wide(a, n, o, lse, scratch, stream);
    return fasn_flash_fwd_tf32x3(a, n, o, lse, stream);
  }
  if (a->D == 384 || a->D == 512) return fasn_flash_fwd_wide(a, n, o, lse, stream);
  if (wide_d(a->D)) {
    const dim3 wide_grid((a->L + BQ - 1) / BQ, a->H, wide_z(a->B, a->D));
    if (wide_grid.z == 0) return cudaErrorInvalidValue;
    return launch(flash_fwd_wide_kernel<__nv_bfloat16>, wide_grid, wide_smem_bytes(), stream, *a,
                  n, static_cast<__nv_bfloat16*>(o), lse);
  }
  switch (a->D) {
    case 32:
      return launch_wgmma<32>(*a, n, o, lse, stream);
    case 64:
      return launch_wgmma<64>(*a, n, o, lse, stream);
    case 128:
      return launch_wgmma<128>(*a, n, o, lse, stream);
    case 256:
      return launch_d256(*a, n, o, lse, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
