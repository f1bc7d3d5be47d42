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
// f32: flash_fwd_kernel, scalar f32 FMAs from shared memory on 64 x 64
// tiles (wgmma has no f32 x f32 product, and TF32 would not hold f32's
// tolerance); the training path's f32 runs and the card tests take it.
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
// f32: scalar FMAs
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D + size_t(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const FasnAttn a, float n, T* __restrict__ o, float* __restrict__ lse) {
  constexpr int DP = D + 1;
  constexpr int BKP = BK + 1;
  constexpr int CD = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;          // BQ x DP
  float* sK = sQ + BQ * DP;  // BK x DP
  float* sV = sK + BK * DP;  // BK x D
  float* sP = sV + BK * D;   // BQ x BKP

  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, S = a.S;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long bh = (long long)b * a.H + h;
  const T* qb = static_cast<const T*>(a.q) + bh * L * D;
  const T* kb = static_cast<const T*>(a.k) + bh * S * D;
  const T* vb = static_cast<const T*>(a.v) + bh * S * D;
  const ScoreMods mods = score_mods(a, b, h);
  const Dropout drop = dropout_of(a);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < L) val = round_to<T>(to_f32(qb[(long long)(q0 + r) * D + c]) * a.scale_q);
    sQ[r * DP + c] = val;
  }

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
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < S) {
        kv = to_f32(kb[(long long)(k0 + r) * D + c]);
        vv = to_f32(vb[(long long)(k0 + r) * D + c]);
      }
      sK[r * DP + c] = kv;
      sV[r * D + c] = vv;
    }
    __syncthreads();

    float s[R4][R4];
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[R4], kv[R4];
#pragma unroll
      for (int i = 0; i < R4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < R4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < R4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

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
      for (int c = 0; c < CD; ++c) vv[c] = sV[kk * D + tx + 16 * c];
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
    T* orow = o + (bh * L + qi) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) orow[tx + 16 * c] = from_f32<T>(dead ? 0.f : acc[i][c] / l[i]);
    if (tx == 0) lse[bh * L + qi] = dead ? NEG_INF : m[i] + logf(l[i]);
  }
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

}  // namespace
}  // namespace fasn

extern "C" int fasn_flash_fwd(const FasnAttn* a, float n, void* o, float* lse,
                              cudaStream_t stream) {
  using namespace fasn;
  if (a->dtype == 1) {
    switch (a->D) {
      case 32:
        return launch_wgmma<32>(*a, n, o, lse, stream);
      case 64:
        return launch_wgmma<64>(*a, n, o, lse, stream);
      case 128:
        return launch_wgmma<128>(*a, n, o, lse, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (a->dtype != 0) return cudaErrorInvalidValue;
  const dim3 grid((a->L + BQ - 1) / BQ, a->H, a->B);
  auto f32 = [&](auto t, auto d) {
    using T = typename decltype(t)::type;
    constexpr int D = decltype(d)::value;
    return launch(flash_fwd_kernel<T, D>, grid, fwd_smem_bytes<D>(), stream, *a, n,
                  static_cast<T*>(o), lse);
  };
  return dispatch_d<float>(a->D, f32);
}
