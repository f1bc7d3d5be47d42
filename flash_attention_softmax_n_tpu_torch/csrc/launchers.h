// Host entry points of the port's CUDA kernels.
//
// Each .cu file defines its functions against this header and bindings.cpp
// calls them, so the compiler checks both sides of every argument list.
// Each launches on `stream`, does not synchronise, and returns the
// cudaError_t of its launch (0 on success).

#pragma once

#include <cuda_runtime_api.h>

extern "C" {

// The attention inputs that K1, K5 and K6 share. q (B,H,L,D), k/v (B,H,S,D)
// contiguous, bf16 (dtype 1) or f32 (dtype 0), D in {32, 64, 128}; bias null
// or f32 with contiguous (L,S) planes at element strides bias_sb (batch) and
// bias_sh (head), 0 where broadcast; slopes null or (H,) f32 ALiBi slopes;
// seed null (no dropout) or one int32 on the device, with the keep threshold
// round(rate * 2^31) and the multiplier 1/(1-rate) in f32. `scale_q` is the
// softmax scale rounded to the input dtype, folded into q.
struct FasnAttn {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  long long bias_sb, bias_sh;
  const float* slopes;
  const int* seed;
  unsigned drop_threshold;
  float drop_mult;
  int B, H, L, S, D, dtype;
  float scale_q;
  int causal;
};

// K1 (flash_fwd.cu): o like q, lse (B,H,L) f32. bf16 takes the TMA kernel:
// q, k and v must start on 16 bytes, and L, S >= 1.
int fasn_flash_fwd(const FasnAttn* a, float n, void* o, float* lse, cudaStream_t stream);

// K5 (flash_bwd_dq.cu): dq like q from dout like q, lse (B,H,L) f32 (the
// forward's, or a caller's global one) and delta = rowsum(dout * o) (B,H,L)
// f32; dq is multiplied by `scale` (unrounded). dbias null or (B,H,L,S) f32;
// dslope_rows null or (B,H,L) f32, each query row's sum of ds * -|dist|.
// bf16 takes the TMA kernel: q, k, v and dout must start on 16 bytes.
int fasn_flash_bwd_dq(const FasnAttn* a, const void* dout, const float* lse, const float* delta,
                      float scale, void* dq, float* dbias, float* dslope_rows,
                      cudaStream_t stream);

// K6 (flash_bwd_dkv.cu): dk like k and dv like v, from the inputs of K5;
// bf16 takes the TMA kernel, as K5 does.
int fasn_flash_bwd_dkv(const FasnAttn* a, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, cudaStream_t stream);

// K2 (qmm_argmax.cu). x (M,K) contiguous, bf16 (dtype 1) or f32 (dtype 0);
// w (K,N) int8 contiguous; scales (N,) f32; out_idx (M,) int32, out_val
// (M,) f32; part_val/part_idx scratch of M * slots. The plan
// (kernels/quant_matmul.py qmm_argmax_plan): f32 x takes bm = 64 (64 x 64
// tiles), ctas = slots = ceil(N / 64) column tiles, no TMA; bf16 x bm 64
// (256 vocab columns a tile), 128 or 256 (128 columns), `ctas` persistent
// CTAs, a multiple of the ceil(M / bm) row tiles and at most the tiles
// (slots = ctas / row tiles), and use_tma where x's and w's row strides
// and base addresses are multiples of 16 bytes. M, K, N >= 1. The
// operator checks the plan.
int fasn_qmm_argmax(const void* x, const void* w, const float* scales, float* part_val,
                    int* part_idx, int* out_idx, float* out_val, int M, int K, int N, int dtype,
                    int bm, int ctas, int use_tma, cudaStream_t stream);

// K3 and K4 (cache_update.cu): the bytes a thread moves for rows of
// row_bytes from src to dst, 16 where row_bytes % 16 == 0 and both are
// 16-byte aligned, else 4; 0 where row_bytes or either address is not a
// multiple of 4 (the kernel refuses those).
int fasn_row_vector_bytes(int row_bytes, const void* dst, const void* src);

// K3. caches[t] (NL,B,KVH,S,row_bytes[t]) and news[t] (NL,B,KVH,row_bytes[t])
// contiguous and 4-byte aligned, row_bytes a multiple of 4, 1 <= n <= 4;
// positions (B,) int32 on the device; rows at positions outside [0, S) are
// skipped. NL*B*KVH*S and the vectors of each tensor's new rows fit an int.
int fasn_cache_append(int n, void* const* caches, const void* const* news, const int* row_bytes,
                      const int* positions, int NL, int B, int KVH, int S, cudaStream_t stream);

// K4 (cache_update.cu). k_tail/v_tail (NL,B,KVH,W,row_bytes), k_new/v_new
// (NL,B,KVH,row_bytes) contiguous and 4-byte aligned; every row goes to
// ring row `index`. Sizes as K3's.
int fasn_tail_append(void* k_tail, void* v_tail, const void* k_new, const void* v_new,
                     int row_bytes, int index, int NL, int B, int KVH, int W,
                     cudaStream_t stream);

// K7 (qmm.cu). Logical K rows of one slice (stage) for x_dtype (below):
// ceil(K / this) slices are split among the CTAs of one output tile.
int fasn_qmm_stage_k(int x_dtype);

// K7's f32 mode (qmm_f32_kernel) with bm-row tiles: its shared-memory
// bytes a CTA, and in *stages the depth of its ring; -1 for a bm it lacks.
int fasn_qmm_f32_layout(int bm, int* stages);

// K7. x (M,K) contiguous, f32 (x_dtype 0), bf16 (1) or int8 (2, W8A8, with
// x_scales (M,) f32); w int8 (K,N), or int4 (bits 4) packed (K/2,N) in
// groups of 256 rows with K % 256 == 0, contiguous; scales (N,) f32; out
// (M,N) contiguous, f32 (out_dtype 0) or bf16 (1). The plan
// (kernels/quant_matmul.py qmm_plan): bm rows per tile (64 or 128 for f32
// or int8 x; 64, 128 or 256 for bf16 x), `splits` ranges of
// `slices_per_split` slices (every slice in one, none empty; the scratch
// holds splits * M * N four-byte partials when splits > 1), and use_tma
// where x's and w's row strides and base addresses are multiples of 16
// bytes (else f32 x takes cp.async, bf16 and int8 x a predicated producer).
// Each kernel's ring is as deep as it is built (Cfg::STAGES,
// F32Cfg::STAGES), which the plan's `stages` reports.
int fasn_qmm(const void* x, const float* x_scales, const void* w, const float* scales,
             void* partial, void* out, int M, int K, int N, int x_dtype, int bits, int out_dtype,
             int bm, int splits, int slices_per_split, int use_tma, cudaStream_t stream);

// K9 (fused_mlp.cu). f32 x: d_ff tiles of the scalar kernel, whose
// scratch gu_part holds tiles * M * K f32.
int fasn_fused_mlp_tiles(int F);

// K9's inputs. x (M,K) contiguous, f32 (dtype 0) or bf16 (1); wg, wu int8
// (K,F) and wd int8 (F,K) contiguous; sg, su (F,) and sd (K,) f32; out (M,K)
// like x. bf16: h (M,F) bf16 scratch; gu_part (2 * gu_splits, M, F) and
// dn_part (dn_splits, M, K) f32 scratch where the phase splits K. f32: K % 64
// == 0 and F % 64 == 0, gu_part as fasn_fused_mlp_tiles says.
struct FasnMlp {
  const void* x;
  const void* wg;
  const float* sg;
  const void* wu;
  const float* su;
  const void* wd;
  const float* sd;
  void* h;
  float* gu_part;
  float* dn_part;
  void* out;
  int M, K, F, dtype;
};

// K9's plan for bf16 x (kernels/fused_mlp.py fused_mlp_plan), one set per
// phase (gu: x @ [Wg | Wu] -> h, 64 d_ff columns a tile; dn: h @ Wd, K7's
// tiles): rows per tile (64, 128 or 256), the ring's stages (the depth the
// kernel is built with), splits ranges of per 64-row K slices (every slice
// in one, none empty), and TMA where the row strides and base addresses are
// multiples of 16 bytes (else the predicated producer).
struct FasnMlpPlan {
  int gu_bm, gu_stages, gu_splits, gu_per, gu_tma;
  int dn_bm, dn_stages, dn_splits, dn_per, dn_tma;
};

// K9. plan is read for bf16 x only; the operator has checked it.
int fasn_fused_mlp(const FasnMlp* a, const FasnMlpPlan* plan, cudaStream_t stream);

// K8's inputs. q (B,KVH,G,HD) contiguous, f32 (q_dtype 0), bf16 (1) or
// int8 (2, int8 compute, with q_scales (B,KVH,G) f32); k and v (B,KVH,S,HD)
// f32 (kv_dtype 0), bf16 (1), int8 (2) or fp8 e4m3 (3) at element strides
// *_sb, *_sh, *_ss with unit stride along HD; k_scales/v_scales null
// (dense) or f32
// (B,KVH,S,1) at element strides ks_*/vs_*; lengths (B,) int32 on the
// device. G <= 16, HD <= 128.
struct FasnDecode {
  const void* q;
  const float* q_scales;
  const void* k;
  const void* v;
  const float* k_scales;
  const float* v_scales;
  const int* lengths;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, ks_ss, vs_sb, vs_sh, vs_ss;
  int B, KVH, G, HD, S, q_dtype, kv_dtype;
};

// K8 (decode_attn.cu). 1 if the kernel takes this plan: `split` positions
// per CTA (32, 64, 128 or 256; exactly 256 under int8 compute, q_dtype 2)
// whose shared-memory layout fits a block, and `products` 0 (f32 FMAs, any
// mode) or 1 (mma.sync: bf16 q, a bf16, int8 or fp8 cache, HD a multiple of
// 16); 1 <= G <= 16, HD <= 128. The operator calls it once, before launching.
int fasn_decode_attn_plan_ok(int split, int products, int G, int HD, int q_dtype, int kv_dtype);

// K8. A plan that fasn_decode_attn_plan_ok accepts (kernels/decode_attention.py
// decode_attn_plan and decode_attn_products); scratch part_acc
// (B,KVH,splits,G,HD), part_m and part_l (B,KVH,splits,G) with splits =
// ceil(S / split); acc (B,KVH,G,HD), m and l (B,KVH,G); all f32 and
// contiguous.
int fasn_decode_attn(const FasnDecode* a, int split, int products, float* part_acc,
                     float* part_m, float* part_l, float* acc, float* m, float* l,
                     cudaStream_t stream);

// K10 (prefill_phases.cu). q, k, v and o (B,H,L,D) contiguous, bf16 (dtype
// 1) or f32 (0), D in {32, 64, 128}; mode 0 dots_only, 1 exp_only, 2
// softmax, 3 mask_softmax. bf16 takes the TMA kernel: q, k and v must start
// on 16 bytes.
int fasn_prefill_phase(const void* q, const void* k, const void* v, void* o, int B, int H, int L,
                       int D, int dtype, int mode, cudaStream_t stream);

}  // extern "C"
