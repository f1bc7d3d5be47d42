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

// K1 (flash_fwd.cu): o like q, lse (B,H,L) f32.
int fasn_flash_fwd(const FasnAttn* a, float n, void* o, float* lse, cudaStream_t stream);

// K5 (flash_bwd_dq.cu): dq like q from dout like q, lse (B,H,L) f32 (the
// forward's, or a caller's global one) and delta = rowsum(dout * o) (B,H,L)
// f32; dq is multiplied by `scale` (unrounded). dbias null or (B,H,L,S) f32;
// dslope_rows null or (B,H,L) f32, each query row's sum of ds * -|dist|.
int fasn_flash_bwd_dq(const FasnAttn* a, const void* dout, const float* lse, const float* delta,
                      float scale, void* dq, float* dbias, float* dslope_rows,
                      cudaStream_t stream);

// K6 (flash_bwd_dkv.cu): dk like k and dv like v, from the inputs of K5.
int fasn_flash_bwd_dkv(const FasnAttn* a, const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, cudaStream_t stream);

// K2 (qmm_argmax.cu). Column tiles of pass 1: the scratch holds M * tiles.
int fasn_qmm_tiles(int N);

// K2. x (M,K) contiguous, bf16 (dtype 1) or f32 (dtype 0); w (K,N) int8
// contiguous; scales (N,) f32; part_val/part_idx scratch of M * tiles(N);
// out_idx (M,) int32, out_val (M,) f32.
int fasn_qmm_argmax(const void* x, const void* w, const float* scales, float* part_val,
                    int* part_idx, int* out_idx, float* out_val, int M, int K, int N, int dtype,
                    cudaStream_t stream);

// K3 (cache_update.cu). caches[t] (NL,B,KVH,S,row_bytes[t]) and news[t]
// (NL,B,KVH,row_bytes[t]) contiguous and 4-byte aligned, row_bytes a
// multiple of 4, 1 <= n <= 4; positions (B,) int32 on the device.
int fasn_cache_append(int n, void* const* caches, const void* const* news, const int* row_bytes,
                      const int* positions, int NL, int B, int KVH, int S, cudaStream_t stream);

// K4 (cache_update.cu). k_tail/v_tail (NL,B,KVH,W,row_bytes), k_new/v_new
// (NL,B,KVH,row_bytes) contiguous and 4-byte aligned; every row goes to
// ring row `index`.
int fasn_tail_append(void* k_tail, void* v_tail, const void* k_new, const void* v_new,
                     int row_bytes, int index, int NL, int B, int KVH, int W,
                     cudaStream_t stream);

}  // extern "C"
