// The port's CUDA kernels as typed PyTorch operators: torch.ops.fasn.*.
//
// Each operator checks what its kernel takes (device, dtype, shape,
// contiguity, alignment) and raises ValueError on anything else, makes the
// tensors' card the current device, launches on PyTorch's current stream of
// that card, and raises with the CUDA error if the launch is refused.
// Outputs and scratch are allocated by the Python wrappers
// (flash_attention_softmax_n_tpu_torch/kernels/) and passed in, marked
// mutable in the schemas, but for the f32 pre-pass's scratch of K1, K5 and
// K6 at D >= 256 (scratch_of), an internal of the operator that the
// caching allocator hands out on the launch's stream. The kernels
// themselves live in the .cu files and are reached through launchers.h.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDACachingAllocator.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <optional>
#include <tuple>

#include "launchers.h"

namespace {

void check_launch(int err, const char* name) {
  TORCH_CHECK(err == cudaSuccess, "CUDA kernel ", name, " failed to launch: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

cudaStream_t stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.get_device()).stream();
}

int dtype_code(const at::Tensor& t, const char* what) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  TORCH_CHECK_VALUE(false, what, " takes bf16 or f32 inputs, got ", t.scalar_type());
  return -1;
}

int as_int(int64_t v, const char* what) {
  TORCH_CHECK_VALUE(v >= 0 && v <= INT_MAX, what, ": size ", v, " does not fit an int");
  return static_cast<int>(v);
}

// on ref's card, contiguous, and 4-byte aligned (the kernels load words)
void check_on(const at::Tensor& t, const at::Tensor& ref, const char* what) {
  TORCH_CHECK_VALUE(t.is_cuda() && t.device() == ref.device(), what,
                    ": all tensors must be on one CUDA device");
  TORCH_CHECK_VALUE(t.is_contiguous(), what, ": tensors must be contiguous");
  TORCH_CHECK_VALUE(reinterpret_cast<uintptr_t>(t.data_ptr()) % 4 == 0, what,
                    ": tensors must start on a 4-byte boundary");
}

// bf16 inputs of the TMA kernels (K1, K5, K6, K10), and with f32 true f32
// ones too (K1's, K5's and K6's split-TF32 kernels at every D: TMA, or
// above 128 their pre-pass's 16-byte loads): each tensor's first row on a
// 16-byte boundary (their rows are 64 bytes or more)
void check_tma(std::initializer_list<const at::Tensor*> ts, const char* what, bool f32 = false) {
  for (const at::Tensor* t : ts)
    TORCH_CHECK_VALUE((t->scalar_type() != at::kBFloat16 && !f32) ||
                          reinterpret_cast<uintptr_t>(t->data_ptr()) % 16 == 0,
                      what, ": ", f32 ? "f32" : "bf16",
                      " tensors must start on a 16-byte boundary (TMA)");
}

void check_shape(const at::Tensor& t, at::IntArrayRef shape, at::ScalarType dtype,
                 const char* what, const char* name) {
  TORCH_CHECK_VALUE(t.sizes() == shape && t.scalar_type() == dtype, what, ": ", name,
                    " must be ", dtype, " ", shape, ", got ", t.scalar_type(), " ", t.sizes());
}

// the head dims the attention kernels (K1, K5, K6, K10) are built for: 32,
// 64, 128, 256 and any multiple of 128 above (the wrappers zero-pad any
// other head dim up to the next of these, as JAX pads to its kernels')
void check_head_dim(int64_t D, const char* what) {
  TORCH_CHECK_VALUE(D == 32 || D == 64 || D == 128 || D == 256 || (D > 256 && D % 128 == 0),
                    what, " head dim must be 32, 64, 128, 256 or a multiple of 128, got ", D);
}

// the attention inputs that K1, K5 and K6 share (launchers.h FasnAttn)
FasnAttn attn_args(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                   const std::optional<at::Tensor>& bias, const std::optional<at::Tensor>& slopes,
                   const std::optional<at::Tensor>& seed, double scale_q, bool causal,
                   int64_t drop_threshold, double drop_mult, const char* what) {
  TORCH_CHECK_VALUE(q.dim() == 4 && k.dim() == 4, what, ": q and k must be (B, H, L|S, D)");
  const int64_t B = q.size(0), H = q.size(1), L = q.size(2), D = q.size(3), S = k.size(2);
  FasnAttn a{};
  a.dtype = dtype_code(q, what);
  check_head_dim(D, what);
  for (const at::Tensor* t : {&q, &k, &v}) check_on(*t, q, what);
  check_shape(k, {B, H, S, D}, q.scalar_type(), what, "k");
  check_shape(v, {B, H, S, D}, q.scalar_type(), what, "v");
  if (bias.has_value()) {
    const at::Tensor& b = *bias;
    check_on(b, q, what);
    TORCH_CHECK_VALUE(b.scalar_type() == at::kFloat && b.dim() == 4 &&
                          (b.size(0) == 1 || b.size(0) == B) &&
                          (b.size(1) == 1 || b.size(1) == H) && b.size(2) == L && b.size(3) == S,
                      what, ": bias must be f32 (B|1, H|1, L, S), got ", b.sizes());
    a.bias_sh = b.size(1) == 1 ? 0 : L * S;
    a.bias_sb = b.size(0) == 1 ? 0 : b.size(1) * L * S;
    a.bias = b.data_ptr<float>();
  }
  if (slopes.has_value()) {
    check_on(*slopes, q, what);
    check_shape(*slopes, {H}, at::kFloat, what, "slopes");
    a.slopes = slopes->data_ptr<float>();
  }
  if (seed.has_value()) {
    check_on(*seed, q, what);
    check_shape(*seed, {1}, at::kInt, what, "seed");
    TORCH_CHECK_VALUE(drop_threshold >= 0 && drop_threshold <= INT_MAX, what,
                      ": dropout threshold ", drop_threshold, " outside [0, 2^31)");
    a.seed = seed->data_ptr<int>();
    a.drop_threshold = static_cast<unsigned>(drop_threshold);
    a.drop_mult = static_cast<float>(drop_mult);
  }
  a.q = q.data_ptr();
  a.k = k.data_ptr();
  a.v = v.data_ptr();
  a.B = as_int(B, what);
  a.H = as_int(H, what);
  a.L = as_int(L, what);
  a.S = as_int(S, what);
  a.D = as_int(D, what);
  a.scale_q = static_cast<float>(scale_q);
  a.causal = causal ? 1 : 0;
  return a;
}

// the device scratch of an f32 pre-pass (K1's, K5's, K6's at D >= 256),
// none where `bytes` is 0: from PyTorch's caching allocator on the current
// device, back to it when the DataPtr goes, after the work queued on the
// stream it was taken on, the launch's
c10::DataPtr scratch_of(size_t bytes) {
  if (bytes == 0) return c10::DataPtr();
  return c10::cuda::CUDACachingAllocator::get()->allocate(bytes);
}

void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const std::optional<at::Tensor>& bias, const std::optional<at::Tensor>& slopes,
               const std::optional<at::Tensor>& seed, const at::Tensor& o, const at::Tensor& lse,
               double scale, double n, bool causal, int64_t drop_threshold, double drop_mult) {
  const char* what = "flash_fwd";
  const c10::cuda::CUDAGuard guard(q.device());
  const FasnAttn a = attn_args(q, k, v, bias, slopes, seed, scale, causal, drop_threshold,
                               drop_mult, what);
  check_tma({&q, &k, &v}, what, q.scalar_type() == at::kFloat);
  check_on(o, q, what);
  check_on(lse, q, what);
  check_shape(o, q.sizes(), q.scalar_type(), what, "o");
  check_shape(lse, {q.size(0), q.size(1), q.size(2)}, at::kFloat, what, "lse");
  const c10::DataPtr scratch = scratch_of(fasn_flash_fwd_tf32x3_wide_scratch(&a));
  check_launch(fasn_flash_fwd(&a, static_cast<float>(n), o.data_ptr(), lse.data_ptr<float>(),
                              scratch.get(), stream_of(q)),
               what);
}

// dout like q; lse and delta (B, H, L) f32
void check_bwd_rows(const at::Tensor& q, const at::Tensor& dout, const at::Tensor& lse,
                    const at::Tensor& delta, const char* what) {
  for (const at::Tensor* t : {&dout, &lse, &delta}) check_on(*t, q, what);
  check_shape(dout, q.sizes(), q.scalar_type(), what, "dout");
  check_shape(lse, {q.size(0), q.size(1), q.size(2)}, at::kFloat, what, "lse");
  check_shape(delta, {q.size(0), q.size(1), q.size(2)}, at::kFloat, what, "delta");
}


void flash_bwd_dq(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                  const std::optional<at::Tensor>& bias, const std::optional<at::Tensor>& slopes,
                  const std::optional<at::Tensor>& seed, const at::Tensor& dout,
                  const at::Tensor& lse, const at::Tensor& delta, const at::Tensor& dq,
                  const std::optional<at::Tensor>& dbias,
                  const std::optional<at::Tensor>& dslope_rows, double scale_q, double scale,
                  bool causal, int64_t drop_threshold, double drop_mult) {
  const char* what = "flash_bwd_dq";
  const c10::cuda::CUDAGuard guard(q.device());
  const FasnAttn a = attn_args(q, k, v, bias, slopes, seed, scale_q, causal, drop_threshold,
                               drop_mult, what);
  check_bwd_rows(q, dout, lse, delta, what);
  check_tma({&q, &k, &v, &dout}, what, q.scalar_type() == at::kFloat);
  check_on(dq, q, what);
  check_shape(dq, q.sizes(), q.scalar_type(), what, "dq");
  float* dbias_ptr = nullptr;
  if (dbias.has_value()) {
    check_on(*dbias, q, what);
    check_shape(*dbias, {q.size(0), q.size(1), q.size(2), k.size(2)}, at::kFloat, what,
                "dbias");
    dbias_ptr = dbias->data_ptr<float>();
  }
  float* dslope_ptr = nullptr;
  if (dslope_rows.has_value()) {
    TORCH_CHECK_VALUE(slopes.has_value(), what, ": dslope_rows needs slopes");
    check_on(*dslope_rows, q, what);
    check_shape(*dslope_rows, {q.size(0), q.size(1), q.size(2)}, at::kFloat, what,
                "dslope_rows");
    dslope_ptr = dslope_rows->data_ptr<float>();
  }
  const c10::DataPtr scratch = scratch_of(fasn_flash_bwd_tf32x3_wide_scratch(&a, 0));
  check_launch(fasn_flash_bwd_dq(&a, dout.data_ptr(), lse.data_ptr<float>(),
                                 delta.data_ptr<float>(), static_cast<float>(scale),
                                 dq.data_ptr(), dbias_ptr, dslope_ptr, scratch.get(),
                                 stream_of(q)),
               what);
}

void flash_bwd_dkv(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                   const std::optional<at::Tensor>& bias, const std::optional<at::Tensor>& slopes,
                   const std::optional<at::Tensor>& seed, const at::Tensor& dout,
                   const at::Tensor& lse, const at::Tensor& delta, const at::Tensor& dk,
                   const at::Tensor& dv, double scale_q, bool causal, int64_t drop_threshold,
                   double drop_mult) {
  const char* what = "flash_bwd_dkv";
  const c10::cuda::CUDAGuard guard(q.device());
  const FasnAttn a = attn_args(q, k, v, bias, slopes, seed, scale_q, causal, drop_threshold,
                               drop_mult, what);
  check_bwd_rows(q, dout, lse, delta, what);
  check_tma({&q, &k, &v, &dout}, what, q.scalar_type() == at::kFloat);
  check_on(dk, q, what);
  check_on(dv, q, what);
  check_shape(dk, k.sizes(), k.scalar_type(), what, "dk");
  check_shape(dv, v.sizes(), v.scalar_type(), what, "dv");
  const c10::DataPtr scratch = scratch_of(fasn_flash_bwd_tf32x3_wide_scratch(&a, 1));
  check_launch(fasn_flash_bwd_dkv(&a, dout.data_ptr(), lse.data_ptr<float>(),
                                  delta.data_ptr<float>(), dk.data_ptr(), dv.data_ptr(),
                                  scratch.get(), stream_of(q)),
               what);
}

void qmm_argmax(const at::Tensor& x, const at::Tensor& w, const at::Tensor& scales,
                const at::Tensor& idx, const at::Tensor& val, const at::Tensor& part_val,
                const at::Tensor& part_idx, int64_t bm, int64_t ctas, bool tma) {
  const char* what = "quantized_matmul_argmax";
  TORCH_CHECK_VALUE(x.dim() == 2 && w.dim() == 2 && w.size(0) == x.size(1), what,
                    ": x (M, K) and w (K, N) must agree on K");
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t M = x.size(0), K = x.size(1), N = w.size(1);
  TORCH_CHECK_VALUE(M >= 1 && K >= 1 && N >= 1, what, ": x ", x.sizes(), " and w ", w.sizes(),
                    " must not be empty");
  const int dtype = dtype_code(x, what);
  for (const at::Tensor* t : {&x, &w, &scales, &idx, &val, &part_val, &part_idx})
    check_on(*t, x, what);
  check_shape(w, {K, N}, at::kChar, what, "w");
  check_shape(scales, {N}, at::kFloat, what, "scales");
  check_shape(idx, {M}, at::kInt, what, "idx");
  check_shape(val, {M}, at::kFloat, what, "val");
  // the plan: f32 x, 64 x 64 or 128 x 64 tiles, one CTA a tile and a slot
  // a column tile; bf16 x, 64 x 256, 128 x 128 or 256 x 128 tiles on
  // persistent CTAs a multiple of the row tiles, a slot per CTA of a row tile
  int64_t slots;
  if (dtype == 0) {
    TORCH_CHECK_VALUE(bm == 64 || bm == 128, what, ": no f32 kernel takes ", bm, "-row tiles");
    const int64_t tiles_m = (M + bm - 1) / bm, tiles_n = (N + 63) / 64;
    TORCH_CHECK_VALUE(ctas == tiles_m * tiles_n, what, ": f32 x takes one CTA a tile, ",
                      tiles_m * tiles_n, ", not ", ctas);
    slots = tiles_n;
  } else {
    TORCH_CHECK_VALUE(bm == 64 || bm == 128 || bm == 256, what, ": no kernel takes ", bm,
                      "-row tiles");
    const int64_t bn = bm == 64 ? 256 : 128;
    const int64_t tiles_m = (M + bm - 1) / bm, tiles = tiles_m * ((N + bn - 1) / bn);
    TORCH_CHECK_VALUE(ctas >= tiles_m && ctas % tiles_m == 0 && ctas <= tiles, what, ": ", ctas,
                      " CTAs are not a multiple of the ", tiles_m, " row tiles within the ",
                      tiles, " tiles");
    slots = ctas / tiles_m;
  }
  if (tma) {
    TORCH_CHECK_VALUE((K * x.element_size()) % 16 == 0 && N % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(w.data_ptr()) % 16 == 0,
                      what, ": TMA needs 16-byte row strides and addresses");
  }
  check_shape(part_val, {M, slots}, at::kFloat, what, "part_val");
  check_shape(part_idx, {M, slots}, at::kInt, what, "part_idx");
  check_launch(fasn_qmm_argmax(x.data_ptr(), w.data_ptr(), scales.data_ptr<float>(),
                               part_val.data_ptr<float>(), part_idx.data_ptr<int>(),
                               idx.data_ptr<int>(), val.data_ptr<float>(), as_int(M, what),
                               as_int(K, what), as_int(N, what), dtype, static_cast<int>(bm),
                               as_int(ctas, what), tma ? 1 : 0, stream_of(x)),
               what);
}

// new rows (NL, B, KVH, D) for a cache (NL, B, KVH, S|W, D) of one dtype;
// returns the row's bytes
int check_rows(const at::Tensor& cache, const at::Tensor& rows, const at::Tensor& ref,
               const char* what) {
  check_on(cache, ref, what);
  check_on(rows, ref, what);
  TORCH_CHECK_VALUE(cache.dim() == 5, what, ": caches must be (NL, B, KVH, S, D)");
  check_shape(rows, {cache.size(0), cache.size(1), cache.size(2), cache.size(4)},
              cache.scalar_type(), what, "new rows");
  const int64_t row_bytes = cache.size(4) * cache.element_size();
  TORCH_CHECK_VALUE(row_bytes % 4 == 0, what, ": rows must be a multiple of 4 bytes");
  // the kernel counts cache rows and new rows' words in 32 bits
  TORCH_CHECK_VALUE(cache.numel() / std::max<int64_t>(cache.size(4), 1) <= INT_MAX &&
                        rows.numel() * rows.element_size() / 4 <= INT_MAX - 256,
                    what, ": caches of 2^31 rows, or new rows of 2^31 words, are too large");
  return as_int(row_bytes, what);
}

// the bytes a thread of K3/K4 moves for this (cache, new rows) pair
int64_t cache_vector_bytes(const at::Tensor& cache, const at::Tensor& rows) {
  const char* what = "cache_vector_bytes";
  const int row_bytes = check_rows(cache, rows, cache, what);
  return fasn_row_vector_bytes(row_bytes, cache.data_ptr(), rows.data_ptr());
}

void cache_append(at::TensorList caches, at::TensorList news, const at::Tensor& positions) {
  const char* what = "cache_append";
  const size_t n = caches.size();
  TORCH_CHECK_VALUE(n >= 1 && n <= 4 && news.size() == n, what,
                    " takes 1 to 4 (cache, new) pairs");
  const at::Tensor& c0 = caches[0];
  TORCH_CHECK_VALUE(c0.dim() == 5, what, ": caches must be (NL, B, KVH, S, D)");
  const c10::cuda::CUDAGuard guard(c0.device());
  void* dst[4];
  const void* src[4];
  int row_bytes[4];
  for (size_t t = 0; t < n; ++t) {
    row_bytes[t] = check_rows(caches[t], news[t], c0, what);
    TORCH_CHECK_VALUE(caches[t].sizes().slice(0, 4) == c0.sizes().slice(0, 4), what,
                      ": all caches must share (NL, B, KVH, S)");
    dst[t] = caches[t].data_ptr();
    src[t] = news[t].data_ptr();
  }
  check_on(positions, c0, what);
  check_shape(positions, {c0.size(1)}, at::kInt, what, "positions");
  check_launch(fasn_cache_append(static_cast<int>(n), dst, src, row_bytes,
                                 positions.data_ptr<int>(), as_int(c0.size(0), what),
                                 as_int(c0.size(1), what), as_int(c0.size(2), what),
                                 as_int(c0.size(3), what), stream_of(c0)),
               what);
}

void tail_append(const at::Tensor& k_tail, const at::Tensor& v_tail, const at::Tensor& k_new,
                 const at::Tensor& v_new, int64_t index) {
  const char* what = "tail_append";
  TORCH_CHECK_VALUE(k_tail.dim() == 5 && v_tail.sizes() == k_tail.sizes(), what,
                    ": k and v tails must be one (NL, B, KVH, W, D) shape");
  const c10::cuda::CUDAGuard guard(k_tail.device());
  const int row_bytes = check_rows(k_tail, k_new, k_tail, what);
  check_rows(v_tail, v_new, k_tail, what);
  TORCH_CHECK_VALUE(v_tail.scalar_type() == k_tail.scalar_type(), what,
                    ": k and v tails must share a dtype");
  TORCH_CHECK_VALUE(index >= 0 && index < k_tail.size(3), what, ": tail index ", index,
                    " outside the ring of ", k_tail.size(3));
  check_launch(fasn_tail_append(k_tail.data_ptr(), v_tail.data_ptr(), k_new.data_ptr(),
                                v_new.data_ptr(), row_bytes, static_cast<int>(index),
                                as_int(k_tail.size(0), what), as_int(k_tail.size(1), what),
                                as_int(k_tail.size(2), what), as_int(k_tail.size(3), what),
                                stream_of(k_tail)),
               what);
}

int64_t qmm_stage_k(int64_t x_dtype) {
  TORCH_CHECK_VALUE(x_dtype >= 0 && x_dtype <= 2, "qmm_stage_k: x_dtype 0, 1 or 2");
  return fasn_qmm_stage_k(static_cast<int>(x_dtype));
}

std::tuple<int64_t, int64_t> qmm_f32_layout(int64_t bm, bool dual) {
  int stages = 0;
  const int smem = fasn_qmm_f32_layout(static_cast<int>(bm), dual ? 1 : 0, &stages);
  TORCH_CHECK_VALUE(smem > 0, "qmm_f32_layout: f32 tiles are 64 or 128 rows, got ", bm);
  return {stages, smem};
}

void qmm(const at::Tensor& x, const std::optional<at::Tensor>& x_scales, const at::Tensor& w,
         const at::Tensor& scales, const at::Tensor& out, const at::Tensor& part, int64_t bits,
         int64_t bm, int64_t splits, int64_t slices_per_split, bool tma) {
  const char* what = "quantized_matmul";
  TORCH_CHECK_VALUE(bits == 8 || bits == 4, what, ": bits must be 8 or 4, got ", bits);
  TORCH_CHECK_VALUE(x.dim() == 2 && w.dim() == 2, what, ": x (M, K) and w (K, N) are 2-D");
  const int64_t M = x.size(0), K = x.size(1), N = w.size(1);
  TORCH_CHECK_VALUE(w.size(0) * (bits == 4 ? 2 : 1) == K, what, ": x K=", K, " and w ",
                    w.sizes(), " disagree");
  TORCH_CHECK_VALUE(bits == 8 || K % 256 == 0, what, ": int4 needs K % 256 == 0, got K=", K);
  const c10::cuda::CUDAGuard guard(x.device());
  int x_dtype;
  const float* xs_ptr = nullptr;
  if (x.scalar_type() == at::kChar) {
    TORCH_CHECK_VALUE(x_scales.has_value(), what, ": int8 x (W8A8) needs x_scales");
    check_on(*x_scales, x, what);
    check_shape(*x_scales, {M}, at::kFloat, what, "x_scales");
    xs_ptr = x_scales->data_ptr<float>();
    x_dtype = 2;
  } else {
    TORCH_CHECK_VALUE(!x_scales.has_value(), what, ": x_scales go with int8 x only");
    x_dtype = dtype_code(x, what);
  }
  for (const at::Tensor* t : {&x, &w, &scales, &out}) check_on(*t, x, what);
  check_shape(w, {w.size(0), N}, at::kChar, what, "w");
  check_shape(scales, {N}, at::kFloat, what, "scales");
  TORCH_CHECK_VALUE(out.sizes() == at::IntArrayRef({M, N}), what, ": out must be (M, N)");
  // the plan: every K slice in one split, none empty; TMA only where the
  // row strides and base addresses are multiples of 16 bytes
  const int64_t stage_k = fasn_qmm_stage_k(x_dtype);
  const int64_t n_slices = (K + stage_k - 1) / stage_k;
  TORCH_CHECK_VALUE(bm == 64 || bm == 128 || (x_dtype == 1 && bm == 256),
                    what, ": bm ", bm, " is not a tile height of this mode");
  TORCH_CHECK_VALUE(splits >= 1 && slices_per_split >= 1 &&
                        splits * slices_per_split >= n_slices &&
                        (splits - 1) * slices_per_split < n_slices,
                    what, ": ", splits, " splits of ", slices_per_split, " slices do not cover ",
                    n_slices, " slices once");
  if (tma) {
    TORCH_CHECK_VALUE((K * x.element_size()) % 16 == 0 && N % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(w.data_ptr()) % 16 == 0,
                      what, ": TMA needs 16-byte row strides and addresses");
  }
  void* part_ptr = nullptr;
  if (splits > 1) {
    check_on(part, x, what);
    check_shape(part, {splits, M, N}, at::kFloat, what, "part");
    part_ptr = part.data_ptr();
  }
  check_launch(fasn_qmm(x.data_ptr(), xs_ptr, w.data_ptr(), scales.data_ptr<float>(), part_ptr,
                        out.data_ptr(), as_int(M, what), as_int(K, what), as_int(N, what),
                        x_dtype, static_cast<int>(bits), dtype_code(out, what),
                        static_cast<int>(bm), as_int(splits, what),
                        as_int(slices_per_split, what), tma ? 1 : 0, stream_of(x)),
               what);
}

// one phase of K9's plan: a tile height of the kernels (bf16 x 64, 128 or
// 256; f32 x 64 or 128), K slices (64 rows for bf16 x, 32 for f32) covered
// once, TMA only where x's and w's row strides and bases are multiples of
// 16 bytes
void check_mlp_phase(const char* what, const char* phase, int64_t bm, int64_t k, int64_t n,
                     int64_t splits, int64_t per, int64_t tma, const at::Tensor& x,
                     std::initializer_list<const at::Tensor*> ws) {
  const bool f32 = x.scalar_type() == at::kFloat;
  TORCH_CHECK_VALUE(bm == 64 || bm == 128 || (bm == 256 && !f32), what, ": ", phase, " bm ", bm,
                    " is not a tile height");
  const int64_t bk = f32 ? 32 : 64, n_slices = (k + bk - 1) / bk;
  TORCH_CHECK_VALUE(splits >= 1 && per >= 1 && splits * per >= n_slices &&
                        (splits - 1) * per < n_slices,
                    what, ": ", phase, " ", splits, " splits of ", per, " slices do not cover ",
                    n_slices, " slices once");
  if (tma) {
    bool ok = (k * x.element_size()) % 16 == 0 && n % 16 == 0 &&
              reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0;
    for (const at::Tensor* w : ws) ok = ok && reinterpret_cast<uintptr_t>(w->data_ptr()) % 16 == 0;
    TORCH_CHECK_VALUE(ok, what, ": ", phase, " TMA needs 16-byte row strides and addresses");
  }
}

void fused_mlp(const at::Tensor& x, const at::Tensor& wg, const at::Tensor& sg,
               const at::Tensor& wu, const at::Tensor& su, const at::Tensor& wd,
               const at::Tensor& sd, const at::Tensor& out, const at::Tensor& h,
               const at::Tensor& gu_part, const at::Tensor& dn_part, at::IntArrayRef plan) {
  const char* what = "fused_mlp_matmul";
  TORCH_CHECK_VALUE(x.dim() == 2 && wg.dim() == 2, what, ": x (M, K) and wg (K, F) are 2-D");
  const int64_t M = x.size(0), K = x.size(1), F = wg.size(1);
  const c10::cuda::CUDAGuard guard(x.device());
  FasnMlp a{};
  a.dtype = dtype_code(x, what);
  for (const at::Tensor* t : {&x, &wg, &sg, &wu, &su, &wd, &sd, &out}) check_on(*t, x, what);
  check_shape(wg, {K, F}, at::kChar, what, "wg");
  check_shape(wu, {K, F}, at::kChar, what, "wu");
  check_shape(wd, {F, K}, at::kChar, what, "wd");
  check_shape(sg, {F}, at::kFloat, what, "sg");
  check_shape(su, {F}, at::kFloat, what, "su");
  check_shape(sd, {K}, at::kFloat, what, "sd");
  check_shape(out, {M, K}, x.scalar_type(), what, "out");
  TORCH_CHECK_VALUE(plan.size() == 10, what, ": the plan has 10 entries, got ", plan.size());
  check_mlp_phase(what, "gate/up", plan[0], K, F, plan[2], plan[3], plan[4], x, {&wg, &wu});
  check_on(h, x, what);
  check_shape(h, {M, F}, x.scalar_type(), what, "h");
  check_mlp_phase(what, "down", plan[5], F, K, plan[7], plan[8], plan[9], h, {&wd});
  if (plan[2] > 1) {
    check_on(gu_part, x, what);
    check_shape(gu_part, {2 * plan[2], M, F}, at::kFloat, what, "gu_part");
    a.gu_part = gu_part.data_ptr<float>();
  }
  if (plan[7] > 1) {
    check_on(dn_part, x, what);
    check_shape(dn_part, {plan[7], M, K}, at::kFloat, what, "dn_part");
    a.dn_part = dn_part.data_ptr<float>();
  }
  a.h = h.data_ptr();
  int q[10];
  for (int i = 0; i < 10; ++i) q[i] = as_int(plan[i], what);
  const FasnMlpPlan p{q[0], q[1], q[2], q[3], q[4] != 0, q[5], q[6], q[7], q[8], q[9] != 0};
  a.x = x.data_ptr();
  a.wg = wg.data_ptr();
  a.sg = sg.data_ptr<float>();
  a.wu = wu.data_ptr();
  a.su = su.data_ptr<float>();
  a.wd = wd.data_ptr();
  a.sd = sd.data_ptr<float>();
  a.out = out.data_ptr();
  a.M = as_int(M, what);
  a.K = as_int(K, what);
  a.F = as_int(F, what);
  check_launch(fasn_fused_mlp(&a, &p, stream_of(x)), what);
}

int kv_code(const at::Tensor& t, const char* what) {
  if (t.scalar_type() == at::kFloat) return 0;
  if (t.scalar_type() == at::kBFloat16) return 1;
  if (t.scalar_type() == at::kChar) return 2;
  if (t.scalar_type() == at::kFloat8_e4m3fn) return 3;
  TORCH_CHECK_VALUE(false, what, " takes f32, bf16, int8 or fp8 e4m3 caches, got ",
                    t.scalar_type());
  return -1;
}

// a cache view (B, KVH, S, D|1) on ref's card with unit stride along D
void check_view(const at::Tensor& t, const at::Tensor& ref, at::IntArrayRef shape,
                const char* what, const char* name) {
  TORCH_CHECK_VALUE(t.is_cuda() && t.device() == ref.device(), what,
                    ": all tensors must be on one CUDA device");
  TORCH_CHECK_VALUE(t.sizes() == shape, what, ": ", name, " must be ", shape, ", got ",
                    t.sizes());
  TORCH_CHECK_VALUE(shape[3] == 1 || t.stride(3) == 1, what, ": ", name,
                    " needs unit stride along the head dim");
}

void decode_attn(const at::Tensor& q, const std::optional<at::Tensor>& q_scales,
                 const at::Tensor& k, const at::Tensor& v,
                 const std::optional<at::Tensor>& k_scales,
                 const std::optional<at::Tensor>& v_scales, const at::Tensor& lengths,
                 const at::Tensor& acc, const at::Tensor& m, const at::Tensor& l,
                 const at::Tensor& part_acc, const at::Tensor& part_m, const at::Tensor& part_l,
                 int64_t split, int64_t products) {
  const char* what = "decode_attention_n";
  TORCH_CHECK_VALUE(q.dim() == 4 && k.dim() == 4, what,
                    ": q (B, KVH, G, hd) and k (B, KVH, S, hd) are 4-D");
  const int64_t B = q.size(0), KVH = q.size(1), G = q.size(2), HD = q.size(3), S = k.size(2);
  TORCH_CHECK_VALUE(G >= 1 && G <= 16 && HD >= 1, what,
                    ": needs 1 <= G <= 16 query rows per KV head and hd >= 1, got G=", G,
                    " hd=", HD);
  const c10::cuda::CUDAGuard guard(q.device());
  FasnDecode a{};
  if (q.scalar_type() == at::kChar) {
    TORCH_CHECK_VALUE(q_scales.has_value() && k.scalar_type() == at::kChar, what,
                      ": int8 q (int8 compute) needs q_scales and an int8 cache");
    check_on(*q_scales, q, what);
    check_shape(*q_scales, {B, KVH, G}, at::kFloat, what, "q_scales");
    a.q_scales = q_scales->data_ptr<float>();
    a.q_dtype = 2;
  } else {
    a.q_dtype = dtype_code(q, what);
  }
  check_on(q, q, what);
  a.kv_dtype = kv_code(k, what);
  check_view(k, q, {B, KVH, S, HD}, what, "k");
  check_view(v, q, {B, KVH, S, HD}, what, "v");
  TORCH_CHECK_VALUE(v.scalar_type() == k.scalar_type(), what, ": k and v must share a dtype");
  TORCH_CHECK_VALUE(k_scales.has_value() == v_scales.has_value() &&
                        k_scales.has_value() == (a.kv_dtype >= 2),
                    what, ": an int8 or fp8 cache needs k and v scales, a dense one none");
  if (k_scales.has_value()) {
    for (const at::Tensor* t : {&*k_scales, &*v_scales}) {
      check_view(*t, q, {B, KVH, S, 1}, what, "scales");
      TORCH_CHECK_VALUE(t->scalar_type() == at::kFloat, what, ": scales must be f32");
    }
    a.k_scales = k_scales->data_ptr<float>();
    a.v_scales = v_scales->data_ptr<float>();
    a.ks_sb = k_scales->stride(0);
    a.ks_sh = k_scales->stride(1);
    a.ks_ss = k_scales->stride(2);
    a.vs_sb = v_scales->stride(0);
    a.vs_sh = v_scales->stride(1);
    a.vs_ss = v_scales->stride(2);
  }
  check_on(lengths, q, what);
  check_shape(lengths, {B}, at::kInt, what, "lengths");
  TORCH_CHECK_VALUE(fasn_decode_attn_plan_ok(as_int(split, what), as_int(products, what),
                                            as_int(G, what), as_int(HD, what), a.q_dtype,
                                            a.kv_dtype),
                    what, ": a split of ", split, " positions with products ", products,
                    " is not a plan the kernel takes here");
  const int64_t splits = (S + split - 1) / split;
  for (const at::Tensor* t : {&acc, &m, &l, &part_acc, &part_m, &part_l}) check_on(*t, q, what);
  check_shape(acc, {B, KVH, G, HD}, at::kFloat, what, "acc");
  check_shape(m, {B, KVH, G}, at::kFloat, what, "m");
  check_shape(l, {B, KVH, G}, at::kFloat, what, "l");
  check_shape(part_acc, {B, KVH, splits, G, HD}, at::kFloat, what, "part_acc");
  check_shape(part_m, {B, KVH, splits, G}, at::kFloat, what, "part_m");
  check_shape(part_l, {B, KVH, splits, G}, at::kFloat, what, "part_l");
  a.q = q.data_ptr();
  a.k = k.data_ptr();
  a.v = v.data_ptr();
  a.lengths = lengths.data_ptr<int>();
  a.k_sb = k.stride(0);
  a.k_sh = k.stride(1);
  a.k_ss = k.stride(2);
  a.v_sb = v.stride(0);
  a.v_sh = v.stride(1);
  a.v_ss = v.stride(2);
  a.B = as_int(B, what);
  a.KVH = as_int(KVH, what);
  a.G = as_int(G, what);
  a.HD = as_int(HD, what);
  a.S = as_int(S, what);
  check_launch(fasn_decode_attn(&a, static_cast<int>(split), static_cast<int>(products),
                                part_acc.data_ptr<float>(),
                                part_m.data_ptr<float>(),
                                part_l.data_ptr<float>(), acc.data_ptr<float>(),
                                m.data_ptr<float>(), l.data_ptr<float>(), stream_of(q)),
               what);
}

void prefill_phase(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                   const at::Tensor& o, int64_t mode) {
  const char* what = "prefill_phase";
  TORCH_CHECK_VALUE(q.dim() == 4, what, ": q, k, v and o are (B, H, L, D)");
  TORCH_CHECK_VALUE(mode >= 0 && mode <= 3, what, ": mode must be 0-3, got ", mode);
  check_head_dim(q.size(3), what);
  const int64_t D = q.size(3);
  const c10::cuda::CUDAGuard guard(q.device());
  const int dtype = dtype_code(q, what);
  for (const at::Tensor* t : {&q, &k, &v, &o}) {
    check_on(*t, q, what);
    check_shape(*t, q.sizes(), q.scalar_type(), what, "k, v and o");
  }
  check_tma({&q, &k, &v}, what);
  check_launch(fasn_prefill_phase(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                  as_int(q.size(0), what), as_int(q.size(1), what),
                                  as_int(q.size(2), what), as_int(D, what), dtype,
                                  static_cast<int>(mode), stream_of(q)),
               what);
}

}  // namespace

TORCH_LIBRARY(fasn, m) {
  m.def(
      "flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? slopes, Tensor? seed, "
      "Tensor(a!) o, Tensor(b!) lse, float scale, float n, bool causal, int drop_threshold, "
      "float drop_mult) -> ()");
  m.def(
      "flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? slopes, Tensor? seed, "
      "Tensor dout, Tensor lse, Tensor delta, Tensor(a!) dq, Tensor(b!)? dbias, "
      "Tensor(c!)? dslope_rows, float scale_q, float scale, bool causal, int drop_threshold, "
      "float drop_mult) -> ()");
  m.def(
      "flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor? bias, Tensor? slopes, Tensor? seed, "
      "Tensor dout, Tensor lse, Tensor delta, Tensor(a!) dk, Tensor(b!) dv, float scale_q, "
      "bool causal, int drop_threshold, float drop_mult) -> ()");
  m.def(
      "qmm_argmax(Tensor x, Tensor w, Tensor scales, Tensor(a!) idx, Tensor(b!) val, "
      "Tensor(c!) part_val, Tensor(d!) part_idx, int bm, int ctas, bool tma) -> ()");
  m.def("cache_vector_bytes(Tensor cache, Tensor rows) -> int");
  m.def("cache_append(Tensor(a!)[] caches, Tensor[] news, Tensor positions) -> ()");
  m.def(
      "tail_append(Tensor(a!) k_tail, Tensor(b!) v_tail, Tensor k_new, Tensor v_new, "
      "int index) -> ()");
  m.def("qmm_stage_k(int x_dtype) -> int", &qmm_stage_k);
  m.def("qmm_f32_layout(int bm, bool dual=False) -> (int, int)", &qmm_f32_layout);
  m.def(
      "qmm(Tensor x, Tensor? x_scales, Tensor w, Tensor scales, Tensor(a!) out, "
      "Tensor(b!) part, int bits, int bm, int splits, int slices_per_split, "
      "bool tma) -> ()");
  m.def(
      "fused_mlp(Tensor x, Tensor wg, Tensor sg, Tensor wu, Tensor su, Tensor wd, Tensor sd, "
      "Tensor(a!) out, Tensor(b!) h, Tensor(c!) gu_part, Tensor(d!) dn_part, int[] plan) -> ()");
  m.def(
      "decode_attn(Tensor q, Tensor? q_scales, Tensor k, Tensor v, Tensor? k_scales, "
      "Tensor? v_scales, Tensor lengths, Tensor(a!) acc, Tensor(b!) m, Tensor(c!) l, "
      "Tensor(d!) part_acc, Tensor(e!) part_m, Tensor(f!) part_l, int split, int products) "
      "-> ()");
  m.def("prefill_phase(Tensor q, Tensor k, Tensor v, Tensor(a!) o, int mode) -> ()");
}

TORCH_LIBRARY_IMPL(fasn, CUDA, m) {
  m.impl("flash_fwd", &flash_fwd);
  m.impl("flash_bwd_dq", &flash_bwd_dq);
  m.impl("flash_bwd_dkv", &flash_bwd_dkv);
  m.impl("qmm_argmax", &qmm_argmax);
  m.impl("cache_vector_bytes", &cache_vector_bytes);
  m.impl("cache_append", &cache_append);
  m.impl("tail_append", &tail_append);
  m.impl("qmm", &qmm);
  m.impl("fused_mlp", &fused_mlp);
  m.impl("decode_attn", &decode_attn);
  m.impl("prefill_phase", &prefill_phase);
}
