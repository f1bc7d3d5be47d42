// The port's CUDA kernels as typed PyTorch operators: torch.ops.fasn.*.
//
// Each operator checks what its kernel takes (device, dtype, shape,
// contiguity, alignment) and raises ValueError on anything else, makes the
// tensors' card the current device, launches on PyTorch's current stream of
// that card, and raises with the CUDA error if the launch is refused.
// Outputs and scratch are allocated by the Python wrappers
// (flash_attention_softmax_n_tpu_torch/kernels/) and passed in, marked
// mutable in the schemas. The kernels themselves live in the .cu files and
// are reached through launchers.h.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <climits>
#include <cstdint>
#include <optional>

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

void check_shape(const at::Tensor& t, at::IntArrayRef shape, at::ScalarType dtype,
                 const char* what, const char* name) {
  TORCH_CHECK_VALUE(t.sizes() == shape && t.scalar_type() == dtype, what, ": ", name,
                    " must be ", dtype, " ", shape, ", got ", t.scalar_type(), " ", t.sizes());
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
  TORCH_CHECK_VALUE(D == 32 || D == 64 || D == 128, what,
                    " head dim must be one of (32, 64, 128), got ", D);
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

void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               const std::optional<at::Tensor>& bias, const std::optional<at::Tensor>& slopes,
               const std::optional<at::Tensor>& seed, const at::Tensor& o, const at::Tensor& lse,
               double scale, double n, bool causal, int64_t drop_threshold, double drop_mult) {
  const char* what = "flash_fwd";
  const c10::cuda::CUDAGuard guard(q.device());
  const FasnAttn a = attn_args(q, k, v, bias, slopes, seed, scale, causal, drop_threshold,
                               drop_mult, what);
  check_on(o, q, what);
  check_on(lse, q, what);
  check_shape(o, q.sizes(), q.scalar_type(), what, "o");
  check_shape(lse, {q.size(0), q.size(1), q.size(2)}, at::kFloat, what, "lse");
  check_launch(fasn_flash_fwd(&a, static_cast<float>(n), o.data_ptr(), lse.data_ptr<float>(),
                              stream_of(q)),
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
  check_launch(fasn_flash_bwd_dq(&a, dout.data_ptr(), lse.data_ptr<float>(),
                                 delta.data_ptr<float>(), static_cast<float>(scale),
                                 dq.data_ptr(), dbias_ptr, dslope_ptr, stream_of(q)),
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
  check_on(dk, q, what);
  check_on(dv, q, what);
  check_shape(dk, k.sizes(), k.scalar_type(), what, "dk");
  check_shape(dv, v.sizes(), v.scalar_type(), what, "dv");
  check_launch(fasn_flash_bwd_dkv(&a, dout.data_ptr(), lse.data_ptr<float>(),
                                  delta.data_ptr<float>(), dk.data_ptr(), dv.data_ptr(),
                                  stream_of(q)),
               what);
}

int64_t qmm_tiles(int64_t n) { return fasn_qmm_tiles(as_int(n, "qmm_tiles")); }

void qmm_argmax(const at::Tensor& x, const at::Tensor& w, const at::Tensor& scales,
                const at::Tensor& idx, const at::Tensor& val, const at::Tensor& part_val,
                const at::Tensor& part_idx) {
  const char* what = "quantized_matmul_argmax";
  TORCH_CHECK_VALUE(x.dim() == 2 && w.dim() == 2 && w.size(0) == x.size(1), what,
                    ": x (M, K) and w (K, N) must agree on K");
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t M = x.size(0), K = x.size(1), N = w.size(1);
  const int dtype = dtype_code(x, what);
  const int64_t tiles = fasn_qmm_tiles(as_int(N, what));
  for (const at::Tensor* t : {&x, &w, &scales, &idx, &val, &part_val, &part_idx})
    check_on(*t, x, what);
  check_shape(w, {K, N}, at::kChar, what, "w");
  check_shape(scales, {N}, at::kFloat, what, "scales");
  check_shape(idx, {M}, at::kInt, what, "idx");
  check_shape(val, {M}, at::kFloat, what, "val");
  check_shape(part_val, {M, tiles}, at::kFloat, what, "part_val");
  check_shape(part_idx, {M, tiles}, at::kInt, what, "part_idx");
  check_launch(fasn_qmm_argmax(x.data_ptr(), w.data_ptr(), scales.data_ptr<float>(),
                               part_val.data_ptr<float>(), part_idx.data_ptr<int>(),
                               idx.data_ptr<int>(), val.data_ptr<float>(), as_int(M, what),
                               as_int(K, what), as_int(N, what), dtype, stream_of(x)),
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
  return as_int(row_bytes, what);
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
  m.def("qmm_tiles(int n) -> int", &qmm_tiles);
  m.def(
      "qmm_argmax(Tensor x, Tensor w, Tensor scales, Tensor(a!) idx, Tensor(b!) val, "
      "Tensor(c!) part_val, Tensor(d!) part_idx) -> ()");
  m.def("cache_append(Tensor(a!)[] caches, Tensor[] news, Tensor positions) -> ()");
  m.def(
      "tail_append(Tensor(a!) k_tail, Tensor(b!) v_tail, Tensor k_new, Tensor v_new, "
      "int index) -> ()");
}

TORCH_LIBRARY_IMPL(fasn, CUDA, m) {
  m.impl("flash_fwd", &flash_fwd);
  m.impl("flash_bwd_dq", &flash_bwd_dq);
  m.impl("flash_bwd_dkv", &flash_bwd_dkv);
  m.impl("qmm_argmax", &qmm_argmax);
  m.impl("cache_append", &cache_append);
  m.impl("tail_append", &tail_append);
}
