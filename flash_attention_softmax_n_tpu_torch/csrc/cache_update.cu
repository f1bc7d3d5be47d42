// K3 cache_append and K4 tail_append: in-place KV row writes for Hopper.
//
// Replace the Pallas kernels _kernel and _tail_kernel
// (flash_attention_softmax_n_tpu/kernels/cache_update.py:92, :40):
//   cache_append: cache_t[l, b, h, positions[b], :] = new_t[l, b, h, :]
//                 for up to four tensors t (int8 values, f32 scale planes);
//   tail_append:  tail[l, b, h, index, :] = new[l, b, h, :] for k and v at
//                 one ring index shared by every slot.
// The TPU kernels rewrite an aligned 8-row window because a block cannot
// address one row; here each thread moves one 4-byte word of one new row
// straight to its place, so only the new rows' bytes are read and written.
// The bound is those bytes over device-memory bandwidth; at decode sizes
// (under 2 MB) the launch itself dominates.

#include <cuda_runtime.h>

#include <cstdint>

#include "launchers.h"

namespace {

constexpr int MAX_TENSORS = 4;
constexpr int THREADS = 256;

struct RowWrites {
  uint32_t* dst[MAX_TENSORS];
  const uint32_t* src[MAX_TENSORS];
  int row_words[MAX_TENSORS];
  int n;
};

// Rows of each source are (NL, B, KVH) in order; destination row r of
// source row (l, b, h) sits at ((l * B + b) * KVH + h) * S + pos, where pos
// is positions[b] or, without positions, the shared index.
__global__ void write_rows_kernel(RowWrites a, const int* __restrict__ positions, int index,
                                  long long rows, int B, int KVH, int S) {
  for (int t = 0; t < a.n; ++t) {
    const int rw = a.row_words[t];
    const long long total = rows * rw;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
      const long long row = e / rw;
      const int word = (int)(e % rw);
      const long long lb = row / KVH;
      const int h = (int)(row % KVH);
      const int b = (int)(lb % B);
      const long long l = lb / B;
      const int pos = positions ? positions[b] : index;
      if (pos < 0 || pos >= S) continue;
      a.dst[t][(((l * B + b) * KVH + h) * S + pos) * rw + word] = a.src[t][e];
    }
  }
}

cudaError_t launch(const RowWrites& a, const int* positions, int index, long long rows, int B,
                   int KVH, int S, cudaStream_t stream) {
  long long words = 0;
  for (int t = 0; t < a.n; ++t) words += rows * a.row_words[t];
  long long blocks = (words + THREADS - 1) / THREADS;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) blocks = 1;
  write_rows_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(a, positions, index, rows, B, KVH,
                                                             S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fasn_cache_append(int n, void* const* caches, const void* const* news,
                                 const int* row_bytes, const int* positions, int NL, int B,
                                 int KVH, int S, cudaStream_t stream) {
  if (n < 1 || n > MAX_TENSORS) return cudaErrorInvalidValue;
  RowWrites a{};
  a.n = n;
  for (int t = 0; t < n; ++t) {
    if (row_bytes[t] % 4) return cudaErrorInvalidValue;
    a.dst[t] = static_cast<uint32_t*>(caches[t]);
    a.src[t] = static_cast<const uint32_t*>(news[t]);
    a.row_words[t] = row_bytes[t] / 4;
  }
  return launch(a, positions, 0, (long long)NL * B * KVH, B, KVH, S, stream);
}

extern "C" int fasn_tail_append(void* k_tail, void* v_tail, const void* k_new, const void* v_new,
                                int row_bytes, int index, int NL, int B, int KVH, int W,
                                cudaStream_t stream) {
  if (row_bytes % 4) return cudaErrorInvalidValue;
  RowWrites a{};
  a.n = 2;
  a.dst[0] = static_cast<uint32_t*>(k_tail);
  a.dst[1] = static_cast<uint32_t*>(v_tail);
  a.src[0] = static_cast<const uint32_t*>(k_new);
  a.src[1] = static_cast<const uint32_t*>(v_new);
  a.row_words[0] = a.row_words[1] = row_bytes / 4;
  return launch(a, nullptr, index, (long long)NL * B * KVH, B, KVH, W, stream);
}
