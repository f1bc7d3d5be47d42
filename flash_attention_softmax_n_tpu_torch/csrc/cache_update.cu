// K3 cache_append and K4 tail_append: in-place KV row writes for Hopper.
//
// Replace the Pallas kernels _kernel and _tail_kernel
// (flash_attention_softmax_n_tpu/kernels/cache_update.py:92, :40):
//   cache_append: cache_t[l, b, h, positions[b], :] = new_t[l, b, h, :]
//                 for up to four tensors t (int8 or fp8 values moved as
//                 bytes, f32 scale planes of one word a row, dense caches);
//   tail_append:  tail[l, b, h, index, :] = new[l, b, h, :] for k and v at
//                 one ring index shared by every slot.
// Rows whose position lies outside [0, S) are skipped.
//
// The TPU kernels rewrite an aligned 8-row window because a block cannot
// address one row; here only the new rows' bytes are read and written.
// What bounds it on the H100: those bytes over device-memory bandwidth
// (at B256 K4 moves 11.5 MB, 0.0034 ms at 3.35 TB/s); at decode sizes
// (under 2 MB) the launch itself.
//
// append_rows_kernel: one launch for every tensor of the call, a flat grid
// of blocks in which each tensor owns a contiguous range (no serial tensor
// loop, no grid-stride loop). A thread moves one vector: 16 bytes (uint4)
// where the tensor's row bytes are a multiple of 16 and both base pointers
// 16-byte aligned, else one 4-byte word (the scale planes, views offset by
// 4 bytes); the host chooses the width per tensor (fasn_row_vector_bytes).
// Reads are contiguous and a warp writes whole rows (8 int8 or 4 bf16 D64
// rows at 16 bytes a thread). Index arithmetic is 32-bit and done once a
// vector: row = v / vecs_per_row, b = (row / KVH) % B, destination vector
// (row * S + pos) * vecs_per_row + lane, widened to 64 bits only for that
// last product; the launcher refuses shapes whose counts do not fit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "launchers.h"

namespace {

constexpr int MAX_TENSORS = 4;
constexpr int THREADS = 256;

// One tensor's rows: vectors of 16 bytes (wide) or 4, vecs_per_row a row,
// and the first block of its range in the flat grid.
struct Rows {
  char* dst;
  const char* src;
  int vecs_per_row;
  int vecs;  // rows * vecs_per_row
  int first_block;
  int wide;
};

struct RowWrites {
  Rows t[MAX_TENSORS];
  int n;
};

// Rows of each source are (NL, B, KVH) in order, so source row `row` of
// (l, b, h) lands at cache row row * S + pos, where pos is positions[b]
// or, without positions, the shared index.
template <typename V>
__device__ __forceinline__ void move_vector(const Rows& r, int v, const int* positions,
                                            int index, int B, int KVH, int S) {
  const int row = v / r.vecs_per_row;
  const int lane = v - row * r.vecs_per_row;
  const int pos = positions ? __ldg(positions + (row / KVH) % B) : index;
  if (static_cast<unsigned>(pos) >= static_cast<unsigned>(S)) return;
  const V x = __ldg(reinterpret_cast<const V*>(r.src) + v);
  reinterpret_cast<V*>(r.dst)[static_cast<long long>(row * S + pos) * r.vecs_per_row + lane] = x;
}

__global__ void __launch_bounds__(THREADS)
    append_rows_kernel(const __grid_constant__ RowWrites a, const int* __restrict__ positions,
                       int index, int B, int KVH, int S) {
  // this block's tensor: the last whose range starts at or before it
  // (selected field by field, so the parameters are never indexed at run time)
  Rows r = a.t[0];
#pragma unroll
  for (int i = 1; i < MAX_TENSORS; ++i)
    if (i < a.n && static_cast<int>(blockIdx.x) >= a.t[i].first_block) r = a.t[i];
  const int v = (static_cast<int>(blockIdx.x) - r.first_block) * THREADS + threadIdx.x;
  if (v >= r.vecs) return;
  if (r.wide)
    move_vector<uint4>(r, v, positions, index, B, KVH, S);
  else
    move_vector<uint32_t>(r, v, positions, index, B, KVH, S);
}

// rows: NL * B * KVH new rows a tensor; every count the kernel forms in
// 32 bits (cache rows, vectors, blocks) must fit an int
cudaError_t launch(RowWrites& a, const int* row_bytes, const int* positions, int index,
                   long long rows, int B, int KVH, int S, cudaStream_t stream) {
  if (rows * S > INT_MAX) return cudaErrorInvalidValue;
  long long blocks = 0;
  for (int t = 0; t < a.n; ++t) {
    const int vec = fasn_row_vector_bytes(row_bytes[t], a.t[t].dst, a.t[t].src);
    if (vec == 0) return cudaErrorInvalidValue;
    const long long vecs = rows * (row_bytes[t] / vec);
    if (vecs > INT_MAX - THREADS) return cudaErrorInvalidValue;
    a.t[t].wide = vec == 16;
    a.t[t].vecs_per_row = row_bytes[t] / vec;
    a.t[t].vecs = static_cast<int>(vecs);
    a.t[t].first_block = static_cast<int>(blocks);
    blocks += (vecs + THREADS - 1) / THREADS;
  }
  if (blocks == 0) return cudaSuccess;  // no rows: nothing to write
  append_rows_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(a, positions, index,
                                                                            B, KVH, S);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fasn_row_vector_bytes(int row_bytes, const void* dst, const void* src) {
  if (row_bytes <= 0 || row_bytes % 4 || reinterpret_cast<uintptr_t>(dst) % 4 ||
      reinterpret_cast<uintptr_t>(src) % 4)
    return 0;
  return row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(src) % 16 == 0
             ? 16
             : 4;
}

extern "C" int fasn_cache_append(int n, void* const* caches, const void* const* news,
                                 const int* row_bytes, const int* positions, int NL, int B,
                                 int KVH, int S, cudaStream_t stream) {
  if (n < 1 || n > MAX_TENSORS) return cudaErrorInvalidValue;
  RowWrites a{};
  a.n = n;
  for (int t = 0; t < n; ++t) {
    a.t[t].dst = static_cast<char*>(caches[t]);
    a.t[t].src = static_cast<const char*>(news[t]);
  }
  return launch(a, row_bytes, positions, 0, (long long)NL * B * KVH, B, KVH, S, stream);
}

extern "C" int fasn_tail_append(void* k_tail, void* v_tail, const void* k_new, const void* v_new,
                                int row_bytes, int index, int NL, int B, int KVH, int W,
                                cudaStream_t stream) {
  RowWrites a{};
  a.n = 2;
  a.t[0].dst = static_cast<char*>(k_tail);
  a.t[1].dst = static_cast<char*>(v_tail);
  a.t[0].src = static_cast<const char*>(k_new);
  a.t[1].src = static_cast<const char*>(v_new);
  const int both[2] = {row_bytes, row_bytes};
  return launch(a, both, nullptr, index, (long long)NL * B * KVH, B, KVH, W, stream);
}
