// Hopper (sm_90a) building blocks shared by the tensor-core kernels: K7
// (qmm.cu), K1 (flash_fwd.cu; in f32 at D <= 128 flash_fwd_f32.cu), K5
// (flash_bwd_dq.cu), K6 (flash_bwd_dkv.cu; both in f32 at D <= 128 in
// flash_bwd_f32.cu, above in flash_bwd_f32_wide.cu) and K10
// (prefill_phases.cu).
// Inline PTX for
// shared-memory addresses, mbarriers, TMA loads, proxy fences, wgmma
// operand descriptors and wgmma itself, and on the host libcuda's
// cuTensorMapEncodeTiled. Device code: only the .cu files, compiled by
// nvcc, include it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed; a phase that never
// completes (a fault in the ring's bookkeeping) traps after about ten
// seconds instead of holding the card. With TRAP false the wait gives up
// after about a second instead and the kernel runs on to a wrong result,
// which the checks against the plain versions catch: a kernel whose
// warpgroups trade registers with setmaxnreg takes it, since ptxas keeps
// every thread at the launch's register count when one trap block serves
// warpgroups of different counts
template <bool TRAP = true>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if constexpr (TRAP) {
      if (clock64() - start > (1ll << 34)) __trap();
    } else if (clock64() - start > (1ll << 31)) {
      return;
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the 128-byte swizzle of a byte offset in a 1024-byte-aligned tile: the
// 16-byte chunk index (bits 4-6) XOR the row within 8 (bits 7-9)
__device__ __forceinline__ uint32_t sw128(uint32_t off) { return off ^ ((off >> 3) & 0x70u); }

// wgmma operand descriptor of a K-major tile with 128-byte rows and the
// 128-byte swizzle: 8-row groups 1024 bytes apart (SBO 64 x 16 B), LBO unused
// A wgmma operand descriptor by its fields: start address, leading and
// stride byte offsets (bytes, multiples of 16) and layout (1: 128-byte
// swizzle, 2: 64-byte swizzle). K-major swizzled tiles (rows of 128 or 64
// bytes along K): SBO is the distance between 8-row groups, LBO unused.
// MN-major ones (rows along K, the 128 or 64 contiguous bytes along M or
// N): SBO is the distance between groups of 8 K rows, LBO between blocks
// of 128 (or 64) bytes along M or N.
__device__ __forceinline__ uint64_t desc_of(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                            uint32_t layout) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// a K-major tile with 128-byte rows and the 128-byte swizzle: 8-row groups
// 1024 bytes apart, LBO unused
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return desc_of(saddr, 16, 1024, 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define HOP_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define HOP_D16(c, i) HOP_D4(c, i), HOP_D4(c, i + 4), HOP_D4(c, i + 8), HOP_D4(c, i + 12)
#define HOP_D32(c) HOP_D16(c, 0), HOP_D16(c, 16)
#define HOP_D64(c) HOP_D32(c), HOP_D16(c, 32), HOP_D16(c, 48)
#define HOP_D96(c) HOP_D64(c), HOP_D16(c, 64), HOP_D16(c, 80)
#define HOP_D128(c) HOP_D64(c), HOP_D16(c, 64), HOP_D16(c, 80), HOP_D16(c, 96), HOP_D16(c, 112)
#define HOP_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HOP_REGS32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOP_REGS64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define HOP_REGS96                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "  \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "  \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "  \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "  \
  "%92, %93, %94, %95}"
#define HOP_REGS128                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "   \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "    \
  "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "    \
  "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "    \
  "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "    \
  "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "      \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "    \
  "%123, %124, %125, %126, %127}"
#define HOP_F(r) "+f"(r)
#define HOP_R(r) "+r"(r)

// d += A (64 x 16, bf16, in registers) * B (16 x N, bf16, in shared memory;
// K-major, or MN-major where TB is 1), N = 256, 192, 128, 64 or 32 by the
// size of d
template <int TB = 0>
__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " HOP_REGS128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : HOP_D128(HOP_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " HOP_REGS96
      ", {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n"
      "}\n"
      : HOP_D96(HOP_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOP_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : HOP_D64(HOP_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : HOP_D32(HOP_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

template <int TB = 0>
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOP_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : HOP_D16(HOP_F, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// d = A (64 x 16) * B (16 x N) + (accumulate ? d : 0), bf16 A and B both
// K-major in shared memory, N = 128, 64 or 32 by the size of d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOP_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOP_D64(HOP_F)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOP_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOP_D32(HOP_F)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HOP_REGS16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOP_D16(HOP_F, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A (64 x 32, s8) * B (32 x 128, s8) in int32, both K-major in shared memory
__device__ __forceinline__ void wgmma(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOP_REGS64
      ", %64, %65, p;\n"
      "}\n"
      : HOP_D64(HOP_R)
      : "l"(a), "l"(b), "r"(1));
}

// TF32 products (the split-TF32 kernels of K1, K5 and K6, tf32x3.h): d +=
// A (64 x 8) * B (8 x N), f32 accumulators, N by the size of d: A in shared
// memory N = 64, 32 or 16, A in registers N = 64 or 32. TF32 has no
// transpose bit: A and B in shared memory are both K-major (8 f32 values,
// 32 bytes, along K per row). The tensor cores read the top 19 bits of
// each f32 word (sign, exponent, 10 mantissa bits) and ignore the low 13.
// A in registers: a[0] (row g, k t), a[1] (row g + 8, k t), a[2] (row g, k
// t + 4), a[3] (row g + 8, k t + 4) of the warp's 16 rows, g = lane / 4,
// t = lane % 4.
#define HOP_D8(c) HOP_D4(c, 0), HOP_D4(c, 4)
#define HOP_REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOP_REGS32
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : HOP_D32(HOP_F)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " HOP_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : HOP_D32(HOP_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HOP_REGS16
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : HOP_D16(HOP_F, 0)
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " HOP_REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : HOP_D16(HOP_F, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " HOP_REGS8
      ", %8, %9, p, 1, 1;\n"
      "}\n"
      : HOP_D8(HOP_F)
      : "l"(a), "l"(b), "r"(1));
}

// a warpgroup's registers a thread: N (a multiple of 8 in [24, 256]) from
// here on, taken from (inc) or given back to (dec) the CTA's pool; every
// warp of the warpgroup executes it
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

// keeps the compiler from moving accumulator accesses across wgmma
template <typename T, int R>
__device__ __forceinline__ void fence_regs(T (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(d[i])::"memory");
    else
      asm volatile("" : "+r"(d[i])::"memory");
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands it over, so
// the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace hopper
