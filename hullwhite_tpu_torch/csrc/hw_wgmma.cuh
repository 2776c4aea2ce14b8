// Tensor-core pieces shared by the curve kernels (curve_full_kernel in
// fused_full.cu, curve_exact_kernel in fused_exact.cu): cp.async staging
// of the split weights, the warpgroup fences, the shared-memory
// descriptor of a K-major B operand without swizzle, wgmma m64nNk16 (N =
// 8 .. 32) with A from registers, and the bf16 split of fp32 values in
// registers.
// sm_90a only (wgmma).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hw {

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest N groups of this thread's copies have landed, and
// are visible to the tensor core's (async proxy's) reads once the CTA
// syncs.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\nfence.proxy.async.shared::cta;\n" ::"n"(N)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from touching v across an in-flight wgmma.
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

// Shared-memory descriptor of a K-major B operand without swizzle: start
// address, LBO (the byte distance from the core matrix of k 0-7 to that of
// k 8-15) and SBO (from one n8 group's core matrices to the next's), all
// in 16-byte units.
template <int LBO, int SBO>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

// d (64 x 8 G fp32 over the warpgroup, as G n8 groups d[0] .. d[G - 1];
// this warp's rows 16w + g, 16w + g + 8) += A (64 x 16 bf16 from the
// warps' registers, mma.m16n8k16's A layout per warp) B (16 x 8 G bf16 in
// shared memory), asynchronously: wgmma m64nNk16 with N = 8 G, G = 1 .. 4.
template <int G>
__device__ __forceinline__ void wgmma_groups(float (*d)[4], const uint32_t (&a)[4],
                                             uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_groups<1>(float (*d)[4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_groups<2>(float (*d)[4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_groups<3>(float (*d)[4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_groups<4>(float (*d)[4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// (lo, hi) rounded to nearest bf16 and packed, lo in the low half: an A
// register of two neighbouring k.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The fp32 values of a packed pair's halves.
__device__ __forceinline__ float low_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float high_f(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// Split of the pair (x0, x1) into PARTS packed bf16 pairs, largest first:
// hi = bf16(x), then (PARTS = 3) mid = bf16(x - hi), lo = bf16(x - hi -
// mid), with hi + mid + lo == x exactly (each difference is exact in
// fp32; the last has at most 8 significant bits).
template <int PARTS>
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t (&out)[PARTS]) {
  out[0] = pack_bf16x2(x0, x1);
  if constexpr (PARTS > 1) {
    const float r0 = x0 - low_f(out[0]), r1 = x1 - high_f(out[0]);
    out[1] = pack_bf16x2(r0, r1);
    out[2] = pack_bf16x2(r0 - low_f(out[1]), r1 - high_f(out[1]));
  }
}

}  // namespace hw
