// Tensor-core and async-copy primitives shared by the matrix-product tiles
// (mm_tiles.cuh) and the attention tiles (attn_tiles.cuh): the mma.sync
// instructions with fp32 accumulators, the TF32 hi / lo split behind
// 3xTF32, and 16-byte cp.async copies into shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// ---- tensor-core instructions: D += A B, fp32 accumulators ------------
struct Bf16 {};   // m16n8k16, bf16 operands
struct F16 {};    // m16n8k16, fp16 operands
struct Tf32 {};   // m16n8k8, tf32 operands

__device__ __forceinline__ void mma(Bf16, float (&d)[4],
                                    const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(F16, float (&d)[4],
                                    const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(Tf32, float (&d)[4],
                                    const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- operand splits ------------------------------------------------------
constexpr uint32_t kTf32Mask = 0xffffe000u;   // tf32: 13 low mantissa bits 0

// a -> tf32 hi, lo: hi is a without its low 13 mantissa bits, lo the same
// of a - hi (3xTF32: acc += ah bh + ah bl + al bh keeps ~2^-19 of |ab|).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(a) & kTf32Mask;
  lo = __float_as_uint(a - __uint_as_float(hi)) & kTf32Mask;
}

// ---- cp.async -------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tc
