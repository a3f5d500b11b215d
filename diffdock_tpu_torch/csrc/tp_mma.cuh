// Device helpers shared by the factored TP kernels (fused_tp3.cu,
// factored_tp2.cu, factored_tp1.cu): float32 products on Hopper's tensor
// cores in 3xTF32, bfloat16 products with float32 accumulation, and
// asynchronous global -> shared copies.
//
// 3xTF32: each float32 operand is split into a TF32 head (rounded to
// nearest) and a TF32 remainder, and rem*head + head*rem + head*head is
// accumulated in float32 by mma.sync m16n8k8, which keeps float32 accuracy
// at a third of the TF32 rate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tp_mma {

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32 for finite x, from two integer
// operations that run at full rate
__device__ __forceinline__ uint32_t tf32_of(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within TF32 rounding of lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_of(x);
  lo = tf32_of(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a*b in 3xTF32: the small cross terms first, then head*head
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// c += a*b, bfloat16 operands (exact products), float32 accumulation
__device__ __forceinline__ void mma_bf16_k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4-byte asynchronous copy; a masked element (ok = false) is zero-filled
// and its source is not read
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
// 8-byte asynchronous copy of the first n (0, 1 or 2) floats at src; the
// rest of the pair is zero-filled
__device__ __forceinline__ void cp_async8(float* dst, const float* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(4 * n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tp_mma
