// Pieces shared by the port's f32-accurate tensor-core kernels
// (conv_epilogue.cu, and the flash kernels through mma_tf32x3.cuh):
// cp.async tile copies and the 3xTF32 operand split.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; 0 source
// bytes when !valid fill the destination with zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo to 2^-21 of |x|. hi is x rounded to the nearest tf32, ties
// away from zero: what cvt.rna.tf32.f32 gives, in two integer
// instructions (cvt.rna compiles to four: it also checks that x is
// finite, which every operand here is). lo = x - hi is exact in f32 and
// goes to the tensor cores as it is: they read the top 19 bits of a tf32
// operand, so lo is truncated to tf32 (CUTLASS's FastF32 relies on the
// same), an error below 2^-10 of |lo| <= 2^-11 of |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

}  // namespace
