// Tensor-core and copy helpers shared by the Gram kernels K1 (gram_matvec.cu)
// and K2 (gram_grads.cu).
//
// - mma.sync m16n8k8 in TF32 with the 3xTF32 split, which keeps a product at
//   fp32 accuracy (the JAX kernels' contraction at Precision.HIGHEST);
// - cp.async copies into shared memory, with zero-fill for a masked source;
// - the short transcendentals ex2.approx and sqrt.approx.
//
// Fragment layouts of m16n8k8 (lane = 4 g + t): A (16 x 8, row-major) a0
// (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8,
// column-major) b0 (t, g), b1 (t + 4, g); C (16 x 8) c0 (g, 2t), c1 (g,
// 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lat {

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo with hi a TF32 value; the tensor core reads only lo's TF32 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b at fp32 accuracy; b = (b0 hi, b1 hi, b0 lo, b1 lo). The small
// terms go first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], const uint4& b) {
  mma_tf32(c, alo, b.x, b.y);
  mma_tf32(c, ahi, b.z, b.w);
  mma_tf32(c, ahi, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace lat
