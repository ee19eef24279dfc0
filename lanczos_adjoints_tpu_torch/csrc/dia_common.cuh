// Shared pieces of the DIA kernels (csrc/dia.cu, csrc/lanczos_dia.cu,
// csrc/arnoldi_dia.cu, csrc/halo_dia.cu).
//
// A DIA operator of n rows stores diagonal k row-aligned in vals[k, :],
// and its product is circular:
//   out[i] = sum_k vals[k, i] * x[(i + d_k) mod n],
// the semantics of the JAX package's roll-based `dia_matvec_fn`.
// The offsets travel in a device int32 array of num_diags entries that the
// host builds once per operator (ops/native.py `offsets_arg`), each already
// reduced to [0, n), so one conditional subtraction wraps an index. A
// kernel stages them in dynamic shared memory, so any number of diagonals
// runs.
#pragma once

#include <cuda_runtime.h>

namespace lat {

// Copy the offsets into shared memory once per block, so the per-row
// loops index them from there.
__device__ inline void stage_offsets(const int* __restrict__ offsets, int num_diags, int* s_off) {
  for (int k = threadIdx.x; k < num_diags; k += blockDim.x) s_off[k] = __ldg(offsets + k);
  __syncthreads();
}

__device__ inline int wrap(int i, int shift, int n) {
  const int j = i + shift;  // i, shift < n <= 2^30, so j < 2^31
  return j >= n ? j - n : j;
}

inline bool valid_shape(int n, int num_diags) {
  return n > 0 && n <= (1 << 30) && num_diags > 0;
}

// Bytes of shared memory that hold num_diags staged offsets, rounded up to
// 16 so that what follows them stays 16-byte aligned.
inline size_t offsets_bytes(int num_diags) {
  return (static_cast<size_t>(num_diags) * sizeof(int) + 15) / 16 * 16;
}

// Lets `kernel` take `bytes` of dynamic shared memory (an opt-in above
// 48 KB). Returns a CUDA error code.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lat
