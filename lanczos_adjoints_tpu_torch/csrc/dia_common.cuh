// Shared pieces of the DIA kernels (csrc/dia.cu, csrc/lanczos_dia.cu).
//
// A DIA operator of n rows stores diagonal k row-aligned in vals[k, :],
// and its product is circular:
//   out[i] = sum_k vals[k, i] * x[(i + d_k) mod n],
// the semantics of the JAX package's roll-based `dia_matvec_fn`.
// The host passes each offset already reduced to [0, n), so one
// conditional subtraction wraps an index.
#pragma once

#include <cuda_runtime.h>

namespace lat {

constexpr int kMaxDiags = 64;  // dia_max_diags of ops/sparse.py

// Offsets travel into a kernel by value (kernel parameter space).
struct DiaOffsets {
  int d[kMaxDiags];
};

inline DiaOffsets offsets_from_host(const int* host, int num_diags) {
  DiaOffsets offs{};
  for (int k = 0; k < num_diags; ++k) offs.d[k] = host[k];
  return offs;
}

// Copy the offsets into shared memory once per block, so the per-row
// loops index them dynamically without a local-memory copy of the
// parameter struct.
__device__ inline void stage_offsets(const DiaOffsets& offs, int num_diags,
                                     int* s_off) {
  for (int k = threadIdx.x; k < num_diags; k += blockDim.x) s_off[k] = offs.d[k];
  __syncthreads();
}

__device__ inline int wrap(int i, int shift, int n) {
  const int j = i + shift;  // i, shift < n <= 2^30, so j < 2^31
  return j >= n ? j - n : j;
}

inline bool valid_shape(int n, int num_diags) {
  return n > 0 && n <= (1 << 30) && num_diags > 0 && num_diags <= kMaxDiags;
}

}  // namespace lat
