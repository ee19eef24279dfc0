// K4 and K5: the DIA matvec and its value gradient.
//
// K4 `lat_dia_matvec` replaces the TPU kernel `_matvec_kernel` of
// lanczos_adjoints_tpu/ops/pallas_dia.py (launched by `_run_matvec`):
//   out[i] = sum_k vals[k, i] * x[(i + d_k) mod n].
// The transposed product (the cotangent of x) is the same kernel run with
// offsets -d_k and each diagonal rolled by d_k; the wrapper prepares both.
//
// K5 `lat_dia_dvals` replaces `_dvals_kernel` (launched by `_run_dvals`):
//   dvals[k, i] = u[i] * x[(i + d_k) mod n].
//
// What bounds them on an H100: bytes. Per row K4 reads D values and D
// entries of x and writes one output, 2D flops; K5 reads u and D entries
// of x and writes D values. Counting each array once, (D + 2) n 4 bytes
// each: at n = 1,048,576 and D = 5, 29.4 MB, or 8.8 us at 3.35 TB/s.
//
// Design: one thread per row in a grid-stride loop, so the reads of
// vals[k, :] and the writes are coalesced. The D shifted reads of x hit
// the same few lines from neighbouring rows and are served by L1/L2, so
// x crosses device memory about once. The TPU kernel kept x resident in
// VMEM with a circularly padded halo; here the wrap is one conditional
// subtraction per index (offsets arrive reduced to [0, n)), and the
// offsets are staged in shared memory once per block.
#include <cuda_runtime.h>

#include "dia_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    dia_matvec_kernel(const float* __restrict__ x, const float* __restrict__ vals,
                      float* __restrict__ out, int n, int num_diags,
                      const int* __restrict__ offsets) {
  extern __shared__ int s_off[];
  lat::stage_offsets(offsets, num_diags, s_off);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float acc = 0.0f;
    for (int k = 0; k < num_diags; ++k) {
      acc = fmaf(vals[static_cast<size_t>(k) * n + i], x[lat::wrap(i, s_off[k], n)], acc);
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    dia_dvals_kernel(const float* __restrict__ x, const float* __restrict__ u,
                     float* __restrict__ dvals, int n, int num_diags,
                     const int* __restrict__ offsets) {
  extern __shared__ int s_off[];
  lat::stage_offsets(offsets, num_diags, s_off);
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float ui = u[i];
    for (int k = 0; k < num_diags; ++k) {
      dvals[static_cast<size_t>(k) * n + i] = ui * x[lat::wrap(i, s_off[k], n)];
    }
  }
}

int grid_for(int n) {
  // Enough blocks for every SM several times over; the loop covers the rest.
  const int blocks = (n + kThreads - 1) / kThreads;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

}  // namespace

// x: (n,), vals: (num_diags, n), out: (n,); float32, contiguous.
// offsets: device int32 array of num_diags offsets, each in [0, n).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape the kernel does not take, without launching).
extern "C" int lat_dia_matvec(const float* x, const float* vals, float* out, int n,
                              int num_diags, const int* offsets, void* stream) {
  if (!lat::valid_shape(n, num_diags)) return cudaErrorInvalidValue;
  const size_t smem = lat::offsets_bytes(num_diags);
  const cudaError_t err = lat::allow_smem(dia_matvec_kernel, smem);
  if (err != cudaSuccess) return err;
  dia_matvec_kernel<<<grid_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, vals, out, n, num_diags, offsets);
  return cudaGetLastError();
}

// x, u: (n,); dvals: (num_diags, n); as above.
extern "C" int lat_dia_dvals(const float* x, const float* u, float* dvals, int n,
                             int num_diags, const int* offsets, void* stream) {
  if (!lat::valid_shape(n, num_diags)) return cudaErrorInvalidValue;
  const size_t smem = lat::offsets_bytes(num_diags);
  const cudaError_t err = lat::allow_smem(dia_dvals_kernel, smem);
  if (err != cudaSuccess) return err;
  dia_dvals_kernel<<<grid_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, u, dvals, n, num_diags, offsets);
  return cudaGetLastError();
}
