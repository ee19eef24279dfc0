// Shared pieces of the cooperative, persistent kernels (csrc/lanczos_dia.cu,
// csrc/arnoldi_dia.cu): fixed-order warp, block and grid sums, the guarded
// divide of a Krylov exhaustion, and the size of a co-resident grid.
//
// Every sum here is taken in one fixed order that does not depend on the
// block that computes it, so a scalar that all blocks reduce from the
// same per-block partials has the same bits in every block and every run.
#pragma once

#include <cuda_runtime.h>

namespace lat {

constexpr int kCoopThreads = 256;
constexpr int kCoopWarps = kCoopThreads / 32;

// Sum of v over the warp, the same bits in every lane (each butterfly
// stage adds two equal-bit group sums, and a + b == b + a exactly).
__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread, in a fixed order.
__device__ inline float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // the previous use of red is finished
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kCoopWarps; ++w) s += red[w];
  return s;
}

// Sum of the per-block partials, the same in every block. Data written
// during the launch is read through L2 (__ldcg), never through L1.
__device__ inline float grid_total(const float* partials, float* red) {
  float s = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += blockDim.x) s += __ldcg(partials + b);
  return block_sum(s, red);
}

__device__ inline float guarded_div(float v, float norm) {
  // Krylov exhaustion: a zero norm truncates to zeros instead of 0 / 0.
  return norm > 0.0f ? v / norm : 0.0f;
}

// Blocks for a cooperative launch of `kernel` with kCoopThreads threads:
// all co-resident, at most one per kCoopThreads rows. Returns a CUDA
// error code.
template <typename Kernel>
cudaError_t cooperative_blocks(Kernel kernel, int n, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCoopThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (n + kCoopThreads - 1) / kCoopThreads;
  *blocks = per_sm * sms < need ? per_sm * sms : need;
  return cudaSuccess;
}

}  // namespace lat
