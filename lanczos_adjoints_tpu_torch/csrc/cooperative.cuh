// Shared pieces of the cooperative, persistent kernels (csrc/lanczos_dia.cu,
// csrc/arnoldi_dia.cu, csrc/halo_dia.cu): fixed-order warp, block and grid
// sums, the guarded divide of a Krylov exhaustion, the size of a
// co-resident grid, and the grid barrier of the kernels planned on the
// host (K7, K9), one block an SM.
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

// Blocks for a cooperative launch of `kernel` with kCoopThreads threads
// and `smem` bytes of dynamic shared memory: all co-resident, at most one
// per kCoopThreads rows. Returns a CUDA error code.
template <typename Kernel>
cudaError_t cooperative_blocks(Kernel kernel, int n, size_t smem, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kCoopThreads, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int need = (n + kCoopThreads - 1) / kCoopThreads;
  *blocks = per_sm * sms < need ? per_sm * sms : need;
  return cudaSuccess;
}

// The barrier of a block's `threads` computing threads (named barrier 1):
// K9's producer warp never joins it; in K7 every thread computes.
__device__ __forceinline__ void sync_workers(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Sum of v over the computing threads, in a fixed order.
__device__ inline float block_total(float v, float* redw, int threads) {
  v = warp_sum(v);
  sync_workers(threads);  // the previous use of redw is finished
  if (threadIdx.x % 32 == 0) redw[threadIdx.x / 32] = v;
  sync_workers(threads);
  float s = 0.0f;
  for (int w = 0; w < threads / 32; ++w) s += redw[w];
  return s;
}

// The grid barrier of the computing threads of a launch planned on the
// host: the grid is co-resident (a cooperative launch), each block's
// arrival is one release add to a counter that the caller zeroes before
// the launch, awaited by acquire loads, and `goal` (the same in every
// thread) counts the arrivals of all barriers so far. It needs no
// grid_group, so a warp that does not compute (K9's producer) never joins.
__device__ inline void grid_sync(unsigned* counter, unsigned& goal, int threads) {
  sync_workers(threads);
  goal += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned seen = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while (static_cast<int>(goal - seen) > 0);
  }
  sync_workers(threads);
}

// The stride of a slab of per-block partials: the blocks rounded up to a
// multiple of 4, the padding zero.
__host__ __device__ inline int slab_stride(int blocks) { return (blocks + 3) / 4 * 4; }

}  // namespace lat
