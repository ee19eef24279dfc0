// Shared pieces of the persistent kernels (csrc/lanczos_dia.cu,
// csrc/arnoldi_dia.cu, csrc/halo_dia.cu): fixed-order warp sums, the
// guarded divide of a Krylov exhaustion, the grid barrier of the kernels
// planned on the host (K6, K7, K9), one block an SM, and the barrier of a
// thread block cluster (K6's cluster path).
//
// Every sum here is taken in one fixed order that does not depend on the
// block that computes it, so a scalar that all blocks reduce from the
// same per-block partials has the same bits in every block and every run.
#pragma once

#include <cuda_runtime.h>

namespace lat {

constexpr int kCoopThreads = 256;  // K11's threads a block

// Sum of v over the warp, the same bits in every lane (each butterfly
// stage adds two equal-bit group sums, and a + b == b + a exactly).
__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float guarded_div(float v, float norm) {
  // Krylov exhaustion: a zero norm truncates to zeros instead of 0 / 0.
  return norm > 0.0f ? v / norm : 0.0f;
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

// The barrier of a thread block cluster: every thread of every block of
// the cluster arrives (release) and waits (acquire), so what a block
// wrote to its shared memory before it is visible after it to the other
// blocks' reads through distributed shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The stride of a slab of per-block partials: the blocks rounded up to a
// multiple of 4, the padding zero.
__host__ __device__ inline int slab_stride(int blocks) { return (blocks + 3) / 4 * 4; }

}  // namespace lat
