// K12: the DIA matvec's speed-of-light probe.
//
// `lat_dia_ceiling` replaces the TPU kernel `_sol_kernel` of
// experiments/benchmarks/spmv_formats/dia_roofline.py (run by
// `speed_of_light`):
//   out[i] = x[i] + vals[0, i] + vals[1, i] + ... + vals[D-1, i],
// summed in that order, so it is bit for bit its plain version
// (ops/fused_dia.py `dia_ceiling_plain`): float32 additions, no fused
// multiply-add to contract. It moves exactly the traffic that one DIA
// matvec must move, (D + 2) n 4 bytes (the values once, x once, the
// output once), and does none of the shifted reads: the attainable
// ceiling that K4 is measured against.
//
// What bounds it on an H100: bytes, and nothing else; one addition per
// 4 bytes read. At n = 1,048,576 and D = 5, 29.4 MB, or 8.76 us at
// 3.35 TB/s (L2-cold; the 50 MB L2 can hold all of it).
//
// Design: a grid-stride loop in which a thread owns 4 consecutive rows:
// one 16-byte load of x, one of each diagonal's row, one 16-byte store.
// A row of vals whose start is not 16-byte aligned (n % 4 != 0, or a
// misaligned view) is read as 4 scalars; a misaligned x or output sends
// every row down the scalar loop, which also takes the n % 4 tail.
// `threads` (128, 256, 512 or 1024 a block) is the counterpart of the TPU
// script's block `chunk`, the knob its ceiling is taken over.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
// Enough blocks to fill every SM many times over; the loop covers the rest.
constexpr int kMaxBlocks = 132 * 32;

__device__ inline bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kMaxThreads)
    dia_ceiling_kernel(const float* __restrict__ x, const float* __restrict__ vals,
                       float* __restrict__ out, int n, int num_diags, int quads) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int q = first; q < quads; q += stride) {
    const int i = 4 * q;
    float4 acc = reinterpret_cast<const float4*>(x)[q];
    for (int k = 0; k < num_diags; ++k) {
      const float* row = vals + static_cast<size_t>(k) * n;
      float4 v;
      if (aligned16(row)) {
        v = reinterpret_cast<const float4*>(row)[q];
      } else {
        v = make_float4(row[i], row[i + 1], row[i + 2], row[i + 3]);
      }
      acc.x = acc.x + v.x;
      acc.y = acc.y + v.y;
      acc.z = acc.z + v.z;
      acc.w = acc.w + v.w;
    }
    reinterpret_cast<float4*>(out)[q] = acc;
  }
  // The rows past the last whole quad: the n % 4 tail, or all of them when
  // x or the output is not 16-byte aligned (quads = 0).
  for (int i = 4 * quads + first; i < n; i += stride) {
    float acc = x[i];
    for (int k = 0; k < num_diags; ++k) acc = acc + vals[static_cast<size_t>(k) * n + i];
    out[i] = acc;
  }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x: (n,), vals: (num_diags, n), out: (n,); float32, contiguous.
// threads: 128, 256, 512 or 1024 a block. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a shape or block size the
// kernel does not take, without launching).
extern "C" int lat_dia_ceiling(const float* x, const float* vals, float* out, int n,
                               int num_diags, int threads, void* stream) {
  if (n <= 0 || n > (1 << 30) || num_diags <= 0) return cudaErrorInvalidValue;
  if (threads != 128 && threads != 256 && threads != 512 && threads != 1024) {
    return cudaErrorInvalidValue;
  }
  const int quads = aligned(x) && aligned(out) ? n / 4 : 0;
  const int work = quads > 0 ? quads : n;
  const int wanted = (work + threads - 1) / threads;
  const int blocks = wanted < kMaxBlocks ? wanted : kMaxBlocks;
  dia_ceiling_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, vals, out, n, num_diags, quads);
  return cudaGetLastError();
}
