// K1: the streamed Gram matvec, out = K(x, y) @ v without forming K.
//
// Replaces the TPU kernel `_matvec_kernel` of
// lanczos_adjoints_tpu/ops/pallas_gram.py (launched by `_matvec_impl`).
//
// What bounds it on an H100: arithmetic. A cell (i, j) costs about
// 3d + 2m + 5 fp32 operations (distance, kernel value, m-wide
// contraction) and the whole call moves only O((N + M)(d + m)) bytes, so
// at N = M = 400,000 the bound is ~10^13 operations on the fp32 pipes
// (ops per byte in the tens of thousands).
//
// Design: one block owns 128 * R rows, one thread R of them, with the
// R scaled x rows in registers. The block walks over all columns in
// tiles of TC staged in shared memory (y tile and the matching v tile,
// zero-filled past the ragged edge, so a masked column contributes
// g * 0). Every thread reads the same y and v entry of the tile at the
// same time (a broadcast), and each such read serves R rows, which keeps
// the shared-memory pipe below the FMA pipe. The sum over columns stays
// in registers (R x MC accumulators); the TPU kernel instead carried it
// across a sequential grid axis in VMEM. m is served in chunks of MC
// columns (MC = 1 for a single right-hand side, else 16); a chunk past
// the first recomputes the kernel values. Distances are direct
// differences for every d (no expanded form), so they are free of
// cancellation. No tensor cores, TMA or tuning yet.
#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

constexpr int kThreads = 128;

template <int KIND, int D, int MC>
__global__ void __launch_bounds__(kThreads)
    gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ v, float* __restrict__ out,
                       int n, int n_cols, int m) {
  constexpr int R = lat::RowsPerThread<D>::value;
  constexpr int TC = (D + MC) <= 48 ? 128 : 64;
  __shared__ __align__(16) float ys[TC * D];
  __shared__ __align__(16) float vs[TC * MC];

  const int tid = threadIdx.x;
  const long row0 = static_cast<long>(blockIdx.x) * (kThreads * R);

  float xr[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long row = row0 + r * kThreads + tid;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) xr[r][dd] = row < n ? x[row * D + dd] : 0.0f;
  }

  for (int c0 = 0; c0 < m; c0 += MC) {
    float acc[R][MC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < MC; ++c) acc[r][c] = 0.0f;

    for (int j0 = 0; j0 < n_cols; j0 += TC) {
      __syncthreads();  // the previous tile is no longer read
      for (int idx = tid; idx < TC * D; idx += kThreads) {
        const int j = j0 + idx / D;
        ys[idx] = j < n_cols ? y[static_cast<long>(j0) * D + idx] : 0.0f;
      }
      for (int idx = tid; idx < TC * MC; idx += kThreads) {
        const int j = j0 + idx / MC;
        const int c = c0 + idx % MC;
        vs[idx] = (j < n_cols && c < m) ? v[static_cast<long>(j) * m + c] : 0.0f;
      }
      __syncthreads();

      const int tc = min(TC, n_cols - j0);
      for (int j = 0; j < tc; ++j) {
        float g[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float p = 0.0f;
#pragma unroll
          for (int dd = 0; dd < D; ++dd) {
            const float diff = xr[r][dd] - ys[j * D + dd];
            p = fmaf(diff, diff, p);
          }
          g[r] = lat::kernel_value<KIND>(p);
        }
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const float vjc = vs[j * MC + c];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][c] = fmaf(g[r], vjc, acc[r][c]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long row = row0 + r * kThreads + tid;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < MC; ++c)
        if (c0 + c < m) out[row * m + c0 + c] = acc[r][c];
    }
  }
}

template <int KIND, int D, int MC>
void launch(const float* x, const float* y, const float* v, float* out, int n,
            int n_cols, int m, cudaStream_t stream) {
  constexpr int rows_per_block = kThreads * lat::RowsPerThread<D>::value;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  gram_matvec_kernel<KIND, D, MC>
      <<<blocks, kThreads, 0, stream>>>(x, y, v, out, n, n_cols, m);
}

}  // namespace

// x: (n, d) and y: (n_cols, d), scaled and zero-padded to d columns;
// v: (n_cols, m); out: (n, m). All float32, row-major, contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported kind or d, without launching).
extern "C" int lat_gram_matvec(int kind, const float* x, const float* y,
                               const float* v, float* out, int n, int n_cols,
                               int m, int d, void* stream) {
  if (n <= 0 || n_cols <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 1) {
#define LAT_LAUNCH(K, DD) launch<K, DD, 1>(x, y, v, out, n, n_cols, m, s)
    LAT_DISPATCH_KIND_D(kind, d, LAT_LAUNCH)
#undef LAT_LAUNCH
  } else {
#define LAT_LAUNCH(K, DD) launch<K, DD, 16>(x, y, v, out, n, n_cols, m, s)
    LAT_DISPATCH_KIND_D(kind, d, LAT_LAUNCH)
#undef LAT_LAUNCH
  }
  return cudaGetLastError();
}
