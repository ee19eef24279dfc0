// K3: the data-gradient pass of the Gram matvec.
//
// Replaces the TPU kernels `_dgrads_kernel_vpu` and `_dgrads_kernel_mxu` of
// lanczos_adjoints_tpu/ops/pallas_gram.py (launched by `_data_grad`).
//
// For L = sum_k u_k^T K(x, y) v_k it computes, for every row i of x, the
// moments
//   col 0:      S_i  = sum_j w_ij
//   col 1 + d:  T_id = sum_j w_ij y_jd       (y in scaled coordinates)
// with w_ij = uv_ij * dg/dsq and uv_ij = sum_c u_ic v_jc, into
// moments (n, 1 + D). The wrapper assembles
// dx = outputscale * 2 / ell^2 * (x * S - T / scale).
//
// What bounds it on an H100: arithmetic, as K2. A cell costs 2m
// operations for uv plus about 5d + 10 for the distance, the kernel
// derivative and the two moments; at m = 225 (the SLQ adjoint's wide
// pass) that is ~7 * 10^13 fp32 operations at N = 400,000, against
// O(N(m + d)) bytes.
//
// Design: K2's tiling. 256 threads as 16 x 16 own a 64 x 64 cell tile,
// 4 x 4 cells a thread; uv is staged through shared memory in chunks of
// 16 of the m columns; distances are direct differences for every d.
// Unlike K2 every row owns its output, so there is no cross-block
// reduction: after each column tile, each of a row's 1 + D moments is
// summed over the tile's columns (within the thread, then a butterfly
// over the 16 lanes that share the row), and one lane adds it to a
// register accumulator (lane q % 16 keeps moment q). The sums run in one
// fixed order, with no atomics, so the result is the same from run to
// run. Out-of-range rows and columns are zero-filled in shared memory
// and add uv = 0. No tensor cores, TMA or tuning yet.
//
// Wide rows (d > 64, a multiple of 64; D = kWide): grid.y runs over the
// 64-column chunks of T. Each block computes the full distance chunk by
// chunk (x and y chunks staged in turn in the same shared arrays), then
// re-stages its own chunk for the moments; chunk 0 also writes S.
#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

constexpr int kBR = 64;  // rows per block
constexpr int kBC = 64;  // columns per tile
constexpr int kKC = 16;  // m-chunk staged per pass
constexpr int kPad = 4;  // keeps 16-byte alignment, spreads banks

template <int KIND, int D>
__global__ void __launch_bounds__(256)
    gram_dgrads_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ v, const float* __restrict__ u,
                       float* __restrict__ moments, int n, int n_cols, int m, int d) {
  constexpr bool kIsWide = D == lat::kWide;
  constexpr int DS = kIsWide ? lat::kChunk : D;  // columns held in shared memory
  constexpr int kQ = 1 + DS;              // moments per row and block
  constexpr int kSlots = (kQ + 15) / 16;  // moments of a row kept by one lane
  __shared__ __align__(16) float us[kKC][kBR + kPad];
  __shared__ __align__(16) float vs[kKC][kBC + kPad];
  __shared__ __align__(16) float xs[DS][kBR + kPad];
  __shared__ __align__(16) float ys[DS][kBC + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long row0 = static_cast<long>(blockIdx.x) * kBR;
  const int chunks = kIsWide ? d / DS : 1;
  const int own = blockIdx.y;  // the chunk of T (0 unless wide)

  // Columns c * DS .. c * DS + DS of the block's x rows and of the tile's y rows.
  auto stage_x = [&](int c) {
    for (int idx = tid; idx < kBR * DS; idx += 256) {
      const int r = idx / DS;
      const int dd = idx % DS;
      xs[dd][r] = row0 + r < n ? x[(row0 + r) * d + c * DS + dd] : 0.0f;
    }
  };
  auto stage_y = [&](int c, int j0) {
    for (int idx = tid; idx < kBC * DS; idx += 256) {
      const int cc = idx / DS;
      const int dd = idx % DS;
      ys[dd][cc] = j0 + cc < n_cols ? y[static_cast<long>(j0 + cc) * d + c * DS + dd] : 0.0f;
    }
  };

  if (!kIsWide) stage_x(0);

  float acc[4][kSlots];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[a][s] = 0.0f;

  for (int j0 = 0; j0 < n_cols; j0 += kBC) {
    if (!kIsWide) {
      __syncthreads();  // the previous tile's ys is no longer read
      stage_y(0, j0);
    }

    float uv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) uv[a][b] = 0.0f;

    for (int k0 = 0; k0 < m; k0 += kKC) {
      __syncthreads();  // the previous chunk is no longer read
      for (int idx = tid; idx < kKC * kBR; idx += 256) {
        const int r = idx / kKC;
        const int k = idx % kKC;
        const long row = row0 + r;
        us[k][r] = (row < n && k0 + k < m) ? u[row * m + k0 + k] : 0.0f;
        const long col = j0 + r;
        vs[k][r] = (col < n_cols && k0 + k < m) ? v[col * m + k0 + k] : 0.0f;
      }
      __syncthreads();
      const int kc = min(kKC, m - k0);
#pragma unroll
      for (int k = 0; k < kKC; ++k) {
        if (k >= kc) break;
        const float4 a4 = *reinterpret_cast<const float4*>(&us[k][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&vs[k][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) uv[a][b] = fmaf(av[a], bv[b], uv[a][b]);
      }
    }

    // Epilogue: w = uv * dg/dsq of the 4 x 4 cells.
    float w[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) w[a][b] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      if (kIsWide) {
        __syncthreads();  // the previous chunk (or tile) is no longer read
        stage_x(c);
        stage_y(c, j0);
        __syncthreads();
      }
#pragma unroll
      for (int dd = 0; dd < DS; ++dd) {
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[dd][ty * 4]);
        const float4 y4 = *reinterpret_cast<const float4*>(&ys[dd][tx * 4]);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const float diff = xv[a] - yv[b];
            w[a][b] = fmaf(diff, diff, w[a][b]);  // p, the scaled sq distance
          }
      }
    }
    if (kIsWide && own != chunks - 1) {  // this block's chunk of T
      __syncthreads();
      stage_y(own, j0);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float g, dg;
        lat::kernel_value_dsq<KIND>(w[a][b], g, dg);
        w[a][b] = uv[a][b] * dg;
      }

    // Moment q of each of the thread's rows over the tile's 64 columns:
    // its 4 columns, then a butterfly over the 16 lanes of the row. The
    // xor butterfly leaves the same value in all 16 lanes (each add is
    // commutative); lane q % 16 keeps it.
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      float col[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if (q > 0) {
        const float4 y4 = *reinterpret_cast<const float4*>(&ys[q - 1][tx * 4]);
        col[0] = y4.x;
        col[1] = y4.y;
        col[2] = y4.z;
        col[3] = y4.w;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float s = w[a][0] * col[0];
#pragma unroll
        for (int b = 1; b < 4; ++b) s = fmaf(w[a][b], col[b], s);
#pragma unroll
        for (int off = 8; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (tx == q % 16) acc[a][q / 16] += s;
      }
    }
  }

  // Column 0 (S) from chunk 0; chunk c's T columns at 1 + c * DS.
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long row = row0 + ty * 4 + a;
    if (row >= n) continue;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int q = s * 16 + tx;
      if (q >= kQ || (q == 0 && own != 0)) continue;
      moments[row * (1 + d) + (q == 0 ? 0 : 1 + own * DS + q - 1)] = acc[a][s];
    }
  }
}

template <int KIND, int D>
void launch(const float* x, const float* y, const float* v, const float* u,
            float* moments, int n, int n_cols, int m, int d, cudaStream_t stream) {
  const dim3 grid((n + kBR - 1) / kBR, D == lat::kWide ? d / lat::kChunk : 1);
  gram_dgrads_kernel<KIND, D>
      <<<grid, 256, 0, stream>>>(x, y, v, u, moments, n, n_cols, m, d);
}

}  // namespace

// x: (n, d), y: (n_cols, d), scaled and zero-padded to d columns (8, 16,
// 32, 64 or a multiple of 64); v: (n_cols, m); u: (n, m); moments:
// (n, 1 + d). All float32, row-major,
// contiguous. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported kind or d).
extern "C" int lat_gram_dgrads(int kind, const float* x, const float* y,
                               const float* v, const float* u, float* moments,
                               int n, int n_cols, int m, int d, void* stream) {
  if (n <= 0 || n_cols <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAT_LAUNCH(K, DD) launch<K, DD>(x, y, v, u, moments, n, n_cols, m, d, s)
  LAT_DISPATCH_KIND_D(kind, d, LAT_LAUNCH)
#undef LAT_LAUNCH
  return cudaGetLastError();
}
