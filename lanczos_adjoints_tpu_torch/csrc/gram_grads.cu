// K2: the parameter-gradient pass of the Gram matvec.
//
// Replaces the TPU kernels `_grads_kernel_vpu` and `_grads_kernel_mxu` of
// lanczos_adjoints_tpu/ops/pallas_gram.py (launched by `_param_grads`).
//
// For L = sum_k u_k^T K(x, y) v_k it computes, per block of 64 rows, the
// partial sums
//   col 0:      sum_ij uv_ij g_ij                       (-> d outputscale)
//   col 1 + d:  sum_ij w_ij (x_id - y_jd)^2,  w = uv * dg/dsq
// with uv_ij = sum_c u_ic v_jc, into partials (n_blocks, 1 + D). The
// wrapper sums the blocks in a fixed order and unscales them; no float
// atomics, so the gradient is the same from run to run.
//
// What bounds it on an H100: arithmetic. A cell costs 2m operations for
// uv plus about 7d + 8 for the distance, kernel derivative and the
// per-dimension sums; at m = 225 (the SLQ adjoint's wide pass) that is
// ~7 * 10^13 fp32 operations at N = 400,000, against O(N(m + d)) bytes.
//
// Design: 256 threads as 16 x 16 own a 64 x 64 cell tile, 4 x 4 cells a
// thread. uv is a small matrix product: u (block rows) and v (column
// tile) are staged through shared memory in chunks of 16 of the m
// columns, k-major, and each thread reads 4 u and 4 v values as two
// 16-byte loads per 16 FMAs. At m = 225 the rows of u and v do not fit
// in registers, hence the staging. The tile's scaled x and y rows sit in
// shared memory transposed (D x 64), so the epilogue reads them as
// 16-byte loads too, and computes distances as direct differences for
// every d. Out-of-range rows and columns are zero-filled in shared
// memory, so they add uv = 0. The per-thread sums are reduced across
// the block with warp shuffles and one shared pass, in a fixed order.
// No tensor cores, TMA or tuning yet.
//
// Wide rows (d > 64, a multiple of 64; D = kWide): grid.y runs over the
// 64-column chunks of the per-dimension sums. Each block computes the
// full distance chunk by chunk (x and y chunks staged in turn in the same
// shared arrays), then re-stages its own chunk for the sums; chunk 0 also
// writes column 0. Everything else is as above.
#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace {

constexpr int kBR = 64;  // rows per block
constexpr int kBC = 64;  // columns per tile
constexpr int kKC = 16;  // m-chunk staged per pass
constexpr int kPad = 4;  // keeps 16-byte alignment, spreads banks

template <int KIND, int D>
__global__ void __launch_bounds__(256)
    gram_grads_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ v, const float* __restrict__ u,
                      float* __restrict__ partials, int n, int n_cols, int m, int d) {
  constexpr bool kIsWide = D == lat::kWide;
  constexpr int DS = kIsWide ? lat::kChunk : D;  // columns held in shared memory
  __shared__ __align__(16) float us[kKC][kBR + kPad];
  __shared__ __align__(16) float vs[kKC][kBC + kPad];
  __shared__ __align__(16) float xs[DS][kBR + kPad];
  __shared__ __align__(16) float ys[DS][kBC + kPad];
  __shared__ float red[8][1 + DS];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long row0 = static_cast<long>(blockIdx.x) * kBR;
  const int chunks = kIsWide ? d / DS : 1;
  const int own = blockIdx.y;  // the chunk of the per-dimension sums (0 unless wide)

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

  float d_out = 0.0f;
  float d_dim[DS];
#pragma unroll
  for (int dd = 0; dd < DS; ++dd) d_dim[dd] = 0.0f;

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

    // Epilogue: kernel value and derivative of the 4 x 4 cells.
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) p[a][b] = 0.0f;
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
            p[a][b] = fmaf(diff, diff, p[a][b]);
          }
      }
    }
    if (kIsWide && own != chunks - 1) {  // this block's chunk for the sums
      __syncthreads();
      stage_x(own);
      stage_y(own, j0);
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float g, dg;
        lat::kernel_value_dsq<KIND>(p[a][b], g, dg);
        d_out = fmaf(uv[a][b], g, d_out);
        p[a][b] = uv[a][b] * dg;  // reuse as w
      }
#pragma unroll
    for (int dd = 0; dd < DS; ++dd) {
      const float4 x4 = *reinterpret_cast<const float4*>(&xs[dd][ty * 4]);
      const float4 y4 = *reinterpret_cast<const float4*>(&ys[dd][tx * 4]);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
      float s = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float diff = xv[a] - yv[b];
          s = fmaf(p[a][b] * diff, diff, s);
        }
      d_dim[dd] += s;
    }
  }

  // Block reduction in a fixed order: warp shuffles, then one pass over
  // the eight warps' sums.
  const int lane = tid % 32;
  const int warp = tid / 32;
#pragma unroll
  for (int q = 0; q <= DS; ++q) {
    float s = q == 0 ? d_out : d_dim[q - 1];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][q] = s;
  }
  __syncthreads();
  for (int q = tid; q <= DS; q += 256) {
    if (q == 0 && own != 0) continue;  // column 0 comes from chunk 0
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s += red[w][q];
    const int col = q == 0 ? 0 : 1 + own * DS + q - 1;
    partials[static_cast<long>(blockIdx.x) * (1 + d) + col] = s;
  }
}

template <int KIND, int D>
void launch(const float* x, const float* y, const float* v, const float* u,
            float* partials, int n, int n_cols, int m, int d, cudaStream_t stream) {
  const dim3 grid((n + kBR - 1) / kBR, D == lat::kWide ? d / lat::kChunk : 1);
  gram_grads_kernel<KIND, D>
      <<<grid, 256, 0, stream>>>(x, y, v, u, partials, n, n_cols, m, d);
}

}  // namespace

// x: (n, d), y: (n_cols, d), scaled and zero-padded to d columns (8, 16,
// 32, 64 or a multiple of 64); v: (n_cols, m); u: (n, m); partials:
// (ceil(n / 64), 1 + d). All
// float32, row-major, contiguous. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported kind or d).
extern "C" int lat_gram_grads(int kind, const float* x, const float* y,
                              const float* v, const float* u, float* partials,
                              int n, int n_cols, int m, int d, void* stream) {
  if (n <= 0 || n_cols <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAT_LAUNCH(K, DD) launch<K, DD>(x, y, v, u, partials, n, n_cols, m, d, s)
  LAT_DISPATCH_KIND_D(kind, d, LAT_LAUNCH)
#undef LAT_LAUNCH
  return cudaGetLastError();
}
