// K9: the whole Arnoldi forward over a DIA operator in one launch.
//
// `lat_arnoldi_dia_forward` replaces the TPU kernels `_arnoldi_kernel`
// (fully unrolled, K <= 48) and `_arnoldi_kernel_looped` (K > 48) of
// lanczos_adjoints_tpu/ops/pallas_arnoldi.py, both launched by
// `hessenberg_dia_forward`. The TPU needed two variants only for Mosaic's
// compile time; one kernel serves every K here. Step i of the recurrence:
//   q_i = guarded(w / norm)                        (basis row i)
//   w   = A q_i                                    (circular DIA, K4's wrap)
//   c   = Q[:i+1] w,  w -= Q[:i+1]^T c             (classical Gram-Schmidt)
//   full: norm1 = |w|, c2 = Q[:i+1] w, w -= Q[:i+1]^T c2, norm = |w|,
//         and norm = w = 0 unless norm > 0.5 norm1 (DGKS truncation)
//   H[:i+1, i] = c (first pass only), H[i+1, i] = norm (i < K - 1).
// Outputs: the basis Q as (K, n) rows, H (K, K), the residual w and 1/|v0|.
//
// What bounds it on an H100. Counting each array once it moves
// (D + 2 + K) n 4 bytes and does about 4 P n K(K+1)/2 flops (P = 1 pass
// without re-orthogonalisation, 2 with). Step i re-reads i + 1 basis rows
// per pass for the dots and again for the update, so the traffic it
// really makes grows as K^2 n: at n = 1,000,000, K = 90 and two passes
// about 65 GB, against a bound of 0.4 ms. At n = 16,384 the basis stays
// in L2 and the chain of grid barriers (2 a step, 3 with
// re-orthogonalisation) sets the time.
//
// Design, simple and correct first: one cooperative, persistent launch
// (the grid sized by the occupancy calculator, co-resident), each thread
// owning the same rows in every phase. The residual w is double-buffered,
// so step i + 1 computes its neighbours' q_{i+1} = w / norm from the
// previous buffer itself and needs no barrier after writing basis row
// i + 1. The i + 1 dot products of a pass are taken warp by warp over the
// block's rows into a (K, blocks) slab of per-block partials; after a grid
// barrier every block sums each coefficient over the blocks in one fixed
// order (lanes over blocks, then a butterfly), so c, the norms and H have
// the same bits in every block and run: no float atomics. A partial slot
// is rewritten only after a grid barrier that follows every read of it.
// Data written during the launch is read across blocks through L2
// (__ldcg). Later work: keep the basis on chip for small n, tensor cores
// for the (i + 1) x n projections, a two-level reduction of the partials.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "dia_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = lat::kCoopThreads;
constexpr int kWarps = lat::kCoopWarps;
using lat::block_sum;
using lat::grid_total;
using lat::guarded_div;
using lat::warp_sum;

// part[j * blocks + b] = sum over block b's rows of q[j][r] * w[r], for
// j < count, one warp per j. The block's rows are those its threads own:
// b * kThreads + e + s * stride. q and w rows of this block were written
// by its own threads before a __syncthreads.
__device__ void block_dots(const float* q, const float* w, int count, int n, float* part) {
  constexpr int kPerLane = kThreads / 32;
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kThreads;
  for (int j = threadIdx.x / 32; j < count; j += kWarps) {
    const float* qj = q + static_cast<size_t>(j) * n;
    float s = 0.0f;
    for (int base = blockIdx.x * kThreads + lane; base < n; base += stride) {
      // All loads of the slab first, then the products in slab order.
      float qv[kPerLane], wv[kPerLane];
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int r = base + 32 * t;
        qv[t] = r < n ? qj[r] : 0.0f;
        wv[t] = r < n ? w[r] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) s = fmaf(qv[t], wv[t], s);
    }
    s = warp_sum(s);
    if (lane == 0) part[static_cast<size_t>(j) * gridDim.x + blockIdx.x] = s;
  }
}

// c[j] = sum over blocks of part[j * blocks + b], for j < count, in one
// fixed order; with h_col, also h_col[j * depth] = c[j] (a column of H).
__device__ void grid_dots(const float* part, int count, float* c, float* h_col, int depth) {
  const int lane = threadIdx.x % 32;
  for (int j = threadIdx.x / 32; j < count; j += kWarps) {
    const float* pj = part + static_cast<size_t>(j) * gridDim.x;
    float s = 0.0f;
#pragma unroll 4
    for (int b = lane; b < gridDim.x; b += 32) s += __ldcg(pj + b);
    s = warp_sum(s);
    if (lane == 0) {
      c[j] = s;
      if (h_col != nullptr) h_col[static_cast<size_t>(j) * depth] = s;
    }
  }
}

// w[r] -= sum_{j < count} c[j] q[j][r] on the calling thread's rows;
// returns the thread's share of |w|^2.
__device__ float subtract_projection(const float* q, const float* c, float* w, int count,
                                     int n) {
  const int stride = gridDim.x * blockDim.x;
  float nsq = 0.0f;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride) {
    float proj = 0.0f;
#pragma unroll 8
    for (int j = 0; j < count; ++j) proj = fmaf(c[j], q[static_cast<size_t>(j) * n + r], proj);
    const float v = w[r] - proj;
    w[r] = v;
    nsq = fmaf(v, v, nsq);
  }
  return nsq;
}

__global__ void __launch_bounds__(kThreads)
    arnoldi_forward_kernel(const float* __restrict__ vals, const float* __restrict__ v0,
                           float* q, float* h, float* res, float* inv_norm, float* wbuf,
                           float* partials, float* coef, int n, int num_diags,
                           lat::DiaOffsets offs, int depth, int full) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[lat::kMaxDiags];
  __shared__ float red[kWarps];
  lat::stage_offsets(offs, num_diags, s_off);
  const size_t slab = static_cast<size_t>(depth) * gridDim.x;
  float* part_c = partials;               // first-pass dots, (depth, blocks)
  float* part_c2 = partials + slab;       // second-pass dots, (depth, blocks)
  float* part_n1 = partials + 2 * slab;   // |w|^2 after the first pass (|v0|^2 first)
  float* part_n2 = part_n1 + gridDim.x;   // |w|^2 after the second pass
  float* c = coef + static_cast<size_t>(blockIdx.x) * depth;  // this block's coefficients
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  float s = 0.0f;
  for (int r = first; r < n; r += stride) s = fmaf(v0[r], v0[r], s);
  s = block_sum(s, red);
  if (threadIdx.x == 0) part_n1[blockIdx.x] = s;
  grid.sync();
  const float norm0 = sqrtf(grid_total(part_n1, red));
  if (blockIdx.x == 0 && threadIdx.x == 0) *inv_norm = 1.0f / norm0;

  float norm = norm0;
  bool keep = true;
  for (int i = 0; i < depth; ++i) {
    const float* prev = i == 0 ? v0 : wbuf + static_cast<size_t>((i - 1) & 1) * n;
    float* w = wbuf + static_cast<size_t>(i & 1) * n;
    float* qi = q + static_cast<size_t>(i) * n;

    // A. Basis row i and w = A q_i; the neighbours' q_i come from the
    // previous residual (visible since the last grid barrier), divided
    // here by the same norm, so they equal the stored row bit for bit.
    for (int r = first; r < n; r += stride) {
      qi[r] = guarded_div(__ldcg(prev + r), norm);
      float acc = 0.0f;
      for (int k = 0; k < num_diags; ++k) {
        const float qj = guarded_div(__ldcg(prev + lat::wrap(r, s_off[k], n)), norm);
        acc = fmaf(vals[static_cast<size_t>(k) * n + r], qj, acc);
      }
      w[r] = acc;
    }
    __syncthreads();
    block_dots(q, w, i + 1, n, part_c);
    grid.sync();  // 1: the first-pass partials are complete

    // B. c, H's column (block 0), w -= Q^T c and |w|^2; with
    // re-orthogonalisation also the second-pass partials of the same w.
    grid_dots(part_c, i + 1, c, blockIdx.x == 0 ? h + i : nullptr, depth);
    if (blockIdx.x == 0) {
      for (int j = i + 2 + threadIdx.x; j < depth; j += blockDim.x) {
        h[static_cast<size_t>(j) * depth + i] = 0.0f;
      }
    }
    __syncthreads();
    float nsq = block_sum(subtract_projection(q, c, w, i + 1, n), red);
    if (threadIdx.x == 0) part_n1[blockIdx.x] = nsq;
    if (full) {
      __syncthreads();
      block_dots(q, w, i + 1, n, part_c2);
    }
    grid.sync();  // 2: |w|^2 (and the second-pass partials) are complete
    const float norm1 = sqrtf(grid_total(part_n1, red));

    if (full) {
      // C. The second pass and the DGKS truncation.
      grid_dots(part_c2, i + 1, c, nullptr, depth);
      __syncthreads();
      nsq = block_sum(subtract_projection(q, c, w, i + 1, n), red);
      if (threadIdx.x == 0) part_n2[blockIdx.x] = nsq;
      grid.sync();  // 3: |w|^2 after the second pass is complete
      const float norm2 = sqrtf(grid_total(part_n2, red));
      keep = norm2 > 0.5f * norm1;
      norm = keep ? norm2 : 0.0f;
    } else {
      norm = norm1;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && i + 1 < depth) {
      h[static_cast<size_t>(i + 1) * depth + i] = norm;
    }
  }

  // The residual: the last w, zero if the last step truncated.
  const float* w_last = wbuf + static_cast<size_t>((depth - 1) & 1) * n;
  for (int r = first; r < n; r += stride) res[r] = keep ? w_last[r] : 0.0f;
}

}  // namespace

// The grid `lat_arnoldi_dia_forward` launches for n rows: the caller sizes
// the scratch for it. Returns a CUDA error code.
extern "C" int lat_arnoldi_dia_grid(int n, int* blocks) {
  if (n < 1) return cudaErrorInvalidValue;
  return lat::cooperative_blocks(arnoldi_forward_kernel, n, blocks);
}

// vals: (num_diags, n); v0: (n,); q: (depth, n) basis rows; h: (depth,
// depth); res: (n,); inv_norm: one float; wbuf: (2, n) scratch;
// partials: (2 depth + 2) blocks floats and coef: depth blocks floats of
// scratch, for the `blocks` of lat_arnoldi_dia_grid(n). offsets: host
// array, each in [0, n). full: 1 for re-orthogonalisation. float32,
// contiguous. Returns the launch's CUDA error code (cudaErrorInvalidValue
// for a shape or grid the kernel does not take, without launching).
extern "C" int lat_arnoldi_dia_forward(const float* vals, const float* v0, float* q, float* h,
                                       float* res, float* inv_norm, float* wbuf,
                                       float* partials, float* coef, int blocks, int n,
                                       int num_diags, const int* offsets, int depth, int full,
                                       void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1 || depth > n) return cudaErrorInvalidValue;
  int want = 0;
  cudaError_t err = lat::cooperative_blocks(arnoldi_forward_kernel, n, &want);
  if (err != cudaSuccess) return err;
  if (blocks != want) return cudaErrorInvalidValue;
  lat::DiaOffsets offs = lat::offsets_from_host(offsets, num_diags);
  void* args[] = {&vals, &v0, &q, &h, &res, &inv_norm, &wbuf, &partials, &coef,
                  &n, &num_diags, &offs, &depth, &full};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(arnoldi_forward_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
