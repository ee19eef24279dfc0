// K6 and K7: the whole Lanczos forward recurrence and the whole
// closed-form adjoint over a DIA operator, one launch each.
//
// `lat_lanczos_dia_forward` (K6) replaces the TPU kernels `_lanczos_kernel`
// (basis resident in VMEM, launched by `lanczos_forward_dia`) and
// `_lanczos_stream_kernel` (basis streamed through HBM, launched by
// `lanczos_forward_dia_stream`) of lanczos_adjoints_tpu/ops/pallas_lanczos.py.
// `lat_lanczos_dia_adjoint` (K7) replaces `_lanczos_adjoint_kernel` and
// `_lanczos_stream_adjoint_kernel` (launched by `lanczos_adjoint_dia` and
// `lanczos_adjoint_dia_stream`). The TPU needed two variants because its
// VMEM holds the basis only up to a size; on this card the basis always
// lives in device memory, so one kernel serves both.
//
// What bounds them on an H100. Bytes, counting each array once: K6 reads
// vals and v0 and writes the (K+1, n) basis, (D + 1 + K + 1) n 4 bytes;
// K7 reads xs, dxs and vals and writes dv and dvals,
// (2 (K + 1) + 2 D + 1) n 4 bytes. At n = 1,048,576, D = 5, K = 90 that is
// 407 MB (121 us) and 809 MB (242 us) at 3.35 TB/s. At n = 16,384 the
// bytes take a few microseconds and the K-step chain of grid-wide
// barriers (3K + 1 in K6, 2K + 1 in K7) sets the time instead.
//
// Design. One cooperative, persistent launch per pass: the grid is sized
// by the occupancy calculator to be co-resident on the card (at most one
// block per 256 rows), and each block walks its rows with a grid stride
// that stays the same in every phase, so a thread only ever reads back
// the scratch entries (ax / resid, xi) that it wrote itself. A step of
// K6 has three grid barriers: after the matvec and the per-block partials
// of x.Ax (then alpha), after the residual and the partials of |resid|^2
// (then beta), and after writing the guarded x_next = resid / beta to
// basis row i + 1 (the next matvec reads its neighbours' rows). A step of
// K7 has two: after the guarded xi / beta and the three partial dots
// (then mu and nu), and after writing lambda (double-buffered; the
// product A lambda and dvals[k, i] += x[i] lambda[(i + d_k) mod n] read
// neighbours' entries). Every block sums the per-block partials in the
// same fixed order, so alpha, beta, mu and nu are the same in every block
// and in every run: no float atomics. Each dvals entry is owned by one
// thread. Data written during the launch is read back across blocks
// through L2 (__ldcg), never through the non-coherent L1 or texture path.
// Later work: a single-block or cluster variant for small n, and keeping
// vals and dvals on chip.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "dia_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = lat::kCoopThreads;
constexpr int kWarps = lat::kCoopWarps;
using lat::block_sum;
using lat::cooperative_blocks;
using lat::grid_total;
using lat::guarded_div;

__global__ void __launch_bounds__(kThreads)
    lanczos_forward_kernel(const float* __restrict__ vals, const float* __restrict__ v0,
                           float* xs, float* alphas, float* betas, float* work,
                           float* partials, int n, int num_diags, lat::DiaOffsets offs,
                           int depth) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[lat::kMaxDiags];
  __shared__ float red[kWarps];
  lat::stage_offsets(offs, num_diags, s_off);
  // A slot is rewritten only after a barrier that follows every block's
  // read of it: part_a after barrier 3, part_b after barrier 1.
  float* part_a = partials;              // x . Ax
  float* part_b = partials + gridDim.x;  // |resid|^2 (and |v0|^2 first)
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  float s = 0.0f;
  for (int i = first; i < n; i += stride) s = fmaf(v0[i], v0[i], s);
  s = block_sum(s, red);
  if (threadIdx.x == 0) part_b[blockIdx.x] = s;
  grid.sync();
  const float norm0 = sqrtf(grid_total(part_b, red));
  for (int i = first; i < n; i += stride) xs[i] = guarded_div(v0[i], norm0);

  float beta = 0.0f;
  for (int step = 0; step < depth; ++step) {
    const float* x = xs + static_cast<size_t>(step) * n;
    const float* x_prev = x - n;  // read only from step 1 on
    float* x_next = xs + static_cast<size_t>(step + 1) * n;

    // 1. ax = A x, and the partials of x . ax. Row 0 of the basis is
    // not yet visible across blocks in step 0, so that step recomputes
    // the neighbours' x0 = v0 / |v0| (the same rounded quotient).
    float p = 0.0f;
    for (int i = first; i < n; i += stride) {
      float acc = 0.0f;
      for (int k = 0; k < num_diags; ++k) {
        const int j = lat::wrap(i, s_off[k], n);
        const float xj = step == 0 ? guarded_div(v0[j], norm0) : __ldcg(x + j);
        acc = fmaf(vals[static_cast<size_t>(k) * n + i], xj, acc);
      }
      work[i] = acc;
      p = fmaf(x[i], acc, p);
    }
    p = block_sum(p, red);
    if (threadIdx.x == 0) part_a[blockIdx.x] = p;
    grid.sync();
    const float alpha = grid_total(part_a, red);

    // 2. resid = ax - alpha x - beta x_prev, and the partials of |resid|^2.
    float q = 0.0f;
    for (int i = first; i < n; i += stride) {
      float r = work[i] - alpha * x[i];
      if (step > 0) r -= beta * x_prev[i];
      work[i] = r;
      q = fmaf(r, r, q);
    }
    q = block_sum(q, red);
    if (threadIdx.x == 0) part_b[blockIdx.x] = q;
    grid.sync();
    const float beta_next = sqrtf(grid_total(part_b, red));

    // 3. The guarded x_next into basis row step + 1.
    for (int i = first; i < n; i += stride) x_next[i] = guarded_div(work[i], beta_next);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      alphas[step] = alpha;
      betas[step] = beta_next;
    }
    beta = beta_next;
    grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads)
    lanczos_adjoint_kernel(const float* __restrict__ vals, const float* __restrict__ xs,
                           const float* __restrict__ dxs, const float* __restrict__ alphas,
                           const float* __restrict__ betas, const float* __restrict__ dalphas,
                           const float* __restrict__ dbetas, const float* __restrict__ inv_norm,
                           float* dv, float* dvals, float* xi, float* lam, float* partials,
                           int n, int num_diags, lat::DiaOffsets offs, int depth) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_off[lat::kMaxDiags];
  __shared__ float red[kWarps];
  lat::stage_offsets(offs, num_diags, s_off);
  float* part0 = partials;  // lam_next . x (and xi . x0 at the end)
  float* part1 = partials + gridDim.x;      // x_next . xi
  float* part2 = partials + 2 * gridDim.x;  // x . xi
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  const float* dx_last = dxs + static_cast<size_t>(depth) * n;
  for (int i = first; i < n; i += stride) {
    xi[i] = -dx_last[i];
    for (int k = 0; k < num_diags; ++k) dvals[static_cast<size_t>(k) * n + i] = 0.0f;
  }

  for (int step = depth - 1; step >= 0; --step) {
    const float* x = xs + static_cast<size_t>(step) * n;
    const float* x_next = x + n;
    const float* dx = dxs + static_cast<size_t>(step) * n;
    const float alpha = alphas[step];
    const float beta = betas[step];
    float* lam_cur = lam + static_cast<size_t>(step & 1) * n;
    const float* lam_next = lam + static_cast<size_t>((step + 1) & 1) * n;
    const bool has_next = step < depth - 1;  // else lam_next is zero

    // a. xi <- guarded(xi / beta), and the three partial dots.
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
    for (int i = first; i < n; i += stride) {
      const float g = guarded_div(xi[i], beta);
      xi[i] = g;
      if (has_next) p0 = fmaf(lam_next[i], x[i], p0);
      p1 = fmaf(x_next[i], g, p1);
      p2 = fmaf(x[i], g, p2);
    }
    p0 = block_sum(p0, red);
    p1 = block_sum(p1, red);
    p2 = block_sum(p2, red);
    if (threadIdx.x == 0) {
      part0[blockIdx.x] = p0;
      part1[blockIdx.x] = p1;
      part2[blockIdx.x] = p2;
    }
    grid.sync();
    const float s0 = grid_total(part0, red);
    const float s1 = grid_total(part1, red);
    const float s2 = grid_total(part2, red);
    const float mu = dbetas[step] - s0 + s1;
    const float nu = dalphas[step] + s2;

    // b. lam = -xi + mu x_next + nu x.
    for (int i = first; i < n; i += stride) lam_cur[i] = -xi[i] + mu * x_next[i] + nu * x[i];
    grid.sync();

    // c. A lam, the value gradient, and xi for the step before.
    for (int i = first; i < n; i += stride) {
      const float xval = x[i];
      float at_lam = 0.0f;
      for (int k = 0; k < num_diags; ++k) {
        const size_t slot = static_cast<size_t>(k) * n + i;
        const float lj = __ldcg(lam_cur + lat::wrap(i, s_off[k], n));
        at_lam = fmaf(vals[slot], lj, at_lam);
        dvals[slot] += xval * lj;
      }
      const float ln = has_next ? lam_next[i] : 0.0f;
      xi[i] = -dx[i] - at_lam + alpha * lam_cur[i] + beta * ln - beta * nu * x_next[i];
    }
  }

  // dv = ((xi . x0) x0 - xi) / |v0|.
  float p = 0.0f;
  for (int i = first; i < n; i += stride) p = fmaf(xi[i], xs[i], p);
  p = block_sum(p, red);
  if (threadIdx.x == 0) part0[blockIdx.x] = p;
  grid.sync();
  const float s = grid_total(part0, red);
  const float inv = *inv_norm;
  for (int i = first; i < n; i += stride) dv[i] = (s * xs[i] - xi[i]) * inv;
}

}  // namespace

// vals: (num_diags, n); v0: (n,); xs: (depth + 1, n); alphas, betas:
// (depth,); work: (n,) scratch; partials: scratch of partials_capacity
// floats (two per block). offsets: host array, each in [0, n). float32,
// contiguous. Returns the launch's CUDA error code (cudaErrorInvalidValue
// for a shape the kernel does not take, without launching).
extern "C" int lat_lanczos_dia_forward(const float* vals, const float* v0, float* xs,
                                       float* alphas, float* betas, float* work,
                                       float* partials, int partials_capacity, int n,
                                       int num_diags, const int* offsets, int depth,
                                       void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = cooperative_blocks(lanczos_forward_kernel, n, &blocks);
  if (err != cudaSuccess) return err;
  if (2 * blocks > partials_capacity) return cudaErrorInvalidValue;
  lat::DiaOffsets offs = lat::offsets_from_host(offsets, num_diags);
  void* args[] = {&vals, &v0, &xs, &alphas, &betas, &work, &partials,
                  &n, &num_diags, &offs, &depth};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lanczos_forward_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// vals: (num_diags, n); xs, dxs: (depth + 1, n); alphas, betas, dalphas,
// dbetas: (depth,); inv_norm: one float on the device (1 / |v0|);
// dv: (n,); dvals: (num_diags, n); xi: (n,) and lam: (2, n) scratch;
// partials: scratch of partials_capacity floats (three per block).
extern "C" int lat_lanczos_dia_adjoint(const float* vals, const float* xs, const float* dxs,
                                       const float* alphas, const float* betas,
                                       const float* dalphas, const float* dbetas,
                                       const float* inv_norm, float* dv, float* dvals,
                                       float* xi, float* lam, float* partials,
                                       int partials_capacity, int n, int num_diags,
                                       const int* offsets, int depth, void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = cooperative_blocks(lanczos_adjoint_kernel, n, &blocks);
  if (err != cudaSuccess) return err;
  if (3 * blocks > partials_capacity) return cudaErrorInvalidValue;
  lat::DiaOffsets offs = lat::offsets_from_host(offsets, num_diags);
  void* args[] = {&vals,   &xs, &dxs, &alphas,   &betas, &dalphas, &dbetas,
                  &inv_norm, &dv, &dvals, &xi, &lam,  &partials, &n,
                  &num_diags, &offs, &depth};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lanczos_adjoint_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
