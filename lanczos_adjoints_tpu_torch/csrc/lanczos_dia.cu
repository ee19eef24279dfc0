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
// K6. One cooperative, persistent launch: the grid is sized by the
// occupancy calculator to be co-resident on the card (at most one block
// per 256 rows), and each block walks its rows with a grid stride that
// stays the same in every phase, so a thread only ever reads back the
// scratch entries (ax / resid) that it wrote itself. A step has three
// grid barriers (cg::this_grid().sync()): after the matvec and the
// per-block partials of x.Ax (then alpha), after the residual and the
// partials of |resid|^2 (then beta), and after writing the guarded
// x_next = resid / beta to basis row i + 1 (the next matvec reads its
// neighbours' rows).
//
// K7, planned on the host (ops/fused_lanczos.py `adjoint_plan`) and only
// validated here, like K9. A step of the adjoint reads x_i, dx_i and the
// values and does: (a) xi <- guarded(xi / beta_i) and the dots
// lam_{i+1}.x_i, x_{i+1}.xi, x_i.xi; (b) after a grid barrier, mu and nu
// from them and lam_i = -xi + mu x_{i+1} + nu x_i; (c) after a second grid
// barrier, A lam_i, dvals[k, r] += x_i[r] lam_i[(r + d_k) mod n] and the
// next xi. The parent kernel ran it over an occupancy-sized grid with a
// grid stride and three sweeps a step, re-reading x, x_next, xi and
// lam_next from device memory in each and read-modify-writing dvals in
// device memory: (16 + 3D) vectors of 4n bytes a step (the D shifted reads
// of lam counted once), 31 at D = 5. This design:
// - at most one block an SM (512 threads, fewer where a block has fewer
//   rows), block b owning rows [b R, (b + 1) R), R a multiple of 4;
// - the block's slice of dvals stays in shared memory for all K steps and
//   is written once at the end (the TPU kernel's VMEM-resident dvals
//   output): all D rows of it (`resident`) or, where they do not fit, the
//   first `resident_diags` of them (`streamed`, e.g. 7 of 9 at n = 2^20);
//   the other diagonals are read-modify-written in device memory, each
//   entry by the one thread that owns its row, their loads issued with
//   the values';
// - a thread owns rows r = tid + s T (s < 16), and keeps their xi,
//   lam_{i+1}, x_{i+1} and x_i in registers across the steps (the x of
//   step i is the x_next of step i - 1); a block of more than 16 T
//   rows keeps them in device memory instead (xi in scratch, the others
//   re-read), on the same launch;
// - lam_i goes to device memory (double-buffered by the step's parity),
//   and A lam and the dvals update read it back through L2 (__ldcg): the
//   block's own rows and its neighbours' halo rows (a window of lam in
//   shared memory measured no faster);
// - phase c takes a thread's rows in chunks of 2 (4 where some diagonals
//   of dvals are streamed), each chunk's loads of a diagonal (and its dx
//   and lambda first) issued before any is used (the first version walked
//   its rows one by one and waited on each row's loads in turn; with
//   dvals all on chip chunks of 2 measured faster than chunks of 4 or 8,
//   two diagonals a batch or all 16 rows at once, which hold more
//   registers at the 128 the state leaves room for; with some streamed,
//   chunks of 4 measured fastest), and issues the next step's x as each
//   chunk finishes, so phase a finds it loaded;
// - the values (21 MB at n = 2^20, D = 5) are read through the read-only
//   path, x and dx with evict-first loads (an L2 evict-last hint on the
//   values measured slower);
// - per step, device memory then sees x and dx read, lam written and read
//   back: (4 + D) vectors with the values, 4 without (and 2 more for each
//   diagonal of dvals in device memory), against the parent's 31 at D = 5;
// - K9's grid barrier (csrc/cooperative.cuh `grid_sync`, an atomic counter
//   the wrapper zeroes), two a step and one for dv, with the three dots'
//   per-block partials summed over the blocks in one fixed order, so every
//   result has the same bits in every run: no float atomics.
// Data written during the launch is read back across blocks through L2
// (__ldcg), never through the non-coherent L1 or texture path.
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
using lat::grid_sync;
using lat::grid_total;
using lat::guarded_div;
using lat::slab_stride;
using lat::sync_workers;
using lat::warp_sum;

__global__ void __launch_bounds__(kThreads)
    lanczos_forward_kernel(const float* __restrict__ vals, const float* __restrict__ v0,
                           float* xs, float* alphas, float* betas, float* work,
                           float* partials, int n, int num_diags,
                           const int* __restrict__ offsets, int depth) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int s_off[];
  __shared__ float red[kWarps];
  lat::stage_offsets(offsets, num_diags, s_off);
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

// K7's constants: threads a block at most and rows a thread keeps in
// registers.
constexpr int kAdjThreads = 512;
constexpr int kAdjWarps = kAdjThreads / 32;
constexpr int kSlots = 16;
// Phase c's rows a chunk (see the kernel): where every diagonal of dvals
// is on chip, and where some are streamed (their loads then wait on
// device memory, and more rows a chunk keep more of them in flight).
constexpr int kChunkOnChip = 2, kChunkStreamed = 4;
static_assert(kSlots % kChunkOnChip == 0 && kSlots % kChunkStreamed == 0,
              "a thread's slots split into whole chunks");

// Floats of K7's dynamic shared memory: the staged offsets (num_diags
// rounded up to 4), three sums per warp, then the block's resident_diags x
// rows slice of dvals. ops/fused_lanczos.py `adjoint_plan` computes the
// same.
__host__ __device__ inline size_t adjoint_smem_floats(int num_diags, int rows, int resident_diags) {
  return static_cast<size_t>((num_diags + 3) / 4 * 4) + 3 * kAdjWarps +
         static_cast<size_t>(resident_diags) * rows;
}

// Sums of a, b and c over the block's threads, each in a fixed order.
__device__ inline void block_total3(float& a, float& b, float& c, float* red, int threads) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  sync_workers(threads);  // the previous use of red is finished
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[w] = a;
    red[kAdjWarps + w] = b;
    red[2 * kAdjWarps + w] = c;
  }
  sync_workers(threads);
  a = b = c = 0.0f;
  for (int u = 0; u < threads / 32; ++u) {
    a += red[u];
    b += red[kAdjWarps + u];
    c += red[2 * kAdjWarps + u];
  }
}

// K7 itself. kStreams: some diagonals of dvals stay in device memory
// (resident_diags < num_diags); without it every diagonal is on chip and
// the kernel carries no code for the others.
//
// The rows of a thread: r = tid + s threads < len, with s < kRegs (the loop
// unrolled, the state in registers) or s = 0 for every row (the state in
// device memory).
#define LAT_FOR_ROWS(s, r)                                                    \
  _Pragma("unroll") for (int s = 0, r = tid; kRegs > 0 ? s < kRegs : r < len; \
                         s += (kRegs > 0), r += threads) if (r < len)

template <bool kStreams, int kRegs>
__global__ void __launch_bounds__(kAdjThreads, 1)
    lanczos_adjoint_kernel(const float* __restrict__ vals, const float* __restrict__ xs,
                           const float* __restrict__ dxs, const float* __restrict__ alphas,
                           const float* __restrict__ betas, const float* __restrict__ dalphas,
                           const float* __restrict__ dbetas, const float* __restrict__ inv_norm,
                           float* dv, float* dvals, float* xi_g, float* lam, float* partials,
                           unsigned* counter, int n, int num_diags, const int* __restrict__ offsets,
                           int depth, int rows, int resident_diags) {
  constexpr int kS = kRegs > 0 ? kRegs : 1;
  constexpr int kChunk = kStreams ? kChunkStreamed : kChunkOnChip;
  extern __shared__ __align__(16) float smem_adj[];
  int* s_off = reinterpret_cast<int*>(smem_adj);  // in [0, n)
  float* red = smem_adj + (num_diags + 3) / 4 * 4;
  float* s_dvals = red + 3 * kAdjWarps;
  const int threads = blockDim.x, tid = threadIdx.x;
  const size_t nn = n;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows), len = r1 - r0;
  const int stride = slab_stride(gridDim.x);
  unsigned goal = 0;

  lat::stage_offsets(offsets, num_diags, s_off);
  float xi[kS], lamn[kS], xn[kS], x[kS];

  // xi = -dx_K, lam_K = 0, x_{i+1} = x_K; dvals = 0.
  const float* dx_last = dxs + static_cast<size_t>(depth) * nn;
  const float* x_last = xs + static_cast<size_t>(depth) * nn;
  LAT_FOR_ROWS(s, r) {
    const int row = r0 + r;
    const float v = -__ldcs(dx_last + row);
    if constexpr (kRegs > 0) {
      xi[s] = v;
      lamn[s] = 0.0f;
      xn[s] = __ldcs(x_last + row);
      x[s] = __ldcs(x_last - nn + row);  // the first step's x; later ones are prefetched in c
    } else {
      xi_g[row] = v;
    }
    for (int k = 0; k < num_diags; ++k) {
      if (k < resident_diags) {
        s_dvals[static_cast<size_t>(k) * rows + r] = 0.0f;
      } else {
        dvals[k * nn + row] = 0.0f;
      }
    }
  }

  for (int step = depth - 1; step >= 0; --step) {
    const float* x_cur = xs + static_cast<size_t>(step) * nn;
    const float* x_next = x_cur + nn;
    const float* dx = dxs + static_cast<size_t>(step) * nn;
    const float alpha = __ldg(alphas + step), beta = __ldg(betas + step);
    float* lam_cur = lam + static_cast<size_t>(step & 1) * nn;
    const float* lam_next = lam + static_cast<size_t>((step + 1) & 1) * nn;
    const bool has_next = step < depth - 1;  // else lam_next is zero

    // a. xi <- guarded(xi / beta), and the three dots' partials.
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
    LAT_FOR_ROWS(s, r) {
      const int row = r0 + r;
      if constexpr (kRegs == 0) {
        xi[0] = xi_g[row];
        xn[0] = __ldg(x_next + row);
        lamn[0] = has_next ? __ldcg(lam_next + row) : 0.0f;
      }
      if constexpr (kRegs == 0) x[0] = __ldg(x_cur + row);
      const float g = guarded_div(xi[s], beta);
      xi[s] = g;
      if (has_next) p0 = fmaf(lamn[s], x[s], p0);
      p1 = fmaf(xn[s], g, p1);
      p2 = fmaf(x[s], g, p2);
      if constexpr (kRegs == 0) xi_g[row] = g;
    }
    block_total3(p0, p1, p2, red, threads);
    if (tid == 0) {
      partials[blockIdx.x] = p0;
      partials[stride + blockIdx.x] = p1;
      partials[2 * stride + blockIdx.x] = p2;
    }
    grid_sync(counter, goal, threads);  // 1: the dots' partials are complete

    // b. mu and nu, the same bits in every block; lam = -xi + mu x_next + nu x.
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int b = tid; b < gridDim.x; b += threads) {
      s0 += __ldcg(partials + b);
      s1 += __ldcg(partials + stride + b);
      s2 += __ldcg(partials + 2 * stride + b);
    }
    block_total3(s0, s1, s2, red, threads);
    const float mu = __ldg(dbetas + step) - s0 + s1;
    const float nu = __ldg(dalphas + step) + s2;
    LAT_FOR_ROWS(s, r) {
      const int row = r0 + r;
      if constexpr (kRegs == 0) {
        xi[0] = xi_g[row];
        x[0] = __ldg(x_cur + row);
        xn[0] = __ldg(x_next + row);
      }
      const float l = -xi[s] + mu * xn[s] + nu * x[s];
      lam_cur[row] = l;
    }
    grid_sync(counter, goal, threads);  // 2: lam is complete

    // c. A lam, the value gradient and the next xi.
    // A thread's rows in chunks of kChunk: a chunk's dx and lambda, then
    // each diagonal's values and lambdas for the chunk, are loaded before
    // any is used, so a thread keeps kChunk loads in flight and waits D
    // times a chunk, not D times a row.
#pragma unroll
    for (int c = 0; kRegs > 0 ? c < kRegs : tid + c * threads < len; c += kChunk) {
      if (tid + c * threads >= len) break;  // and every later chunk
      int rr[kChunk];
      bool ok[kChunk];
      float d[kChunk], lv[kChunk], xv[kChunk], xnv[kChunk], lnv[kChunk], at[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        ok[u] = tid + (c + u) * threads < len;
        rr[u] = ok[u] ? tid + (c + u) * threads : 0;
        const int row = r0 + rr[u];
        d[u] = __ldcs(dx + row);
        lv[u] = __ldcg(lam_cur + row);
        if constexpr (kRegs > 0) {
          xv[u] = x[c + u];
          xnv[u] = xn[c + u];
          lnv[u] = lamn[c + u];
        } else {
          xv[u] = __ldg(x_cur + row);
          xnv[u] = __ldg(x_next + row);
          lnv[u] = has_next ? __ldcg(lam_next + row) : 0.0f;
        }
        at[u] = 0.0f;
      }
      for (int k = 0; k < num_diags; ++k) {
        const int off = s_off[k];
        const bool on_chip = !kStreams || k < resident_diags;  // the same in every thread
        float vv[kChunk], ll[kChunk], dd[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int row = r0 + rr[u];
          vv[u] = __ldg(vals + k * nn + row);
          ll[u] = __ldcg(lam_cur + lat::wrap(row, off, n));
          // A streamed diagonal's dvals loads go out with the values', not
          // one round trip after another behind each store.
          if constexpr (kStreams) dd[u] = on_chip ? 0.0f : dvals[k * nn + row];
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (!ok[u]) continue;
          at[u] = fmaf(vv[u], ll[u], at[u]);
          if (on_chip) {
            s_dvals[static_cast<size_t>(k) * rows + rr[u]] += xv[u] * ll[u];
          } else {
            dvals[k * nn + r0 + rr[u]] = dd[u] + xv[u] * ll[u];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (!ok[u]) continue;
        const float v = -d[u] - at[u] + alpha * lv[u] + beta * lnv[u] - beta * nu * xnv[u];
        if constexpr (kRegs > 0) {
          xi[c + u] = v;
          lamn[c + u] = lv[u];
          xn[c + u] = xv[u];
          if (step > 0) x[c + u] = __ldcs(x_cur - nn + r0 + rr[u]);  // the next step's x, in flight
        } else {
          xi_g[r0 + rr[u]] = v;
        }
      }
    }
  }

  // dv = ((xi . x0) x0 - xi) / |v0|; x0 is the last step's x, now in xn.
  float p = 0.0f, none1 = 0.0f, none2 = 0.0f;
  LAT_FOR_ROWS(s, r) {
    const int row = r0 + r;
    if constexpr (kRegs == 0) {
      xi[0] = xi_g[row];
      xn[0] = __ldg(xs + row);
    }
    p = fmaf(xi[s], xn[s], p);
  }
  block_total3(p, none1, none2, red, threads);
  if (tid == 0) partials[blockIdx.x] = p;
  grid_sync(counter, goal, threads);  // 3: the partials of xi . x0 are complete
  float total = 0.0f;
  for (int b = tid; b < gridDim.x; b += threads) total += __ldcg(partials + b);
  none1 = none2 = 0.0f;
  block_total3(total, none1, none2, red, threads);
  const float inv = __ldg(inv_norm);
  LAT_FOR_ROWS(s, r) {
    const int row = r0 + r;
    if constexpr (kRegs == 0) {
      xi[0] = xi_g[row];
      xn[0] = __ldg(xs + row);
    }
    dv[row] = (total * xn[s] - xi[s]) * inv;
    for (int k = 0; k < resident_diags; ++k) {
      dvals[k * nn + row] = s_dvals[static_cast<size_t>(k) * rows + r];
    }
  }
}

#undef LAT_FOR_ROWS

}  // namespace

// vals: (num_diags, n); v0: (n,); xs: (depth + 1, n); alphas, betas:
// (depth,); work: (n,) scratch; partials: scratch of partials_capacity
// floats (two per block). offsets: device int32 array, each in [0, n). float32,
// contiguous. Returns the launch's CUDA error code (cudaErrorInvalidValue
// for a shape the kernel does not take, without launching).
extern "C" int lat_lanczos_dia_forward(const float* vals, const float* v0, float* xs,
                                       float* alphas, float* betas, float* work,
                                       float* partials, int partials_capacity, int n,
                                       int num_diags, const int* offsets, int depth,
                                       void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1) return cudaErrorInvalidValue;
  const size_t smem = lat::offsets_bytes(num_diags);
  int blocks = 0;
  cudaError_t err = lat::allow_smem(lanczos_forward_kernel, smem);
  if (err == cudaSuccess) err = cooperative_blocks(lanczos_forward_kernel, n, smem, &blocks);
  if (err != cudaSuccess) return err;
  if (2 * blocks > partials_capacity) return cudaErrorInvalidValue;
  void* args[] = {&vals, &v0, &xs, &alphas, &betas, &work, &partials,
                  &n, &num_diags, &offsets, &depth};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lanczos_forward_kernel),
                                    dim3(blocks), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// vals: (num_diags, n); xs, dxs: (depth + 1, n); alphas, betas, dalphas,
// dbetas: (depth,); inv_norm: one float on the device (1 / |v0|); dv: (n,);
// dvals: (num_diags, n); xi: (n,) and lam: (2, n) scratch; partials:
// 3 slab_stride(blocks) floats of scratch; counter: one unsigned, zero.
// offsets: device int32 array, each in [0, n). float32, contiguous. The
// plan (blocks, threads a block, rows a block, the diagonals of dvals
// kept in shared memory, shared bytes) comes from ops/fused_lanczos.py
// `adjoint_plan`; it is validated, never changed: a grid that does not
// cover n with rows a block, more blocks than SMs, a grid that is not
// co-resident, threads that are not a multiple of 32 up to kAdjThreads,
// resident diagonals outside [0, num_diags], or shared bytes other than
// the layout's return cudaErrorInvalidValue (or the occupancy's
// error) without a launch.
extern "C" int lat_lanczos_dia_adjoint(const float* vals, const float* xs, const float* dxs,
                                       const float* alphas, const float* betas,
                                       const float* dalphas, const float* dbetas,
                                       const float* inv_norm, float* dv, float* dvals,
                                       float* xi, float* lam, float* partials, unsigned* counter,
                                       int n, int num_diags, const int* offsets, int depth,
                                       int blocks, int threads, int rows, int resident_diags,
                                       int smem_bytes, void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1) return cudaErrorInvalidValue;
  if (resident_diags < 0 || resident_diags > num_diags) return cudaErrorInvalidValue;
  if (threads < 32 || threads % 32 != 0 || threads > kAdjThreads) return cudaErrorInvalidValue;
  if (rows < 4 || rows % 4 != 0 || blocks < 1 || static_cast<long long>(blocks) * rows < n ||
      static_cast<long long>(blocks - 1) * rows >= n)
    return cudaErrorInvalidValue;
  const size_t need = sizeof(float) * adjoint_smem_floats(num_diags, rows, resident_diags);
  if (smem_bytes < 0 || need != static_cast<size_t>(smem_bytes)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks > sms) return cudaErrorInvalidValue;
  const bool regs = (rows + threads - 1) / threads <= kSlots;
  const bool streams = resident_diags < num_diags;
  auto kernel = streams ? (regs ? &lanczos_adjoint_kernel<true, kSlots> : &lanczos_adjoint_kernel<true, 0>)
                        : (regs ? &lanczos_adjoint_kernel<false, kSlots> : &lanczos_adjoint_kernel<false, 0>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&vals, &xs, &dxs, &alphas, &betas, &dalphas, &dbetas, &inv_norm, &dv,
                  &dvals, &xi, &lam, &partials, &counter, &n, &num_diags, &offsets, &depth,
                  &rows, &resident_diags};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(threads),
                                    args, static_cast<size_t>(smem_bytes),
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
