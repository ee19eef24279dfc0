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
// bytes take a few microseconds and the K-step chain of barriers (2K + 1
// in each) sets the time instead.
//
// K6, planned on the host (ops/fused_lanczos.py `forward_plan`) and only
// validated here, like K7 and K9. A step computes w = A x and
// alpha = x.w, then r = w - alpha x - beta x_prev and beta' = |r|, then
// x' = r / beta' (guarded). The parent kernel ran it over an
// occupancy-sized grid (up to 8 blocks an SM, ~1,056 blocks) with a grid
// stride and three grid barriers a step (cg::this_grid().sync()), every
// block re-summing all ~1,056 partials after each, and moved (D + 8)
// vectors of 4n bytes a step through device memory (the values re-read, a
// work vector written, read and re-written, x read twice more, x_prev
// once; the D shifted reads of x counted once): 13 at D = 5, 4.9 GB over
// 90 steps at n = 2^20 (1.46 ms at 3.35 TB/s). This design:
// - the grid path: at most one block an SM (up to 512 threads), block b
//   owning rows [b R, (b + 1) R), R a multiple of 4;
// - the block's rows of the values are staged once into shared memory for
//   all K steps (the TPU kernel's VMEM-resident values): all D diagonals
//   where they fit (5 x 7,944 floats, 158.9 KB at n = 2^20), else the
//   first `resident_diags`, the others read through the read-only path
//   each step;
// - a thread owns rows r = tid + s T (s < 16, or s < 4 where a thread owns
//   4 rows or fewer) and keeps their x_prev, x and w in registers; a block
//   of more than 16 T rows reads x and x_prev back from its own rows of
//   the basis and keeps w in device scratch, on the same launch;
// - two grid barriers a step, not three: after the partials of x.w
//   (alpha), and after r and the partials of |r|^2 (beta'). r goes to one
//   (n,) scratch; after the second barrier each block writes only its own
//   rows of basis row i + 1, as r / beta' from registers (evict-first),
//   and keeps them as the next x. A neighbour's row j of the next x is
//   guarded(r[j] / beta') (step 0: v0[j] / |v0|), the same rounded
//   quotient bit for bit, so no barrier waits for the basis row. One
//   scratch suffices: every read of step i's r ends before the first
//   barrier of step i + 1, and step i + 1 writes r after it;
// - where it fits in the shared memory the values leave (n = 2^20 and
//   1,000,000 at five diagonals; not at 7 diagonals or more there), the
//   matvec reads x from a window: the block's own rows, written from
//   registers, and the halo its offsets reach, loaded from r once a step
//   in batches and divided once (without it the kernel reads 1.64 ms at
//   (2^20, 5, 90) on an H100 against 1.14, scripts/torch_kernel_variants.py
//   --only k6); else x comes from r in device memory, each load of a batch
//   issued before any divide;
// - per step device memory sees r written, its halo (or D shifted reads)
//   read back and the basis row written: 3 vectors, and one more for each
//   diagonal of the values not in shared memory;
// - K9's grid barrier (csrc/cooperative.cuh `grid_sync`, an atomic
//   counter the wrapper zeroes); after it one warp a block sums the
//   blocks' partials (132, not ~1,056) in one fixed order and shares the
//   total through shared memory (with every warp reading them, 2,112
//   warps queue on the same lines and a barrier costs several times
//   more): the same bits in every block and every run.
// The cluster path, for n up to the plan's CLUSTER_MAX_N (the 128 x 128
// Laplacian): there a grid barrier a step sets the time, against a bound
// of 1.9 us for the whole launch. One thread block cluster (16 blocks,
// the non-portable size) runs the recurrence: each block keeps its rows
// of the values, of r and its window of x in shared memory, fills the
// window's halo from its neighbours' r through distributed shared memory
// once a step, and each warp pushes its partial sum into every block's
// shared memory (so no block barrier and no remote read waits on the
// sum); the two barriers a step are the cluster's
// (barrier.cluster.arrive.release / barrier.cluster.wait.acquire). Only
// the basis rows and the coefficients go to device memory.
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

using lat::grid_sync;
using lat::guarded_div;
using lat::slab_stride;
using lat::sync_workers;
using lat::warp_sum;

// The rows of a thread (K6 and K7): r = tid + s threads < len, with
// s < kRegs (the loop unrolled, the state in registers) or s = 0 for every
// row (the state in device memory).
#define LAT_FOR_ROWS(s, r)                                                    \
  _Pragma("unroll") for (int s = 0, r = tid; kRegs > 0 ? s < kRegs : r < len; \
                         s += (kRegs > 0), r += threads) if (r < len)

// K6's constants: threads a block at most, rows a thread keeps in
// registers (kFwdFewSlots where a thread owns few rows, so that a small
// block does not walk 16 slots that hold nothing), and the largest
// cluster (the non-portable size).
constexpr int kFwdThreads = 512;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdSlots = 16;
constexpr int kFwdFewSlots = 4;
constexpr int kMaxCluster = 16;
// Loads a thread issues before it divides or multiplies any of them:
// rows (state in registers) or diagonals of a row (state in device
// memory) of the matvec, and rows of the window's halo.
constexpr int kFwdBatch = 8;
// Floats of the block sums: one a warp, the two totals (grid path), and
// the warp sums the cluster's blocks push to each other (two slots of
// kMaxCluster x kFwdWarps).
constexpr int kFwdSums = kFwdWarps + 4 + 2 * kMaxCluster * kFwdWarps;

// Floats of K6's dynamic shared memory: the staged offsets and the window
// table (3 num_diags + 4 ints), each rounded up to 4, the block sums, the
// block's resident_diags x rows slice of the values, on the cluster path
// the block's rows of r, and the window of x. ops/fused_lanczos.py
// `forward_smem_bytes` computes the same.
__host__ __device__ inline size_t forward_smem_floats(int num_diags, int rows, int resident_diags,
                                                      bool cluster, int window) {
  return static_cast<size_t>((num_diags + 3) / 4 * 4) + (3 * num_diags + 4 + 3) / 4 * 4 + kFwdSums +
         static_cast<size_t>(resident_diags + (cluster ? 1 : 0)) * rows + window;
}

// The sum of v over every thread of the grid (or the cluster), the same
// bits in every thread. On the grid path the block's sum (its warps' sums
// added by warp 0 in one fixed order) is published as its partial in
// `slot`; after a grid barrier warp 0 sums all blocks' partials in one
// fixed order and shares the total through shared memory (one warp a
// block reads the partials, so their lines see 132 readers, not 2,112).
// On the cluster path each warp pushes its sum into every block's shared
// memory before a cluster barrier, after which every warp sums all warps'
// sums, in one fixed order, from its own: no block barrier waits on the
// way. A slot is rewritten only after the next barrier, which every
// reader of it reaches after its read.
template <bool kCluster>
__device__ inline float all_blocks_total(float v, int slot, float* sums, float* partials,
                                         unsigned* counter, unsigned& goal, int threads) {
  float* red = sums;                 // kFwdWarps
  float* totals = sums + kFwdWarps;  // 2 (grid)
  float* pushed = totals + 4;        // 2 x kMaxCluster x kFwdWarps (cluster)
  const int blocks = gridDim.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = threads / 32;
  v = warp_sum(v);
  if constexpr (kCluster) {
    float* mine = pushed + slot * kMaxCluster * kFwdWarps;
    if (lane < blocks)
      *cg::this_cluster().map_shared_rank(mine + blockIdx.x * kFwdWarps + warp, lane) = v;
    lat::cluster_sync();
    float t = 0.0f;
    for (int i = lane; i < blocks * kFwdWarps; i += 32) {
      if (i % kFwdWarps < warps) t += mine[i];
    }
    return warp_sum(t);
  } else {
    if (lane == 0) red[warp] = v;
    sync_workers(threads);
    float* slab = partials + slot * slab_stride(blocks);
    if (warp == 0) {
      const float s = warp_sum(lane < warps ? red[lane] : 0.0f);
      if (lane == 0) slab[blockIdx.x] = s;
    }
    grid_sync(counter, goal, threads);
    if (warp == 0) {
      float t = 0.0f;
      for (int b = lane; b < blocks; b += 32) t += __ldcg(slab + b);
      t = warp_sum(t);
      if (lane == 0) totals[slot] = t;
    }
    sync_workers(threads);
    return totals[slot];
  }
}

// Row j of the vector whose quotient is this step's x: v0 at step 0, else
// the previous step's r, from the scratch in device memory (grid) or from
// the shared memory of the block that owns it (cluster).
template <bool kCluster>
__device__ __forceinline__ float source_row(const float* src, float* s_r, int j, int rows,
                                            bool first) {
  if constexpr (kCluster) {
    if (!first) {
      const int rank = j / rows;
      const int local = j - rank * rows;
      if (rank == static_cast<int>(blockIdx.x)) return s_r[local];
      return *cg::this_cluster().map_shared_rank(s_r + local, rank);
    }
  }
  return __ldcg(src + j);
}

// The window of x: the rows the block's matvec reads, the block's own
// rows among them, as contiguous segments of rows relative to the block's
// first row. The table (ops/fused_lanczos.py `window_table`): the window
// index of the block's first row, the number of segments, each segment's
// (window index, row relative to the block's first row), then for each
// diagonal k the window index of row (first row + d_k). Fill the rows the
// block does not own with guarded(src[g] / scale); the owners of the own
// rows write them from registers.
template <bool kCluster>
__device__ inline void stage_halo(float* s_win, const int* s_tab, int window, int len, int r0,
                                  int n, int rows, const float* src, float* s_r, float scale,
                                  bool first, int threads) {
  const int own = s_tab[0], segs = s_tab[1];
  const int* seg = s_tab + 2;
  const int halo = window - len;
  for (int j0 = threadIdx.x; j0 < halo; j0 += kFwdBatch * threads) {
    float v[kFwdBatch];
    int at[kFwdBatch];
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u) {
      const int j = j0 + u * threads;
      at[u] = -1;
      v[u] = 0.0f;
      if (j < halo) {
        const int idx = j < own ? j : j + len;
        int i = 0;
        while (i + 1 < segs && seg[2 * (i + 1)] <= idx) ++i;
        int g = (r0 + seg[2 * i + 1] + (idx - seg[2 * i])) % n;
        if (g < 0) g += n;
        at[u] = idx;
        v[u] = source_row<kCluster>(src, s_r, g, rows, first);
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdBatch; ++u) {
      if (at[u] >= 0) s_win[at[u]] = guarded_div(v[u], scale);
    }
  }
}

// K6 itself. kCluster: the grid is one thread block cluster and r lives in
// shared memory; else the grid is co-resident, one block an SM at most,
// and r lives in `scratch`. kRegs: as in LAT_FOR_ROWS. kWindow: the
// matvec reads x from the block's window in shared memory (filled once a
// step, each row divided once), else every neighbour's row from r,
// divided where read. The C entry launches the cluster path only as
// <true, kFwdFewSlots, true>, the plan's only cluster.
template <bool kCluster, int kRegs, bool kWindow>
__global__ void __launch_bounds__(kFwdThreads, 1)
    lanczos_forward_kernel(const float* __restrict__ vals, const float* __restrict__ v0,
                           float* xs, float* alphas, float* betas, float* scratch,
                           float* partials, unsigned* counter, int n, int num_diags,
                           const int* __restrict__ offsets, const int* __restrict__ table,
                           int depth, int rows, int resident_diags, int window) {
  constexpr int kS = kRegs > 0 ? kRegs : 1;
  constexpr int kRowBatch = kS < kFwdBatch ? kS : kFwdBatch;
  static_assert(kS % kRowBatch == 0, "a thread's slots split into whole batches");
  extern __shared__ __align__(16) float smem_fwd[];
  int* s_off = reinterpret_cast<int*>(smem_fwd);  // in [0, n)
  int* s_tab = s_off + (num_diags + 3) / 4 * 4;
  float* sums = reinterpret_cast<float*>(s_tab + (3 * num_diags + 4 + 3) / 4 * 4);
  float* s_vals = sums + kFwdSums;
  float* s_r = s_vals + static_cast<size_t>(resident_diags) * rows;  // cluster path
  float* s_win = s_r + (kCluster ? rows : 0);
  const int threads = blockDim.x, tid = threadIdx.x;
  const size_t nn = n;
  const int r0 = blockIdx.x * rows, len = max(0, min(n, r0 + rows) - r0);
  float* r_g = scratch;       // grid path: r of the step before, all rows
  float* w_g = scratch + nn;  // the state in device memory: this step's w
  unsigned goal = 0;
  auto total = [&](float v, int slot) {
    return all_blocks_total<kCluster>(v, slot, sums, partials, counter, goal, threads);
  };

  if constexpr (kWindow) {
    for (int i = tid; i < 3 * num_diags + 4; i += threads) s_tab[i] = __ldg(table + i);
  }
  lat::stage_offsets(offsets, num_diags, s_off);  // and a barrier of the whole block
  const int* s_base = s_tab + 2 + 2 * (kWindow ? s_tab[1] : 0);  // window index of row d_k
  for (int k = 0; k < resident_diags; ++k) {
    for (int r = tid; r < len; r += threads) {
      s_vals[static_cast<size_t>(k) * rows + r] = __ldg(vals + k * nn + r0 + r);
    }
  }

  // x0 = v0 / |v0| into basis row 0 (the staged values are visible to the
  // whole block after the barrier in `total`).
  float x[kS], xp[kS], w[kS];
  float p = 0.0f;
  LAT_FOR_ROWS(s, r) {
    const float v = __ldg(v0 + r0 + r);
    p = fmaf(v, v, p);
  }
  const float norm0 = sqrtf(total(p, 1));
  LAT_FOR_ROWS(s, r) {
    const float v = guarded_div(__ldg(v0 + r0 + r), norm0);
    if constexpr (kRegs > 0) {
      x[s] = v;
      xp[s] = 0.0f;
    }
    if constexpr (kWindow) s_win[s_tab[0] + r] = v;
    __stcs(xs + r0 + r, v);
  }
  if constexpr (kWindow) {
    stage_halo<kCluster>(s_win, s_tab, window, len, r0, n, rows, v0, s_r, norm0, true, threads);
    sync_workers(threads);
  }

  const float* src = v0;
  float scale = norm0, beta = 0.0f;
  for (int step = 0; step < depth; ++step) {
    const float* x_row = xs + static_cast<size_t>(step) * nn;
    const bool first = step == 0;

    // A. w = A x, and the partials of x . w. Row j of x is
    // guarded(src[j] / scale), the quotient its owner stored in the basis:
    // read from the window, or loaded and divided here. The loads of a
    // batch of rows (or diagonals) are issued before any divide: a
    // divide's slow-path branch would otherwise hold each load back until
    // the one before it returned.
    p = 0.0f;
    if constexpr (kRegs > 0) {
#pragma unroll
      for (int s = 0; s < kS; ++s) w[s] = 0.0f;
      for (int k = 0; k < num_diags; ++k) {
        const int off = s_off[k];
        const bool on_chip = k < resident_diags;  // the same in every thread
        const float* sk = s_vals + static_cast<size_t>(k) * rows;
        const float* vk = vals + k * nn + r0;
        const float* wk = s_win + (kWindow ? s_base[k] : 0);
#pragma unroll
        for (int s0 = 0; s0 < kS; s0 += kRowBatch) {
          float v[kRowBatch], xj[kRowBatch];
#pragma unroll
          for (int u = 0; u < kRowBatch; ++u) {
            const int r = tid + (s0 + u) * threads;
            const bool ok = r < len;
            v[u] = ok ? (on_chip ? sk[r] : __ldg(vk + r)) : 0.0f;
            if constexpr (kWindow) {
              xj[u] = ok ? wk[r] : 0.0f;
            } else {
              xj[u] = ok && off != 0
                          ? source_row<kCluster>(src, s_r, lat::wrap(r0 + r, off, n), rows, first)
                          : 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kRowBatch; ++u) {
            const int s = s0 + u;
            if (tid + s * threads < len) {
              const float xv = kWindow || off == 0 ? (kWindow ? xj[u] : x[s]) : guarded_div(xj[u], scale);
              w[s] = fmaf(v[u], xv, w[s]);
            }
          }
        }
      }
      LAT_FOR_ROWS(s, r) p = fmaf(x[s], w[s], p);
    } else {
      for (int r = tid; r < len; r += threads) {
        const int row = r0 + r;
        const float xv = __ldcg(x_row + row);  // this thread's own store
        float a = 0.0f;
        for (int k0 = 0; k0 < num_diags; k0 += kFwdBatch) {
          float v[kFwdBatch], xj[kFwdBatch];
#pragma unroll
          for (int u = 0; u < kFwdBatch; ++u) {
            const int k = k0 + u;
            const int off = k < num_diags ? s_off[k] : 0;
            v[u] = k >= num_diags        ? 0.0f
                   : k < resident_diags ? s_vals[static_cast<size_t>(k) * rows + r]
                                        : __ldg(vals + k * nn + row);
            if constexpr (kWindow) {
              xj[u] = k < num_diags ? s_win[s_base[k] + r] : 0.0f;
            } else {
              xj[u] = off == 0 ? xv : __ldcg(src + lat::wrap(row, off, n));
            }
          }
#pragma unroll
          for (int u = 0; u < kFwdBatch; ++u) {
            if (k0 + u < num_diags) {
              const bool direct = kWindow || s_off[k0 + u] == 0;
              a = fmaf(v[u], direct ? xj[u] : guarded_div(xj[u], scale), a);
            }
          }
        }
        __stcg(w_g + row, a);
        p = fmaf(xv, a, p);
      }
    }
    const float alpha = total(p, 0);  // barrier 1

    // B. r = w - alpha x - beta x_prev into the scratch (or shared memory),
    // and the partials of |r|^2.
    float q = 0.0f;
    LAT_FOR_ROWS(s, r) {
      const int row = r0 + r;
      float rv;
      if constexpr (kRegs > 0) {
        rv = w[s] - alpha * x[s] - beta * xp[s];
        w[s] = rv;
      } else {
        rv = __ldcg(w_g + row) - alpha * __ldcg(x_row + row);
        if (!first) rv -= beta * __ldcg(x_row - nn + row);
      }
      if constexpr (kCluster) {
        s_r[r] = rv;
      } else {
        __stcg(r_g + row, rv);
      }
      q = fmaf(rv, rv, q);
    }
    const float beta_next = sqrtf(total(q, 1));  // barrier 2

    // C. The block's own rows of basis row step + 1, kept as the next x
    // (and written to the window, whose halo is then filled for the next
    // step).
    float* x_next = xs + static_cast<size_t>(step + 1) * nn;
    LAT_FOR_ROWS(s, r) {
      const int row = r0 + r;
      float xn;
      if constexpr (kRegs > 0) {
        xp[s] = x[s];
        x[s] = xn = guarded_div(w[s], beta_next);
      } else {
        xn = guarded_div(__ldcg(r_g + row), beta_next);
      }
      if constexpr (kWindow) s_win[s_tab[0] + r] = xn;
      __stcs(x_next + row, xn);
    }
    if (blockIdx.x == 0 && tid == 0) {
      alphas[step] = alpha;
      betas[step] = beta_next;
    }
    src = r_g;
    scale = beta = beta_next;
    if constexpr (kWindow) {
      if (step + 1 < depth) {
        stage_halo<kCluster>(s_win, s_tab, window, len, r0, n, rows, r_g, s_r, beta_next, false,
                             threads);
        sync_workers(threads);
      }
    }
  }
  // No block leaves while another may still read its shared memory.
  if constexpr (kCluster) lat::cluster_sync();
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

// The checks of a K6 launch of `blocks` x `threads` with `smem` bytes,
// made on every launch: the kernel may use `smem` bytes of dynamic shared
// memory; the cluster path needs a card that places the cluster
// (cudaOccupancyMaxActiveClusters >= 1), the grid path a card of
// cooperative launches that holds the grid co-resident, one block an SM
// at most.
template <typename Kernel>
cudaError_t check_forward_launch(Kernel kernel, bool cluster, int blocks, int threads,
                                 size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.attrs = attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    return clusters < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks > sms) return cudaErrorInvalidValue;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace

// vals: (num_diags, n); v0: (n,); xs: (depth + 1, n); alphas, betas:
// (depth,); scratch: (n,) floats on the grid path (r), (2, n) where the
// state is in device memory (r, w), unused on the cluster path; partials:
// 2 slab_stride(blocks) floats of scratch on the grid path; counter: one
// unsigned, zero (the grid barrier's). offsets: device int32 array, each
// in [0, n); table: the window's (3 num_diags + 4 ints, see stage_halo),
// read where window > 0. float32, contiguous. The plan (the path, blocks,
// threads a block, rows a block, the diagonals of the values kept in
// shared memory, the window's floats, shared bytes) comes from
// ops/fused_lanczos.py `forward_plan`; it is validated, never changed: a
// depth outside [1, n], a grid that does not cover n with rows a block
// (or, on the grid path, has an empty block), threads that are not a
// multiple of 32 up to kFwdThreads, resident diagonals outside
// [0, num_diags], a window shorter than a block's rows or without a
// table, shared bytes other than the layout's, on the grid path more
// blocks than SMs or a grid that is not co-resident, on the cluster path
// more than kMaxCluster blocks, values not all resident, no window or
// more than kFwdFewSlots rows a thread (the planner takes the cluster only
// then), or a cluster the card cannot place
// (cudaOccupancyMaxActiveClusters < 1) return an error without a launch;
// no other path is tried.
extern "C" int lat_lanczos_dia_forward(const float* vals, const float* v0, float* xs,
                                       float* alphas, float* betas, float* scratch,
                                       float* partials, unsigned* counter, int n, int num_diags,
                                       const int* offsets, const int* table, int depth,
                                       int cluster, int blocks, int threads, int rows,
                                       int resident_diags, int window, int smem_bytes,
                                       void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1 || depth > n) return cudaErrorInvalidValue;
  if (resident_diags < 0 || resident_diags > num_diags) return cudaErrorInvalidValue;
  if (threads < 32 || threads % 32 != 0 || threads > kFwdThreads) return cudaErrorInvalidValue;
  if (rows < 4 || rows % 4 != 0 || blocks < 1 || static_cast<long long>(blocks) * rows < n)
    return cudaErrorInvalidValue;
  if (window < 0 || (window > 0 && (window < rows || table == nullptr))) return cudaErrorInvalidValue;
  const int per_thread = (rows + threads - 1) / threads;
  const bool regs = per_thread <= kFwdSlots, few = per_thread <= kFwdFewSlots;
  const bool win = window > 0;
  if (cluster ? blocks > kMaxCluster || resident_diags != num_diags || !win || !few
              : static_cast<long long>(blocks - 1) * rows >= n)
    return cudaErrorInvalidValue;
  const size_t need =
      sizeof(float) * forward_smem_floats(num_diags, rows, resident_diags, cluster, window);
  if (smem_bytes < 0 || need != static_cast<size_t>(smem_bytes)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster) {
    auto kernel = &lanczos_forward_kernel<true, kFwdFewSlots, true>;
    err = check_forward_launch(kernel, true, blocks, threads, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(blocks);
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = smem;
    config.stream = s;
    config.attrs = attr;
    config.numAttrs = 1;
    err = cudaLaunchKernelEx(&config, kernel, vals, v0, xs, alphas, betas, scratch, partials,
                             counter, n, num_diags, offsets, table, depth, rows, resident_diags,
                             window);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  auto kernel = few    ? (win ? &lanczos_forward_kernel<false, kFwdFewSlots, true>
                               : &lanczos_forward_kernel<false, kFwdFewSlots, false>)
                : regs ? (win ? &lanczos_forward_kernel<false, kFwdSlots, true>
                              : &lanczos_forward_kernel<false, kFwdSlots, false>)
                       : (win ? &lanczos_forward_kernel<false, 0, true>
                              : &lanczos_forward_kernel<false, 0, false>);
  err = check_forward_launch(kernel, false, blocks, threads, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&vals, &v0, &xs, &alphas, &betas, &scratch, &partials, &counter, &n,
                  &num_diags, &offsets, &table, &depth, &rows, &resident_diags, &window};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks), dim3(threads),
                                    args, smem, s);
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
