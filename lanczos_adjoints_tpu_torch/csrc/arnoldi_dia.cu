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
// without re-orthogonalisation, 2 with): 0.50 ms at n = 1,000,000,
// K = 90, full, by the fp32 rate. That bound needs the basis on chip.
// Where it is not (the card's shared memory holds 132 x 227 KB), this
// kernel's step i reads Q[:i+1] three times with re-orthogonalisation (the
// first-pass dots; the first update together with the second-pass dots;
// the second update) and twice without, because each dot pass needs a
// grid-wide sum before the update that follows it: 49.5 GB, 14.8 ms at
// 3.35 TB/s at that shape, the traffic of this schedule (rows kept in
// shared memory or L2 would save up to ~12 % of it). The projections are matrix-vector products, about 0.5 flop
// a byte, so fp32 has ~100x to spare and no tensor core is used. At
// n = 16,384 the basis (5.9 MB at K = 90) fits the blocks' shared memory,
// and the chain of grid barriers (3 a step, 2 without
// re-orthogonalisation) and the sums of the per-block partials set the
// time.
//
// Design. One cooperative, persistent launch of at most one block an SM,
// planned on the host (ops/fused_arnoldi.py `launch_plan`) and only
// validated here. Block b owns rows [b R, (b + 1) R), R a multiple of 4,
// in every phase. Three paths, one template:
// - resident: the block's R x K slice of the basis lives in shared
//   memory for the whole launch; each new row goes there and to Q in
//   device memory, and the basis is never read back from device memory;
// - streamed: a step walks the block's rows in tiles three times (twice
//   without re-orthogonalisation): A computes q_i and w = A q_i for the
//   tile (writing both to device memory) and the first-pass dot partials;
//   B applies the first update, |w|^2 and the second-pass partials from
//   the same staged tile; C applies the second update and |w|^2. A B or C
//   tile holds Q[:i+1] and w over T rows, an A tile Q[:i], the D rows of
//   the values and D + 1 windows of the previous residual (its q_i and w
//   stay beside the buffers). One producer warp stages the tiles into
//   kStages buffers ahead of the computing warps, by bulk copies (the
//   Tensor Memory Accelerator, one cp.async.bulk a row or window) when
//   n % 4 == 0 and by 4-byte cp.async otherwise; a tile's arrival and its
//   release are mbarriers, so no computing warp issues or waits on a copy.
//   A sweep's first tiles arrive while the grid waits at the barrier
//   before it (A's without their windows, which follow once a third
//   mbarrier says the previous residual is final). T is the largest
//   multiple of 4 with a tile in a buffer, at most the computing threads,
//   so a tile moves about as many bytes at every deep step; odd sweeps
//   walk the rows backwards, so that a sweep starts on the rows the one
//   before it read last, while they are still in L2;
// - direct: where the deepest A tile would hold fewer than kMinTile rows
//   (K >= 843 with D = 5 and an H100's shared memory), the
//   streamed path's sweeps read Q and w from device memory themselves, a
//   row a thread, with no producer and no staging: any depth runs.
// The dot partials of a pass, one per block and coefficient, form an
// (i + 1) x blocks slab; after a grid barrier every block sums each
// coefficient over the blocks in one fixed order (lanes over groups of 4
// blocks, then a butterfly), so c, the norms and H have the same bits in
// every block and run: no float atomics. The grid barrier is the kernel's
// own (a release add and acquire loads on a counter), so that the
// producer warp never has to join it. The residual is double-buffered in
// device memory, so step i + 1 computes its neighbours' q_{i+1} = w / norm
// from the previous buffer itself; data written during the launch is read
// across blocks through L2 (__ldcg) or by bulk copies after a proxy fence.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cooperative.cuh"
#include "dia_common.cuh"
#include "tensor_core.cuh"  // the cp.async helpers

namespace {

// A block's threads, the producer warp included: 512 computing threads
// and the producer, so that the compiler may give a thread 112 registers
// (the projection and the dots keep 16 and 8 loads in flight).
constexpr int kMaxThreads = 544;
constexpr int kStages = 2;  // staging buffers of the streamed path
// Shared memory ahead of the coefficients: the staged offsets (num_diags
// rounded up to 4), one float per warp for the block sums, and room for 8
// mbarriers (8 bytes each).
constexpr int kWarpSlots = 32;
__host__ __device__ inline int head_floats(int num_diags) {
  return (num_diags + 3) / 4 * 4 + kWarpSlots + 16;
}
static_assert(2 * kStages + 1 <= 8, "the head holds 8 mbarriers");
// The fewest rows of a staged tile: a launch whose deepest A tile would
// hold fewer takes the direct path.
constexpr int kMinTile = 32;
// The paths, the kernel's template argument.
constexpr int kResidentPath = 0, kStreamedPath = 1, kDirectPath = 2;

using lat::block_total;
using lat::grid_sync;
using lat::guarded_div;
using lat::slab_stride;
using lat::sync_workers;
using lat::warp_sum;

// Floats for the coefficients (and, beside the second pass's, |w|^2).
__host__ __device__ inline int padded_depth(int depth) { return (depth + 4) / 4 * 4; }

// Floats of dynamic shared memory: the head, the coefficients c and the
// dot accumulators (padded_depth each; in device memory instead where
// `coefs_on_chip` is false, the direct path at a depth whose coefficients
// do not fit), the split sums (one per computing thread), then the
// resident path's w (R) and basis slice (K x R), or the other paths' q_i
// and w of a tile (one per computing thread each) and the streamed path's
// kStages staging buffers of `stage` floats. ops/fused_arnoldi.py
// `launch_plan` computes the same.
__host__ __device__ inline size_t smem_floats(int depth, int threads, int rows, int path, int stage,
                                              int num_diags, bool coefs_on_chip) {
  const size_t head = head_floats(num_diags) +
                      (coefs_on_chip ? 2 * static_cast<size_t>(padded_depth(depth)) : 0) + threads;
  if (path == kResidentPath) return head + static_cast<size_t>(depth + 1) * rows;
  return head + 2 * static_cast<size_t>(threads) +
         (path == kStreamedPath ? kStages * static_cast<size_t>(stage) : 0);
}

// Rows of a streamed tile at step i. A's tile holds Q[:i] and the D rows of
// the values (T floats each), then the D + 1 windows of the previous
// residual that A q_i reads (T + 4 floats each: the offsets 0, d_1..d_D);
// B's and C's hold Q[:i+1] and w. T is a multiple of 4, at most R and at
// most the computing threads.
__host__ __device__ inline int tile_rows(int stage, int step, int num_diags, bool a, int rows,
                                         int threads) {
  int t = a ? (stage - 4 * (num_diags + 1)) / (step + 2 * num_diags + 1) : stage / (step + 2);
  t = t / 4 * 4;
  t = t < rows ? t : rows;
  return t < threads ? t : threads;
}

// Sum of the per-block partials, the same in every block.
__device__ float grid_total(const float* partials, float* redw, int threads) {
  float s = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += threads) s += __ldcg(partials + b);
  return block_total(s, redw, threads);
}

// c[j] = sum over blocks of part[j * stride + b], for j < count, one warp
// a coefficient (four at a time, so that their loads are in flight
// together), in one fixed order: each lane over its groups of 4 blocks (16
// bytes a load), then a butterfly. With h_col also h_col[j * depth] = c[j].
__device__ void grid_coefs(const float* part, int count, float* c, float* h_col, int depth,
                           int threads) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x % 32, warps = threads / 32, stride = slab_stride(gridDim.x);
  for (int j0 = threadIdx.x / 32; j0 < count; j0 += kBatch * warps) {
    float s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * warps;
      s[u] = 0.0f;
      if (j < count) {
        const float4* pj = reinterpret_cast<const float4*>(part + static_cast<size_t>(j) * stride);
        for (int g = lane; g < stride / 4; g += 32) {
          const float4 p = __ldcg(pj + g);
          s[u] += (p.x + p.y) + (p.z + p.w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * warps;
      const float t = warp_sum(s[u]);
      if (lane == 0 && j < count) {
        c[j] = t;
        if (h_col != nullptr) h_col[static_cast<size_t>(j) * depth] = t;
      }
    }
  }
}

// acc[j] += sum_{r < len} q_j[r] w[r] for j < count, q_j row j of the
// tile (row count - 1 at `last` where given), four rows a warp at a time
// (one load of w for four products, four sums in flight); warp w owns
// j = 4w..4w+3 (+ 4 warps, ...), so the tiles add up in their order.
__device__ void tile_dots(const float* tile, int ld, const float* last, const float* w, int len,
                          int count, float* acc, int threads) {
  const int lane = threadIdx.x % 32, warps = threads / 32;
  for (int j = 4 * (threadIdx.x / 32); j < count; j += 4 * warps) {
    const int rows = min(4, count - j);
    const float* qj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      qj[u] = last != nullptr && j + u == count - 1 ? last : tile + static_cast<size_t>(j + u) * ld;
    }
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int r = lane; r < len; r += 32) {
      const float wr = w[r];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < rows) s[u] = fmaf(qj[u][r], wr, s[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float t = warp_sum(s[u]);
      if (lane == 0 && u < rows) acc[j + u] += t;
    }
  }
}

// sum_{j0 <= j < j1} c[j] tile[j ld + r], in four interleaved partial sums
// (j mod 4) added up in a fixed order; j0 is a multiple of 4 and c is
// 16-byte aligned, so four coefficients come in one load.
__device__ inline float projection(const float* tile, int ld, const float* c, int j0, int j1,
                                   int r) {
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
  const float* t = tile + static_cast<size_t>(j0) * ld + r;
  int j = j0;
#pragma unroll 4
  for (; j + 4 <= j1; j += 4, t += 4 * static_cast<size_t>(ld)) {
    const float4 cj = *reinterpret_cast<const float4*>(c + j);
    p0 = fmaf(cj.x, t[0], p0);
    p1 = fmaf(cj.y, t[ld], p1);
    p2 = fmaf(cj.z, t[2 * ld], p2);
    p3 = fmaf(cj.w, t[3 * ld], p3);
  }
  for (; j < j1; ++j, t += ld) p0 = fmaf(c[j], t[0], p0);
  return (p0 + p1) + (p2 + p3);
}

// w_out[r] = w[r] - sum_{j < count} c[j] tile[j ld + r] for r < len, in
// shared memory (w_out may be w) and in wg (device memory); returns the
// thread's share of |w_out|^2. Where the tile has fewer rows than the
// computing threads, `splits` threads share a row, each over a contiguous
// range of j, and their sums add up in split order.
__device__ float tile_update(const float* tile, int ld, const float* c, int count, const float* w,
                             float* w_out, float* wg, int len, float* red, int threads) {
  const int tid = threadIdx.x;
  const int splits = len < threads ? threads / len : 1;
  float nsq = 0.0f;
  if (splits == 1) {
    for (int r = tid; r < len; r += threads) {
      const float v = w[r] - projection(tile, ld, c, 0, count, r);
      w_out[r] = v;
      wg[r] = v;
      nsq = fmaf(v, v, nsq);
    }
    return nsq;
  }
  const int chunk = (count + 4 * splits - 1) / (4 * splits) * 4;  // a multiple of 4
  const int s = tid / len, r = tid - s * len;
  if (s < splits) {
    red[tid] = projection(tile, ld, c, min(count, s * chunk), min(count, (s + 1) * chunk), r);
  }
  sync_workers(threads);
  if (tid < len) {
    float proj = 0.0f;
    for (int k = 0; k < splits; ++k) proj += red[k * len + tid];
    const float v = w[tid] - proj;
    w_out[tid] = v;
    wg[tid] = v;
    nsq = fmaf(v, v, nsq);
  }
  return nsq;
}

// mbarriers and bulk copies of the streamed path.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The arrival of this thread's earlier cp.async copies, counted on `bar`.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Spins until the phase of the given parity has completed; a phase that
// never completes (a fault in the copies' accounting) ends the launch with
// an error after about 2^34 cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The streamed path: kStages buffers, tiles numbered in the order they are
// staged across sweeps and steps. Tile s uses buffer s % kStages; its
// arrival completes phase s / kStages of full[s % kStages] and its release
// (every computing thread done with it) phase s / kStages of
// empty[s % kStages]. Phase i of `gate` completes when step i may read the
// previous residual (the grid barrier before it has passed).
struct Stream {
  float* base;      // kStages buffers of `stage` floats
  uint64_t* full;   // kStages mbarriers: a tile has arrived
  uint64_t* empty;  // kStages mbarriers: a tile has been consumed
  uint64_t* gate;
  int rows, stage, threads, num_diags;
  int r0, r1;       // the block's rows
  bool vec;         // n % 4 == 0: bulk copies
  bool direct;      // the direct path: tiles of a row a thread in device memory

  __device__ float* buffer(int s) const { return base + static_cast<size_t>(s % kStages) * stage; }
  __device__ int tile(int step, bool a) const {
    return direct ? min(rows, threads) : tile_rows(stage, step, num_diags, a, rows, threads);
  }
  __device__ int tiles(int step, bool a) const { return (r1 - r0 + tile(step, a) - 1) / tile(step, a); }
  // The first row of the sweep's t-th tile: odd sweeps walk the block's
  // rows backwards, so a sweep starts on the rows whose tiles the sweep
  // before it read last, while they are still in L2.
  __device__ int first_row(int step, bool a, int t, int sweep) const {
    return r0 + ((sweep & 1) ? tiles(step, a) - 1 - t : t) * tile(step, a);
  }
};

// The offset of window e of an A tile: 0, then the operator's offsets.
__device__ __forceinline__ int window_offset(const int* s_off, int e) {
  return e == 0 ? 0 : s_off[e - 1];
}

// Copies rows [j0, j1) of a tile: Q row j < nq, then (B, C) w as row nq,
// or (A) the values' row j - nq. One lane a row with bulk copies, else the
// warp's lanes over each row by 4-byte cp.async.
__device__ void stage_rows(float* st, int ld, const float* q, const float* tail, size_t n,
                           int nq, bool a, int j0, int j1, int g0, int len, bool vec,
                           uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  for (int j = j0 + (vec ? lane : 0); j < j1; j += vec ? 32 : 1) {
    const float* src = (j < nq ? q + static_cast<size_t>(j) * n
                               : tail + (a ? static_cast<size_t>(j - nq) * n : 0)) + g0;
    float* dst = st + static_cast<size_t>(j) * ld;
    if (vec) {
      bulk_copy(dst, src, static_cast<unsigned>(len * 4), bar);
    } else {
      for (int r = lane; r < len; r += 32) lat::cp_async4(dst + r, src + r, true);
    }
  }
}

// Copies the D + 1 windows of the previous residual into an A tile: window
// e holds prev[(g0 + d_e + r) mod n] at r + (d_e mod 4) with bulk copies
// (from the 16-byte boundary below, len + 4 floats, split where they wrap
// around n), at r with 4-byte ones.
__device__ void stage_windows(float* win, int ld, const float* prev, int n, const int* s_off,
                              int num_diags, int g0, int len, bool vec, uint64_t* bar) {
  const int lane = threadIdx.x % 32;
  for (int e = vec ? lane : 0; e <= num_diags; e += vec ? 32 : 1) {
    const int d = window_offset(s_off, e);
    float* dst = win + static_cast<size_t>(e) * (ld + 4);
    if (vec) {
      int pos = g0 + d - (d & 3);
      pos = pos >= n ? pos - n : pos;
      for (int done = 0, left = len + 4; left > 0;) {
        const int part = min(left, n - pos);
        bulk_copy(dst + done, prev + pos, static_cast<unsigned>(part * 4), bar);
        done += part;
        left -= part;
        pos = 0;
      }
    } else {
      for (int r = lane; r < len; r += 32) {
        lat::cp_async4(dst + r, prev + lat::wrap(lat::wrap(g0, r, n), d, n), true);
      }
    }
  }
}

// The producer warp: stages every tile of every sweep, in the order the
// computing threads consume them. A sweep's rows are final once the
// previous sweep is consumed (its last tile released); the previous
// residual that A's windows read, once the step's gate has passed, so A's
// first tiles go out without their windows and get them after the gate.
// A buffer is free once the tile kStages before it is released.
__device__ void produce(const Stream& k, const float* q, const float* vals, const float* v0,
                        const float* wbuf, int n, const int* s_off, int depth, int full) {
  const int lane = threadIdx.x % 32, nd = k.num_diags;
  const size_t nn = n;
  int s = 0, sweeps = 0;  // tiles and sweeps staged
  for (int i = 0; i < depth; ++i) {
    const float* prev = i == 0 ? v0 : wbuf + static_cast<size_t>((i - 1) & 1) * nn;
    const float* wg = wbuf + static_cast<size_t>(i & 1) * nn;
    for (int sweep = 0; sweep < (full ? 3 : 2); ++sweep, ++sweeps) {
      const bool a = sweep == 0;
      const int t_rows = k.tile(i, a), tiles = k.tiles(i, a);
      // A: Q[:i], the values, then the windows; B, C: Q[:i+1] and w.
      const int nq = a ? i : i + 1, rows = a ? i + nd : i + 2;
      const int early = a ? min(tiles, kStages) : 0;  // A's tiles staged before the gate
      auto windows = [&](int seq, int t) {
        const int g0 = k.first_row(i, a, t, sweeps);
        float* st = k.buffer(seq);
        stage_windows(st + static_cast<size_t>(rows) * t_rows, t_rows, prev, n, s_off, nd, g0,
                      min(t_rows, k.r1 - g0), k.vec, k.full + seq % kStages);
        if (!k.vec) mbar_arrive_copies(k.full + seq % kStages);
      };
      auto finish_early = [&]() {
        mbar_wait(k.gate, i & 1);
        for (int e = 0; e < early; ++e) windows(s - early + e, e);
      };
      if (s > 0) mbar_wait(k.empty + (s - 1) % kStages, ((s - 1) / kStages) & 1);
      for (int t = 0; t < tiles; ++t) {
        if (t == early && early > 0) finish_early();
        if (s >= kStages) mbar_wait(k.empty + s % kStages, ((s / kStages) - 1) & 1);
        const int g0 = k.first_row(i, a, t, sweeps), len = min(t_rows, k.r1 - g0);
        uint64_t* bar = k.full + s % kStages;
        if (k.vec && lane == 0) {
          const int floats = rows * len + (a ? (nd + 1) * (len + 4) : 0);
          mbar_expect_tx(bar, static_cast<unsigned>(floats * 4));
        }
        __syncwarp();
        stage_rows(k.buffer(s), t_rows, q, a ? vals : wg, nn, nq, a, 0, rows, g0, len, k.vec, bar);
        if (a && t >= early) {
          windows(s, t);
        } else if (!a && !k.vec) {
          mbar_arrive_copies(bar);
        }
        ++s;
      }
      if (early == tiles && early > 0) finish_early();
    }
  }
}

// One sweep of the computing threads over the block's rows: fn(tile, ld,
// g0, len) for each tile. The resident path has one tile, the block's
// slice; the direct path's tiles are Q's rows in device memory (ld = n).
// After a streamed sweep's last tile every thread orders its stores to Q
// and w before the bulk copies that read them; thread 0 releases each
// streamed tile once every thread is done with it.
template <int kPath, typename Fn>
__device__ void walk(const Stream& k, const float* q, int n, int& s, int& sweeps, int step, bool a,
                     Fn&& fn) {
  if constexpr (kPath == kResidentPath) {
    sync_workers(k.threads);
    fn(k.base + k.rows, k.rows, k.r0, k.r1 - k.r0);
    sync_workers(k.threads);
  } else if constexpr (kPath == kDirectPath) {
    const int t_rows = k.tile(step, a), tiles = k.tiles(step, a);
    for (int t = 0; t < tiles; ++t) {
      const int g0 = k.first_row(step, a, t, sweeps);
      fn(q + g0, n, g0, min(t_rows, k.r1 - g0));
      sync_workers(k.threads);
    }
    ++sweeps;
  } else {
    const int t_rows = k.tile(step, a), tiles = k.tiles(step, a);
    for (int t = 0; t < tiles; ++t, ++s) {
      mbar_wait(k.full + s % kStages, (s / kStages) & 1);
      const int g0 = k.first_row(step, a, t, sweeps);
      fn(k.buffer(s), t_rows, g0, min(t_rows, k.r1 - g0));
      if (t + 1 == tiles) asm volatile("fence.proxy.async.global;" ::: "memory");
      sync_workers(k.threads);
      if (threadIdx.x == 0) mbar_arrive(k.empty + s % kStages);
    }
    ++sweeps;
  }
}

// kDeviceCoefs: the direct path at a depth whose coefficients do not fit
// a block's shared memory keeps them in device memory. A template argument,
// so that every other launch addresses them as shared memory.
template <int kPath, bool kDeviceCoefs = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
    arnoldi_forward_kernel(const float* __restrict__ vals, const float* __restrict__ v0,
                           float* q, float* h, float* res, float* inv_norm, float* wbuf,
                           float* partials, unsigned* counter, float* coefs, int n, int num_diags,
                           const int* __restrict__ offsets, int depth, int full, int rows, int stage) {
  constexpr bool kResident = kPath == kResidentPath, kStreamed = kPath == kStreamedPath;
  extern __shared__ __align__(16) float smem[];
  const int off_floats = (num_diags + 3) / 4 * 4;
  int* s_off = reinterpret_cast<int*>(smem);
  float* redw = smem + off_floats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + off_floats + kWarpSlots);
  // The coefficients and dot accumulators in shared memory, or in the
  // block's slice of device memory (kDeviceCoefs), read back by its own
  // threads only after a barrier of the block.
  float* c;
  float* red;
  if constexpr (kDeviceCoefs) {
    c = coefs + 2 * static_cast<size_t>(padded_depth(depth)) * blockIdx.x;
    red = smem + head_floats(num_diags);
  } else {
    c = smem + head_floats(num_diags);
    red = c + 2 * padded_depth(depth);
  }
  float* acc = c + padded_depth(depth);
  // The streamed path's last warp is the producer; the others compute.
  const int threads = kStreamed ? static_cast<int>(blockDim.x) - 32 : static_cast<int>(blockDim.x);
  float* qrow = red + threads;  // streamed, direct: a tile's q_i and w
  float* wrow = qrow + threads;
  const int tid = threadIdx.x, blocks = gridDim.x;
  const size_t nn = n;
  const int r0 = blockIdx.x * rows, r1 = min(n, r0 + rows);
  const bool vec = (n & 3) == 0;
  const Stream k{kResident ? red + threads : wrow + threads, bars, bars + kStages,
                 bars + 2 * kStages, rows, stage, threads, num_diags, r0, r1, vec,
                 kPath == kDirectPath};
  if (kStreamed && tid == 0) {
    for (int b = 0; b < kStages; ++b) {
      mbar_init(k.full + b, vec ? 1u : 32u);  // one expect_tx, or the producer's 32 lanes
      mbar_init(k.empty + b, 1u);             // thread 0 of the computing threads
    }
    mbar_init(k.gate, 1u);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  lat::stage_offsets(offsets, num_diags, s_off);  // and a barrier of the whole block
  if (kStreamed && tid >= threads) {
    produce(k, q, vals, v0, wbuf, n, s_off, depth, full);
    return;
  }

  // Slabs of per-block partials, `stride` floats a row: the first-pass dots
  // (depth rows); the second-pass dots with |w|^2 after the first pass as
  // the row after the step's last coefficient (depth + 1 rows); |w|^2 after
  // the first pass without re-orthogonalisation (|v0|^2 first) and after
  // the second pass.
  const int stride = slab_stride(blocks);
  float* part_c = partials;
  float* part_c2 = partials + static_cast<size_t>(depth) * stride;
  float* part_n1 = partials + (2 * static_cast<size_t>(depth) + 1) * stride;
  float* part_n2 = part_n1 + stride;
  if (blockIdx.x == 0) {  // the padding of the dot slabs stays zero
    for (int idx = tid; idx < (2 * depth + 1) * (stride - blocks); idx += threads) {
      const int j = idx / (stride - blocks), b = blocks + idx % (stride - blocks);
      partials[static_cast<size_t>(j) * stride + b] = 0.0f;
    }
  }
  unsigned goal = 0;
  int s = 0, sweeps = 0;  // streamed tiles and sweeps consumed

  float v = 0.0f;
  for (int r = r0 + tid; r < r1; r += threads) v = fmaf(v0[r], v0[r], v);
  v = block_total(v, redw, threads);
  if (tid == 0) part_n1[blockIdx.x] = v;
  grid_sync(counter, goal, threads);
  const float norm0 = sqrtf(grid_total(part_n1, redw, threads));
  if (blockIdx.x == 0 && tid == 0) *inv_norm = 1.0f / norm0;

  auto publish = [&](float* part, int count) {  // after a walk's closing barrier
    for (int j = tid; j < count; j += threads) part[static_cast<size_t>(j) * stride + blockIdx.x] = acc[j];
  };
  auto clear = [&](int count) {  // before a walk's opening barrier
    for (int j = tid; j < count; j += threads) acc[j] = 0.0f;
  };

  float norm = norm0;
  bool keep = true;
  for (int i = 0; i < depth; ++i) {
    const int count = i + 1;
    const float* prev = i == 0 ? v0 : wbuf + static_cast<size_t>((i - 1) & 1) * nn;
    float* wg = wbuf + static_cast<size_t>(i & 1) * nn;
    float* qi = q + static_cast<size_t>(i) * nn;
    if (kStreamed && tid == 0) mbar_arrive(k.gate);  // the previous residual is final

    // A. Basis row i and w = A q_i; the neighbours' q_i come from the
    // previous residual (visible since the last grid barrier), divided
    // here by the same norm, so they equal the stored row bit for bit.
    // Then the first-pass dot partials.
    clear(count);
    if constexpr (!kResident) sync_workers(threads);
    walk<kPath>(k, q, n, s, sweeps, i, true, [&](const float* tile, int ld, int g0, int len) {
      if constexpr (kResident) {  // the basis slice and w in shared memory
        float* slice = k.base + k.rows;
        float* w = k.base;
        for (int r = tid; r < len; r += threads) {
          const int row = g0 + r;
          const float qv = guarded_div(__ldcg(prev + row), norm);
          slice[static_cast<size_t>(i) * ld + r] = qv;
          qi[row] = qv;
          float a = 0.0f;
          for (int d0 = 0; d0 < num_diags; d0 += 8) {  // eight diagonals' loads in flight
            float pv[8], vv[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (d0 + u < num_diags) {
                pv[u] = __ldcg(prev + lat::wrap(row, s_off[d0 + u], n));
                vv[u] = vals[(d0 + u) * nn + row];
              }
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (d0 + u < num_diags) a = fmaf(vv[u], guarded_div(pv[u], norm), a);
            }
          }
          w[r] = a;
          wg[row] = a;
        }
        sync_workers(threads);
        tile_dots(tile, ld, nullptr, w, len, count, acc, threads);
      } else if constexpr (kPath == kDirectPath) {  // q_i and w from the previous residual
        for (int r = tid; r < len; r += threads) {
          const int row = g0 + r;
          const float qv = guarded_div(__ldcg(prev + row), norm);
          float a = 0.0f;
          for (int d = 0; d < num_diags; ++d) {
            a = fmaf(vals[d * nn + row], guarded_div(__ldcg(prev + lat::wrap(row, s_off[d], n)), norm), a);
          }
          qrow[r] = qv;
          wrow[r] = a;
          qi[row] = qv;
          wg[row] = a;
        }
        sync_workers(threads);
        tile_dots(tile, ld, qrow, wrow, len, count, acc, threads);
      } else {  // Q[:i], the values and the windows staged; q_i and w beside
        const float* vr = tile + static_cast<size_t>(i) * ld;
        const float* win = vr + static_cast<size_t>(num_diags) * ld;
        for (int r = tid; r < len; r += threads) {
          const float qv = guarded_div(win[r], norm);
          float a = 0.0f;
          for (int d = 0; d < num_diags; ++d) {
            const int e = d + 1, at = vec ? r + (s_off[d] & 3) : r;
            const float qj = guarded_div(win[static_cast<size_t>(e) * (ld + 4) + at], norm);
            a = fmaf(vr[static_cast<size_t>(d) * ld + r], qj, a);
          }
          qrow[r] = qv;
          wrow[r] = a;
          qi[g0 + r] = qv;
          wg[g0 + r] = a;
        }
        sync_workers(threads);
        tile_dots(tile, ld, qrow, wrow, len, count, acc, threads);
      }
    });
    publish(part_c, count);
    grid_sync(counter, goal, threads);  // 1: the first-pass partials are complete

    // B. c, H's column (block 0), w -= Q^T c and |w|^2; with
    // re-orthogonalisation also the second-pass partials, from the same tile.
    grid_coefs(part_c, count, c, blockIdx.x == 0 ? h + i : nullptr, depth, threads);
    if (blockIdx.x == 0) {
      for (int j = i + 2 + tid; j < depth; j += threads) h[static_cast<size_t>(j) * depth + i] = 0.0f;
    }
    clear(count);
    sync_workers(threads);
    float nsq = 0.0f;
    walk<kPath>(k, q, n, s, sweeps, i, false, [&](const float* tile, int ld, int g0, int len) {
      const float* w = kResident ? k.base : kStreamed ? tile + static_cast<size_t>(count) * ld : wg + g0;
      float* w_out = kResident ? k.base : wrow;
      nsq += tile_update(tile, ld, c, count, w, w_out, wg + g0, len, red, threads);
      if (full) {
        sync_workers(threads);
        tile_dots(tile, ld, nullptr, w_out, len, count, acc, threads);
      }
    });
    nsq = block_total(nsq, redw, threads);
    if (tid == 0) (full ? part_c2 + static_cast<size_t>(count) * stride : part_n1)[blockIdx.x] = nsq;
    if (full) publish(part_c2, count);
    grid_sync(counter, goal, threads);  // 2: |w|^2 (and the second-pass partials) are complete
    float norm1;

    if (full) {
      // C. The second update and the DGKS truncation; |w|^2 comes with the
      // second-pass coefficients, as their row `count`.
      grid_coefs(part_c2, count + 1, c, nullptr, depth, threads);
      sync_workers(threads);
      norm1 = sqrtf(c[count]);
      float nsq2 = 0.0f;
      walk<kPath>(k, q, n, s, sweeps, i, false, [&](const float* tile, int ld, int g0, int len) {
        const float* w = kResident ? k.base : kStreamed ? tile + static_cast<size_t>(count) * ld : wg + g0;
        float* w_out = kResident ? k.base : wrow;
        nsq2 += tile_update(tile, ld, c, count, w, w_out, wg + g0, len, red, threads);
      });
      nsq2 = block_total(nsq2, redw, threads);
      if (tid == 0) part_n2[blockIdx.x] = nsq2;
      grid_sync(counter, goal, threads);  // 3: |w|^2 after the second pass is complete
      const float norm2 = sqrtf(grid_total(part_n2, redw, threads));
      keep = norm2 > 0.5f * norm1;
      norm = keep ? norm2 : 0.0f;
    } else {
      norm1 = sqrtf(grid_total(part_n1, redw, threads));
      norm = norm1;
    }
    if (blockIdx.x == 0 && tid == 0 && i + 1 < depth) h[static_cast<size_t>(i + 1) * depth + i] = norm;
  }

  // The residual: the last w, zero if the last step truncated.
  const float* w_last = wbuf + static_cast<size_t>((depth - 1) & 1) * nn;
  for (int r = r0 + tid; r < r1; r += threads) res[r] = keep ? __ldcg(w_last + r) : 0.0f;
}

}  // namespace

// vals: (num_diags, n); v0: (n,); q: (depth, n) basis rows; h: (depth,
// depth); res: (n,); inv_norm: one float; wbuf: (2, n) scratch; partials:
// (2 depth + 3) slab_stride(blocks) floats of scratch, 16-byte aligned;
// counter: one unsigned, zero; coefs: null (the coefficients in shared
// memory) or, on the direct path only, blocks x 2 padded_depth(depth)
// floats of scratch, 16-byte aligned.
// offsets: device int32 array, each in [0, n). full: 1 for re-orthogonalisation.
// float32, contiguous. The plan (blocks, computing threads a block, rows
// a block, path 0 resident / 1 streamed / 2 direct, stage floats, shared
// bytes) comes from ops/fused_arnoldi.py `launch_plan`; it is validated,
// never changed: a grid that does not cover n with rows a block, more
// blocks than SMs, a grid that is not co-resident, a streamed plan whose
// staging buffers are not a multiple of 4 floats or whose deepest A tile
// would hold fewer than min(kMinTile, rows) rows (that depth takes the
// direct path), staging buffers on another path, shared bytes other than
// the layout's, or (the streamed path with n % 4 == 0, whose bulk copies
// need 16-byte aligned rows) vals, v0, q or wbuf not 16-byte aligned
// return cudaErrorInvalidValue (or the occupancy's error) without a
// launch. The streamed path launches one producer warp beyond `threads`.
extern "C" int lat_arnoldi_dia_forward(const float* vals, const float* v0, float* q, float* h,
                                       float* res, float* inv_norm, float* wbuf,
                                       float* partials, unsigned* counter, float* coefs, int n,
                                       int num_diags, const int* offsets, int depth, int full, int blocks,
                                       int threads, int rows, int path, int stage,
                                       int smem_bytes, void* stream) {
  if (!lat::valid_shape(n, num_diags) || depth < 1 || depth > n) return cudaErrorInvalidValue;
  if (path != kResidentPath && path != kStreamedPath && path != kDirectPath) return cudaErrorInvalidValue;
  const bool streamed = path == kStreamedPath;
  const int block_threads = threads + (streamed ? 32 : 0);
  if (threads < 32 || threads % 32 != 0 || block_threads > kMaxThreads) return cudaErrorInvalidValue;
  if (rows < 4 || rows % 4 != 0 || blocks < 1 || static_cast<long long>(blocks) * rows < n ||
      static_cast<long long>(blocks - 1) * rows >= n)
    return cudaErrorInvalidValue;
  if (streamed ? stage % 4 != 0 || tile_rows(stage, depth - 1, num_diags, true, rows, threads) <
                                        (rows < kMinTile ? rows : kMinTile)
               : stage != 0)
    return cudaErrorInvalidValue;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(partials) || (streamed && n % 4 == 0 && (misaligned(vals) || misaligned(v0) ||
                                                          misaligned(q) || misaligned(wbuf))))
    return cudaErrorInvalidValue;
  if (coefs != nullptr && (path != kDirectPath || misaligned(coefs))) return cudaErrorInvalidValue;
  const size_t need =
      sizeof(float) * smem_floats(depth, threads, rows, path, stage, num_diags, coefs == nullptr);
  if (smem_bytes < 0 || need != static_cast<size_t>(smem_bytes)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (blocks > sms) return cudaErrorInvalidValue;
  auto kernel = path == kResidentPath   ? &arnoldi_forward_kernel<kResidentPath>
                : path == kStreamedPath ? &arnoldi_forward_kernel<kStreamedPath>
                : coefs == nullptr      ? &arnoldi_forward_kernel<kDirectPath>
                                        : &arnoldi_forward_kernel<kDirectPath, true>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block_threads, smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&vals, &v0, &q, &h, &res, &inv_norm, &wbuf, &partials, &counter, &coefs, &n,
                  &num_diags, &offsets, &depth, &full, &rows, &stage};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(blocks),
                                    dim3(block_threads), args, static_cast<size_t>(smem_bytes),
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
