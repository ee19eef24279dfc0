// K1: the streamed Gram matvec, out = K(x, y) @ v without forming K.
//
// Replaces the TPU kernel `_matvec_kernel` of
// lanczos_adjoints_tpu/ops/pallas_gram.py (launched by `_matvec_impl`).
//
// What bounds it on an H100: arithmetic. A cell (i, j) needs a squared
// distance, a kernel value (two short transcendentals on MUFU, the SM's
// special-function unit, at 16 results a clock) and 2m operations of the
// contraction with v; the call moves only O((N + M)(d + m)) bytes. The
// contraction runs on the tensor cores, so what else a cell costs on the
// SM's issue slots and on MUFU sets the time.
//
// Design:
// - The m-contraction is a tensor-core product: mma.sync m16n8k8 in TF32
//   with a 3xTF32 split (a_lo b_hi + a_hi b_lo + a_hi b_hi, hi by
//   cvt.rna.tf32), which keeps it at fp32 accuracy, as the JAX kernel's
//   contraction at Precision.HIGHEST does. The Gram values are computed
//   straight into the A-fragment layout (lane = 4 g + t owns rows g, g + 8
//   and columns t, t + 4 of each 16 x 8 piece), so g never passes through
//   shared memory. The v tile is split into hi/lo once per tile, in shared
//   memory, in B-fragment order (one 16-byte load per lane per n-tile). m
//   is served in n-tiles of 8, at most two per pass (m = 15: one pass); a
//   pass past the first recomputes the kernel values. The tensor cores
//   round their sums toward zero, so they sum one tile of columns and the
//   tiles are added in fp32.
// - Short transcendentals: ex2.approx on the argument pre-scaled by
//   log2 e, sqrt.approx for the Matern distance (a few ulp, far inside
//   the 1e-4 gate). K2 takes them too; K3 keeps the full-precision
//   kernel_value_dsq.
// - Two routes form the squared distances (ops/fused_gram.py k1_route
//   picks one from the family and the width; the C entry refuses the
//   other):
//   - the product route, rbf and matern32 at d = 8 and 16
//     (gram_matvec_kernel_mma): p = |x|^2 + |y|^2 - 2 x.y, the product a
//     3xTF32 mma.sync over the d columns, as the JAX kernel's MXU path and
//     the benchmark's float32 reference form it. The warp's x rows are
//     split into hi/lo A fragments once and stay in registers; each y tile
//     is split once in shared memory in B-fragment order, -2 folded in.
//     The norms come from the same product, |z|^2 = -(z . (-2 z)) / 2 (z
//     as both operands; the block's x rows once, each y tile's rows as it
//     is staged), so that where a row equals a column the three terms
//     cancel exactly: the diagonal's p is 0, as the plain version's. (Norms
//     summed on the fp32 pipes left p at the tensor cores' rounding, which
//     is toward zero: 1e-5 to 1e-4 at the GP's |x|^2 of ~140, and the
//     loss and noise gradient drifted to 5-10x the direct route's gap to
//     the benchmark's reference.) p is clamped (max(p + eps, eps) is
//     max(p, 0) + eps; eps joins the x norms) before the kernel value. The
//     product's C fragment (rows g, g + 8; columns 2t, 2t + 1) is the
//     contraction's A fragment once column 2t is read as k = t and 2t + 1
//     as k = t + 4, and the v tile is staged in that order: the distances
//     never leave registers. The wrapper centres x and y on y's mean first,
//     so the cancellation's error, which grows with |x|^2 + |y|^2, stays
//     small, and pads v's rows to a multiple of 4 columns for 16-byte
//     copies. Its splits round by two integer operations (cvt.rna.tf32 adds
//     a test for Inf and NaN). A block is 8 warps (256 rows), 2 an SM, so
//     each y and v tile staged serves twice the rows, and a warp forms the
//     norms of each 8 of a tile's 64 columns. A cell then costs 14.75 issue
//     slots at m = 15 (13.5 at m = 1), 2.3 of them mma.sync, and 2 MUFU
//     operations, which at 16 a clock an SM set the floor (~77 ms at
//     N = M = 400,000).
//   - direct differences, accumulated over the row's columns in order
//     (free of cancellation), for matern12, whose value's slope is unbounded
//     at distance 0, and for every d >= 32.
//   The plain PyTorch version (ops/fused_gram.py gram_matvec_plain) takes
//   direct differences for every family and width: it is the oracle.
// - The direct route at d = 8 and 16 keeps the block's x rows in registers
//   (2 m-tiles of 16 rows a warp, 128 rows a block); the y and raw v tiles
//   arrive by cp.async, double-buffered, so their loads overlap the
//   previous tile's arithmetic (the product route too). d = 32, 64 and
//   every wider d stage x and y in shared memory in chunks of 32 or 64
//   columns (128 rows a block), keeping each cell's partial distance in
//   registers across chunks. All hold 128 registers a thread, so 16 warps
//   share an SM: 4 m-tiles a warp took 184 registers, 2 blocks an SM, and
//   2.6x the time at d = 8.
// - A column split for few rows: when the row blocks would leave the last
//   wave of the card's 4 x 132 block slots short, the wrapper asks for S
//   column segments (grid.y; ops/fused_gram.py column_splits). Each block
//   writes its segment's partial product to partials (S, n, m); the last
//   block of a row block to finish (a counter per row block) sums the S
//   partials in segment order, in the same launch, so the result does
//   not depend on which block finished last.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 4;  // K1_BLOCKS_PER_SM in ops/fused_gram.py
// The product route's block (gram_matvec_kernel_mma): K1_PRODUCT_ROWS and
// K1_PRODUCT_BLOCKS_PER_SM in ops/fused_gram.py.
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBlocksPerSM = 2;
constexpr float kLog2e = 1.4426950408889634f;

using lat::cp_async16;
using lat::cp_async4;
using lat::cp_async_commit;
using lat::cp_async_wait;
using lat::ex2_approx;
using lat::mma_3xtf32;
using lat::split_tf32;
using lat::sqrt_approx;

// g of the families in gram_common.cuh (ops/fused_gram.py kernel_value)
// from pe = p + eps (rbf: from p), with the short transcendentals.
template <int KIND>
__device__ __forceinline__ float kernel_value_shifted(float pe) {
  if (KIND == lat::kRbf) return ex2_approx(-kLog2e * pe);
  const float dist = sqrt_approx(pe);
  const float e = ex2_approx(-kLog2e * dist);
  if (KIND == lat::kMatern12) return e;
  return fmaf(dist, e, e);  // (1 + dist) e
}

// g(p), with the short transcendentals.
template <int KIND>
__device__ __forceinline__ float kernel_value_fast(float p) {
  return kernel_value_shifted<KIND>(KIND == lat::kRbf ? p : p + lat::kEps);
}

template <int R, int NT>
__device__ __forceinline__ void zero(float (&c)[R][NT][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[r][nt][q] = 0.0f;
}

// The tensor cores round their fp32 sums toward zero, which over 400,000
// columns biases a sum by ~1e-3; so they sum one tile of columns at a
// time and the tiles are added here, rounded to nearest.
template <int R, int NT>
__device__ __forceinline__ void accumulate(float (&acc)[R][NT][4], const float (&part)[R][NT][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][nt][q] += part[r][nt][q];
}

// The A fragment of four pre-scaled squared distances: p[0] (row g,
// column t), p[1] (g + 8, t), p[2] (g, t + 4), p[3] (g + 8, t + 4).
template <int KIND>
__device__ __forceinline__ void a_fragment(const float (&p)[4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(kernel_value_fast<KIND>(p[q]), hi[q], lo[q]);
}

// x rounded to TF32, to nearest with ties away from zero: what
// cvt.rna.tf32 gives for a finite x, in two integer operations (the
// instruction adds a test for Inf and NaN, which the product route's
// finite operands never take).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The product route's A operand of the contraction: x = hi + lo, hi as
// tf32_rna, lo the rest (the tensor cores read its TF32 bits), as
// split_tf32 splits it.
__device__ __forceinline__ void split_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The tile's v columns (TC x 8 NT values from load(j, c)) as B fragments
// split into hi/lo: vfrag[(s * NT + nt) * 32 + lane] holds rows s * 8 + t
// and s * 8 + t + 4, column nt * 8 + g.
template <int TC, int NT, class Load>
__device__ __forceinline__ void stage_vfrag(uint4* vfrag, Load load) {
  for (int idx = threadIdx.x; idx < (TC / 8) * NT * 32; idx += kThreads) {
    const int lane = idx % 32;
    const int f = idx / 32;
    const int s = f / NT;
    const int col = (f % NT) * 8 + lane / 4;
    const int j = s * 8 + lane % 4;
    uint32_t h0, l0, h1, l1;
    split_tf32(load(j, col), h0, l0);
    split_tf32(load(j + 4, col), h1, l1);
    vfrag[idx] = make_uint4(h0, h1, l0, l1);
  }
}

// fn(idx) for idx = threadIdx.x, threadIdx.x + THREADS, ... below N, with
// the trip count known when compiled.
template <int N, int THREADS, class Fn>
__device__ __forceinline__ void strided(Fn fn) {
#pragma unroll
  for (int k = 0; k < (N + THREADS - 1) / THREADS; ++k) {
    const int idx = static_cast<int>(threadIdx.x) + k * THREADS;
    if (N % THREADS == 0 || idx < N) fn(idx);
  }
}

// The product route's v tile (TC rows of vraw, VP floats apart) as B
// fragments split into hi/lo: vfrag[(s * NT + nt) * 32 + lane] holds rows
// s * 8 + 2t and s * 8 + 2t + 1 (the order of k in which the distance
// product's C fragment is the contraction's A fragment), column nt * 8 + g.
template <int TC, int NT, int VP>
__device__ __forceinline__ void stage_vfrag_paired(uint4* vfrag, const float* vraw) {
  strided<(TC / 8) * NT * 32, kMmaThreads>([&](int idx) {
    const int lane = idx % 32;
    const int f = idx / 32;
    const float* vj = vraw + ((f / NT) * 8 + 2 * (lane % 4)) * VP + (f % NT) * 8 + lane / 4;
    uint32_t h0, l0, h1, l1;
    split_rna(vj[0], h0, l0);
    split_rna(vj[VP], h1, l1);
    vfrag[idx] = make_uint4(h0, h1, l0, l1);
  });
}

// The distance product's operands: x = hi + lo to about 2^-22 |x|, both
// rounded to TF32, so the tensor cores read them whole.
__device__ __forceinline__ void split_rna2(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// f u for the bits u of a TF32 value and a power of two f: exact.
__device__ __forceinline__ uint32_t scaled(uint32_t u, float f) {
  return __float_as_uint(f * __uint_as_float(u));
}

// A lane's element (row g, column g) of a C fragment c whose A and B hold
// the same eight vectors (rows g and columns g): its own z . (-2 z) product
// (lanes with t = g / 2 hold it; rows g + 8 from c[2], c[3] with h = 1).
__device__ __forceinline__ float diagonal(const float (&c)[4], int g, int h) {
  return (g & 1) ? c[2 * h + 1] : c[2 * h];
}

// The tile's y columns (TC rows of ys, DP floats apart) as B fragments of
// the distance product, -2 folded in and split into hi/lo:
// yfrag[(s * KD + kd) * 32 + lane] holds columns kd * 8 + t and
// kd * 8 + t + 4 of y's row s * 8 + g. Warp s also forms its 8 rows'
// norms, |y|^2 = -(y . (-2 y)) / 2, by the same 3xTF32 product as the
// distances (its rows as the A operand), into ynorm.
template <int TC, int KD, int DP>
__device__ __forceinline__ void stage_yfrag(uint4* yfrag, float* ynorm, const float* ys) {
  static_assert(TC / 8 == kMmaWarps, "a warp for each 8 columns of the tile");
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int s = threadIdx.x / 32;
  const float* yj = ys + (s * 8 + g) * DP + t;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    uint32_t h0, l0, h1, l1;
    split_rna2(-2.0f * yj[kd * 8], h0, l0);
    split_rna2(-2.0f * yj[kd * 8 + 4], h1, l1);
    const uint4 b = make_uint4(h0, h1, l0, l1);
    yfrag[(s * KD + kd) * 32 + lane] = b;
    // The rows as A (rows g; rows g + 8 empty): -1/2 of their B.
    const uint32_t ahi[4] = {scaled(h0, -0.5f), 0u, scaled(h1, -0.5f), 0u};
    const uint32_t alo[4] = {scaled(l0, -0.5f), 0u, scaled(l1, -0.5f), 0u};
    mma_3xtf32(c, ahi, alo, b);
  }
  if (t == g / 2) ynorm[s * 8 + g] = -0.5f * diagonal(c, g, 0);
}

// Store the C fragment of m-tile rows (row, row + 8), columns c0 + nt * 8
// + 2t (+1) to dst (n, m).
__device__ __forceinline__ void store_fragment(float* dst, const float (&c)[4], long row, int col,
                                               int n, int m) {
  if (row < n) {
    if (col < m) dst[row * m + col] = c[0];
    if (col + 1 < m) dst[row * m + col + 1] = c[1];
  }
  if (row + 8 < n) {
    if (col < m) dst[(row + 8) * m + col] = c[2];
    if (col + 1 < m) dst[(row + 8) * m + col + 1] = c[3];
  }
}

// After every block of a row block has written its segment's partial
// product: the last one to arrive sums partials (S, n, m) over the S
// segments in order into out. The order is fixed, so the result is the
// same whichever block arrives last.
__device__ void reduce_segments(const float* partials, int* counters, float* out, long row0,
                                int rows, int n, int m) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[blockIdx.x], 1) == static_cast<int>(gridDim.y) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long count = (n - row0 < rows ? n - row0 : rows) * static_cast<long>(m);
  const long plane = static_cast<long>(n) * m;
  for (long idx = threadIdx.x; idx < count; idx += blockDim.x) {
    float s = 0.0f;
    for (int seg = 0; seg < static_cast<int>(gridDim.y); ++seg)
      s += __ldcg(partials + seg * plane + row0 * m + idx);
    out[row0 * m + idx] = s;
  }
}

// The direct route at d = 8 or 16 (matern12): the block's x rows in
// registers, y and v by cp.async.
template <int KIND, int D, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gram_matvec_kernel_reg(const float* __restrict__ x, const float* __restrict__ y,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ partials, int* __restrict__ counters, int n,
                           int n_cols, int m, int seg_cols) {
  constexpr int R = 2;                    // m-tiles of 16 rows a warp
  constexpr int ROWS = kWarps * 16 * R;   // rows a block
  constexpr int TC = 64;                  // columns a tile
  constexpr int DP = D == 8 ? 8 : D + 4;  // y row stride in shared memory (no bank conflicts)
  constexpr int MW = 8 * NT;              // columns of v a pass
  __shared__ __align__(16) float ys[2][TC * DP];
  __shared__ __align__(16) float vraw[2][TC * MW];
  __shared__ __align__(16) uint4 vfrag[(TC / 8) * NT * 32];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long block_row0 = static_cast<long>(blockIdx.x) * ROWS;
  const long row0 = block_row0 + (tid / 32) * 16 * R;
  const int j_begin = blockIdx.y * seg_cols;
  const int j_end = min(n_cols, j_begin + seg_cols);
  const int tiles = (j_end - j_begin + TC - 1) / TC;
  float* dst = gridDim.y > 1 ? partials + static_cast<long>(blockIdx.y) * n * m : out;

  float xr[R][2][D];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + r * 16 + h * 8 + g;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 x4 = row < n ? *reinterpret_cast<const float4*>(x + row * D + 4 * q)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        xr[r][h][4 * q] = x4.x;
        xr[r][h][4 * q + 1] = x4.y;
        xr[r][h][4 * q + 2] = x4.z;
        xr[r][h][4 * q + 3] = x4.w;
      }
    }

  for (int c0 = 0; c0 < m; c0 += MW) {
    float acc[R][NT][4];
    zero(acc);

    // Zero-filled past the segment's last column, so a masked column adds g * 0.
    auto stage = [&](int buf, int j0) {
      for (int idx = tid; idx < TC * (D / 4); idx += kThreads) {
        const int jj = idx / (D / 4);
        const int q = idx % (D / 4);
        const bool ok = j0 + jj < j_end;
        cp_async16(&ys[buf][jj * DP + 4 * q], y + (ok ? static_cast<long>(j0 + jj) * D + 4 * q : 0), ok);
      }
      for (int idx = tid; idx < TC * MW; idx += kThreads) {
        const int jj = idx / MW;
        const int c = c0 + idx % MW;
        const bool ok = j0 + jj < j_end && c < m;
        cp_async4(&vraw[buf][idx], v + (ok ? static_cast<long>(j0 + jj) * m + c : 0), ok);
      }
    };

    stage(0, j_begin);
    cp_async_commit();
    for (int tile = 0; tile < tiles; ++tile) {
      const int buf = tile % 2;
      if (tile + 1 < tiles) stage(buf ^ 1, j_begin + (tile + 1) * TC);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies, not the next one's
      __syncthreads();
      const float* vb = vraw[buf];
      stage_vfrag<TC, NT>(vfrag, [&](int j, int c) { return vb[j * MW + c]; });
      __syncthreads();

      float part[R][NT][4];
      zero(part);
#pragma unroll 2
      for (int s = 0; s < TC / 8; ++s) {
        float ya[D], yb[D];
        const float* pa = &ys[buf][(s * 8 + t) * DP];
#pragma unroll
        for (int q = 0; q < D / 4; ++q) {
          const float4 a4 = *reinterpret_cast<const float4*>(pa + 4 * q);
          const float4 b4 = *reinterpret_cast<const float4*>(pa + 4 * DP + 4 * q);
          ya[4 * q] = a4.x, ya[4 * q + 1] = a4.y, ya[4 * q + 2] = a4.z, ya[4 * q + 3] = a4.w;
          yb[4 * q] = b4.x, yb[4 * q + 1] = b4.y, yb[4 * q + 2] = b4.z, yb[4 * q + 3] = b4.w;
        }
        uint4 bf[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) bf[nt] = vfrag[(s * NT + nt) * 32 + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int dd = 0; dd < D; ++dd) {
            const float d0 = xr[r][0][dd] - ya[dd];
            const float d1 = xr[r][1][dd] - ya[dd];
            const float d2 = xr[r][0][dd] - yb[dd];
            const float d3 = xr[r][1][dd] - yb[dd];
            p[0] = fmaf(d0, d0, p[0]);
            p[1] = fmaf(d1, d1, p[1]);
            p[2] = fmaf(d2, d2, p[2]);
            p[3] = fmaf(d3, d3, p[3]);
          }
          uint32_t ahi[4], alo[4];
          a_fragment<KIND>(p, ahi, alo);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_3xtf32(part[r][nt], ahi, alo, bf[nt]);
        }
      }
      accumulate(acc, part);
      __syncthreads();  // ys[buf] and vfrag are rewritten next
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store_fragment(dst, acc[r][nt], row0 + r * 16 + g, c0 + nt * 8 + 2 * t, n, m);
  }
  if (gridDim.y > 1) reduce_segments(partials, counters, out, block_row0, ROWS, n, m);
}

// The product route (rbf and matern32 at d = 8 or 16): the block's x rows
// as A fragments in registers, y and v by 16-byte cp.async (v's rows
// padded to a multiple of 4 columns by the wrapper); p from a 3xTF32
// product, fed in registers to the contraction.
template <int KIND, int D, int NT>
__global__ void __launch_bounds__(kMmaThreads, kMmaBlocksPerSM)
    gram_matvec_kernel_mma(const float* __restrict__ x, const float* __restrict__ y,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ partials, int* __restrict__ counters, int n,
                           int n_cols, int m, int seg_cols) {
  constexpr int R = 2;                    // m-tiles of 16 rows a warp
  constexpr int ROWS = kMmaWarps * 16 * R;  // rows a block
  constexpr int TC = 64;                  // columns a tile
  constexpr int KD = D / 8;               // k-steps of the distance product
  constexpr int DP = D == 8 ? 8 : D + 4;  // y row stride in shared memory (no bank conflicts)
  constexpr int MW = 8 * NT;              // columns of v a pass
  constexpr int VP = MW + 4;              // v row stride in shared memory (no bank conflicts)
  // eps joins the rows' norms: max(p, 0) + eps is max(p + eps, eps).
  constexpr float kShift = KIND == lat::kRbf ? 0.0f : lat::kEps;
  __shared__ __align__(16) float ys[2][TC * DP];
  __shared__ __align__(16) float vraw[2][TC * VP];
  __shared__ __align__(16) uint4 yfrag[(TC / 8) * KD * 32];
  __shared__ __align__(16) uint4 vfrag[(TC / 8) * NT * 32];
  __shared__ __align__(16) float ynorm[TC];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int ldv = (m + 3) / 4 * 4;
  const long block_row0 = static_cast<long>(blockIdx.x) * ROWS;
  const long row0 = block_row0 + (tid / 32) * 16 * R;
  const int j_begin = blockIdx.y * seg_cols;
  const int j_end = min(n_cols, j_begin + seg_cols);
  const int tiles = (j_end - j_begin + TC - 1) / TC;
  float* dst = gridDim.y > 1 ? partials + static_cast<long>(blockIdx.y) * n * m : out;

  // A fragments of the warp's rows: [h + 2q] holds row g + 8h, column
  // kd * 8 + t + 4q.
  uint32_t xhi[R][KD][4], xlo[R][KD][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long row = row0 + r * 16 + h * 8 + g;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          split_rna2(row < n ? x[row * D + kd * 8 + t + 4 * q] : 0.0f, xhi[r][kd][h + 2 * q],
                     xlo[r][kd][h + 2 * q]);
    }
  // xn[r][h]: row g + 8h's norm, -(x . (-2 x)) / 2 by the distance product
  // itself (its rows as the B operand too), plus kShift.
  float xn[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t(&hi)[4] = xhi[r][kd];
        const uint32_t(&lo)[4] = xlo[r][kd];
        mma_3xtf32(c, hi, lo,
                   make_uint4(scaled(hi[h], -2.0f), scaled(hi[h + 2], -2.0f), scaled(lo[h], -2.0f),
                              scaled(lo[h + 2], -2.0f)));
      }
      xn[r][h] = -0.5f * __shfl_sync(0xffffffffu, diagonal(c, g, h), 4 * g + g / 2) + kShift;
    }

  for (int c0 = 0; c0 < m; c0 += MW) {
    float acc[R][NT][4];
    zero(acc);

    // Zero-filled past the segment's last column, so a masked column adds g * 0.
    auto stage = [&](int buf, int j0) {
      strided<TC * (D / 4), kMmaThreads>([&](int idx) {
        const int jj = idx / (D / 4);
        const int q = idx % (D / 4);
        const bool ok = j0 + jj < j_end;
        cp_async16(&ys[buf][jj * DP + 4 * q], y + (ok ? static_cast<long>(j0 + jj) * D + 4 * q : 0), ok);
      });
      strided<TC * (MW / 4), kMmaThreads>([&](int idx) {
        const int jj = idx / (MW / 4);
        const int c = 4 * (idx % (MW / 4));
        const bool ok = j0 + jj < j_end && c0 + c < ldv;
        cp_async16(&vraw[buf][jj * VP + c], v + (ok ? static_cast<long>(j0 + jj) * ldv + c0 + c : 0), ok);
      });
    };

    stage(0, j_begin);
    cp_async_commit();
    for (int tile = 0; tile < tiles; ++tile) {
      const int buf = tile % 2;
      if (tile + 1 < tiles) stage(buf ^ 1, j_begin + (tile + 1) * TC);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies, not the next one's
      __syncthreads();
      stage_vfrag_paired<TC, NT, VP>(vfrag, vraw[buf]);
      stage_yfrag<TC, KD, DP>(yfrag, ynorm, ys[buf]);
      __syncthreads();

      float part[R][NT][4];
      zero(part);
#pragma unroll
      for (int s = 0; s < TC / 8; ++s) {
        uint4 yb[KD], bf[NT];
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) yb[kd] = yfrag[(s * KD + kd) * 32 + lane];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) bf[nt] = vfrag[(s * NT + nt) * 32 + lane];
        const float2 yn = *reinterpret_cast<const float2*>(&ynorm[s * 8 + 2 * t]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // C: x . (-2 y) at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1);
          // plus both norms, p + kShift; as the A fragment, column 2t is
          // k = t and column 2t + 1 is k = t + 4.
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) mma_3xtf32(c, xhi[r][kd], xlo[r][kd], yb[kd]);
          const float p[4] = {(xn[r][0] + yn.x) + c[0], (xn[r][1] + yn.x) + c[2],
                              (xn[r][0] + yn.y) + c[1], (xn[r][1] + yn.y) + c[3]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)  // max(p, 0) (+ eps)
            split_rna(kernel_value_shifted<KIND>(fmaxf(p[q], kShift)), ahi[q], alo[q]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_3xtf32(part[r][nt], ahi, alo, bf[nt]);
        }
      }
      accumulate(acc, part);
      __syncthreads();  // ys[buf], vraw[buf], yfrag, ynorm and vfrag are rewritten next
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store_fragment(dst, acc[r][nt], row0 + r * 16 + g, c0 + nt * 8 + 2 * t, n, m);
  }
  if (gridDim.y > 1) reduce_segments(partials, counters, out, block_row0, ROWS, n, m);
}

// d = 32, 64 or wider: x and y staged in shared memory DC columns at a
// time; each cell's partial distance stays in registers across chunks.
template <int KIND, int DC, int NT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gram_matvec_kernel_staged(const float* __restrict__ x, const float* __restrict__ y,
                              const float* __restrict__ v, float* __restrict__ out,
                              float* __restrict__ partials, int* __restrict__ counters, int n,
                              int n_cols, int m, int d, int seg_cols) {
  constexpr int R = 2;                   // m-tiles of 16 rows a warp
  constexpr int ROWS = kWarps * 16 * R;  // rows a block
  constexpr int TC = 32;                 // columns a tile
  constexpr int KS = TC / 8;             // k-steps a tile
  constexpr int DP = DC + 4;             // row stride in shared memory (no bank conflicts)
  constexpr int MW = 8 * NT;
  __shared__ __align__(16) float xs[ROWS * DP];
  __shared__ __align__(16) float ys[TC * DP];
  __shared__ __align__(16) uint4 vfrag[KS * NT * 32];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wrow = (tid / 32) * 16 * R;  // the warp's first row in the block
  const long block_row0 = static_cast<long>(blockIdx.x) * ROWS;
  const int j_begin = blockIdx.y * seg_cols;
  const int j_end = min(n_cols, j_begin + seg_cols);
  const int chunks = d / DC;
  float* dst = gridDim.y > 1 ? partials + static_cast<long>(blockIdx.y) * n * m : out;
  bool x_staged = false;

  for (int c0 = 0; c0 < m; c0 += MW) {
    float acc[R][NT][4];
    zero(acc);

    for (int j0 = j_begin; j0 < j_end; j0 += TC) {
      float p[KS][R][4];
#pragma unroll
      for (int s = 0; s < KS; ++s)
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[s][r][q] = 0.0f;

      for (int c = 0; c < chunks; ++c) {
        __syncthreads();  // the previous chunk (and tile) is no longer read
        if (chunks > 1 || !x_staged) {
          for (int idx = tid; idx < ROWS * (DC / 4); idx += kThreads) {
            const int r = idx / (DC / 4);
            const int q = idx % (DC / 4);
            const long row = block_row0 + r;
            *reinterpret_cast<float4*>(&xs[r * DP + 4 * q]) =
                row < n ? *reinterpret_cast<const float4*>(x + row * d + c * DC + 4 * q)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
          x_staged = true;
        }
        for (int idx = tid; idx < TC * (DC / 4); idx += kThreads) {
          const int jj = idx / (DC / 4);
          const int q = idx % (DC / 4);
          const long j = j0 + jj;
          *reinterpret_cast<float4*>(&ys[jj * DP + 4 * q]) =
              j < j_end ? *reinterpret_cast<const float4*>(y + j * d + c * DC + 4 * q)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < KS; ++s) {
#pragma unroll 4
          for (int q = 0; q < DC / 4; ++q) {
            const float4 ya = *reinterpret_cast<const float4*>(&ys[(s * 8 + t) * DP + 4 * q]);
            const float4 yb = *reinterpret_cast<const float4*>(&ys[(s * 8 + t + 4) * DP + 4 * q]);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 xa = *reinterpret_cast<const float4*>(&xs[(wrow + r * 16 + g) * DP + 4 * q]);
              const float4 xb =
                  *reinterpret_cast<const float4*>(&xs[(wrow + r * 16 + g + 8) * DP + 4 * q]);
              const float xv[2][4] = {{xa.x, xa.y, xa.z, xa.w}, {xb.x, xb.y, xb.z, xb.w}};
              const float yv[2][4] = {{ya.x, ya.y, ya.z, ya.w}, {yb.x, yb.y, yb.z, yb.w}};
#pragma unroll
              for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int cell = 0; cell < 4; ++cell) {
                  const float diff = xv[cell % 2][k] - yv[cell / 2][k];
                  p[s][r][cell] = fmaf(diff, diff, p[s][r][cell]);
                }
            }
          }
        }
      }

      // vfrag was last read before this tile's first chunk barrier.
      stage_vfrag<TC, NT>(vfrag, [&](int jj, int col) {
        const long j = j0 + jj;
        const int cc = c0 + col;
        return (j < j_end && cc < m) ? v[j * m + cc] : 0.0f;
      });
      __syncthreads();
      float part[R][NT][4];
      zero(part);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint4 bf[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) bf[nt] = vfrag[(s * NT + nt) * 32 + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          uint32_t ahi[4], alo[4];
          a_fragment<KIND>(p[s][r], ahi, alo);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_3xtf32(part[r][nt], ahi, alo, bf[nt]);
        }
      }
      accumulate(acc, part);
    }

#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        store_fragment(dst, acc[r][nt], block_row0 + wrow + r * 16 + g, c0 + nt * 8 + 2 * t, n, m);
  }
  if (gridDim.y > 1) reduce_segments(partials, counters, out, block_row0, ROWS, n, m);
}

// Segments of at least one column tile; the grid's y extent is the count
// of non-empty ones (never more than the requested splits).
template <int TC>
dim3 grid_for(int n, int n_cols, int rows, int splits, int* seg_cols) {
  const int per = (n_cols + splits - 1) / splits;
  *seg_cols = (per + TC - 1) / TC * TC;
  return dim3((n + rows - 1) / rows, (n_cols + *seg_cols - 1) / *seg_cols);
}

// The route that forms the distances (ops/fused_gram.py k1_route): the
// tensor-core product for rbf and matern32 at d = 8 and 16, direct
// differences otherwise.
constexpr int kDirect = 0;
constexpr int kProduct = 1;
template <int KIND, int D>
constexpr int kRoute = KIND != lat::kMatern12 && (D == 8 || D == 16) ? kProduct : kDirect;

template <int KIND, int D>
cudaError_t launch(int route, const float* x, const float* y, const float* v, float* out,
                   float* partials, int* counters, int n, int n_cols, int m, int d, int splits,
                   cudaStream_t s) {
  if (route != kRoute<KIND, D>) return cudaErrorInvalidValue;
  int seg = 0;
  if constexpr (kRoute<KIND, D> == kProduct) {
    const dim3 grid = grid_for<64>(n, n_cols, kMmaWarps * 16 * 2, splits, &seg);
    if (grid.y > 1 && (partials == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
    if (m <= 8) {
      gram_matvec_kernel_mma<KIND, D, 1>
          <<<grid, kMmaThreads, 0, s>>>(x, y, v, out, partials, counters, n, n_cols, m, seg);
    } else {
      gram_matvec_kernel_mma<KIND, D, 2>
          <<<grid, kMmaThreads, 0, s>>>(x, y, v, out, partials, counters, n, n_cols, m, seg);
    }
  } else if constexpr (D == 8 || D == 16) {
    const dim3 grid = grid_for<64>(n, n_cols, kWarps * 16 * 2, splits, &seg);
    if (grid.y > 1 && (partials == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
    if (m <= 8) {
      gram_matvec_kernel_reg<KIND, D, 1>
          <<<grid, kThreads, 0, s>>>(x, y, v, out, partials, counters, n, n_cols, m, seg);
    } else {
      gram_matvec_kernel_reg<KIND, D, 2>
          <<<grid, kThreads, 0, s>>>(x, y, v, out, partials, counters, n, n_cols, m, seg);
    }
  } else {
    constexpr int DC = D == 32 ? 32 : lat::kChunk;
    const dim3 grid = grid_for<32>(n, n_cols, kWarps * 16 * 2, splits, &seg);
    if (grid.y > 1 && (partials == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
    if (m <= 8) {
      gram_matvec_kernel_staged<KIND, DC, 1>
          <<<grid, kThreads, 0, s>>>(x, y, v, out, partials, counters, n, n_cols, m, d, seg);
    } else {
      gram_matvec_kernel_staged<KIND, DC, 2>
          <<<grid, kThreads, 0, s>>>(x, y, v, out, partials, counters, n, n_cols, m, d, seg);
    }
  }
  return cudaSuccess;
}

}  // namespace

// route: 0 direct differences, 1 the tensor-core product (ops/fused_gram.py
// k1_route). x: (n, d) and y: (n_cols, d), scaled and zero-padded to d
// columns, 16-byte aligned; v: (n_cols, m) (the product route: (n_cols, m4),
// m4 = m rounded up to a multiple of 4, zero past m, 16-byte aligned);
// out: (n, m). With splits > 1:
// partials (splits, n, m) scratch and counters, one zeroed int per row block
// of 128 rows. All float32, row-major, contiguous.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported kind or d, a route other than the pair's, or missing scratch,
// without launching).
extern "C" int lat_gram_matvec(int kind, int route, const float* x, const float* y,
                               const float* v, float* out, float* partials, int* counters, int n,
                               int n_cols, int m, int d, int splits, void* stream) {
  if (n <= 0 || n_cols <= 0 || m <= 0 || splits <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t status = cudaSuccess;
#define LAT_LAUNCH(K, DD) \
  status = launch<K, DD>(route, x, y, v, out, partials, counters, n, n_cols, m, d, splits, s)
  LAT_DISPATCH_KIND_D(kind, d, LAT_LAUNCH)
#undef LAT_LAUNCH
  if (status != cudaSuccess) return status;
  return cudaGetLastError();
}
