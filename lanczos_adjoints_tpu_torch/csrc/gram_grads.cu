// K2: the parameter-gradient pass of the Gram matvec.
//
// Replaces the TPU kernels `_grads_kernel_vpu` and `_grads_kernel_mxu` of
// lanczos_adjoints_tpu/ops/pallas_gram.py (launched by `_param_grads`).
//
// For L = sum_k u_k^T K(x, y) v_k it computes, per block of 128 rows, the
// partial sums
//   col 0:      sum_ij uv_ij g_ij                       (-> d outputscale)
//   col 1 + d:  sum_ij w_ij (x_id - y_jd)^2,  w = uv * dg/dsq
// with uv_ij = sum_c u_ic v_jc, into partials (n_blocks, 1 + D). The
// wrapper sums the blocks in a fixed order and unscales them; no float
// atomics, so the gradient is the same from run to run.
//
// What bounds it on an H100: arithmetic. A cell costs 2m operations for
// uv plus about 5d + 9 for the distance, kernel derivative and the
// per-dimension sums; at m = 225 (the SLQ adjoint's wide pass) the
// contraction is ~7 * 10^13 operations at N = 400,000, against
// O(N(m + d)) bytes.
//
// Design: 12 warps own a 128 x 96 cell tile, each warp 32 x 32 (2 m-tiles
// of 16 rows x 4 n-tiles of 8 columns), so each lane owns the cells of
// the mma accumulator fragments: rows g, g + 8 and columns 2t, 2t + 1 of
// every 16 x 8 piece. One block an SM: 16 warps under the 128-register
// cap spilled, 12 take 126 registers and none.
// - m > 1: uv is a tensor-core product, mma.sync m16n8k8 in TF32 with the
//   3xTF32 split (tensor_core.cuh), fp32-accurate as the JAX kernel's
//   Precision.HIGHEST product. The block's U rows stay in shared memory
//   for its life (staged once; 128 KB at m = 225), and V (the tile's
//   columns) arrives in chunks of 32 of the m columns by cp.async, double
//   buffered; the next tile's first chunk is in flight during this tile's
//   epilogue. Where U does not fit beside the rest (m above 352 at d = 8,
//   above 256 at d = 64), it is re-staged with V chunk by chunk.
//   Out-of-range rows, columns and the m tail are zero-filled, so they add
//   uv = 0; m comes in multiples of 4 (the wrapper pads u and v with zero
//   columns), so every copy is 16 bytes. The physical k order inside 16
//   columns is permuted the same way for U and V (lane t takes 4t..4t+3
//   for two k-steps), so one 16-byte load gives a lane its values of two
//   k-steps; the halves of odd rows are swapped so that those loads are
//   free of bank conflicts. The tensor cores round their sums toward zero,
//   but a cell's chain is only ceil(m / 8) k-steps deep (29 at m = 225),
//   not K1's hundreds of thousands of columns.
// - m = 1 (the PCG backward's launch): uv = u_i v_j is one multiply on
//   values in registers (u) and shared memory (v); no m-staging and no
//   tensor cores.
// - The epilogue works on the fragment in registers: the distances as
//   direct differences for every d, from the x rows and y columns in
//   shared memory (16-byte reads), then the kernel value and derivative
//   with K1's short transcendentals ex2.approx and sqrt.approx (a few ulp;
//   22 % off the time at m = 1), then the per-dimension sums: d <= 16
//   adds each thread's sums to its own slots in shared memory, wider rows
//   reduce each tile's sums over the warp into the warp's slots. The block
//   reduces in a fixed order at the end.
//
// Wide rows (d > 64, a multiple of 64; D = kWide): grid.y runs over the
// 64-column chunks of the per-dimension sums. Each block computes the
// full distance chunk by chunk (x and y chunks staged in turn in the same
// shared arrays), then re-stages its own chunk for the sums; chunk 0 also
// writes column 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gram_common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kWarps = 12;                 // 4 warp rows x kWarps / 4 warp columns
constexpr int kThreads = kWarps * 32;
constexpr int kR = 2;                      // m-tiles of 16 rows a warp
constexpr int kNT = 4;                     // n-tiles of 8 columns a warp
constexpr int kRows = 4 * 16 * kR;         // rows a block (_GRADS_BLOCK_ROWS in ops/fused_gram.py)
constexpr int kCols = kWarps / 4 * 8 * kNT;  // columns a tile
constexpr int kKC = 32;                    // m-columns a pipeline stage (4 k-steps)
constexpr int kStages = 2;                 // pipeline stages in flight
constexpr int kBlocksPerSM = 1;            // the register cap: 65,536 / kThreads
constexpr bool kFastMath = true;           // ex2.approx / sqrt.approx for g and dg
constexpr bool kResidentU = true;          // U kept in shared memory for the block's life
constexpr int kNH = 2;                     // n-tiles an epilogue pass
constexpr float kLog2e = 1.4426950408889634f;

// g and dg/dsq (gram_common.cuh), optionally with the short transcendentals.
template <int KIND>
__device__ __forceinline__ void kernel_values(float p, float& g, float& dg) {
  if constexpr (!kFastMath) {
    lat::kernel_value_dsq<KIND>(p, g, dg);
  } else if constexpr (KIND == lat::kRbf) {
    g = lat::ex2_approx(-kLog2e * p);
    dg = -0.5f * g;
  } else {
    const float dist = lat::sqrt_approx(p + lat::kEps);
    const float e = lat::ex2_approx(-kLog2e * dist);
    if constexpr (KIND == lat::kMatern12) {
      g = e;
      dg = -0.5f * __fdividef(e, dist);
    } else {
      g = fmaf(dist, e, e);
      dg = -1.5f * e;
    }
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

// One pass over the DS columns of the block's x rows (xs) and the tile's y
// rows (ys), both with row stride DS + 4: the distances into p (kSums
// false), or the per-dimension sums of w (x - y)^2 with w in p (kSums
// true), into the thread's own sums tsum[dd * kThreads] (DS <= 16) or,
// reduced over the warp, into the warp's row of sums wrow[1 + dd].
template <int DS, bool kSums, int NH>
__device__ __forceinline__ void dims_pass(const float* xs, const float* ys, int wr, int wc, int g, int t,
                                          float (&p)[kR][NH][4], float* tsum, float* wrow, int lane) {
  constexpr int XS = DS + 4;
#pragma unroll 1
  for (int q4 = 0; q4 < DS / 4; ++q4) {
    float xv[kR][2][4];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[(wr + r * 16 + h * 8 + g) * XS + 4 * q4]);
        xv[r][h][0] = a.x, xv[r][h][1] = a.y, xv[r][h][2] = a.z, xv[r][h][3] = a.w;
      }
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = *reinterpret_cast<const float4*>(&ys[(wc + nt * 8 + 2 * t + e) * XS + 4 * q4]);
        const float yv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float diff = xv[r][h][k] - yv[k];
              if constexpr (kSums) s[k] = fmaf(p[r][nt][2 * h + e] * diff, diff, s[k]);
              else p[r][nt][2 * h + e] = fmaf(diff, diff, p[r][nt][2 * h + e]);
            }
      }
    if constexpr (kSums) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (DS <= 16) {
          tsum[(4 * q4 + k) * kThreads] += s[k];
        } else {
          const float total = warp_sum(s[k]);
          if (lane == 0) wrow[1 + 4 * q4 + k] += total;
        }
      }
    }
  }
}

// Floats of shared memory before the pipeline: xs, ys, per-warp sums, the
// threads' own sums (DS <= 16) and v (m = 1). The pipeline (m > 1)
// follows: kStages stages of (U chunk, V chunk), or with a resident U all
// of U's chunks and kStages stages of V chunks.
template <int DS, bool ONE>
__host__ __device__ constexpr int fixed_floats() {
  return (kRows + kCols) * (DS + 4) + kWarps * (1 + DS) + (DS <= 16 ? DS * kThreads : 0) +
         (ONE ? kCols : 0);
}

__host__ __device__ inline int pipe_floats(bool one, bool resident, int kchunks) {
  if (one) return 0;
  return resident ? kchunks * kRows * kKC + kStages * kCols * kKC : kStages * (kRows + kCols) * kKC;
}

template <int KIND, int D, bool ONE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gram_grads_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ v, const float* __restrict__ u,
                      float* __restrict__ partials, int n, int n_cols, int m, int d, bool resident) {
  constexpr bool kIsWide = D == lat::kWide;
  constexpr int DS = kIsWide ? lat::kChunk : D;  // columns held in shared memory
  constexpr int XS = DS + 4;                     // row stride of xs and ys
  constexpr bool kRegSums = DS <= 16;            // per-thread sums (else per warp)
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // (kRows, XS)
  float* ys = xs + kRows * XS;        // (kCols, XS)
  float* wsum = ys + kCols * XS;      // (kWarps, 1 + DS)
  float* tsum = wsum + kWarps * (1 + DS);  // (DS, kThreads) if kRegSums
  float* vt = tsum + (kRegSums ? DS * kThreads : 0);  // m = 1: the tile's v (kCols)
  float* pipe = smem + fixed_floats<DS, ONE>();

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wr = (warp % 4) * 16 * kR;  // the warp's first row in the block
  const int wc = (warp / 4) * 8 * kNT;  // the warp's first column in the tile
  const long row0 = static_cast<long>(blockIdx.x) * kRows;
  const int chunks = kIsWide ? d / DS : 1;
  const int own = blockIdx.y;  // the chunk of the per-dimension sums (0 unless wide)
  const int kchunks = (m + kKC - 1) / kKC;

  // Columns c * DS .. c * DS + DS of the block's x rows and of the tile's y rows.
  auto stage_x = [&](int c) {
    for (int idx = tid; idx < kRows * (DS / 4); idx += kThreads) {
      const int r = idx / (DS / 4);
      const int q = idx % (DS / 4);
      const long row = row0 + r;
      *reinterpret_cast<float4*>(&xs[r * XS + 4 * q]) =
          row < n ? *reinterpret_cast<const float4*>(x + row * d + c * DS + 4 * q)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto stage_y = [&](int c, int j0) {
    for (int idx = tid; idx < kCols * (DS / 4); idx += kThreads) {
      const int r = idx / (DS / 4);
      const int q = idx % (DS / 4);
      const long col = j0 + r;
      *reinterpret_cast<float4*>(&ys[r * XS + 4 * q]) =
          col < n_cols ? *reinterpret_cast<const float4*>(y + col * d + c * DS + 4 * q)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  // Rows [first, last) of a chunk of m-columns k0 .. k0 + kKC, by 16-byte
  // copies: rows below kRows are U's (block row row0 + r, to dst_u), the
  // others V's (column j0 + r - kRows, to dst_v). Element (r, k) sits at
  // r * kKC + 4 * (quad ^ 4 (odd r)) + k % 4, quad = k / 4.
  auto stage_chunk = [&](float* dst_u, float* dst_v, int first, int last, int j0, int k0) {
    for (int idx = first * (kKC / 4) + tid; idx < last * (kKC / 4); idx += kThreads) {
      const int r = idx / (kKC / 4);
      const int q = idx % (kKC / 4);
      const bool is_u = r < kRows;
      const int rr = is_u ? r : r - kRows;
      const long row = is_u ? row0 + rr : static_cast<long>(j0) + rr;
      const int k = k0 + 4 * q;
      const bool ok = row < (is_u ? n : n_cols) && k < m;
      const float* src = (is_u ? u : v) + (ok ? row * m + k : 0);
      lat::cp_async16((is_u ? dst_u : dst_v) + rr * kKC + 4 * (q ^ ((rr & 1) * 4)), src, ok);
    }
  };
  // Pipeline iteration `it` is chunk it % kchunks of column tile it / kchunks.
  const int total = (n_cols + kCols - 1) / kCols * kchunks;
  auto u_buf = [&](int it) {
    return resident ? pipe + (it % kchunks) * kRows * kKC
                    : pipe + (it % kStages) * (kRows + kCols) * kKC;
  };
  auto v_buf = [&](int it) {
    return resident ? pipe + kchunks * kRows * kKC + (it % kStages) * kCols * kKC
                    : u_buf(it) + kRows * kKC;
  };
  // Start iteration it's copies (none past the last) and close their group.
  auto prefetch = [&](int it) {
    if (it < total) {
      const int j0 = it / kchunks * kCols;
      const int k0 = it % kchunks * kKC;
      if (resident) stage_chunk(nullptr, v_buf(it), kRows, kRows + kCols, j0, k0);
      else stage_chunk(u_buf(it), v_buf(it), 0, kRows + kCols, j0, k0);
    }
    lat::cp_async_commit();
  };

  for (int idx = tid; idx < kWarps * (1 + DS) + (kRegSums ? DS * kThreads : 0); idx += kThreads)
    wsum[idx] = 0.0f;  // and tsum
  if (!kIsWide) stage_x(0);

  float ur[kR][2];  // m = 1: u of the lane's rows
  if constexpr (ONE) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long row = row0 + wr + r * 16 + h * 8 + g;
        ur[r][h] = row < n ? u[row] : 0.0f;
      }
  } else {
    if (resident)  // all of U's chunks, once, in the first group
      for (int c = 0; c < kchunks; ++c)
        stage_chunk(pipe + c * kRows * kKC, nullptr, 0, kRows, 0, c * kKC);
    for (int it = 0; it < kStages - 1; ++it) prefetch(it);
  }

  float d_out = 0.0f;

  int it = 0;  // pipeline iteration, counted across tiles
  for (int j0 = 0; j0 < n_cols; j0 += kCols) {
    __syncthreads();  // the previous tile's ys and vt are no longer read
    if (!kIsWide) stage_y(0, j0);
    if constexpr (ONE) {
      for (int idx = tid; idx < kCols; idx += kThreads)
        vt[idx] = j0 + idx < n_cols ? v[j0 + idx] : 0.0f;
      __syncthreads();
    }

    float acc[kR][kNT][4];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][nt][q] = 0.0f;

    if constexpr (!ONE) {
      for (int c = 0; c < kchunks; ++c, ++it) {
        // kStages - 1 iterations ahead, into the buffer read at it - 1; this
        // tile's later chunks, then the next tile's, whose copies overlap
        // this tile's epilogue.
        prefetch(it + kStages - 1);
        lat::cp_async_wait<kStages - 1>();  // this iteration's copies (and U's, if resident)
        __syncthreads();
        const float* us = u_buf(it);
        const float* vs = v_buf(it);
#pragma unroll 1
        for (int pr = 0; pr < kKC / 16; ++pr) {
          const int kp = c * kKC + pr * 16;  // first m-column of the pair of k-steps
          if (kp >= m) break;
          const int quad = 4 * ((4 * pr + t) ^ ((g & 1) * 4));  // float offset of the lane's quad
          // Both k-steps of the pair (past m they multiply zeros): A split
          // once, then B one n-tile at a time.
          uint32_t ahi[2][kR][4], alo[2][kR][4];  // [step][m-tile]
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const float4 f0 = *reinterpret_cast<const float4*>(&us[(wr + r * 16 + g) * kKC + quad]);
            const float4 f1 = *reinterpret_cast<const float4*>(&us[(wr + r * 16 + 8 + g) * kKC + quad]);
            const float a[2][4] = {{f0.x, f1.x, f0.y, f1.y}, {f0.z, f1.z, f0.w, f1.w}};
#pragma unroll
            for (int st = 0; st < 2; ++st)
#pragma unroll
              for (int q = 0; q < 4; ++q) lat::split_tf32(a[st][q], ahi[st][r][q], alo[st][r][q]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float4 fb = *reinterpret_cast<const float4*>(&vs[(wc + nt * 8 + g) * kKC + quad]);
            const float b[2][2] = {{fb.x, fb.y}, {fb.z, fb.w}};
#pragma unroll
            for (int st = 0; st < 2; ++st) {
              uint32_t h0, l0, h1, l1;
              lat::split_tf32(b[st][0], h0, l0);
              lat::split_tf32(b[st][1], h1, l1);
              const uint4 bb = make_uint4(h0, h1, l0, l1);
#pragma unroll
              for (int r = 0; r < kR; ++r) lat::mma_3xtf32(acc[r][nt], ahi[st][r], alo[st][r], bb);
            }
          }
        }
        __syncthreads();  // this stage's buffers are refilled next
      }
    }

    // Epilogue on the fragment, kNH n-tiles at a time (fewer live registers):
    // cell (r, nh, q) of pass hf is row wr + r * 16 + (q / 2) * 8 + g, column
    // wc + (hf * kNH + nh) * 8 + 2t + q % 2.
#pragma unroll
    for (int hf = 0; hf < kNT / kNH; ++hf) {
      const int wch = wc + hf * kNH * 8;
      float p[kR][kNH][4];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int nh = 0; nh < kNH; ++nh)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[r][nh][q] = 0.0f;

      for (int c = 0; c < chunks; ++c) {
        if (kIsWide) {
          __syncthreads();  // the previous chunk (or tile) is no longer read
          stage_x(c);
          stage_y(c, j0);
          __syncthreads();
        }
        dims_pass<DS, false>(xs, ys, wr, wch, g, t, p, tsum + tid, wsum + warp * (1 + DS), lane);
      }
      if (kIsWide && own != chunks - 1) {  // this block's chunk for the sums
        __syncthreads();
        stage_x(own);
        stage_y(own, j0);
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int nh = 0; nh < kNH; ++nh)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float uv;
            if constexpr (ONE) uv = ur[r][q / 2] * vt[wch + nh * 8 + 2 * t + q % 2];
            else uv = acc[r][hf * kNH + nh][q];
            float gv, dg;
            kernel_values<KIND>(p[r][nh][q], gv, dg);
            d_out = fmaf(uv, gv, d_out);
            p[r][nh][q] = uv * dg;  // w
          }

      dims_pass<DS, true>(xs, ys, wr, wch, g, t, p, tsum + tid, wsum + warp * (1 + DS), lane);
    }
  }
  if constexpr (!ONE) lat::cp_async_wait<0>();

  // Block reduction in a fixed order: warp shuffles, then one pass over
  // the warps' sums.
  {
    float* wrow = wsum + warp * (1 + DS);
    const float s = warp_sum(d_out);
    if (lane == 0) wrow[0] = s;
    if constexpr (kRegSums) {
#pragma unroll
      for (int dd = 0; dd < DS; ++dd) {
        const float sd = warp_sum(tsum[dd * kThreads + tid]);
        if (lane == 0) wrow[1 + dd] = sd;
      }
    }
  }
  __syncthreads();
  for (int q = tid; q <= DS; q += kThreads) {
    if (q == 0 && own != 0) continue;  // column 0 comes from chunk 0
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w * (1 + DS) + q];
    const int col = q == 0 ? 0 : 1 + own * DS + q - 1;
    partials[static_cast<long>(blockIdx.x) * (1 + d) + col] = s;
  }
}

template <int KIND, int D, bool ONE>
cudaError_t launch(const float* x, const float* y, const float* v, const float* u, float* partials,
                   int n, int n_cols, int m, int d, cudaStream_t stream) {
  constexpr int DS = D == lat::kWide ? lat::kChunk : D;
  const int kchunks = (m + kKC - 1) / kKC;
  int floats = fixed_floats<DS, ONE>() + pipe_floats(ONE, kResidentU, kchunks);
  bool resident = kResidentU && !ONE;
  int device = 0, most = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (resident && floats * static_cast<int>(sizeof(float)) > most) {  // U does not fit: re-stage it
    resident = false;
    floats = fixed_floats<DS, ONE>() + pipe_floats(ONE, false, kchunks);
  }
  const int bytes = floats * static_cast<int>(sizeof(float));
  auto kernel = gram_grads_kernel<KIND, D, ONE>;
  cudaError_t status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (status != cudaSuccess) return status;
  status = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  if (status != cudaSuccess) return status;
  const dim3 grid((n + kRows - 1) / kRows, D == lat::kWide ? d / lat::kChunk : 1);
  kernel<<<grid, kThreads, bytes, stream>>>(x, y, v, u, partials, n, n_cols, m, d, resident);
  return cudaSuccess;
}

}  // namespace

// x: (n, d), y: (n_cols, d), scaled and zero-padded to d columns (8, 16,
// 32, 64 or a multiple of 64); v: (n_cols, m); u: (n, m), m = 1 or a
// multiple of 4 (the wrapper pads u and v with zero columns); partials:
// (ceil(n / 128), 1 + d). All float32, row-major, contiguous, 16-byte
// aligned. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported kind, d or m, without
// launching).
extern "C" int lat_gram_grads(int kind, const float* x, const float* y,
                              const float* v, const float* u, float* partials,
                              int n, int n_cols, int m, int d, void* stream) {
  if (n <= 0 || n_cols <= 0 || m <= 0 || (m > 1 && m % 4 != 0)) return cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(u) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t status = cudaSuccess;
#define LAT_LAUNCH(K, DD)                                                              \
  status = m == 1 ? launch<K, DD, true>(x, y, v, u, partials, n, n_cols, m, d, s)      \
                  : launch<K, DD, false>(x, y, v, u, partials, n, n_cols, m, d, s)
  LAT_DISPATCH_KIND_D(kind, d, LAT_LAUNCH)
#undef LAT_LAUNCH
  if (status != cudaSuccess) return status;
  return cudaGetLastError();
}
