// K10: the block-ELL sparse matrix-vector product.
//
// Replaces the TPU kernel `_bsr_kernel` of lanczos_adjoints_tpu/ops/pallas_bsr.py
// (launched by `bsr_spmv_pallas`). For tiles (nbr, width, 8, 128) and
// block_cols (nbr, width):
//   out[b * 8 + r] = sum_w sum_c tiles[b, w, r, c] * v[block_cols[b, w] * 128 + c]
// Padded slots have block column 0 and zero tiles; columns may repeat.
//
// What bounds it on an H100: bytes. Every stored tile is read once, at 2
// operations per 4-byte value, so the tile stream (170 MB for the FEM
// test matrix at grid 24) sets the time at 3.35 TB/s; v is read once per
// tile from L2.
//
// Design: one warp per row block. The JAX package gathers the source
// blocks of v into a (nbr, width, 128) array before its kernel; here the
// warp reads them in place: lane l holds v[bc * 128 + 4l .. 4l + 3] as
// one 16-byte load, and each tile row is one coalesced 512-byte load
// (lane l takes columns 4l .. 4l + 3), streamed past the caches. The
// row block's block columns are loaded once, 32 at a time, and passed
// round by a shuffle. Each lane keeps 8 row sums; a butterfly over the
// warp completes them in one fixed order (no atomics), and lane r writes
// row r.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // columns per tile
constexpr int kRows = 8;    // rows per tile
constexpr int kWarps = 8;   // row blocks per thread block

__global__ void __launch_bounds__(kWarps * 32)
    bsr_spmv_kernel(const float* __restrict__ tiles, const int* __restrict__ block_cols,
                    const float* __restrict__ v, float* __restrict__ out, int nbr,
                    int width, int n_rows, int n_cols) {
  const int lane = threadIdx.x % 32;
  const long b = static_cast<long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (b >= nbr) return;  // the whole warp: b is uniform across it

  const float4* tile4 =
      reinterpret_cast<const float4*>(tiles) + b * width * kRows * (kTile / 4);
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  for (int w0 = 0; w0 < width; w0 += 32) {
    const int mine = w0 + lane < width ? block_cols[b * width + w0 + lane] : 0;
    const int count = min(32, width - w0);
    for (int k = 0; k < count; ++k) {
      const long col = static_cast<long>(__shfl_sync(0xffffffffu, mine, k)) * kTile + lane * 4;
      float4 x;
      if (col + 3 < n_cols) {
        x = __ldg(reinterpret_cast<const float4*>(v + col));
      } else {  // the ragged last column block
        x.x = col < n_cols ? v[col] : 0.0f;
        x.y = col + 1 < n_cols ? v[col + 1] : 0.0f;
        x.z = col + 2 < n_cols ? v[col + 2] : 0.0f;
        x.w = col + 3 < n_cols ? v[col + 3] : 0.0f;
      }
      const float4* row4 = tile4 + static_cast<long>(w0 + k) * kRows * (kTile / 4) + lane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 t = __ldcs(row4 + r * (kTile / 4));
        acc[r] = fmaf(t.x, x.x, acc[r]);
        acc[r] = fmaf(t.y, x.y, acc[r]);
        acc[r] = fmaf(t.z, x.z, acc[r]);
        acc[r] = fmaf(t.w, x.w, acc[r]);
      }
    }
  }

  float total = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == r) total = s;
  }
  const long row = b * kRows + lane;
  if (lane < kRows && row < n_rows) out[row] = total;
}

}  // namespace

// tiles: (nbr, width, 8, 128) float32, 16-byte aligned; block_cols:
// (nbr, width) int32; v: (n_cols,) float32, 16-byte aligned; out:
// (n_rows,) float32, n_rows <= 8 * nbr. Returns cudaGetLastError() after
// the launch.
extern "C" int lat_bsr_spmv(const float* tiles, const int* block_cols, const float* v,
                            float* out, int nbr, int width, int n_rows, int n_cols,
                            void* stream) {
  if (nbr <= 0 || width <= 0 || n_rows <= 0 || n_cols <= 0 || n_rows > nbr * kRows) {
    return cudaErrorInvalidValue;
  }
  const int blocks = (nbr + kWarps - 1) / kWarps;
  bsr_spmv_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, block_cols, v, out, nbr, width, n_rows, n_cols);
  return cudaGetLastError();
}
