// K10: the sparse matrix-vector product of a BSR operator, over a packed
// CSR view of its tiles.
//
// Replaces the TPU kernel `_bsr_kernel` of lanczos_adjoints_tpu/ops/pallas_bsr.py
// (launched by `bsr_spmv_pallas`), which contracts every stored (8, 128)
// tile. The operator's parameter stays those (nbr, width, 8, 128) tiles;
// the wrapper (ops/fused_bsr.py) packs them, once for each distinct values
// tensor, into CSR: vals (nnz,), int32 cols (nnz,) and row_ptr (n + 1,),
// with exactly the tiles' nonzero pattern. Here
//   out[i] = sum_{k in [row_ptr[i], row_ptr[i + 1])} vals[k] * v[cols[k]].
//
// What bounds it on an H100: bytes. Each nonzero's value and column, the
// row pointers, v and out once: nnz (4 + 4) + (n + 1) 4 + 2 n 4, 25.2 MB
// for the FEM test matrix at grid 24, where the tile stream the TPU
// kernel reads is 170 MB (fill 0.073).
//
// Design: a group of G lanes per row (the wrapper picks G from the mean
// row length: 4 for the ~74 entries of an FEM row). The group walks its
// row: scalar loads up to a 16-byte boundary, then float4s of vals and
// int4s of cols (4G entries a coalesced 16G-byte load, kUnroll of them in
// flight a lane before their products), then a scalar tail; v through the
// read-only path. Each lane sums its entries in a fixed order and the
// group's sum is a fixed xor butterfly, with no atomics, so the result is the same bit for bit
// from run to run. vals and cols are read with the default caching, so
// over a Krylov loop the view may stay in the 50 MB L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // float4 loads of vals and cols in flight a lane

template <int G>
__global__ void __launch_bounds__(kThreads)
    bsr_csr_spmv_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                        const int* __restrict__ row_ptr, const float* __restrict__ v,
                        float* __restrict__ out, int n_rows) {
  const int lg = threadIdx.x % G;
  const long row = static_cast<long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  float s = 0.0f;
  if (row < n_rows) {
    const int begin = __ldg(row_ptr + row);
    const int end = __ldg(row_ptr + row + 1);
    const int head = min(end, (begin + 3) & ~3);  // the first 16-byte boundary
    int k = begin + lg;
    if (k < head) s = fmaf(__ldg(vals + k), __ldg(v + __ldg(cols + k)), s);
    const int body_end = head + ((end - head) & ~3);
    for (k = head + 4 * lg; k < body_end; k += 4 * G * kUnroll) {
      float4 a[kUnroll];
      int4 c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // all loads first, then the products
        const int ku = k + 4 * G * u;
        a[u] = ku < body_end ? __ldg(reinterpret_cast<const float4*>(vals + ku))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        c[u] = ku < body_end ? __ldg(reinterpret_cast<const int4*>(cols + ku)) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + 4 * G * u >= body_end) break;
        s = fmaf(a[u].x, __ldg(v + c[u].x), s);
        s = fmaf(a[u].y, __ldg(v + c[u].y), s);
        s = fmaf(a[u].z, __ldg(v + c[u].z), s);
        s = fmaf(a[u].w, __ldg(v + c[u].w), s);
      }
    }
    k = body_end + lg;  // fewer than 4 entries remain
    if (k < end) s = fmaf(__ldg(vals + k), __ldg(v + __ldg(cols + k)), s);
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lg == 0 && row < n_rows) out[row] = s;
}

template <int G>
void launch(const float* vals, const int* cols, const int* row_ptr, const float* v, float* out,
            int n_rows, cudaStream_t stream) {
  constexpr int rows = kThreads / G;
  bsr_csr_spmv_kernel<G>
      <<<(n_rows + rows - 1) / rows, kThreads, 0, stream>>>(vals, cols, row_ptr, v, out, n_rows);
}

}  // namespace

// vals: (nnz,) float32 and cols: (nnz,) int32, both 16-byte aligned;
// row_ptr: (n_rows + 1,) int32; v: (n_cols,) float32 with every column
// index below n_cols; out: (n_rows,) float32. lanes: 4, 8, 16 or 32 a
// row. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for other lanes, without launching).
extern "C" int lat_bsr_spmv(const float* vals, const int* cols, const int* row_ptr,
                            const float* v, float* out, int n_rows, int lanes, void* stream) {
  if (n_rows <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 4: launch<4>(vals, cols, row_ptr, v, out, n_rows, s); break;
    case 8: launch<8>(vals, cols, row_ptr, v, out, n_rows, s); break;
    case 16: launch<16>(vals, cols, row_ptr, v, out, n_rows, s); break;
    case 32: launch<32>(vals, cols, row_ptr, v, out, n_rows, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
