// K11: the row-partitioned DIA matvec over a ring of P partitions, each
// partition reading its neighbours' halos where they lie, in one launch.
//
// `lat_halo_dia_matvec` replaces the TPU kernel `_halo_kernel` of
// lanczos_adjoints_tpu/parallel/pallas_halo.py (launched by
// `sharded_dia_operator_pallas`). Partition p owns rows
// [p local_n, (p + 1) local_n) of an n-row DIA operator: its segment v_p of
// the vector, its columns vals_p (D, local_n) of the values and its segment
// out_p of the product. With ring neighbours l = (p - 1) mod P and
// r = (p + 1) mod P and ext_p = [v_l[-halo:], v_p, v_r[:halo]],
//   out_p[i] = sum_k vals_p[k, i] * ext_p[halo + i + d_k],
// which is K4's circular product on the whole vector, for any values.
//
// What bounds it on an H100: bytes, as K4. Each partition reads its
// values and its segment and writes its output once; the halos are 2 P
// halo floats more, read from the neighbours' segments. At n = 1,048,576
// and D = 5, (D + 2) n 4 bytes = 29.4 MB, 8.76 us at 3.35 TB/s.
//
// Design. The TPU kernel runs on chips that are truly apart: each sends
// its boundary rows to its ring neighbours by RDMA, sweeps its own rows
// while the copies fly, and waits on semaphores before its edge rows. On
// one card every partition's segment already lies in device memory, and
// the launch is ordered on its stream after whatever wrote them, so a
// partition reads its neighbours' halos in place (a get where the TPU
// kernel does a put): no copy, no flag, no wait, and a plain launch.
//   - Rows: the blocks are split evenly over the partitions (the
//     partition from the block index) and walk its rows with a grid
//     stride, kRows consecutive rows a thread. Interior and edge rows are
//     one pass: a row group whose stencil stays inside v_p reads it
//     unchecked; one that reaches past an end reads ext_p[halo + j] as
//     v_l[local_n + j] (j < 0), v_p[j] or v_r[j - local_n] (j >= local_n),
//     so there is no edge tail. Where 2 halo > local_n the two ends overlap
//     and every row is an edge row.
//   - kRows = 4: float4 loads of the values and float4 stores of the
//     output, where local_n and ld are multiples of 4 and every partition's
//     values and output are 16-byte aligned (the C entry refuses a vector
//     launch on anything else); kRows = 1: scalar, any shape. The D
//     shifted reads of v stay scalar, through L1 (__ldg), as in K4: read
//     as aligned float4 windows they took more registers, fewer resident
//     blocks and more time. Two diagonals a loop iteration keep the
//     vector path under 48 registers (5 blocks an SM).
//   - Segments: `Rows` forms partition p's pointers as base + p local_n
//     (one tensor each, the operator's path, nothing built per call);
//     `Table` reads them from tables of P pointers passed by value as a
//     __grid_constant__ parameter (one allocation per partition), indexed
//     in the parameter space with no local copy. Those tables are where
//     partitions on distinct cards would put peer pointers, with an event
//     per card ordering the launch after each card's v.
// Every sum is taken in K4's order (fmaf over k = 0 .. D - 1), so each
// output equals K4's on the global vector, bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "dia_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVectorRows = 4;  // rows a thread on the vector path
constexpr int kUnroll = 2;      // diagonals a loop iteration
// __launch_bounds__'s resident blocks an SM: the scalar path fits 8 blocks
// (2,048 threads) in 32 registers; the vector path takes what it needs.
constexpr int kMinBlocksScalar = 8;
constexpr int kMinBlocksVector = 1;
constexpr int kMaxParts = 64;   // MAX_PARTITIONS of ops/native.py

// Partition p's segments as views of one tensor each (vals with row
// stride ld): base + p local_n.
struct Rows {
  const float* v;
  const float* vals;
  float* out;
  __device__ const float* v_of(int p, int local_n) const {
    return v + static_cast<size_t>(p) * local_n;
  }
  __device__ const float* vals_of(int p, int local_n) const {
    return vals + static_cast<size_t>(p) * local_n;
  }
  __device__ float* out_of(int p, int local_n) const { return out + static_cast<size_t>(p) * local_n; }
};

// Partition p's segments, each its own allocation.
struct Table {
  const float* v[kMaxParts];
  const float* vals[kMaxParts];
  float* out[kMaxParts];
  __device__ const float* v_of(int p, int) const { return v[p]; }
  __device__ const float* vals_of(int p, int) const { return vals[p]; }
  __device__ float* out_of(int p, int) const { return out[p]; }
};

// kRows consecutive floats from p (16-byte aligned where kRows > 1).
template <int kRows>
__device__ inline void load_rows(const float* __restrict__ p, float (&f)[kRows]) {
  if constexpr (kRows == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      f[4 * q] = t.x, f[4 * q + 1] = t.y, f[4 * q + 2] = t.z, f[4 * q + 3] = t.w;
    }
  }
}

template <int kRows>
__device__ inline void store_rows(float* __restrict__ p, const float (&f)[kRows]) {
  if constexpr (kRows == 1) {
    *p = f[0];
  } else {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
  }
}

template <int kRows, class Segments>
__global__ void __launch_bounds__(kThreads, kRows == 1 ? kMinBlocksScalar : kMinBlocksVector)
    halo_dia_kernel(const __grid_constant__ Segments seg, int parts, int per_part, int local_n,
                    long long ld, int halo, int num_diags, const int* __restrict__ offsets) {
  extern __shared__ int s_off[];
  lat::stage_offsets(offsets, num_diags, s_off);
  const int p = blockIdx.x / per_part;
  const int b = blockIdx.x - p * per_part;
  const int left = p == 0 ? parts - 1 : p - 1;
  const int right = p == parts - 1 ? 0 : p + 1;
  const float* __restrict__ v = seg.v_of(p, local_n);
  const float* __restrict__ v_left = seg.v_of(left, local_n);
  const float* __restrict__ v_right = seg.v_of(right, local_n);
  const float* __restrict__ vals = seg.vals_of(p, local_n);
  float* __restrict__ out = seg.out_of(p, local_n);

  const int stride = per_part * kThreads * kRows;
  for (int i = (b * kThreads + threadIdx.x) * kRows; i < local_n; i += stride) {
    // i + kRows <= local_n: kRows > 1 only where local_n % kRows == 0.
    float acc[kRows], w[kRows], x[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = 0.0f;
    const float* row = vals + i;
    if (i >= halo && i + kRows + halo <= local_n) {
      // An interior group: its stencil stays inside v_p.
#pragma unroll kUnroll
      for (int k = 0; k < num_diags; ++k, row += ld) {
        load_rows<kRows>(row, w);
        const float* vk = v + i + s_off[k];
#pragma unroll
        for (int u = 0; u < kRows; ++u) acc[u] = fmaf(w[u], __ldg(vk + u), acc[u]);
      }
    } else {
#pragma unroll kUnroll
      for (int k = 0; k < num_diags; ++k, row += ld) {
        load_rows<kRows>(row, w);
        const int d = s_off[k];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int j = i + u + d;  // index into v_p; outside it, a neighbour's halo
          x[u] = j < 0 ? __ldg(v_left + (local_n + j))
                       : (j < local_n ? __ldg(v + j) : __ldg(v_right + (j - local_n)));
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) acc[u] = fmaf(w[u], x[u], acc[u]);
      }
    }
    store_rows<kRows>(out + i, acc);
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <int kRows, class Segments>
cudaError_t launch(const Segments& seg, int parts, int local_n, int ld, int halo, int num_diags,
                   const int* offsets, int max_blocks, cudaStream_t stream) {
  auto kernel = &halo_dia_kernel<kRows, Segments>;
  const size_t smem = lat::offsets_bytes(num_diags);
  const cudaError_t err = lat::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int need = (local_n + kThreads * kRows - 1) / (kThreads * kRows);
  const int per_part = need < max_blocks ? need : max_blocks;
  kernel<<<per_part * parts, kThreads, smem, stream>>>(seg, parts, per_part, local_n, ld, halo,
                                                       num_diags, offsets);
  return cudaGetLastError();
}

}  // namespace

// table = 0: v, vals, out are the device pointers of the global tensors
// v (parts local_n,), vals (num_diags rows of parts local_n, row stride
// ld) and out (parts local_n,); partition p's segments begin at
// p local_n. table = 1: v, vals, out are host arrays of `parts` device
// pointers, partition p's v_p (local_n,), vals_p (num_diags rows of
// local_n, row stride ld >= local_n) and out_p (local_n,). float32.
// offsets_host: host array of num_diags signed offsets, |d_k| <= halo <=
// local_n; offsets: the same on the device. rows: rows a thread, 4 (the
// vector path: local_n and ld multiples of 4, every partition's values
// and output 16-byte aligned) or 1. max_blocks: blocks a partition at
// most (the launch plan's; a grid-stride loop covers the rest). Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for a shape or a plan the kernel does not take).
extern "C" int lat_halo_dia_matvec(const void* v, const void* vals, void* out, int table,
                                   int parts, int local_n, int ld, int halo, int num_diags,
                                   const int* offsets_host, const int* offsets, int rows,
                                   int max_blocks, void* stream) {
  const long long n = static_cast<long long>(parts) * local_n;
  if (parts < 1 || parts > kMaxParts || local_n < 1 || n > (1 << 30) || halo < 1 ||
      halo > local_n || ld < (table ? local_n : n) || num_diags < 1 || max_blocks < 1 ||
      (rows != 1 && rows != kVectorRows))
    return cudaErrorInvalidValue;
  for (int k = 0; k < num_diags; ++k) {
    if (offsets_host[k] > halo || offsets_host[k] < -halo) return cudaErrorInvalidValue;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (!table) {
    const Rows seg{static_cast<const float*>(v), static_cast<const float*>(vals),
                   static_cast<float*>(out)};
    if (rows == 1) return launch<1>(seg, parts, local_n, ld, halo, num_diags, offsets, max_blocks, s);
    if (local_n % kVectorRows || ld % 4 || !aligned16(seg.vals) || !aligned16(seg.out))
      return cudaErrorInvalidValue;
    return launch<kVectorRows>(seg, parts, local_n, ld, halo, num_diags, offsets, max_blocks, s);
  }
  Table seg{};
  for (int p = 0; p < parts; ++p) {
    seg.v[p] = static_cast<const float* const*>(v)[p];
    seg.vals[p] = static_cast<const float* const*>(vals)[p];
    seg.out[p] = static_cast<float* const*>(out)[p];
  }
  if (rows == 1) return launch<1>(seg, parts, local_n, ld, halo, num_diags, offsets, max_blocks, s);
  if (local_n % kVectorRows || ld % 4) return cudaErrorInvalidValue;
  for (int p = 0; p < parts; ++p) {
    if (!aligned16(seg.vals[p]) || !aligned16(seg.out[p])) return cudaErrorInvalidValue;
  }
  return launch<kVectorRows>(seg, parts, local_n, ld, halo, num_diags, offsets, max_blocks, s);
}
