// K11: the row-partitioned DIA matvec over a ring of P partitions, with
// the halo exchange, in one launch.
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
// halo floats more. At n = 1,048,576 and D = 5, (D + 2) n 4 bytes =
// 29.4 MB, 8.76 us at 3.35 TB/s.
//
// Design. One cooperative launch over all partitions, so that every
// block is resident and a spin-wait never waits on a block that has not
// started; the blocks are split evenly over the partitions, and each
// partition's blocks walk its rows with a grid stride. The TPU kernel's
// neighbour barrier, RDMAs and DMA semaphores become:
//   1. send: the first block of partition p stores its first and last
//      `halo` entries into the receive buffers of l and r, then
//      (__syncthreads, __threadfence) releases the receiver's flag for
//      that side with the call's epoch;
//   2. interior sweep: rows [halo, local_n - halo), whose stencil stays
//      inside v_p, as K4 computes them (the overlap window of the TPU
//      kernel);
//   3. edge fix-up: a block that owns any of the edge rows (the first
//      and the last `halo` rows, min(2 halo, local_n) in all: where
//      2 halo > local_n they overlap and every row is an edge row)
//      acquires its two flags and computes those rows straight from
//      ext_p, reading the received entries of both sides through L2
//      (__ldcg).
// The epoch is a counter of the caller's, one per call: a flag is never
// reset, a receiver waits until its flag has reached the call's epoch
// (a signed difference, so the count may wrap), and the receive buffers
// are double-buffered by the epoch's parity, so that a sender one call
// ahead cannot overwrite a halo still being read. Pointers that change
// from call to call (v, vals, out) travel by value in the launch's
// parameters; the receive buffers and flags are reached through device
// tables of P pointers that the caller builds once, the tables that
// would hold peer pointers once partitions live on distinct cards.
// Every sum is taken in K4's order (fmaf over k = 0 .. D - 1), so each
// output equals K4's on the global vector.
#include <cuda_runtime.h>

#include "cooperative.cuh"
#include "dia_common.cuh"

namespace {

constexpr int kThreads = lat::kCoopThreads;
constexpr int kMaxParts = 64;  // MAX_PARTITIONS of ops/native.py

struct PartPtrs {
  const float* v[kMaxParts];
  const float* vals[kMaxParts];
  float* out[kMaxParts];
};

__device__ inline unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ inline bool reached(unsigned flag, unsigned epoch) {
  return static_cast<int>(flag - epoch) >= 0;
}

// Receive buffer of a partition: [parity][side][halo] floats; side 0
// holds the left neighbour's tail, side 1 the right neighbour's head.
// Flags of a partition: [side] (set by the neighbour on that side).
__global__ void __launch_bounds__(kThreads)
    halo_dia_kernel(PartPtrs ptrs, float* const* recv, unsigned* const* flags, int parts,
                    int local_n, long long ld, int halo, int num_diags,
                    const int* __restrict__ offsets, unsigned epoch) {
  extern __shared__ int s_off[];
  lat::stage_offsets(offsets, num_diags, s_off);
  const int per_part = gridDim.x / parts;
  const int p = blockIdx.x / per_part;
  const int b = blockIdx.x % per_part;
  const int left = (p + parts - 1) % parts;
  const int right = (p + 1) % parts;
  const size_t parity = epoch & 1u;
  const float* __restrict__ v = ptrs.v[p];
  const float* __restrict__ vals = ptrs.vals[p];
  float* __restrict__ out = ptrs.out[p];

  // 1. Send: my tail to the right neighbour's left side, my head to the
  // left neighbour's right side.
  if (b == 0) {
    float* to_right = recv[right] + (parity * 2 + 0) * halo;
    float* to_left = recv[left] + (parity * 2 + 1) * halo;
    for (int t = threadIdx.x; t < halo; t += blockDim.x) {
      to_right[t] = v[local_n - halo + t];
      to_left[t] = v[t];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      store_release(flags[right] + 0, epoch);
      store_release(flags[left] + 1, epoch);
    }
  }

  // 2. Interior sweep.
  const int first = b * blockDim.x + threadIdx.x;
  const int stride = per_part * blockDim.x;
  for (int i = halo + first; i < local_n - halo; i += stride) {
    float acc = 0.0f;
    for (int k = 0; k < num_diags; ++k) {
      acc = fmaf(vals[k * ld + i], v[i + s_off[k]], acc);
    }
    out[i] = acc;
  }

  // 3. Edge fix-up: edge e < halo is row e, edge e >= halo is row
  // local_n - edges + e (every row once where 2 halo > local_n). A block
  // waits only if it owns an edge row.
  const int edges = 2 * halo < local_n ? 2 * halo : local_n;
  if (b * blockDim.x >= edges) return;
  if (threadIdx.x == 0) {
    while (!reached(load_acquire(flags[p] + 0), epoch)) __nanosleep(32);
    while (!reached(load_acquire(flags[p] + 1), epoch)) __nanosleep(32);
  }
  __syncthreads();
  const float* from_left = recv[p] + (parity * 2 + 0) * halo;
  const float* from_right = recv[p] + (parity * 2 + 1) * halo;
  for (int e = first; e < edges; e += stride) {
    const int i = e < halo ? e : local_n - edges + e;
    float acc = 0.0f;
    for (int k = 0; k < num_diags; ++k) {
      const int j = i + s_off[k];  // index into v_p; outside it, a halo
      const float x = j < 0 ? __ldcg(from_left + halo + j)
                            : (j < local_n ? v[j] : __ldcg(from_right + (j - local_n)));
      acc = fmaf(vals[k * ld + i], x, acc);
    }
    out[i] = acc;
  }
}

}  // namespace

// v, vals, out: host arrays of `parts` device pointers, partition p's
// v_p (local_n,), vals_p (num_diags rows of local_n, row stride ld >=
// local_n) and out_p (local_n,); float32. recv, flags: device tables of
// `parts` pointers to each partition's receive buffer (2 x 2 x halo
// floats) and its two flags (zero before the first call). offsets_host:
// host array of num_diags signed offsets, |d_k| <= halo <= local_n;
// offsets: the same on the device. epoch: the call's
// count, never the previous call's. Returns the launch's CUDA error code
// (cudaErrorInvalidValue for a shape the kernel does not take, without
// launching; cudaErrorCooperativeLaunchTooLarge when the card cannot hold
// one block per partition).
extern "C" int lat_halo_dia_matvec(const float* const* v, const float* const* vals,
                                   float* const* out, float* const* recv,
                                   unsigned* const* flags, int parts, int local_n, int ld,
                                   int halo, int num_diags, const int* offsets_host,
                                   const int* offsets, unsigned epoch, void* stream) {
  const long long n = static_cast<long long>(parts) * local_n;
  if (parts < 1 || parts > kMaxParts || local_n < 1 || n > (1 << 30) || halo < 1 ||
      halo > local_n || ld < local_n || num_diags < 1)
    return cudaErrorInvalidValue;
  for (int k = 0; k < num_diags; ++k) {
    if (offsets_host[k] > halo || offsets_host[k] < -halo) return cudaErrorInvalidValue;
  }
  const size_t smem = lat::offsets_bytes(num_diags);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = lat::allow_smem(halo_dia_kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, halo_dia_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const int need = (local_n + kThreads - 1) / kThreads;
  const int room = per_sm * sms / parts;
  const int per_part = room < need ? room : need;
  if (per_part < 1) return cudaErrorCooperativeLaunchTooLarge;
  PartPtrs ptrs{};
  for (int p = 0; p < parts; ++p) {
    ptrs.v[p] = v[p];
    ptrs.vals[p] = vals[p];
    ptrs.out[p] = out[p];
  }
  long long ld_wide = ld;
  void* args[] = {&ptrs, &recv, &flags, &parts, &local_n, &ld_wide,
                  &halo, &num_diags, &offsets, &epoch};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(halo_dia_kernel),
                                    dim3(per_part * parts), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
