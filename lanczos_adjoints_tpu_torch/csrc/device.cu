// The card's limits that the host's launch plans read (K7's
// ops/fused_lanczos.py `adjoint_plan`, K9's ops/fused_arnoldi.py
// `launch_plan`). No kernel: a query of the CUDA runtime alone, so that
// planning a launch builds and loads no kernel's source.
#include <cuda_runtime.h>

// The current device's SMs and the shared memory a block may opt into.
// Returns a CUDA error code.
extern "C" int lat_device_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err;
}
