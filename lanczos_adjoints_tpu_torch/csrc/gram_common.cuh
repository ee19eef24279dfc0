// Shared pieces of the fused Gram kernels: kernel families and their values.
//
// The kernels take rows that the wrapper has already scaled by
// sqrt(pscale) / lengthscale and padded with zero columns to a width d of
// 8, 16, 32 or 64, or a multiple of 64 above 64 ("wide": instantiated as
// D = kWide, with d read at run time and taken in chunks of kChunk
// columns), so the pre-scaled squared distance of a cell is
// p = sum_d (x_d - y_d)^2 = pscale * sq, with sq = |x - y|^2 / ell^2.
// pscale folds the family's distance factor into the data:
//   rbf       pscale = 1/2  ->  g = exp(-p)
//   matern12  pscale = 1    ->  g = exp(-dist),            dist = sqrt(p + eps)
//   matern32  pscale = 3    ->  g = (1 + dist) exp(-dist), dist = sqrt(p + eps)
// which is the GPyTorch parametrisation of models/gp.py, eps shift included.
#pragma once

#include <cuda_runtime.h>

namespace lat {

enum Kind { kRbf = 0, kMatern12 = 1, kMatern32 = 2 };

constexpr float kEps = 1.1920928955078125e-07f;  // float32 machine epsilon

constexpr int kChunk = 64;  // columns per chunk of a wide row
constexpr int kWide = 0;    // the D of the wide instantiations (d > 64, d % 64 == 0)

__host__ __device__ constexpr bool width_ok(int d) {
  return d == 8 || d == 16 || d == 32 || d == 64 || (d > kChunk && d % kChunk == 0);
}

// g and dg/dsq, the derivative with respect to the unscaled sq.
template <int KIND>
__device__ __forceinline__ void kernel_value_dsq(float p, float& g, float& dg) {
  if (KIND == kRbf) {
    g = expf(-p);
    dg = -0.5f * g;
    return;
  }
  const float dist = sqrtf(p + kEps);
  const float e = expf(-dist);
  if (KIND == kMatern12) {
    g = e;
    dg = -0.5f * e / dist;  // d/dsq exp(-sqrt(sq + eps))
    return;
  }
  g = (1.0f + dist) * e;
  dg = -1.5f * e;  // d/dsq (1 + dist) exp(-dist), dist = sqrt(3 sq + eps)
}

}  // namespace lat

// Instantiate LAUNCH(KIND, D) for the runtime (kind, d) pair, D = kWide
// for every wide d; returns cudaErrorInvalidValue from the enclosing
// function for any other pair.
#define LAT_DISPATCH_KIND_D(kind, d, LAUNCH)                                   \
  if (!lat::width_ok(d)) return cudaErrorInvalidValue;                         \
  switch ((kind) * 1000 + ((d) > lat::kChunk ? 0 : (d))) {                     \
    case 0: LAUNCH(0, lat::kWide); break;                                      \
    case 8: LAUNCH(0, 8); break;                                               \
    case 16: LAUNCH(0, 16); break;                                             \
    case 32: LAUNCH(0, 32); break;                                             \
    case 64: LAUNCH(0, 64); break;                                             \
    case 1000: LAUNCH(1, lat::kWide); break;                                   \
    case 1008: LAUNCH(1, 8); break;                                            \
    case 1016: LAUNCH(1, 16); break;                                           \
    case 1032: LAUNCH(1, 32); break;                                           \
    case 1064: LAUNCH(1, 64); break;                                           \
    case 2000: LAUNCH(2, lat::kWide); break;                                   \
    case 2008: LAUNCH(2, 8); break;                                            \
    case 2016: LAUNCH(2, 16); break;                                           \
    case 2032: LAUNCH(2, 32); break;                                           \
    case 2064: LAUNCH(2, 64); break;                                           \
    default: return cudaErrorInvalidValue;                                     \
  }
