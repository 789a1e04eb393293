// Shared helpers for the PiPNN CUDA kernels.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define PIPNN_EXPORT extern "C" __attribute__((visibility("default")))

namespace pipnn {

enum Metric : int { kL2 = 0, kMips = 1, kCosine = 2 };

// (dist, id) lexicographic strict less-than: the reference's tie rule.
__device__ __forceinline__ bool lex_less(float d1, int i1, float d2, int i2) {
  return d1 < d2 || (d1 == d2 && i1 < i2);
}

// max(v, 0) returning +0.0 for -0.0, like jnp.maximum(v, 0.0).
__device__ __forceinline__ float clamp_zero(float v) { return v > 0.f ? v : 0.f; }

}  // namespace pipnn
