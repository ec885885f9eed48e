// Shared device helpers for the port's Hopper kernels.
#pragma once

#include <cuda_runtime.h>

namespace dyno {

// Sum of `v` over a warp by butterfly; every lane receives the same total
// (each step adds a pair in both orders, and float addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace dyno
