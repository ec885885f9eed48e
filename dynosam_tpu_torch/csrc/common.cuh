// Shared device helpers for the port's Hopper kernels.
#pragma once

#include <cuda_runtime.h>

namespace dyno {

// Bilinear sample of a row-major (H, W) image at (x, y), with the
// coordinates clamped to the image first and the +1 taps clamped to the
// last row/column — the contract of `ops/klt.py:bilinear_sample`.  A NaN
// coordinate clamps to 0 (fmaxf returns the non-NaN operand).
__device__ __forceinline__ float bilinear_clamped(const float* __restrict__ img,
                                                  int H, int W, float x, float y) {
  x = fminf(fmaxf(x, 0.f), (float)(W - 1));
  y = fminf(fmaxf(y, 0.f), (float)(H - 1));
  const float xf = floorf(x), yf = floorf(y);
  const int x0 = (int)xf, y0 = (int)yf;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float fx = x - xf, fy = y - yf;
  const float v00 = __ldg(img + (size_t)y0 * W + x0);
  const float v01 = __ldg(img + (size_t)y0 * W + x1);
  const float v10 = __ldg(img + (size_t)y1 * W + x0);
  const float v11 = __ldg(img + (size_t)y1 * W + x1);
  return v00 * (1.f - fx) * (1.f - fy) + v01 * fx * (1.f - fy) +
         v10 * (1.f - fx) * fy + v11 * fx * fy;
}

// Sum of `v` over a warp (all lanes receive the total).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide sums of up to three values; every thread receives the totals.
// `scratch` must hold 3 * 32 floats.  Contains two __syncthreads().
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[k * 32 + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += scratch[k * 32 + w];
    v[k] = s;
  }
  __syncthreads();
}

}  // namespace dyno
