// K2: batched point sampling of a (C, H, W) channel stack at N float (x, y)
// points.  Replaces the Pallas kernel `dynosam_tpu/ops/pallas/point_sample.py`
// (`point_sample`, `_make_kernel`) and its TPU production form
// `ops/onehot_sample.py:point_sample_mxu`.
//
// Per channel, bit c of `nearest_mask` selects the mode:
//   bilinear — coordinates clamped to the image, border-clamped 2-hot
//              weights (`ops/klt.py:bilinear_sample`);
//   nearest  — round half to even (rintf, as jnp.round), then clamp
//              (`ops/klt.py:nearest_at`).
// Rows with valid == 0 write 0 and read nothing.
//
// Bound: one launch moves < 0.3 MB at the main path's shapes, so it is
// bound by launch latency, not by bytes.  Design: one thread per point and
// one pass over the channels, so the 2-hot weights are built once per point
// and the four taps of each channel come from L2 (the stack is read-only).
#include <cstdint>

#include "common.cuh"

namespace {

__global__ void point_sample_kernel(const float* __restrict__ stack, int C, int H,
                                    int W, const float* __restrict__ uv,
                                    const uint8_t* __restrict__ valid, int N,
                                    int nearest_mask, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float* o = out + (size_t)i * C;
  if (!valid[i]) {
    for (int c = 0; c < C; ++c) o[c] = 0.f;
    return;
  }
  float x = uv[2 * i], y = uv[2 * i + 1];
  if (x != x) x = 0.f;  // NaN -> 0, the plain version's sanitisation
  if (y != y) y = 0.f;
  // nearest tap: round half to even, then clamp (in float, so huge
  // coordinates never overflow the int conversion)
  const int xn = (int)fminf(fmaxf(rintf(x), 0.f), (float)(W - 1));
  const int yn = (int)fminf(fmaxf(rintf(y), 0.f), (float)(H - 1));
  const size_t plane = (size_t)H * W;
  for (int c = 0; c < C; ++c) {
    const float* img = stack + c * plane;
    if ((nearest_mask >> c) & 1) {
      o[c] = __ldg(img + (size_t)yn * W + xn);
    } else {
      o[c] = dyno::bilinear_clamped(img, H, W, x, y);
    }
  }
}

}  // namespace

extern "C" int dyno_point_sample(const float* stack, int C, int H, int W,
                                 const float* uv, const uint8_t* valid, int N,
                                 int nearest_mask, float* out, void* stream) {
  if (N > 0) {
    const int threads = 128;
    const int blocks = (N + threads - 1) / threads;
    point_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        stack, C, H, W, uv, valid, N, nearest_mask, out);
  }
  return (int)cudaGetLastError();
}
