// K2: batched point sampling of C (H, W) channels at N float (x, y) points.
// Replaces the Pallas kernel `dynosam_tpu/ops/pallas/point_sample.py`
// (`point_sample`, `_make_kernel`) and its TPU production form
// `ops/onehot_sample.py:point_sample_mxu`.
//
// Per channel, bit c of `nearest_mask` selects the mode:
//   bilinear — coordinates clamped to the image, border-clamped 2-hot
//              weights (`ops/klt.py:bilinear_sample`);
//   nearest  — round half to even (rintf, as jnp.round), then clamp
//              (`ops/klt.py:nearest_at`).
// Rows with valid == 0 write 0 and read nothing; a null `valid` marks
// every row valid.  The output is (N, C) float32.
//
// Channels are read in place: each has its own base pointer, element type
// (float32, int32, or one byte: bool / uint8) and element strides, so a
// caller passes a view (a plane of an (H, W, 2) flow field, an int32 label
// image, a bool mask) without a stacked, permuted or converted copy.  A tap
// of an int or byte channel converts to float in registers (labels below
// 2^24 are exact).
//
// Bound: one launch moves < 0.3 MB at the main path's shapes, so the kernel
// sits at the launch floor (about 2 us on the device); a call's cost is the
// host's.  Design: one thread per point (uv loaded as one float2), one pass
// over the channels with the channel loop unrolled so every parameter read
// is static, and a C launcher that takes two pointers — a per-call block
// (N, uv, valid, out, stream, channel pointers) and a per-layout block that
// the wrapper builds once per (modes, dtypes, strides) — so the host call
// converts two arguments and fills one struct passed by value.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_CHANNELS = 8;
enum : int { F32 = 0, I32 = 1, U8 = 2 };

struct Params {
  const void* base[MAX_CHANNELS];
  long long sy[MAX_CHANNELS], sx[MAX_CHANNELS];  // element strides
  int dtype[MAX_CHANNELS];
  int C, H, W, N, nearest_mask;
  const float2* uv;
  const uint8_t* valid;  // null: every row valid
  float* out;
};

// One channel's sample at taps given as element offsets; the four bilinear
// loads are issued together, in the channel's own type.
template <typename T>
__device__ __forceinline__ float sample(const void* base, bool nearest, long long on,
                                        long long o00, long long o01, long long o10,
                                        long long o11, float fx, float fy) {
  const T* img = static_cast<const T*>(base);
  if (nearest) return (float)__ldg(img + on);
  const float v00 = (float)__ldg(img + o00), v01 = (float)__ldg(img + o01);
  const float v10 = (float)__ldg(img + o10), v11 = (float)__ldg(img + o11);
  return v00 * (1.f - fx) * (1.f - fy) + v01 * fx * (1.f - fy) + v10 * (1.f - fx) * fy +
         v11 * fx * fy;
}

// __grid_constant__: the parameter struct is read in place, no local copy
__global__ void point_sample_kernel(const __grid_constant__ Params p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.N) return;
  const float2 q = p.uv[i];  // loaded beside `valid`, not after it
  float* o = p.out + (size_t)i * p.C;
  if (p.valid != nullptr && !p.valid[i]) {
#pragma unroll
    for (int c = 0; c < MAX_CHANNELS; ++c)
      if (c < p.C) o[c] = 0.f;
    return;
  }
  float x = q.x, y = q.y;
  if (x != x) x = 0.f;  // NaN -> 0, the plain version's sanitisation
  if (y != y) y = 0.f;
  // nearest tap: round half to even, then clamp (in float, so huge
  // coordinates never overflow the int conversion)
  const int xn = (int)fminf(fmaxf(rintf(x), 0.f), (float)(p.W - 1));
  const int yn = (int)fminf(fmaxf(rintf(y), 0.f), (float)(p.H - 1));
  // bilinear taps and weights, shared by every bilinear channel
  const float xc = fminf(fmaxf(x, 0.f), (float)(p.W - 1));
  const float yc = fminf(fmaxf(y, 0.f), (float)(p.H - 1));
  const float xf = floorf(xc), yf = floorf(yc);
  const int x0 = (int)xf, y0 = (int)yf;
  const int x1 = min(x0 + 1, p.W - 1), y1 = min(y0 + 1, p.H - 1);
  const float fx = xc - xf, fy = yc - yf;
#pragma unroll
  for (int c = 0; c < MAX_CHANNELS; ++c) {
    if (c >= p.C) break;
    const long long sy = p.sy[c], sx = p.sx[c];
    const bool nearest = (p.nearest_mask >> c) & 1;
    const long long on = yn * sy + xn * sx;
    const long long o00 = y0 * sy + x0 * sx, o01 = y0 * sy + x1 * sx;
    const long long o10 = y1 * sy + x0 * sx, o11 = y1 * sy + x1 * sx;
    switch (p.dtype[c]) {
      case F32: o[c] = sample<float>(p.base[c], nearest, on, o00, o01, o10, o11, fx, fy); break;
      case I32: o[c] = sample<int>(p.base[c], nearest, on, o00, o01, o10, o11, fx, fy); break;
      default: o[c] = sample<unsigned char>(p.base[c], nearest, on, o00, o01, o10, o11, fx, fy);
    }
  }
}

}  // namespace

// call:   [N, uv, valid (0: none), out, stream, channel pointers...]
// layout: [C, H, W, nearest_mask, then per channel (dtype, sy, sx)]
extern "C" int dyno_point_sample(const long long* call, const long long* layout) {
  Params p;
  p.C = (int)layout[0];
  p.H = (int)layout[1];
  p.W = (int)layout[2];
  p.nearest_mask = (int)layout[3];
  p.N = (int)call[0];
  p.uv = reinterpret_cast<const float2*>(call[1]);
  p.valid = reinterpret_cast<const uint8_t*>(call[2]);
  p.out = reinterpret_cast<float*>(call[3]);
  for (int c = 0; c < MAX_CHANNELS; ++c) {
    const bool used = c < p.C;
    p.base[c] = used ? reinterpret_cast<const void*>(call[5 + c]) : nullptr;
    p.dtype[c] = used ? (int)layout[4 + 3 * c] : F32;
    p.sy[c] = used ? layout[5 + 3 * c] : 0;
    p.sx[c] = used ? layout[6 + 3 * c] : 0;
  }
  if (p.N > 0) {
    const int threads = 128;
    const int blocks = (p.N + threads - 1) / threads;
    point_sample_kernel<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(call[4])>>>(p);
  }
  return (int)cudaGetLastError();
}
