// K4: ORB orientation and steered-BRIEF sampling at N keypoints of a
// canvas.  Replaces the Pallas kernel `dynosam_tpu/ops/pallas/orb_sample.py`
// (`orb_orientation_descriptors`, body `_make_kernel`).
//
// Per keypoint (x, y) in canvas pixels:
//   m10, m01 = sum over the 31x31 offsets (ox, oy) inside the radius-15 disc
//              of raw[clip(rint(y) + oy), clip(rint(x) + ox)] * (ox, oy);
//   angle    = atan2(m01, m10);
//   (ca, sa) = (m10, m01) / |(m10, m01)|, or (1, 0) when that is 0;
//   tap k    = (x, y) + R(ca, sa) * taps[k], bilinear on the blurred canvas
//              with the coordinates clipped to it (k < 256: the a taps,
//              k >= 256: the b taps of the BRIEF pairs);
//   bit j    = +1 where tap j < tap j + 256, else -1.
//
// Arithmetic is float32 with no fused multiply-adds (`__f*_rn`), and the
// moment sums run in a fixed order that the plain version
// (`kernels/orb_sample.py:_kernel_order_sum`) repeats: thread t adds
// elements t, t+256, t+512, t+768 of the zero-padded 1024 offsets; a shuffle
// butterfly sums each warp; warp sums are added in warp order.
//
// Bound: bytes.  A frame's call reads the distinct disc and tap pixels of
// its keypoints (a few MB from L2-resident canvases) and writes 257 bytes
// per keypoint.  Design: one 256-thread block per keypoint, one thread per
// BRIEF pair.  The disc is read straight from global memory (each pixel
// once, row segments coalesced); the blurred 29x29 window around the
// keypoint is staged in shared memory, clamped at the canvas edge, and
// serves the 2048 bilinear reads of the 512 taps.  Rotated taps reach at
// most 12 px (`_PATTERN_CLIP`) plus the +1 bilinear neighbour and float
// slack, so a +-14 px window holds every read.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kHalf = 15;
constexpr int kSide = 2 * kHalf + 1;        // 31
constexpr int kDisc = kSide * kSide;        // 961 offsets
constexpr int kThreads = 256;               // one per BRIEF pair
constexpr int kStrides = 4;                 // 4 * 256 >= 961
constexpr int kWarps = kThreads / 32;
constexpr int kWinR = 14;
constexpr int kWin = 2 * kWinR + 1;         // 29

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

__device__ __forceinline__ float clampf(float v, float hi) { return fminf(fmaxf(v, 0.f), hi); }

// Butterfly sum of a warp; every lane receives lane-pair sums in the order
// x[l] + x[l ^ o] for o = 16, 8, 4, 2, 1.
__device__ __forceinline__ float warp_butterfly(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Bilinear sample from the staged window, as `point_sample.bilinear_gather`:
// clip, floor, +1 neighbour clamped to the canvas, the four products in
// order.  (x0w, y0w) is the canvas pixel of window entry (0, 0).
__device__ __forceinline__ float window_bilinear(const float* win, int x0w, int y0w, int H, int W,
                                                 float x, float y) {
  x = clampf(x, (float)(W - 1));
  y = clampf(y, (float)(H - 1));
  const float xf = floorf(x), yf = floorf(y);
  const int x0 = (int)xf, y0 = (int)yf;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float fx = __fsub_rn(x, xf), fy = __fsub_rn(y, yf);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const int c0 = clampi(x0 - x0w, 0, kWin - 1), c1 = clampi(x1 - x0w, 0, kWin - 1);
  const int r0 = clampi(y0 - y0w, 0, kWin - 1), r1 = clampi(y1 - y0w, 0, kWin - 1);
  const float t00 = __fmul_rn(__fmul_rn(win[r0 * kWin + c0], gx), gy);
  const float t01 = __fmul_rn(__fmul_rn(win[r0 * kWin + c1], fx), gy);
  const float t10 = __fmul_rn(__fmul_rn(win[r1 * kWin + c0], gx), fy);
  const float t11 = __fmul_rn(__fmul_rn(win[r1 * kWin + c1], fx), fy);
  return __fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11);
}

__global__ void __launch_bounds__(kThreads)
    orb_sample_kernel(const float* __restrict__ raw, const float* __restrict__ blur, int H, int W,
                      const float* __restrict__ uv, const float* __restrict__ taps,
                      float* __restrict__ angle, int8_t* __restrict__ desc) {
  __shared__ float win[kWin * kWin];
  __shared__ float part[2][kWarps];
  const int i = blockIdx.x;
  const int t = threadIdx.x;
  float px = uv[2 * i], py = uv[2 * i + 1];
  if (px != px) px = 0.f;  // NaN -> 0, the plain version's sanitisation
  if (py != py) py = 0.f;

  // stage the blurred window around the clipped keypoint (independent of
  // the moments, so its loads overlap them)
  const int x0w = (int)floorf(clampf(px, (float)(W - 1))) - kWinR;
  const int y0w = (int)floorf(clampf(py, (float)(H - 1))) - kWinR;
  for (int e = t; e < kWin * kWin; e += kThreads) {
    const int gy = clampi(y0w + e / kWin, 0, H - 1);
    const int gx = clampi(x0w + e % kWin, 0, W - 1);
    win[e] = __ldg(blur + (size_t)gy * W + gx);
  }

  // intensity-centroid moments; padded offsets (e >= 961) read the centre
  // with weight 0, as the plain version's zero-padded tables do
  const float xr = rintf(px), yr = rintf(py);
  float m10 = 0.f, m01 = 0.f;
#pragma unroll
  for (int k = 0; k < kStrides; ++k) {
    const int e = t + k * kThreads;
    int ox = 0, oy = 0;
    float wx = 0.f, wy = 0.f;
    if (e < kDisc) {
      oy = e / kSide - kHalf;
      ox = e % kSide - kHalf;
      if (ox * ox + oy * oy <= kHalf * kHalf) {
        wx = (float)ox;
        wy = (float)oy;
      }
    }
    const int r = (int)clampf(__fadd_rn(yr, (float)oy), (float)(H - 1));
    const int c = (int)clampf(__fadd_rn(xr, (float)ox), (float)(W - 1));
    const float v = __ldg(raw + (size_t)r * W + c);
    const float p10 = __fmul_rn(v, wx), p01 = __fmul_rn(v, wy);
    m10 = (k == 0) ? p10 : __fadd_rn(m10, p10);
    m01 = (k == 0) ? p01 : __fadd_rn(m01, p01);
  }
  m10 = warp_butterfly(m10);
  m01 = warp_butterfly(m01);
  if ((t & 31) == 0) {
    part[0][t >> 5] = m10;
    part[1][t >> 5] = m01;
  }
  __syncthreads();  // also publishes the staged window
  m10 = part[0][0];
  m01 = part[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    m10 = __fadd_rn(m10, part[0][w]);
    m01 = __fadd_rn(m01, part[1][w]);
  }

  const float rr = __fsqrt_rn(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)));
  const bool r_ok = rr > 0.f;
  const float ca = r_ok ? __fdiv_rn(m10, rr) : 1.f;
  const float sa = r_ok ? __fdiv_rn(m01, rr) : 0.f;
  if (t == 0) angle[i] = atan2f(m01, m10);

  // this thread's BRIEF pair: tap t (a) against tap t + 256 (b)
  float v[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float ox = __ldg(taps + 2 * (t + s * kThreads));
    const float oy = __ldg(taps + 2 * (t + s * kThreads) + 1);
    const float tx = __fsub_rn(__fadd_rn(px, __fmul_rn(ca, ox)), __fmul_rn(sa, oy));
    const float ty = __fadd_rn(__fadd_rn(py, __fmul_rn(sa, ox)), __fmul_rn(ca, oy));
    v[s] = window_bilinear(win, x0w, y0w, H, W, tx, ty);
  }
  desc[(size_t)i * kThreads + t] = (v[0] < v[1]) ? int8_t(1) : int8_t(-1);
}

}  // namespace

extern "C" int dyno_orb_sample(const float* raw, const float* blur, int H, int W, const float* uv,
                               int N, const float* taps, float* angle, int8_t* desc,
                               void* stream) {
  if (N > 0) {
    orb_sample_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(raw, blur, H, W, uv, taps,
                                                                angle, desc);
  }
  return (int)cudaGetLastError();
}
