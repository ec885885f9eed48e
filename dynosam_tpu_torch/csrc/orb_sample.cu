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
// (`kernels/orb_sample.py:_kernel_order_sum`) repeats: lane l owns disc
// column ox = l - 15 (lane 31 holds column 16, all weight 0) and adds its
// 31 rows top to bottom; a shuffle butterfly then sums the 32 lanes.
//
// Bound: bytes.  A frame's call reads the distinct disc and tap pixels of
// its keypoints (a few MB from L2-resident canvases) and writes 257 bytes
// per keypoint, about 2 us of the card's bandwidth at 2000 keypoints.  What
// holds a kernel of this size back is latency: each keypoint is a short
// chain (disc loads, moments, rotation, taps, store).  Design, against it:
//   * one warp per keypoint, WARPS keypoints per block, so a frame's 2000
//     keypoints are resident in one wave (500 blocks, 12 fit on an SM) and
//     every reduction is a warp butterfly;
//   * the disc's 31 rows are 31 independent coalesced row loads, one column
//     per lane, all in flight together;
//   * before them, the warp issues cp.async copies of the blurred 29x29
//     window around the keypoint (one row per copy round, lane = column,
//     rows 29 floats apart, which is odd, so a row's copies and the taps'
//     reads spread over the banks) and the block copies the 512 pattern taps
//     into shared memory once; the one block barrier comes after the
//     moments, so the copies overlap them;
//   * lane l takes the BRIEF pairs l + 32 j, j = 0..7, and the 256 bytes go
//     out as 8 coalesced 32-byte warp stores.
// Rotated taps reach at most 12 px (`_PATTERN_CLIP`) plus the +1 bilinear
// neighbour and float slack, so the +-14 px window holds every read.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHalf = 15;
constexpr int kRows = 2 * kHalf + 1;        // 31 disc rows
constexpr int kWarps = 4;                   // keypoints per block
constexpr int kThreads = 32 * kWarps;
constexpr int kPairs = 256;
constexpr int kTaps = 2 * kPairs;           // 512: the a taps, then the b taps
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
                      const float* __restrict__ uv, int N, const float* __restrict__ taps,
                      float* __restrict__ angle, int8_t* __restrict__ desc) {
  __shared__ __align__(16) float2 s_taps[kTaps];
  __shared__ float s_win[kWarps][kWin * kWin];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + wid;
  const bool live = i < N;  // warps past N compute at (0, 0) and store nothing

  // the pattern taps, 16 bytes per copy
  for (int e = threadIdx.x; e < kTaps / 2; e += kThreads)
    __pipeline_memcpy_async(&s_taps[2 * e], taps + 4 * e, 16);

  float px = live ? uv[2 * i] : 0.f, py = live ? uv[2 * i + 1] : 0.f;
  if (px != px) px = 0.f;  // NaN -> 0, the plain version's sanitisation
  if (py != py) py = 0.f;

  // the blurred window around the clipped keypoint, lane = column
  float* win = s_win[wid];
  const int x0w = (int)floorf(clampf(px, (float)(W - 1))) - kWinR;
  const int y0w = (int)floorf(clampf(py, (float)(H - 1))) - kWinR;
  if (lane < kWin) {
    const float* col = blur + clampi(x0w + lane, 0, W - 1);
#pragma unroll 4
    for (int r = 0; r < kWin; ++r)
      __pipeline_memcpy_async(win + r * kWin + lane, col + (size_t)clampi(y0w + r, 0, H - 1) * W,
                              sizeof(float));
  }
  __pipeline_commit();

  // intensity-centroid moments: lane l owns column ox = l - 15 of the disc
  const float xr = rintf(px), yr = rintf(py);
  const int ox = lane - kHalf;
  const float* col = raw + (int)clampf(__fadd_rn(xr, (float)ox), (float)(W - 1));
  float v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    v[k] = __ldg(col + (size_t)(int)clampf(__fadd_rn(yr, (float)(k - kHalf)), (float)(H - 1)) * W);
  float m10 = 0.f, m01 = 0.f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int oy = k - kHalf;
    const bool in = ox * ox + oy * oy <= kHalf * kHalf;
    const float p10 = __fmul_rn(v[k], in ? (float)ox : 0.f);
    const float p01 = __fmul_rn(v[k], in ? (float)oy : 0.f);
    m10 = (k == 0) ? p10 : __fadd_rn(m10, p10);
    m01 = (k == 0) ? p01 : __fadd_rn(m01, p01);
  }
  m10 = warp_butterfly(m10);
  m01 = warp_butterfly(m01);

  const float rr = __fsqrt_rn(__fadd_rn(__fmul_rn(m10, m10), __fmul_rn(m01, m01)));
  const bool r_ok = rr > 0.f;
  const float ca = r_ok ? __fdiv_rn(m10, rr) : 1.f;
  const float sa = r_ok ? __fdiv_rn(m01, rr) : 0.f;

  __pipeline_wait_prior(0);
  __syncthreads();  // the taps and every warp's window are in shared memory
  if (!live) return;
  if (lane == 0) angle[i] = atan2f(m01, m10);

  // BRIEF pairs lane + 32 j: tap a = pair, tap b = pair + 256
  int8_t* out = desc + (size_t)i * kPairs;
#pragma unroll
  for (int j = 0; j < kPairs / 32; ++j) {
    const int k = lane + 32 * j;
    float s[2];
#pragma unroll
    for (int ab = 0; ab < 2; ++ab) {
      const float2 o = s_taps[k + ab * kPairs];
      const float tx = __fsub_rn(__fadd_rn(px, __fmul_rn(ca, o.x)), __fmul_rn(sa, o.y));
      const float ty = __fadd_rn(__fadd_rn(py, __fmul_rn(sa, o.x)), __fmul_rn(ca, o.y));
      s[ab] = window_bilinear(win, x0w, y0w, H, W, tx, ty);
    }
    out[k] = (s[0] < s[1]) ? int8_t(1) : int8_t(-1);
  }
}

}  // namespace

extern "C" int dyno_orb_sample(const float* raw, const float* blur, int H, int W, const float* uv,
                               int N, const float* taps, float* angle, int8_t* desc,
                               void* stream) {
  if (N > 0) {
    orb_sample_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
        raw, blur, H, W, uv, N, taps, angle, desc);
  }
  return (int)cudaGetLastError();
}
