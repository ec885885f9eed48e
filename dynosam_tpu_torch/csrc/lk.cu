// K1: one pyramid level of batched Lucas-Kanade.  Replaces the Pallas
// kernel `dynosam_tpu/ops/pallas/lk.py:lk_level` (wrapper
// `klt_track_pallas`; its four TPU schedules `_make_kernel`,
// `_make_kernel_resident`, `_make_kernel_fma` and `_make_kernel_stacked`
// share one contract, ported here once).
//
// Per slot i:
//   * template T = bilinear(prev, p + o) over the win x win offsets o in
//     [-win/2, win/2]^2, gradients by central differences of bilinear
//     samples at o +- 1, the 2x2 structure tensor G and the guard
//     det(G) > 1e-6;
//   * up to `iters` Gauss-Newton steps g += clip(-G^-1 b, -win, win) with
//     b = sum (bilinear(cur, p + g + o) - T) grad; the slot stops after the
//     first step whose squared length is <= eps^2 (eps <= 0: never);
//   * err = mean |bilinear(cur, p + g + o) - T|.
// Every sample clamps its own coordinates (`ops/klt.py:bilinear_sample`);
// the TPU's aligned windows were a means, not the contract.  Inactive slots
// (valid == 0) return g0 and err 0 without touching the images.
//
// Bound: at the main path's shapes (2 x 1.97 MB images, ~1000 active of
// 2048 slots, 10 iterations of 441 samples) the bytes and the ~70 MFLOP
// are both well under a microsecond of the card's rates; what bounds the
// kernel is the latency of a slot's chain of dependent iterations (each
// needs the window's sums before the next position is known).
//
// Design, against that latency:
//   * one warp per slot, WARPS slots per block: every sum is a warp
//     butterfly (`__shfl_xor_sync`), so no iteration waits on a block
//     barrier, and each lane holds the same sums, so the 2x2 solve and the
//     eps exit are warp-uniform; a lane takes taps lane, lane + 32, ...
//     (14 of 441 at win 21) and keeps their T, gx, gy in registers;
//   * all taps of a slot share one fractional part (p plus an integer
//     offset keeps p's fraction), so each sample is four shared-memory
//     reads weighted by per-slot weights.  The template reads a
//     (win+3)^2 tile of `prev` around floor(p); each iteration reads a
//     (win+2M+1)^2 tile of `cur` around the window's warm-start position,
//     restaged, warp-uniformly, only when a step moves the window more than
//     M pixels from the tile's centre.  Both tiles are staged together with
//     cp.async, every copy issued before any is waited on, so staging costs
//     one memory round trip; the cur tile's rows are win + 32 floats apart,
//     so the 32 consecutive taps a warp reads hit 32 banks;
//   * the frontend's window (21) is compiled in, so index arithmetic is by
//     constants; other windows up to 31 take it as an argument;
//   * tiles are staged with clamped (replicated) indices, which reproduces
//     the contract's per-sample clamp up to float rounding: a sample whose
//     coordinate leaves the image reads the border pixel at both taps.
//     Positions are clamped to [-(win/2+2), size+win/2+1] first, which
//     changes no sample (every tap there is already clamped) and keeps the
//     integer arithmetic finite for NaN or huge positions;
//   * a warp of an inactive slot writes g0 and err 0 and exits.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WARPS = 4;    // slots per block
constexpr int MARGIN = 4;   // pixels the window may move before a restage
constexpr int MAX_WIN = 31; // at most 32 taps per lane

// floats of shared memory one warp uses: the prev tile, the template with
// its 1-sample ring, and the cur tile.  The cur tile's rows are win + 32
// floats apart, so the 32 consecutive taps a warp reads fall in 32
// different banks wherever their rows break.
__host__ __device__ inline int warp_floats(int win) {
  const int ts = win + 3, pw = win + 2, tc = win + 2 * MARGIN + 1;
  return ts * ts + pw * pw + tc * (win + 32);
}

// Issue the asynchronous copies (cp.async) of the n x n tile of `img` whose
// top-left pixel is (x0, y0), with clamped (replicated) indices, into rows
// `ld` floats apart; one warp.
// Every lane issues all its copies before `stage_wait`, so tiles cost about
// one memory round trip together rather than one per row.
__device__ __forceinline__ void stage_async(const float* __restrict__ img, int H, int W,
                                            int x0, int y0, int n, int ld, float* __restrict__ s,
                                            int lane) {
  for (int k = lane; k < n * n; k += 32) {
    const int r = k / n, c = k - r * n;
    __pipeline_memcpy_async(s + r * ld + c, img + (size_t)min(max(y0 + r, 0), H - 1) * W + min(max(x0 + c, 0), W - 1),
                            sizeof(float));
  }
}

__device__ __forceinline__ void stage_wait() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();  // the other lanes' copies are visible too
}

// WIN > 0 compiles the window's sizes in (index arithmetic by constants,
// loops of known length); WIN == 0 takes the window as an argument, with
// room for 32 taps per lane (windows up to 31).
template <int WIN>
__global__ void __launch_bounds__(WARPS * 32)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                int H, int W, const float2* __restrict__ p,
                const float2* __restrict__ g0, const uint8_t* __restrict__ valid,
                int N, int win_arg, int iters, float eps2, float2* __restrict__ g_out,
                float* __restrict__ err_out) {
  constexpr int KT = WIN > 0 ? (WIN * WIN + 31) / 32 : 32;  // taps per lane
  const int win = WIN > 0 ? WIN : win_arg;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i >= N) return;
  float2 g = g0[i];
  if (!valid[i]) {
    if (lane == 0) {
      g_out[i] = g;
      err_out[i] = 0.f;
    }
    return;
  }
  const int hw = win / 2, np = win * win;
  const int ts = win + 3, pw = win + 2, tc = win + 2 * MARGIN + 1, ld = win + 32;
  float* s = smem + (threadIdx.x >> 5) * warp_floats(win);
  const float lo = -(float)(hw + 2);
  const float hix = (float)(W + hw + 1), hiy = (float)(H + hw + 1);
  const float2 p0 = p[i];

  float* s_prev = s;                       // (ts, ts): pixels from floor(p) - hw - 1
  float* s_b = s + ts * ts;                // (pw, pw): samples at p + (c - hw - 1, r - hw - 1)
  float* s_cur = s + ts * ts + pw * pw;    // (tc, tc), rows ld apart: pixels from (cx, cy) - hw - MARGIN

  // the window's integer position at p + g (clamped as described above)
  auto position = [&](float& qx, float& qy) {
    qx = fminf(fmaxf(p0.x + g.x, lo), hix);
    qy = fminf(fmaxf(p0.y + g.y, lo), hiy);
  };
  float qx, qy;
  position(qx, qy);
  int cx = (int)floorf(qx), cy = (int)floorf(qy);  // the cur tile's centre

  // ---- both tiles in one round trip; then the template and gradients
  {
    const float px = fminf(fmaxf(p0.x, lo), hix), py = fminf(fmaxf(p0.y, lo), hiy);
    const float xf = floorf(px), yf = floorf(py);
    const float fx = px - xf, fy = py - yf;
    stage_async(prev, H, W, (int)xf - hw - 1, (int)yf - hw - 1, ts, ts, s_prev, lane);
    stage_async(cur, H, W, cx - hw - MARGIN, cy - hw - MARGIN, tc, ld, s_cur, lane);
    stage_wait();
    const float w00 = (1.f - fx) * (1.f - fy), w01 = fx * (1.f - fy);
    const float w10 = (1.f - fx) * fy, w11 = fx * fy;
    for (int k = lane; k < pw * pw; k += 32) {
      const int r = k / pw, c = k - r * pw;
      const float* q = s_prev + r * ts + c;
      s_b[k] = w00 * q[0] + w01 * q[1] + w10 * q[ts] + w11 * q[ts + 1];
    }
    __syncwarp();
  }
  float t[KT], gx[KT], gy[KT];
  int off[KT];  // the tap's offset in the cur tile: r * ld + c
  float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int tap = lane + 32 * k;
    t[k] = gx[k] = gy[k] = 0.f;  // taps past the window add nothing
    off[k] = 0;
    if (tap < np) {
      const int r = tap / win, c = tap - r * win;
      const float* b = s_b + (r + 1) * pw + (c + 1);
      t[k] = b[0];
      gx[k] = (b[1] - b[-1]) * 0.5f;
      gy[k] = (b[pw] - b[-pw]) * 0.5f;
      off[k] = r * ld + c;
      sxx += gx[k] * gx[k];
      sxy += gx[k] * gy[k];
      syy += gy[k] * gy[k];
    }
  }
  const float gxx = dyno::warp_sum(sxx), gxy = dyno::warp_sum(sxy), gyy = dyno::warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const bool inv_ok = det > 1e-6f;
  const float inv_det = inv_ok ? 1.f / det : 0.f;  // no division in the loop
  const float wf = (float)win;

  // sample the window at p + g: per-slot weights and the cur tile's base
  // offset; a step that moved the window more than MARGIN pixels from the
  // tile's centre restages the tile around it (warp-uniform)
  auto locate = [&](float& w00, float& w01, float& w10, float& w11) -> const float* {
    position(qx, qy);
    const float xf = floorf(qx), yf = floorf(qy);
    const int ix = (int)xf, iy = (int)yf;
    if (abs(ix - cx) > MARGIN || abs(iy - cy) > MARGIN) {
      __syncwarp();  // every lane is done with the old tile
      cx = ix;
      cy = iy;
      stage_async(cur, H, W, cx - hw - MARGIN, cy - hw - MARGIN, tc, ld, s_cur, lane);
      stage_wait();
    }
    const float fx = qx - xf, fy = qy - yf;
    w00 = (1.f - fx) * (1.f - fy);
    w01 = fx * (1.f - fy);
    w10 = (1.f - fx) * fy;
    w11 = fx * fy;
    return s_cur + (iy - cy + MARGIN) * ld + (ix - cx + MARGIN);
  };

  for (int it = 0; it < iters; ++it) {
    float w00, w01, w10, w11;
    const float* base = locate(w00, w01, w10, w11);
    float b0 = 0.f, b1 = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const float* q = base + off[k];
      const float res = w00 * q[0] + w01 * q[1] + w10 * q[ld] + w11 * q[ld + 1] - t[k];
      b0 += res * gx[k];
      b1 += res * gy[k];
    }
    b0 = dyno::warp_sum(b0);
    b1 = dyno::warp_sum(b1);
    const float du = fminf(fmaxf(-(gyy * b0 - gxy * b1) * inv_det, -wf), wf);
    const float dv = fminf(fmaxf(-(-gxy * b0 + gxx * b1) * inv_det, -wf), wf);
    g.x += du;
    g.y += dv;
    // every lane holds the same sums, so the exit is warp-uniform
    if (eps2 > 0.f && du * du + dv * dv <= eps2) break;
  }

  float w00, w01, w10, w11;
  const float* base = locate(w00, w01, w10, w11);
  float e = 0.f;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (lane + 32 * k < np) {
      const float* q = base + off[k];
      e += fabsf(w00 * q[0] + w01 * q[1] + w10 * q[ld] + w11 * q[ld + 1] - t[k]);
    }
  }
  e = dyno::warp_sum(e);
  if (lane == 0) {
    g_out[i] = g;
    err_out[i] = e / (float)np;
  }
}

}  // namespace

extern "C" int dyno_lk_level(const float* prev, const float* cur, int H, int W,
                             const float* p, const float* g0,
                             const uint8_t* valid, int N, int win, int iters,
                             float eps, float* g_out, float* err_out,
                             void* stream) {
  if (win < 1 || win > MAX_WIN) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    const float eps2 = eps > 0.f ? eps * eps : 0.f;
    const int blocks = (N + WARPS - 1) / WARPS;
    // 43,120 bytes at win 21; 76,240 at win 31
    const int smem = WARPS * warp_floats(win) * (int)sizeof(float);
    const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const auto* p2 = reinterpret_cast<const float2*>(p);
    const auto* g02 = reinterpret_cast<const float2*>(g0);
    auto* go2 = reinterpret_cast<float2*>(g_out);
    if (win == 21) {  // the frontend's window (`TrackerConfig.klt_window`)
      lk_level_kernel<21><<<blocks, WARPS * 32, smem, st>>>(
          prev, cur, H, W, p2, g02, valid, N, win, iters, eps2, go2, err_out);
    } else {
      // windows above 21 need more than the default 48 KB per block
      static const cudaError_t raised = cudaFuncSetAttribute(
          lk_level_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          WARPS * warp_floats(MAX_WIN) * (int)sizeof(float));
      if (raised != cudaSuccess) return (int)raised;
      lk_level_kernel<0><<<blocks, WARPS * 32, smem, st>>>(
          prev, cur, H, W, p2, g02, valid, N, win, iters, eps2, go2, err_out);
    }
  }
  return (int)cudaGetLastError();
}
