// K1: one pyramid level of batched Lucas-Kanade.  Replaces the Pallas
// kernel `dynosam_tpu/ops/pallas/lk.py:lk_level` (wrapper
// `klt_track_pallas`; its four TPU schedules `_make_kernel`,
// `_make_kernel_resident`, `_make_kernel_fma` and `_make_kernel_stacked`
// share one contract, ported here once).
//
// Per slot i (one thread block each):
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
// 2048 slots, 10 iterations of 441 samples) both the bytes and the ~70
// MFLOP are microseconds of work; the kernel is bound by the latency of
// its dependent iterations (each needs a block reduction before the next
// position is known).  Design: the template and its gradients live in
// shared memory for the whole loop, each iteration re-samples the current
// image from L2 (both images are L2-resident), and one block per slot keeps
// the per-slot loop free of any cross-block coordination.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                int H, int W, const float* __restrict__ p,
                const float* __restrict__ g0, const uint8_t* __restrict__ valid,
                int win, int iters, float eps2, float* __restrict__ g_out,
                float* __restrict__ err_out) {
  extern __shared__ float smem[];
  __shared__ float red[3 * 32];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  float gu = g0[2 * i], gv = g0[2 * i + 1];
  if (!valid[i]) {
    if (tid == 0) {
      g_out[2 * i] = gu;
      g_out[2 * i + 1] = gv;
      err_out[i] = 0.f;
    }
    return;
  }
  const float px = p[2 * i], py = p[2 * i + 1];
  const int hw = win / 2, pw = win + 2, np = win * win;
  float* s_b = smem;             // (pw, pw) template with a 1-sample ring
  float* s_t = s_b + pw * pw;    // (win, win) template
  float* s_gx = s_t + np;        // (win, win) x gradient
  float* s_gy = s_gx + np;       // (win, win) y gradient

  for (int k = tid; k < pw * pw; k += blockDim.x) {
    const int r = k / pw, c = k % pw;
    s_b[k] = dyno::bilinear_clamped(prev, H, W, px + (float)(c - hw - 1),
                                    py + (float)(r - hw - 1));
  }
  __syncthreads();

  float acc[3] = {0.f, 0.f, 0.f};
  for (int k = tid; k < np; k += blockDim.x) {
    const int r = k / win + 1, c = k % win + 1;
    const float gx = (s_b[r * pw + c + 1] - s_b[r * pw + c - 1]) * 0.5f;
    const float gy = (s_b[(r + 1) * pw + c] - s_b[(r - 1) * pw + c]) * 0.5f;
    s_t[k] = s_b[r * pw + c];
    s_gx[k] = gx;
    s_gy[k] = gy;
    acc[0] += gx * gx;
    acc[1] += gx * gy;
    acc[2] += gy * gy;
  }
  dyno::block_sum<3>(acc, red);  // also orders the s_t/s_gx/s_gy writes
  const float gxx = acc[0], gxy = acc[1], gyy = acc[2];
  const float det = gxx * gyy - gxy * gxy;
  const bool inv_ok = det > 1e-6f;
  const float det_safe = inv_ok ? det : 1.f;
  const float wf = (float)win;

  for (int it = 0; it < iters; ++it) {
    const float cx = px + gu, cy = py + gv;
    float b[2] = {0.f, 0.f};
    for (int k = tid; k < np; k += blockDim.x) {
      const int r = k / win, c = k % win;
      const float s = dyno::bilinear_clamped(cur, H, W, cx + (float)(c - hw),
                                             cy + (float)(r - hw));
      const float res = s - s_t[k];
      b[0] += res * s_gx[k];
      b[1] += res * s_gy[k];
    }
    dyno::block_sum<2>(b, red);
    float du = -(gyy * b[0] - gxy * b[1]) / det_safe;
    float dv = -(-gxy * b[0] + gxx * b[1]) / det_safe;
    du = inv_ok ? fminf(fmaxf(du, -wf), wf) : 0.f;
    dv = inv_ok ? fminf(fmaxf(dv, -wf), wf) : 0.f;
    gu += du;
    gv += dv;
    // every thread holds identical values, so the exit is block-uniform
    if (eps2 > 0.f && du * du + dv * dv <= eps2) break;
  }

  const float cx = px + gu, cy = py + gv;
  float e[1] = {0.f};
  for (int k = tid; k < np; k += blockDim.x) {
    const int r = k / win, c = k % win;
    const float s = dyno::bilinear_clamped(cur, H, W, cx + (float)(c - hw),
                                           cy + (float)(r - hw));
    e[0] += fabsf(s - s_t[k]);
  }
  dyno::block_sum<1>(e, red);
  if (tid == 0) {
    g_out[2 * i] = gu;
    g_out[2 * i + 1] = gv;
    err_out[i] = e[0] / (float)np;
  }
}

}  // namespace

extern "C" int dyno_lk_smem_bytes(int win) {
  const int pw = win + 2;
  return (pw * pw + 3 * win * win) * (int)sizeof(float);
}

extern "C" int dyno_lk_level(const float* prev, const float* cur, int H, int W,
                             const float* p, const float* g0,
                             const uint8_t* valid, int N, int win, int iters,
                             float eps, float* g_out, float* err_out,
                             void* stream) {
  if (N > 0) {
    const float eps2 = eps > 0.f ? eps * eps : 0.f;
    lk_level_kernel<<<N, THREADS, dyno_lk_smem_bytes(win), (cudaStream_t)stream>>>(
        prev, cur, H, W, p, g0, valid, win, iters, eps2, g_out, err_out);
  }
  return (int)cudaGetLastError();
}
