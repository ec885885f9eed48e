// K3: fused Shi-Tomasi (minimum-eigenvalue) corner response of a (H, W)
// float image.  Replaces the Pallas kernel
// `dynosam_tpu/ops/pallas/response.py:shi_tomasi_response_pallas`
// (body `_response_kernel`) and reproduces the frontend's XLA form
// `frontend/detect.py:shi_tomasi_response_fast` everywhere, borders included:
//   * Sobel x 1/8 on the edge-replicated image (`detect.py:_shift`);
//   * products Ixx, Iyy, Ixy;
//   * 5x5 box sums with the products taken as ZERO outside the image,
//     divided by 25 (what `_box_sum`'s integral image computes — the Pallas
//     body edge-replicates here instead, so it agrees only in the interior);
//   * lambda_min = 0.5 (tr - sqrt((sxx - syy)^2 + 4 sxy^2)).
//
// Bound: bytes — one read and one write per pixel (3.9 MB at 384x1280).
// Design: one 32x16 output tile per block with a 3-pixel halo of the image
// in shared memory (1 for Sobel + 2 for the box); the gradient products of
// the 2-pixel halo ring are formed once in shared memory, so no
// intermediate image ever reaches device memory.
#include "common.cuh"

namespace {

constexpr int TW = 32, TH = 16;        // output tile
constexpr int IW = TW + 6, IH = TH + 6;  // image tile, 3-pixel halo
constexpr int PW = TW + 4, PH = TH + 4;  // product tile, 2-pixel halo

__global__ void __launch_bounds__(256)
shi_tomasi_kernel(const float* __restrict__ img, int H, int W,
                  float* __restrict__ out) {
  __shared__ float s_img[IH][IW];
  __shared__ float s_xx[PH][PW], s_yy[PH][PW], s_xy[PH][PW];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // edge-replicated image tile (Sobel's boundary rule)
  for (int k = tid; k < IH * IW; k += nthr) {
    const int ly = k / IW, lx = k % IW;
    const int gy = min(max(y0 - 3 + ly, 0), H - 1);
    const int gx = min(max(x0 - 3 + lx, 0), W - 1);
    s_img[ly][lx] = __ldg(img + (size_t)gy * W + gx);
  }
  __syncthreads();

  // gradient products on the product tile; zero outside the image (the
  // box sum's boundary rule)
  for (int k = tid; k < PH * PW; k += nthr) {
    const int ly = k / PW, lx = k % PW;
    const int gy = y0 - 2 + ly, gx = x0 - 2 + lx;
    float pxx = 0.f, pyy = 0.f, pxy = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int iy = ly + 1, ix = lx + 1;  // centre in s_img
      const float tl = s_img[iy - 1][ix - 1], tc = s_img[iy - 1][ix],
                  tr = s_img[iy - 1][ix + 1];
      const float ml = s_img[iy][ix - 1], mr = s_img[iy][ix + 1];
      const float bl = s_img[iy + 1][ix - 1], bc = s_img[iy + 1][ix],
                  br = s_img[iy + 1][ix + 1];
      const float gxv = ((tr + 2.f * mr + br) - (tl + 2.f * ml + bl)) / 8.f;
      const float gyv = ((bl + 2.f * bc + br) - (tl + 2.f * tc + tr)) / 8.f;
      pxx = gxv * gxv;
      pyy = gyv * gyv;
      pxy = gxv * gyv;
    }
    s_xx[ly][lx] = pxx;
    s_yy[ly][lx] = pyy;
    s_xy[ly][lx] = pxy;
  }
  __syncthreads();

  for (int k = tid; k < TH * TW; k += nthr) {
    const int ly = k / TW, lx = k % TW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= H || gx >= W) continue;
    float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
    for (int dy = 0; dy < 5; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 5; ++dx) {
        sxx += s_xx[ly + dy][lx + dx];
        syy += s_yy[ly + dy][lx + dx];
        sxy += s_xy[ly + dy][lx + dx];
      }
    }
    sxx /= 25.f;
    syy /= 25.f;
    sxy /= 25.f;
    const float d = sxx - syy;
    const float rad = sqrtf(fmaxf(d * d + 4.f * sxy * sxy, 0.f));
    out[(size_t)gy * W + gx] = 0.5f * ((sxx + syy) - rad);
  }
}

}  // namespace

extern "C" int dyno_shi_tomasi(const float* img, int H, int W, float* out,
                               void* stream) {
  if (H > 0 && W > 0) {
    const dim3 threads(32, 8);
    const dim3 blocks((W + TW - 1) / TW, (H + TH - 1) / TH);
    shi_tomasi_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(img, H, W,
                                                                     out);
  }
  return (int)cudaGetLastError();
}
