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
// Every operation is the plain version's (`kernels/response.py`) as
// PyTorch runs it on the card, in its order and without fused
// multiply-adds (`__f*_rn`): the box sums are separable, the vertical
// 5-sum of each product column first (rows ascending), then the horizontal
// 5-sum (columns ascending), so on the card the two agree bit for bit.
//
// Bound: bytes — one read and one write per pixel (3.9 MB at 384x1280,
// 1.2 us).  What costs time is the arithmetic and data movement per
// pixel: Sobel, three products and 3 x 24 box-sum adds.  Design: one warp
// walks down a strip of STRIP output rows, lane l owning product column
// x0 - 2 + l of the warp's band.  Each step reads one image row (three
// coalesced loads, the lane's column and its two neighbours; the rows
// above stay in registers), forms the lane's three products once, keeps
// the last five product rows in a register ring for the vertical sums,
// and takes the horizontal sums over lanes l..l+4 with four shuffles, so
// lanes 0..27 each finish one output pixel per step.  No shared memory,
// no block barrier, about 5 shuffles or loads per output and channel.
// The strips are 8 rows (4
// more product rows of halo per strip, 1.5x) so that the frame's 384x1280
// gives 2,208 warps, about 17 resident per SM, to hide load latency.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr int OUT_COLS = LANES - 4;   // lanes 0..27 finish an output pixel
constexpr int STRIP = 8;              // output rows per warp
constexpr int WARPS = 4;              // warps per block, stacked vertically
// `/ 25` as PyTorch divides a CUDA tensor by a Python scalar: times the
// reciprocal rounded to float
constexpr float kInv25 = 1.f / 25.f;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// (a + 2 b) + c, as the plain version's `a + 2.0 * b + c`
__device__ __forceinline__ float tap3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, __fmul_rn(2.f, b)), c);
}

// sum of v over lanes l..l+4, in that order (lanes past 31 read their own
// value; their sums are not used)
__device__ __forceinline__ float sum5_lanes(float v) {
  float s = v;
#pragma unroll
  for (int d = 1; d <= 4; ++d) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, v, d));
  return s;
}

__global__ void __launch_bounds__(WARPS * LANES)
shi_tomasi_kernel(const float* __restrict__ img, int H, int W, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int x0 = blockIdx.x * OUT_COLS;                          // the band's first output column
  const int y0 = (blockIdx.y * WARPS + threadIdx.y) * STRIP;     // this warp's first output row
  if (y0 >= H) return;                                           // warp-uniform
  const int pc = x0 - 2 + lane;                                  // this lane's product column
  const bool col_in = pc >= 0 && pc < W;
  const float* cl = img + clampi(pc - 1, 0, W - 1);
  const float* cc = img + clampi(pc, 0, W - 1);
  const float* cr = img + clampi(pc + 1, 0, W - 1);
  auto row = [&](int y) { return (size_t)clampi(y, 0, H - 1) * W; };

  // rolling 3x3 neighbourhood of the edge-replicated image (top, mid, bot
  // rows; the centre pixel has weight 0 and is kept only as it moves up)
  size_t o = row(y0 - 3);
  float tl = __ldg(cl + o), tc = __ldg(cc + o), tr = __ldg(cr + o);
  o = row(y0 - 2);
  float ml = __ldg(cl + o), mc = __ldg(cc + o), mr = __ldg(cr + o);
  float rxx[5] = {}, ryy[5] = {}, rxy[5] = {};  // the last five product rows, oldest first

#pragma unroll
  for (int k = 0; k < STRIP + 4; ++k) {
    const int pr = y0 - 2 + k;  // product row of this step
    o = row(pr + 1);
    const float bl = __ldg(cl + o), bc = __ldg(cc + o), br = __ldg(cr + o);
    float pxx = 0.f, pyy = 0.f, pxy = 0.f;  // zero outside the image
    if (col_in && pr >= 0 && pr < H) {
      const float ix = __fmul_rn(__fsub_rn(tap3(tr, mr, br), tap3(tl, ml, bl)), 0.125f);
      const float iy = __fmul_rn(__fsub_rn(tap3(bl, bc, br), tap3(tl, tc, tr)), 0.125f);
      pxx = __fmul_rn(ix, ix);
      pyy = __fmul_rn(iy, iy);
      pxy = __fmul_rn(ix, iy);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rxx[j] = rxx[j + 1];
      ryy[j] = ryy[j + 1];
      rxy[j] = rxy[j + 1];
    }
    rxx[4] = pxx;
    ryy[4] = pyy;
    rxy[4] = pxy;
    tl = ml; tc = mc; tr = mr;
    ml = bl; mc = bc; mr = br;
    if (k < 4) continue;  // the ring fills

    // vertical 5-sums (rows ascending), then horizontal over lanes l..l+4
    float vxx = rxx[0], vyy = ryy[0], vxy = rxy[0];
#pragma unroll
    for (int j = 1; j < 5; ++j) {
      vxx = __fadd_rn(vxx, rxx[j]);
      vyy = __fadd_rn(vyy, ryy[j]);
      vxy = __fadd_rn(vxy, rxy[j]);
    }
    const float sxx = __fmul_rn(sum5_lanes(vxx), kInv25);
    const float syy = __fmul_rn(sum5_lanes(vyy), kInv25);
    const float sxy = __fmul_rn(sum5_lanes(vxy), kInv25);
    const int y = pr - 2, x = x0 + lane;
    if (lane < OUT_COLS && x < W && y < H) {
      const float d = __fsub_rn(sxx, syy);
      const float q = __fadd_rn(__fmul_rn(d, d), __fmul_rn(__fmul_rn(4.f, sxy), sxy));
      const float rad = __fsqrt_rn(fmaxf(q, 0.f));
      out[(size_t)y * W + x] = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(sxx, syy), rad));
    }
  }
}

}  // namespace

extern "C" int dyno_shi_tomasi(const float* img, int H, int W, float* out,
                               void* stream) {
  if (H > 0 && W > 0) {
    const dim3 threads(LANES, WARPS);
    const dim3 blocks((W + OUT_COLS - 1) / OUT_COLS, (H + WARPS * STRIP - 1) / (WARPS * STRIP));
    shi_tomasi_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(img, H, W, out);
  }
  return (int)cudaGetLastError();
}
