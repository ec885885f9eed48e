// Small fixed-size float32 algebra for the port's solver kernels (K5
// `refine.cu`, K6 `ransac.cu`): SE(3) on 3x3 row-major rotations, the
// pinhole projection and its Jacobians, the closed-form small inverses and
// the robust kernels.
//
// Each function repeats the operation order of its PyTorch counterpart
// (`core/lie.py`, `core/camera.py`, `ops/linalg.py`, `ops/robust.py`,
// `backend/solver.py:robust_loss`): a 3-term sum is ((a + b) + c), a
// product of a Python constant and two tensors is ((k * x) * y), a division
// stays a division.  The sources that include this header are compiled
// with `-fmad=false`, so no multiply-add is contracted and every product
// and sum rounds as the separate PyTorch operations do.  Sums over rows
// and the transcendental functions still differ from PyTorch's in the last
// bits; the kernels' tolerances say by how much.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dyno {

struct Cam {
  float fx, fy, cx, cy;
};

// torch.clamp(x, min=m) / (x, max=m): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float m) { return x < m ? m : x; }
__device__ __forceinline__ float clamp_max(float x, float m) { return x > m ? m : x; }

// `_mv`: y = A x for a row-major 3x3 A
__device__ __forceinline__ void mv3(const float* A, const float* x, float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = (A[3 * i] * x[0] + A[3 * i + 1] * x[1]) + A[3 * i + 2] * x[2];
}

// `_mm`: C = A B for row-major 3x3 matrices (C must not alias A or B)
__device__ __forceinline__ void mm3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = (A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]) + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void transpose3(const float* A, float* T) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[3 * i + j] = A[3 * j + i];
}

// a pose: R row-major, then t
struct SE3 {
  float R[9];
  float t[3];
};

__device__ __forceinline__ SE3 se3_identity() {
  SE3 g;
#pragma unroll
  for (int i = 0; i < 9; ++i) g.R[i] = (i % 4 == 0) ? 1.f : 0.f;
  g.t[0] = g.t[1] = g.t[2] = 0.f;
  return g;
}

__device__ __forceinline__ SE3 se3_load(const float* p) {  // 12 floats: R, t
  SE3 g;
#pragma unroll
  for (int i = 0; i < 9; ++i) g.R[i] = p[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) g.t[i] = p[9 + i];
  return g;
}

// `se3_inverse`: (R^T, -(R^T t))
__device__ __forceinline__ SE3 se3_inverse(const SE3& g) {
  SE3 h;
  transpose3(g.R, h.R);
  float m[3];
  mv3(h.R, g.t, m);
#pragma unroll
  for (int i = 0; i < 3; ++i) h.t[i] = -m[i];
  return h;
}

// `se3_apply`: R p + t
__device__ __forceinline__ void se3_apply(const SE3& g, const float* p, float* q) {
  float m[3];
  mv3(g.R, p, m);
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = m[i] + g.t[i];
}

// `se3_compose`: (Ra Rb, Ra tb + ta)
__device__ __forceinline__ SE3 se3_compose(const SE3& a, const SE3& b) {
  SE3 c;
  mm3(a.R, b.R, c.R);
  float m[3];
  mv3(a.R, b.t, m);
#pragma unroll
  for (int i = 0; i < 3; ++i) c.t[i] = m[i] + a.t[i];
  return c;
}

__device__ __forceinline__ void so3_hat(const float* w, float* W) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
}

// `so3_exp` and `so3_left_jacobian` of one tangent w (`_SMALL` = 1e-4)
__device__ __forceinline__ void so3_exp_and_left_jacobian(const float* w, float* R, float* V) {
  const float sq = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const bool small = sq < 1e-8f;
  const float th = sqrtf(small ? 1.f : sq);
  const float sq_safe = small ? 1.f : sq;
  float W[9], W2[9];
  so3_hat(w, W);
  mm3(W, W, W2);
  const float s = sinf(th), c = cosf(th);
  const float a = small ? 1.f - sq / 6.f : s / th;
  const float b = small ? 0.5f - sq / 24.f : (1.f - c) / sq_safe;
  const float cc = small ? (1.f / 6.f) - sq / 120.f : (th - s) / (sq_safe * th);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.f : 0.f;
    R[i] = (e + a * W[i]) + b * W2[i];
    V[i] = (e + b * W[i]) + cc * W2[i];
  }
}

// `se3_exp` of xi = [omega, v]
__device__ __forceinline__ SE3 se3_exp(const float* xi) {
  SE3 g;
  float V[9];
  so3_exp_and_left_jacobian(xi, g.R, V);
  mv3(V, xi + 3, g.t);
  return g;
}

// `se3_retract`: a Exp(xi)
__device__ __forceinline__ SE3 se3_retract(const SE3& a, const float* xi) {
  return se3_compose(a, se3_exp(xi));
}

// `project_local`: uv and depth; |z| < 1e-9 divides by +-1e-9
__device__ __forceinline__ void project_local(const Cam& c, const float* p, float* uv, float* z) {
  const float zz = p[2];
  const float zs = fabsf(zz) < 1e-9f ? (zz < 0.f ? -1e-9f : 1e-9f) : zz;
  uv[0] = (c.fx * p[0]) / zs + c.cx;
  uv[1] = (c.fy * p[1]) / zs + c.cy;
  *z = zz;
}

// `project_jacobian_pose`: d(uv)/d(xi), row-major (2, 6)
__device__ __forceinline__ void project_jacobian_pose(const Cam& c, const float* p, float* J) {
  const float x = p[0], y = p[1], z = p[2];
  const float iz = 1.f / z;
  const float iz2 = iz * iz;
  const float fx = c.fx, fy = c.fy;
  J[0] = ((fx * x) * y) * iz2;
  J[1] = -fx * (1.f + (x * x) * iz2);
  J[2] = (fx * y) * iz;
  J[3] = -fx * iz;
  J[4] = 0.f;
  J[5] = (fx * x) * iz2;
  J[6] = fy * (1.f + (y * y) * iz2);
  J[7] = ((-fy * x) * y) * iz2;
  J[8] = (-fy * x) * iz;
  J[9] = 0.f;
  J[10] = -fy * iz;
  J[11] = (fy * y) * iz2;
}

// `project_jacobian_point`: d(uv)/d(p_cam), row-major (2, 3)
__device__ __forceinline__ void project_jacobian_point(const Cam& c, const float* p, float* J) {
  const float x = p[0], y = p[1], z = p[2];
  const float iz = 1.f / z;
  const float iz2 = iz * iz;
  J[0] = c.fx * iz;
  J[1] = 0.f;
  J[2] = (-c.fx * x) * iz2;
  J[3] = 0.f;
  J[4] = c.fy * iz;
  J[5] = (-c.fy * y) * iz2;
}

// `inv2`, `inv3` and `inv_spd` (ops/linalg.py), row-major
__device__ __forceinline__ void inv2(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2], d = M[3];
  const float inv_det = 1.f / (a * d - b * c);
  out[0] = d * inv_det;
  out[1] = -b * inv_det;
  out[2] = -c * inv_det;
  out[3] = a * inv_det;
}

__device__ __forceinline__ void inv3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2];
  const float d = M[3], e = M[4], f = M[5];
  const float g = M[6], h = M[7], i = M[8];
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float det = (a * A + b * B) + c * C;
  const float s = 1.f / det;
  out[0] = A * s;
  out[1] = -(b * i - c * h) * s;
  out[2] = (b * f - c * e) * s;
  out[3] = B * s;
  out[4] = (a * i - c * g) * s;
  out[5] = -(a * f - c * d) * s;
  out[6] = C * s;
  out[7] = -(a * h - b * g) * s;
  out[8] = (a * e - b * d) * s;
}

// the 6x6 recursion of `inv_spd`: 3x3 blocks A, B, C; Ai = inv3(A),
// S = C - B^T Ai B, Si = inv3(S), TL = Ai + (Ai B Si)(Ai B)^T,
// TR = -(Ai B Si), BL = TR^T
__device__ __forceinline__ void inv_spd6(const float* M, float* out) {
  float A[9], B[9], Bt[9], C[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = M[6 * i + j];
      B[3 * i + j] = M[6 * i + 3 + j];
      C[3 * i + j] = M[6 * (3 + i) + 3 + j];
    }
  transpose3(B, Bt);
  float Ai[9], AiB[9], BtAiB[9], S[9], Si[9], P[9], AiBt[9], Q[9];
  inv3(A, Ai);
  mm3(Ai, B, AiB);
  mm3(Bt, AiB, BtAiB);
#pragma unroll
  for (int i = 0; i < 9; ++i) S[i] = C[i] - BtAiB[i];
  inv3(S, Si);
  mm3(AiB, Si, P);
  transpose3(AiB, AiBt);
  mm3(P, AiBt, Q);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[6 * i + j] = Ai[3 * i + j] + Q[3 * i + j];
      out[6 * i + 3 + j] = -P[3 * i + j];
      out[6 * (3 + i) + j] = -P[3 * j + i];
      out[6 * (3 + i) + 3 + j] = Si[3 * i + j];
    }
}

// `ops/robust.py:robust_sqrt_weights` for Huber on a whitened residual of
// norm `norm`
__device__ __forceinline__ float huber_sqrt_weight(float norm, float k) {
  const float safe = clamp_min(norm, 1e-30f);
  return sqrtf(norm <= k ? 1.f : k / safe);
}

// `backend/solver.py:robust_loss` from the squared norm; `half_k2` is
// 0.5 k^2 rounded from double, as PyTorch passes the Python constant
__device__ __forceinline__ float huber_loss(float sq, float k, float half_k2) {
  const float norm = sqrtf(clamp_min(sq, 1e-30f));
  return norm <= k ? 0.5f * sq : k * norm - half_k2;
}

// Deterministic block sum of `n` per-thread values: a butterfly within
// each warp, then the warps' partials in warp order by threads 0..n-1.
// `scratch` holds (blockDim.x / 32 + 1) * n floats; every thread receives the
// totals in `v`.  Ends with a barrier.
template <int NV>
__device__ __forceinline__ void block_sum(float* v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    v[i] = x;
  }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) scratch[warp * NV + i] = v[i];
  __syncthreads();
  float* tot = scratch + nw * NV;
  for (int i = threadIdx.x; i < NV; i += blockDim.x) {
    float s = scratch[i];
    for (int w = 1; w < nw; ++w) s += scratch[w * NV + i];
    tot[i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = tot[i];
  __syncthreads();
}

}  // namespace dyno
