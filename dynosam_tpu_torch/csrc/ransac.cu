// K6: the motion RANSAC of the frontend, 3d2d (PnP) and 3d3d (Arun), for a
// batch of B independent problems.  It replaces no Pallas kernel: it is the
// device-side form of the JAX package's fused, vmapped programs
// `dynosam_tpu/ops/ransac.py:165` (`ransac_rigid`) and `:314`
// (`ransac_pose_3d2d`), which XLA compiles into a few fused loops; in
// PyTorch the same work is about 1,400 small operators a call.  Wrapper and
// plain version: `kernels/ransac.py`.
//
// Contract (the plain version, `ops/ransac.py:_hypotheses_and_polish`):
//   * hypothesis (b, k) aligns the three rows idx[b, k, :] of src onto dst
//     by orthonormal triads (`rigid_from_minimal`); it is proper unless a
//     triad is degenerate; in 3d2d the hypothesis is its inverse (^w X_c);
//   * row n is an inlier of it where err < threshold, valid[n] and proper:
//     3d2d: err = |pi(R^T (src - t)) - uv|, inf unless the depth > 0.05;
//     3d3d: err = |R src + t - dst|;
//   * the first hypothesis of most inliers (`torch.argmax`) is polished by
//     `refine_steps` Gauss-Newton steps on its inliers (3d2d: those in
//     front of the camera): A = J^T W J + 1e-6 I, xi = -inv_spd(A) g,
//     T <- T Exp(xi), with `inv_spd`'s closed-form 6x6 recursion in float32
//     (fault F1 of ROADMAP.md behaves as the plain version's);
//   * final inliers under the polished pose, their count, the status
//     (FEW_MATCHES below 5 valid rows, VALID at `min_inliers`, else
//     INVALID) and the pose, the identity where not VALID; inliers are
//     cleared where not VALID.
//
// Bound at the main path's shapes (ego: B 1, K 500, N 1,536; objects: B 8,
// K 500, N 512): scoring is 2.8 M hypothesis-rows of ~35 FLOPs, ~0.1 GFLOP,
// 1.5 us at the card's float32 rate; inputs and outputs are < 0.2 MB.  The
// polish is a chain of 5 dependent block reductions and 6x6 solves per
// problem, so its latency, not a rate, bounds it.
//
// Design: (a) `ransac_score_kernel`, one warp per hypothesis: every lane
// solves the minimal set (three rows, a few hundred FLOPs), takes rows
// lane, lane + 32, ..., and the warp adds its integer counts (exact in any
// order).  (b) `ransac_polish_kernel`, one block per problem: the argmax
// as a block reduction of (count, -k), the best hypothesis solved again
// (the same device code, so the same bits as in (a)), then each GN step as
// one fixed-order block sum of the 21 + 6 entries of A and g and one
// thread's 6x6 solve and retraction, shared through shared memory.  No
// atomics: the result is the same on every run.
#include <cuda_runtime.h>

#include <cstdint>

#include "small.cuh"

namespace {

using dyno::Cam;
using dyno::SE3;

constexpr int POLISH_THREADS = 256;

struct Problem {
  const float* src;      // (B, N, 3)
  const float* dst;      // (B, N, 3)
  const float* uv;       // (B, N, 2), 3d2d only
  const uint8_t* valid;  // (B, N)
  const long long* idx;  // (B, K, 3)
  int B, N, K;
  Cam cam;
  float threshold;
};

__device__ __forceinline__ void sub3(const float* a, const float* b, float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i] = a[i] - b[i];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// `rigid_from_minimal`'s triad of (u, v): columns e1, e2, e3 of E
// (E[3 i + c] = e_c[i]); ok unless u is tiny or v nearly parallel to it
__device__ __forceinline__ bool triad(const float* u, const float* v, float* E) {
  const float nu = sqrtf(dot3(u, u));
  float e1[3], wv[3], e2[3];
  const float nu_c = dyno::clamp_min(nu, 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) e1[i] = u[i] / nu_c;
  const float ve = dot3(v, e1);
#pragma unroll
  for (int i = 0; i < 3; ++i) wv[i] = v[i] - ve * e1[i];
  const float nw = sqrtf(dot3(wv, wv));
  const float nw_c = dyno::clamp_min(nw, 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) e2[i] = wv[i] / nw_c;
  const float e3[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                       e1[0] * e2[1] - e1[1] * e2[0]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    E[3 * i] = e1[i];
    E[3 * i + 1] = e2[i];
    E[3 * i + 2] = e3[i];
  }
  return (nu > 1e-9f) && (nw > 1e-4f * nu);
}

// hypothesis k of problem b (`rigid_from_minimal`, inverted in 3d2d)
template <bool REPROJ>
__device__ __forceinline__ SE3 hypothesis(const Problem& p, int b, int k, bool* proper) {
  const long long* ix = p.idx + ((long long)b * p.K + k) * 3;
  float s[3][3], d[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const long long r = (long long)b * p.N + ix[j];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[j][c] = p.src[r * 3 + c];
      d[j][c] = p.dst[r * 3 + c];
    }
  }
  float a1[3], a2[3], b1[3], b2[3], E[9], F[9];
  sub3(s[1], s[0], a1);
  sub3(s[2], s[0], a2);
  sub3(d[1], d[0], b1);
  sub3(d[2], d[0], b2);
  const bool ok_e = triad(a1, a2, E);
  const bool ok_f = triad(b1, b2, F);
  SE3 h;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      h.R[3 * i + j] = (F[3 * i] * E[3 * j] + F[3 * i + 1] * E[3 * j + 1]) + F[3 * i + 2] * E[3 * j + 2];
  float cs[3], cd[3], m[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cs[c] = ((s[0][c] + s[1][c]) + s[2][c]) / 3.f;
    cd[c] = ((d[0][c] + d[1][c]) + d[2][c]) / 3.f;
  }
  dyno::mv3(h.R, cs, m);
#pragma unroll
  for (int c = 0; c < 3; ++c) h.t[c] = cd[c] - m[c];
  *proper = ok_e && ok_f;
  return REPROJ ? dyno::se3_inverse(h) : h;
}

__device__ __forceinline__ float norm2(float a, float b) { return sqrtf(a * a + b * b); }

// the scoring error of row n under hypothesis h (see the contract)
template <bool REPROJ>
__device__ __forceinline__ float score_error(const Problem& p, const SE3& h, long long row) {
  const float* s = p.src + row * 3;
  if (REPROJ) {
    float diff[3], pc[3], uv[2], z;
    sub3(s, h.t, diff);
    // p_cam = R^T diff, as `torch.sum(Rt * diff, -1)`
#pragma unroll
    for (int i = 0; i < 3; ++i) pc[i] = (h.R[i] * diff[0] + h.R[3 + i] * diff[1]) + h.R[6 + i] * diff[2];
    dyno::project_local(p.cam, pc, uv, &z);
    const float e = norm2(uv[0] - p.uv[row * 2], uv[1] - p.uv[row * 2 + 1]);
    return z > 0.05f ? e : CUDART_INF_F;
  }
  float m[3];
  dyno::mv3(h.R, s, m);
  const float* d = p.dst + row * 3;
  const float e0 = (m[0] + h.t[0]) - d[0], e1 = (m[1] + h.t[1]) - d[1], e2 = (m[2] + h.t[2]) - d[2];
  return sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
}

// the final error of row n under the polished pose T (3d2d: through
// `se3_inverse(T)` applied, as the plain version's last pass)
template <bool REPROJ>
__device__ __forceinline__ float final_error(const Problem& p, const SE3& Tinv, const SE3& T, long long row) {
  const float* s = p.src + row * 3;
  float q[3];
  if (REPROJ) {
    float uv[2], z;
    dyno::se3_apply(Tinv, s, q);
    dyno::project_local(p.cam, q, uv, &z);
    const float e = norm2(uv[0] - p.uv[row * 2], uv[1] - p.uv[row * 2 + 1]);
    return z > 0.05f ? e : CUDART_INF_F;
  }
  dyno::se3_apply(T, s, q);
  const float* d = p.dst + row * 3;
  const float e0 = q[0] - d[0], e1 = q[1] - d[1], e2 = q[2] - d[2];
  return sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
}

template <bool REPROJ>
__global__ void ransac_score_kernel(const __grid_constant__ Problem p, int* __restrict__ counts) {
  const int h = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (h >= p.B * p.K) return;  // whole warps
  const int b = h / p.K, k = h % p.K;
  bool proper;
  const SE3 hyp = hypothesis<REPROJ>(p, b, k, &proper);
  int c = 0;
  if (proper)
    for (int n = lane; n < p.N; n += 32) {
      const long long row = (long long)b * p.N + n;
      c += (p.valid[row] && score_error<REPROJ>(p, hyp, row) < p.threshold) ? 1 : 0;
    }
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) counts[h] = c;
}

// Gauss-Newton rows of one correspondence at T (the plain version's
// polish): residuals r (ND of them) and Jacobian rows J (ND x 6); w the
// row weight (0 or 1)
template <bool REPROJ>
__device__ __forceinline__ void polish_row(const Problem& p, const SE3& T, const SE3& Tinv, long long row,
                                           bool best_inl, float* r, float* J, float* w) {
  const float* s = p.src + row * 3;
  if (REPROJ) {
    float pc[3], uv[2], z;
    dyno::se3_apply(Tinv, s, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    r[0] = uv[0] - p.uv[row * 2];
    r[1] = uv[1] - p.uv[row * 2 + 1];
    *w = (best_inl && z > 0.05f) ? 1.f : 0.f;
    const float ps[3] = {pc[0], pc[1], z > 0.05f ? z : 1.f};
    dyno::project_jacobian_pose(p.cam, ps, J);
  } else {
    float q[3], H[9], RH[9];
    dyno::se3_apply(T, s, q);
    const float* d = p.dst + row * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = q[i] - d[i];
    *w = best_inl ? 1.f : 0.f;
    // d/dxi T Exp(xi) src = R [-hat(src) | I]
    const float ns[3] = {-s[0], -s[1], -s[2]};
    dyno::so3_hat(ns, H);  // hat(-s) = -hat(s)
    dyno::mm3(T.R, H, RH);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        J[6 * i + j] = RH[3 * i + j];
        J[6 * i + 3 + j] = T.R[3 * i + j];
      }
  }
}

template <bool REPROJ>
__global__ void __launch_bounds__(POLISH_THREADS)
    ransac_polish_kernel(const __grid_constant__ Problem p, const int* __restrict__ counts, int refine_steps,
                         int min_inliers, float* __restrict__ R_out, float* __restrict__ t_out,
                         uint8_t* __restrict__ inliers, int* __restrict__ n_out, int* __restrict__ status_out) {
  constexpr int ND = REPROJ ? 2 : 3;
  __shared__ float red[(POLISH_THREADS / 32 + 1) * 27];
  __shared__ int best_c[POLISH_THREADS], best_k[POLISH_THREADS];
  __shared__ float pose[12];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long base = (long long)b * p.N;

  // the first hypothesis of the most inliers
  int bc = -1, bk = 0;
  for (int k = tid; k < p.K; k += blockDim.x) {
    const int c = counts[(long long)b * p.K + k];
    if (c > bc) {
      bc = c;
      bk = k;
    }
  }
  best_c[tid] = bc;
  best_k[tid] = bk;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (tid < s) {
      const int oc = best_c[tid + s], ok = best_k[tid + s];
      if (oc > best_c[tid] || (oc == best_c[tid] && ok < best_k[tid])) {
        best_c[tid] = oc;
        best_k[tid] = ok;
      }
    }
    __syncthreads();
  }
  const int k_best = best_k[0];
  __syncthreads();  // best_c and best_k are reused for the final counts
  bool proper;
  SE3 T = hypothesis<REPROJ>(p, b, k_best, &proper);
  // its inliers, kept in the output until the final pass overwrites them
  for (int n = tid; n < p.N; n += blockDim.x) {
    const long long row = base + n;
    inliers[row] = (proper && p.valid[row] && score_error<REPROJ>(p, T, row) < p.threshold) ? 1 : 0;
  }

  for (int step = 0; step < refine_steps; ++step) {
    const SE3 Tinv = dyno::se3_inverse(T);
    float acc[27];  // A's upper triangle (21, row-major), then g (6)
#pragma unroll
    for (int i = 0; i < 27; ++i) acc[i] = 0.f;
    for (int n = tid; n < p.N; n += blockDim.x) {
      const long long row = base + n;
      float r[ND], J[ND * 6], w;
      polish_row<REPROJ>(p, T, Tinv, row, inliers[row] != 0, r, J, &w);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        float Jw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) Jw[i] = J[6 * d + i] * w;
        int o = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j) acc[o++] += Jw[i] * J[6 * d + j];
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r[d];
      }
    }
    dyno::block_sum<27>(acc, red);
    if (tid == 0) {
      float A[36], Ai[36], xi[6];
      int o = 0;
      for (int i = 0; i < 6; ++i)
        for (int j = i; j < 6; ++j) {
          A[6 * i + j] = acc[o];
          A[6 * j + i] = acc[o];
          ++o;
        }
      for (int i = 0; i < 6; ++i) A[7 * i] = A[7 * i] + 1e-6f;
      dyno::inv_spd6(A, Ai);
      for (int i = 0; i < 6; ++i) {
        float s = Ai[6 * i] * acc[21];
        for (int j = 1; j < 6; ++j) s += Ai[6 * i + j] * acc[21 + j];
        xi[i] = -s;
      }
      const SE3 Tn = dyno::se3_retract(T, xi);
      for (int i = 0; i < 9; ++i) pose[i] = Tn.R[i];
      for (int i = 0; i < 3; ++i) pose[9 + i] = Tn.t[i];
    }
    __syncthreads();
    T = dyno::se3_load(pose);
    __syncthreads();
  }

  // final inliers, counts, status and pose
  const SE3 Tinv = dyno::se3_inverse(T);
  int n_fin = 0, n_val = 0;
  for (int n = tid; n < p.N; n += blockDim.x) {
    const long long row = base + n;
    const bool v = p.valid[row] != 0;
    const bool in = v && final_error<REPROJ>(p, Tinv, T, row) < p.threshold;
    inliers[row] = in ? 1 : 0;
    n_fin += in ? 1 : 0;
    n_val += v ? 1 : 0;
  }
  n_fin = __reduce_add_sync(0xffffffffu, n_fin);
  n_val = __reduce_add_sync(0xffffffffu, n_val);
  if ((tid & 31) == 0) {
    best_c[tid >> 5] = n_fin;
    best_k[tid >> 5] = n_val;
  }
  __syncthreads();
  int tot_fin = 0, tot_val = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    tot_fin += best_c[w];
    tot_val += best_k[w];
  }
  const int status = tot_val < 5 ? 1 : (tot_fin >= min_inliers ? 0 : 2);
  const bool ok = status == 0;
  if (!ok)
    for (int n = tid; n < p.N; n += blockDim.x) inliers[base + n] = 0;
  if (tid == 0) {
    const SE3 out = ok ? T : dyno::se3_identity();
    for (int i = 0; i < 9; ++i) R_out[b * 9 + i] = out.R[i];
    for (int i = 0; i < 3; ++i) t_out[b * 3 + i] = out.t[i];
    n_out[b] = tot_fin;
    status_out[b] = status;
  }
}

}  // namespace

// uv == 0 selects 3d3d.  counts: (B, K) int32 scratch.
extern "C" int dyno_ransac(const float* src, const float* dst, const float* uv, const uint8_t* valid,
                           const long long* idx, int B, int N, int K, float fx, float fy, float cx, float cy,
                           float threshold, int refine_steps, int min_inliers, int* counts, float* R_out,
                           float* t_out, uint8_t* inliers, int* n_out, int* status_out, void* stream) {
  Problem p{src, dst, uv, valid, idx, B, N, K, Cam{fx, fy, cx, cy}, threshold};
  if (B <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int warps = 4;
  const int blocks = (B * K + warps - 1) / warps;
  if (uv != nullptr) {
    if (K > 0) ransac_score_kernel<true><<<blocks, 32 * warps, 0, s>>>(p, counts);
    ransac_polish_kernel<true><<<B, POLISH_THREADS, 0, s>>>(p, counts, refine_steps, min_inliers, R_out, t_out,
                                                            inliers, n_out, status_out);
  } else {
    if (K > 0) ransac_score_kernel<false><<<blocks, 32 * warps, 0, s>>>(p, counts);
    ransac_polish_kernel<false><<<B, POLISH_THREADS, 0, s>>>(p, counts, refine_steps, min_inliers, R_out, t_out,
                                                             inliers, n_out, status_out);
  }
  return (int)cudaGetLastError();
}
