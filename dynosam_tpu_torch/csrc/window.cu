// K7-K9: one Levenberg-Marquardt iteration of the direct-Schur window solve
// (WorldMotion, updater 0) on the device, in place of the ~1,090 small
// ATen kernels an iteration that `backend/schur.py` replays.  They replace
// no Pallas kernel: the JAX package runs the whole window LM as one fused
// XLA `lax.while_loop` (`dynosam_tpu/backend/schur.py:1463`, build `:611`,
// step `:1072`).  Wrappers: `backend/schur.py:window_build`, `window_step`,
// `window_update`; bindings: `kernels/window.py`; plain versions: the
// existing functions those wrappers name.
//
//   K7 window_build  -- `build_normal_system` with `sqrt_weights` at the
//        current values and residuals: every `NormalSystem` field.  One
//        launch, four block roles: a block per frame sums its camera block
//        (Hcc row k, b_cam) over the static and dynamic points in a fixed
//        order, with the odometry and anchor blocks (a warp each, the
//        lanes over the 6x6 entries of the right Jacobians' Horner
//        scheme); a thread per static point (Us, Hll_s, b_sp), per (frame,
//        track) (Rc, b_dp, chain_c, the one-hot and the square-root motion
//        factor) and a warp per (frame, object) (Dmm, Omm1, b_mot).
//   K8 window_step   -- `schur_reduce`, six kernels: the static elimination
//        (a thread per static point and column, the adjugate inverse of
//        `_inv3` on the damped block); the Woodbury blocks of each (frame,
//        track) (inv_c, AU_cur, AU_prev, Bcol, phi_hat, the capacitance
//        chain's alpha_M and B_M); the chains (a block per track, its
//        blocks and `chain_solve_scalar`'s pivots in shared memory, a
//        thread per column of the 2 * 6W + 1 right sides, the forward
//        sweep in shared memory); the camera rows' sums over the points
//        and tracks split into segments (a block per row and segment), and
//        per-frame lists of the tracks in a motion factor's chain; the raw
//        reduced system, a thread per entry, adding the segments in order
//        and looping over the listed tracks; and a tiled pass that
//        symmetrises it and adds the diagonal floor.  The factorisation
//        stays `torch.linalg.cholesky_ex` / `cholesky_solve` (cuSOLVER).
//   K9 window_update -- `schur_back` and `_lm_tail`, three kernels: the
//        back-substitution (a warp per track for the chain's dot
//        products), retraction, trial residuals and their robust error
//        (per-block partials per family); one block that adds the partials
//        in block order and takes the accept, lambda, ratchet and
//        convergence decisions; a pass that commits the trial where
//        accepted.  At a zero step (`dyno_window_head`) the same kernels
//        give the LM head: residuals and error at the current values.
//
// Bound on the card: latency.  A KITTI window (W 10, 1,024 static points,
// 1,024 tracks, 8 objects) needs ~0.1 GFLOP an iteration, microseconds of
// the card's float32 rate, and ~20-40 MB of traffic, most of it the chain
// solutions Z (W x ND x 3 x (2 * 6W + 1) floats, 15 MB), which stay in the
// 50 MB L2 between K8's passes and K9.  An iteration is ten launches
// besides the factorisation's; each kernel's time is in `PERF.md`.  An
// IEEE division of a zero goes by a product (`div0`): KITTI's windows,
// with no motion factor, fill the chains with zeros, and the division's
// slow path for them cost the chain pass 13 of its 31 us.
//
// No float atomics: every sum runs in a fixed order (index order within a
// thread, warp butterflies, warps and blocks in order), so a launch repeats
// bit for bit.  Padding rows and masked factors give exact zeros.  The
// products and sums are rounded one by one (`-fmad=false`), in the plain
// version's order where it is a short closed form; long sums differ in
// order, so the kernels agree with the plain versions within float32
// spread, not bit for bit.  float32 only; W <= 16, NS <= 1024, ND <= 1024,
// O <= 8 (`kernels/window.py:check` raises on anything else).
#include "common.cuh"
#include "small.cuh"

#include <cstdint>

namespace {

using dyno::SE3;
using dyno::clamp_max;
using dyno::clamp_min;
using dyno::mm3;
using dyno::mv3;
using dyno::so3_hat;
using dyno::transpose3;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 16;
constexpr int N_FAMILY = 6;

// the pointer table (kernels/window.py:POINTERS, same order)
enum Ptr {
  XR, XT, HR, HT, SP, DP,
  R_ANCHOR, R_ODO, R_STATIC, R_DYN, R_TERN, R_SMOOTH,
  STATIC_XYZ, DYN_XYZ, DYN_OBJ, XI_R, XI_T,
  STATIC_OBS, DYN_OBS, TERNARY, SMOOTHING, ODOMETRY,
  ANCHOR_R, ANCHOR_T, PRIOR_L,
  HCC, DMM, OMM1, OMM2, B_CAM, B_MOT, HLL_S, US, B_SP, RC, B_DP, ONEHOT, CHAIN_C, CHAIN_T, ST_S, ST_R, ST_G,
  ST_PHI,
  ERR, LAM, LAM_MIN, DONE, ACCEPT, FLAGS, ERR_INIT,
  YC_S, YB_S, ZBUF, INV_C, AU_CUR, AU_PREV, BCOL, OBJ, HRAW, HRED, BRED,
  SOL, INFO, TRIAL, PARTIALS, PART_CC, PART_DD, ACT_LIST, ACT_COUNT, PHI_HAT, BMAT, ALPHA_M,
  N_PTR
};

// the float settings (kernels/window.py:PARAMS, same order)
enum Param {
  SIG_S, SIG_D, SIG_T, SIG_D2, SIG_T2, PRIOR_SIGMA, K_S, K_D, HALF_K2_S, HALF_K2_D,
  ODO_SIG, SMOOTH_SIG = ODO_SIG + 6, FLOOR = SMOOTH_SIG + 6, TINY, REL, LAMBDA_FACTOR, MAX_LAMBDA, REL_TOL,
  ABS_TOL, INIT_LAMBDA, MIN_LAMBDA, N_PARAM
};

struct Args {
  int W, NS, ND, O;
  int nc, nm, n, C;          // 6W, 6WO, nc + nm, 2 nc + 1
  float p[N_PARAM];
  void* ptr[N_PTR];
  __device__ float* f(int i) const { return static_cast<float*>(ptr[i]); }
  __device__ const uint8_t* b(int i) const { return static_cast<const uint8_t*>(ptr[i]); }
  __device__ uint8_t* bw(int i) const { return static_cast<uint8_t*>(ptr[i]); }
  __device__ int* i32(int i) const { return static_cast<int*>(ptr[i]); }
};

// x / d with IEEE division's result for every input; a zero x by a finite
// non-zero d goes by the product (the same signed zero), off the division's
// slow path
__device__ __forceinline__ float div0(float x, float d) {
  return (x == 0.f && d != 0.f && isfinite(d)) ? x * d : x / d;
}

// ---------------------------------------------------------------- Lie algebra

// `core/lie.py:so3_log`: small-angle, generic and near-pi regimes
__device__ void so3_log(const float* R, float* w) {
  const float trace = (R[0] + R[4]) + R[8];
  float cos_th = (trace - 1.f) * 0.5f;
  cos_th = cos_th < -1.f ? -1.f : (cos_th > 1.f ? 1.f : cos_th);
  const float anti[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const bool small = cos_th > 0.999999f;
  const bool near_pi = cos_th < -0.98877108f;
  const bool generic = !small && !near_pi;
  const float cos_g = generic ? cos_th : 0.f;
  const float th_g = acosf(cos_g);
  const float scale_g = th_g / (2.f * sinf(th_g));
  const float scale_s = 0.5f + (3.f - trace) * (1.f / 12.f);
  const float scale = small ? scale_s : scale_g;
  const float cos_p = near_pi ? cos_th : 0.f;
  const float th_p = acosf(cos_p);
  const float f = (th_p * th_p) / (1.f - cos_p);
  const float diag[3] = {R[0], R[4], R[8]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float w2 = f * (diag[i] - cos_p);
    const float w_abs = sqrtf(clamp_min(w2, 0.f) + 1e-12f);
    const float sgn = fabsf(anti[i]) > 1e-7f ? (anti[i] > 0.f ? 1.f : -1.f) : 1.f;
    w[i] = near_pi ? w_abs * sgn : scale * anti[i];
  }
}

// `core/lie.py:so3_left_jacobian_inv`
__device__ void so3_left_jacobian_inv(const float* w, float* Vi) {
  const float sq = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const bool small = sq < 1e-8f;
  const float th = sqrtf(small ? 1.f : sq);
  const float sq_safe = small ? 1.f : sq;
  float W[9], W2[9];
  so3_hat(w, W);
  mm3(W, W, W2);
  const float half = th * 0.5f;
  const float cot = small ? (1.f / 12.f) + sq * (1.f / 720.f) : (1.f - (half * cosf(half)) / sinf(half)) / sq_safe;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float e = (i % 4 == 0) ? 1.f : 0.f;
    Vi[i] = (e - 0.5f * W[i]) + cot * W2[i];
  }
}

// `core/lie.py:se3_log`: [omega, v]
__device__ void se3_log(const SE3& g, float* xi) {
  so3_log(g.R, xi);
  float Vi[9];
  so3_left_jacobian_inv(xi, Vi);
  mv3(Vi, g.t, xi + 3);
}

__device__ SE3 load_pose(const float* R, const float* t) {
  SE3 g;
#pragma unroll
  for (int i = 0; i < 9; ++i) g.R[i] = R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) g.t[i] = t[i];
  return g;
}

// `core/lie.py:se3_adjoint`: [[R, 0], [hat(t) R, R]]
__device__ void adjoint(const SE3& g, float* A) {
  float th[9], tR[9];
  so3_hat(g.t, th);
  mm3(th, g.R, tR);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      A[6 * i + j] = g.R[3 * i + j];
      A[6 * i + 3 + j] = 0.f;
      A[6 * (3 + i) + j] = tR[3 * i + j];
      A[6 * (3 + i) + 3 + j] = g.R[3 * i + j];
    }
}

// ---- the pose families' Jacobians on one warp: the lanes take the entries
// of each 6x6 product, lane 0 the group operations between them

struct PoseSmem {
  float ad[36], ad2[36], P[36], T[36], Ad[36], Ja[36], Jb[36], e[6];
};

// C = A B for row-major 6x6 in shared memory, entry i on lane i % 32
__device__ void mm6_warp(const float* A, const float* B, float* C) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 36; i += 32) {
    const int r = i / 6, c = i % 6;
    float s = 0.f;
    for (int k = 0; k < 6; ++k) s += A[6 * r + k] * B[6 * k + c];
    C[i] = s;
  }
  __syncwarp();
}

// `_right_jacobian_inv` of m.e into J (shared), Horner's scheme in ad^2
__device__ void right_jacobian_inv_warp(PoseSmem& m, float* J) {
  const float c[7] = {1.f / 12.f, -1.f / 720.f, 1.f / 30240.f, -1.f / 1209600.f, 1.f / 47900160.f,
                      (float)(-691.0 / 1307674368000.0), (float)(1.0 / 74724249600.0)};
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 36; i += 32) {
    const int r = i / 6, cc = i % 6;
    const float* v = (r >= 3 && cc < 3) ? m.e + 3 : m.e;    // [[w^, 0], [v^, w^]]
    const int a = r % 3, b = cc % 3;
    float h = 0.f;
    if (a == 0 && b == 1) h = -v[2];
    else if (a == 0 && b == 2) h = v[1];
    else if (a == 1 && b == 0) h = v[2];
    else if (a == 1 && b == 2) h = -v[0];
    else if (a == 2 && b == 0) h = -v[1];
    else if (a == 2 && b == 1) h = v[0];
    m.ad[i] = (r < 3 && cc >= 3) ? 0.f : h;
  }
  __syncwarp();
  mm6_warp(m.ad, m.ad, m.ad2);
  for (int i = lane; i < 36; i += 32) m.P[i] = (i % 7 == 0) ? c[6] : 0.f;
  __syncwarp();
  for (int k = 5; k >= 0; --k) {
    mm6_warp(m.ad2, m.P, m.T);
    for (int i = lane; i < 36; i += 32) m.P[i] = m.T[i] + ((i % 7 == 0) ? c[k] : 0.f);
    __syncwarp();
  }
  mm6_warp(m.ad2, m.P, m.T);
  for (int i = lane; i < 36; i += 32) J[i] = (((i % 7 == 0) ? 1.f : 0.f) + 0.5f * m.ad[i]) + m.T[i];
  __syncwarp();
}

// `_between_jacobians` on a warp: m.Ja and m.Jb
__device__ void between_jacobians_warp(const SE3& a, const SE3& b, const SE3* Z, const float* sigma, PoseSmem& m) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    const SE3 M = dyno::se3_compose(dyno::se3_inverse(a), b);
    se3_log(Z ? dyno::se3_compose(dyno::se3_inverse(*Z), M) : M, m.e);
    adjoint(dyno::se3_inverse(M), m.Ad);
  }
  __syncwarp();
  right_jacobian_inv_warp(m, m.Jb);
  for (int i = lane; i < 36; i += 32) m.Jb[i] = div0(m.Jb[i], sigma[i / 6]);
  __syncwarp();
  mm6_warp(m.Jb, m.Ad, m.T);
  for (int i = lane; i < 36; i += 32) m.Ja[i] = -m.T[i];
  __syncwarp();
}

// w A^T B (6x6) entry i, and w A^T r entry i
__device__ float gram_entry(float w, const float* A, const float* B, int i) {
  const int a = i / 6, b = i % 6;
  float s = 0.f;
  for (int r = 0; r < 6; ++r) s += A[6 * r + a] * B[6 * r + b];
  return w * s;
}

__device__ float grad_entry(float w, const float* A, const float* r, int a) {
  float s = 0.f;
  for (int i = 0; i < 6; ++i) s += A[6 * i + a] * r[i];
  return w * s;
}

// `ops/robust.py:robust_sqrt_weights` (Huber) of a 3-vector residual
__device__ float huber_weight3(const float* r, float k) {
  const float norm = sqrtf((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]);
  return dyno::huber_sqrt_weight(norm, k);
}

// `se3_apply(se3_inverse(X), p)`: R^T p + (-(R^T t))
__device__ void to_local(const SE3& X, const float* p, float* y) {
  const SE3 inv = dyno::se3_inverse(X);
  dyno::se3_apply(inv, p, y);
}

__device__ SE3 retract(const float* R, const float* t, const float* xi) {
  return dyno::se3_retract(load_pose(R, t), xi);
}

__device__ float nan_max(float a, float b) { return (a != a || b != b) ? (a + b) : (a > b ? a : b); }

// sum over the block of per-thread values v[N] in a fixed order (warp
// butterflies, then the warps in order); thread 0 receives the totals
template <int N>
__device__ void block_sum(float* v, float (*part)[N], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < N; ++i) {
    const float s = dyno::warp_sum(v[i]);
    if (lane == 0) part[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = part[0][threadIdx.x];
    for (int w = 1; w < WARPS; ++w) s += part[w][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- K7: build

struct BuildShape {
  int frame, stat, dyn, obj;   // blocks of each role, in this order
};

__host__ __device__ inline BuildShape build_shape(int W, int NS, int ND, int O) {
  return BuildShape{W, (NS + THREADS - 1) / THREADS, (W * ND + THREADS - 1) / THREADS,
                    (W * O + WARPS - 1) / WARPS};
}

// the camera block of frame k: Hcc row k and b_cam[k]
__device__ void build_frame(const Args& a, int k) {
  __shared__ float part[WARPS][42];
  __shared__ float tot[42];
  __shared__ float pose[3][42];      // odometry (k, k+1), odometry (k-1, k), anchor: diag 36 + gradient 6
  __shared__ float off[2][36];       // Hcc (k, k+1), (k, k-1)
  const int W = a.W, NS = a.NS, ND = a.ND, nc = a.nc;
  const SE3 X = load_pose(a.f(XR) + 9 * k, a.f(XT) + 3 * k);
  float Rt[9];
  transpose3(X.R, Rt);
  float acc[42];
  for (int i = 0; i < 42; ++i) acc[i] = 0.f;
  for (int fam = 0; fam < 2; ++fam) {
    const int N = fam == 0 ? NS : ND;
    const float inv_sig = 1.f / (fam == 0 ? a.p[SIG_S] : a.p[SIG_D]);
    const float kh = fam == 0 ? a.p[K_S] : a.p[K_D];
    const uint8_t* obs = fam == 0 ? a.b(STATIC_OBS) + k * NS : a.b(DYN_OBS) + k * ND;
    const float* res = (fam == 0 ? a.f(R_STATIC) + 3 * k * NS : a.f(R_DYN) + 3 * k * ND);
    for (int n = threadIdx.x; n < N; n += THREADS) {
      if (!obs[n]) continue;
      const float* r = res + 3 * n;
      const float sw = huber_weight3(r, kh);
      const float w = sw * sw;
      const float* p = fam == 0 ? a.f(SP) + 3 * n : a.f(DP) + 3 * (k * ND + n);
      const float d[3] = {p[0] - X.t[0], p[1] - X.t[1], p[2] - X.t[2]};
      float y[3];
      mv3(Rt, d, y);
      // J = [hat(y) | -I] / sigma
      float J[18];
      const float hy[9] = {0.f, -y[2], y[1], y[2], 0.f, -y[0], -y[1], y[0], 0.f};
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          J[6 * i + j] = hy[3 * i + j] * inv_sig;
          J[6 * i + 3 + j] = (i == j ? -1.f : 0.f) * inv_sig;
        }
      for (int c = 0; c < 6; ++c) {
        for (int e = 0; e < 6; ++e)
          acc[6 * c + e] += ((w * J[c]) * J[e] + (w * J[6 + c]) * J[6 + e]) + (w * J[12 + c]) * J[12 + e];
        acc[36 + c] += ((w * J[c]) * r[0] + (w * J[6 + c]) * r[1]) + (w * J[12 + c]) * r[2];
      }
    }
  }
  // the pose families, one warp each: odometry (k, k+1), (k-1, k), anchor
  __shared__ PoseSmem psm[3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 3) {
    PoseSmem& m = psm[warp];
    float* D = pose[warp];
    for (int i = lane; i < 42; i += 32) D[i] = 0.f;
    if (warp < 2) {
      const int pk = warp == 0 ? k : k - 1;       // pair (pk, pk + 1)
      if (pk >= 0 && pk + 1 < W) {
        const float wgt = a.b(ODOMETRY)[pk + 1] ? 1.f : 0.f;
        const SE3 Xa = load_pose(a.f(XR) + 9 * pk, a.f(XT) + 3 * pk);
        const SE3 Xb = load_pose(a.f(XR) + 9 * (pk + 1), a.f(XT) + 3 * (pk + 1));
        const SE3 Za = load_pose(a.f(XI_R) + 9 * pk, a.f(XI_T) + 3 * pk);
        const SE3 Zb = load_pose(a.f(XI_R) + 9 * (pk + 1), a.f(XI_T) + 3 * (pk + 1));
        const SE3 Z = dyno::se3_compose(dyno::se3_inverse(Za), Zb);
        between_jacobians_warp(Xa, Xb, &Z, a.p + ODO_SIG, m);
        const float* r = a.f(R_ODO) + 6 * pk;
        const float* Jk = warp == 0 ? m.Ja : m.Jb;
        for (int i = lane; i < 36; i += 32) {
          D[i] = gram_entry(wgt, Jk, Jk, i);
          const int t = warp == 0 ? i : 6 * (i % 6) + i / 6;      // (k, k-1) is the transpose
          off[warp][i] = gram_entry(wgt, m.Ja, m.Jb, t);
        }
        if (lane < 6) D[36 + lane] = grad_entry(wgt, Jk, r, lane);
      } else {
        for (int i = lane; i < 36; i += 32) off[warp][i] = 0.f;
      }
    } else if (k == 0) {
      if (lane == 0) {
        const SE3 A = load_pose(a.f(ANCHOR_R), a.f(ANCHOR_T));
        se3_log(dyno::se3_compose(dyno::se3_inverse(A), X), m.e);
      }
      __syncwarp();
      right_jacobian_inv_warp(m, m.Jb);
      const float* L = a.f(PRIOR_L);
      const float inv = 1.f / a.p[PRIOR_SIGMA];
      for (int i = lane; i < 36; i += 32) {
        if (L) {
          const int r = i / 6, c = i % 6;
          float s = 0.f;
          for (int mm = 0; mm < 6; ++mm) s += L[6 * mm + r] * m.Jb[6 * mm + c];
          m.Ja[i] = s;
        } else {
          m.Ja[i] = m.Jb[i] * inv;
        }
      }
      __syncwarp();
      for (int i = lane; i < 36; i += 32) D[i] = gram_entry(1.f, m.Ja, m.Ja, i);
      if (lane < 6) D[36 + lane] = grad_entry(1.f, m.Ja, a.f(R_ANCHOR), lane);
    }
  }
  block_sum<42>(acc, part, tot);
  // Hcc row block k and b_cam[k]
  for (int idx = threadIdx.x; idx < 6 * nc; idx += THREADS) {
    const int r = idx / nc, q = idx % nc, l = q / 6, c = q % 6;
    float v = 0.f;
    if (l == k) v = ((pose[0][6 * r + c] + pose[1][6 * r + c]) + pose[2][6 * r + c]) + tot[6 * r + c];
    else if (l == k + 1) v = off[0][6 * r + c];
    else if (l == k - 1) v = off[1][6 * r + c];
    a.f(HCC)[(6 * k + r) * nc + q] = v;
  }
  if (threadIdx.x < 6) {
    const int r = threadIdx.x;
    a.f(B_CAM)[6 * k + r] = -(((pose[0][36 + r] + pose[1][36 + r]) + pose[2][36 + r]) + tot[36 + r]);
  }
}

// a static point: Us[:, n], Hll_s[n], b_sp[n]; the camera poses come from
// shared memory and each frame's residual and mask are loaded before the
// previous frame's stores
__device__ void build_static(const Args& a, int n, const float (*Xs)[12]) {
  const int W = a.W, NS = a.NS;
  const float inv_sig = 1.f / a.p[SIG_S];
  float H[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
  const float* pp = a.f(SP) + 3 * n;
  const float p[3] = {pp[0], pp[1], pp[2]};
  float rn[3], r[3];
  bool on, o;
  for (int i = 0; i < 3; ++i) rn[i] = a.f(R_STATIC)[3 * n + i];
  on = a.b(STATIC_OBS)[n];
  for (int k = 0; k < W; ++k) {
    for (int i = 0; i < 3; ++i) r[i] = rn[i];
    o = on;
    if (k + 1 < W) {
      const float* rp = a.f(R_STATIC) + 3 * ((k + 1) * NS + n);
      for (int i = 0; i < 3; ++i) rn[i] = rp[i];
      on = a.b(STATIC_OBS)[(k + 1) * NS + n];
    }
    const float sw = huber_weight3(r, a.p[K_S]);
    const float w = (sw * sw) * (o ? 1.f : 0.f);
    const float* XR_ = Xs[k];
    const float* Xt_ = Xs[k] + 9;
    float Rt[9], Jp[9], y[3];
    transpose3(XR_, Rt);
    for (int i = 0; i < 9; ++i) Jp[i] = Rt[i] * inv_sig;
    const float d[3] = {p[0] - Xt_[0], p[1] - Xt_[1], p[2] - Xt_[2]};
    mv3(Rt, d, y);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float s = (Jp[i] * Jp[j] + Jp[3 + i] * Jp[3 + j]) + Jp[6 + i] * Jp[6 + j];
        H[3 * i + j] += w * s;
      }
    const float hy[9] = {0.f, -y[2], y[1], y[2], 0.f, -y[0], -y[1], y[0], 0.f};
    float* U = a.f(US) + 18 * (k * NS + n);
    for (int c = 0; c < 6; ++c)
      for (int m = 0; m < 3; ++m) {
        float s = 0.f;
        for (int i = 0; i < 3; ++i) {
          const float Jx = c < 3 ? hy[3 * i + c] * inv_sig : (i == c - 3 ? -1.f : 0.f) * inv_sig;
          s += Jx * Jp[3 * i + m];
        }
        U[3 * c + m] = w * s;
      }
    for (int m = 0; m < 3; ++m) g[m] += w * ((Jp[m] * r[0] + Jp[3 + m] * r[1]) + Jp[6 + m] * r[2]);
  }
  for (int i = 0; i < 9; ++i) a.f(HLL_S)[9 * n + i] = H[i] + (i % 4 == 0 ? a.p[TINY] : 0.f);
  for (int m = 0; m < 3; ++m) a.f(B_SP)[3 * n + m] = -g[m];
}

// a (frame, track): the observation part and the square-root motion
// factor; every load comes before the first store
__device__ void build_dynamic(const Args& a, int k, int d) {
  const int W = a.W, ND = a.ND, O = a.O;
  const int kd = k * ND + d;
  const float inv_sig = 1.f / a.p[SIG_D];
  const float* rp = a.f(R_DYN) + 3 * kd;
  const float r[3] = {rp[0], rp[1], rp[2]};
  const bool obs = a.b(DYN_OBS)[kd];
  const SE3 X = load_pose(a.f(XR) + 9 * k, a.f(XT) + 3 * k);
  const float* pp = a.f(DP) + 3 * kd;
  const float p[3] = {pp[0], pp[1], pp[2]};
  // select_motions(H, dyn_obj, ternary | next(ternary)): the one-hot and H_sel
  const bool tern = a.b(TERNARY)[kd];
  const bool active = tern || (k + 1 < W && a.b(TERNARY)[kd + ND]);
  const int obj = a.i32(DYN_OBJ)[kd];
  const bool sel = active && obj >= 0 && obj < O;
  SE3 Hs = dyno::se3_identity();
  float rt[3] = {0.f, 0.f, 0.f};
  if (k > 0) {
    if (sel) Hs = load_pose(a.f(HR) + 9 * (k * O + obj), a.f(HT) + 3 * (k * O + obj));
    const float* rtp = a.f(R_TERN) + 3 * ((k - 1) * ND + d);
    for (int i = 0; i < 3; ++i) rt[i] = rtp[i];
  }
  const float sw = huber_weight3(r, a.p[K_D]);
  const float w = (sw * sw) * (obs ? 1.f : 0.f);
  float Rt[9], Jp[9], y[3];
  transpose3(X.R, Rt);
  for (int i = 0; i < 9; ++i) Jp[i] = Rt[i] * inv_sig;
  const float dd[3] = {p[0] - X.t[0], p[1] - X.t[1], p[2] - X.t[2]};
  mv3(Rt, dd, y);
  const float hy[9] = {0.f, -y[2], y[1], y[2], 0.f, -y[0], -y[1], y[0], 0.f};
  float* Rc = a.f(RC) + 18 * kd;
  for (int m = 0; m < 3; ++m)
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
      for (int i = 0; i < 3; ++i) {
        const float Jx = c < 3 ? hy[3 * i + c] * inv_sig : (i == c - 3 ? -1.f : 0.f) * inv_sig;
        s += Jp[3 * i + m] * Jx;
      }
      Rc[6 * m + c] = w * s;
    }
  for (int m = 0; m < 3; ++m)
    a.f(B_DP)[3 * kd + m] = -(w * ((Jp[m] * r[0] + Jp[3 + m] * r[1]) + Jp[6 + m] * r[2]));
  a.f(CHAIN_C)[kd] = w * (1.f / a.p[SIG_D2]) + a.p[TINY];
  for (int o = 0; o < O; ++o) a.f(ONEHOT)[kd * O + o] = (sel && obj == o) ? 1.f : 0.f;
  float* sR = a.f(ST_R) + 9 * kd;
  float* sG = a.f(ST_G) + 18 * kd;
  float* sphi = a.f(ST_PHI) + 3 * kd;
  if (k == 0) {
    a.f(CHAIN_T)[kd] = 0.f;
    a.f(ST_S)[kd] = 0.f;
    for (int i = 0; i < 9; ++i) sR[i] = (i % 4 == 0) ? 1.f : 0.f;
    for (int i = 0; i < 18; ++i) sG[i] = 0.f;
    for (int i = 0; i < 3; ++i) sphi[i] = 0.f;
    return;
  }
  float HRt[9], yt[3];
  transpose3(Hs.R, HRt);
  const float dt[3] = {p[0] - Hs.t[0], p[1] - Hs.t[1], p[2] - Hs.t[2]};
  mv3(HRt, dt, yt);
  const float swt = huber_weight3(rt, a.p[K_D]);
  const float m = tern ? 1.f : 0.f;
  const float wgt = (swt * swt) * m;
  const float sqw = swt * m;
  a.f(CHAIN_T)[kd] = wgt * (1.f / a.p[SIG_T2]);
  a.f(ST_S)[kd] = sqw * (1.f / a.p[SIG_T]);
  for (int i = 0; i < 9; ++i) sR[i] = Hs.R[i];
  // G = [-hat(y) | I]
  const float hyt[9] = {0.f, -yt[2], yt[1], yt[2], 0.f, -yt[0], -yt[1], yt[0], 0.f};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      sG[6 * i + j] = -hyt[3 * i + j];
      sG[6 * i + 3 + j] = i == j ? 1.f : 0.f;
    }
  for (int i = 0; i < 3; ++i) sphi[i] = sqw * rt[i];
}

// a (frame, object) on one warp: the smoothing blocks Dmm, Omm1 and b_mot
__device__ void build_object(const Args& a, int k, int o, PoseSmem& m, float* D) {
  const int W = a.W, O = a.O, lane = threadIdx.x & 31;
  for (int i = lane; i < 42; i += 32) D[i] = 0.f;
  __syncwarp();
  for (int side = 0; side < 2; ++side) {
    const int pk = side == 0 ? k : k - 1;       // pair (pk, pk + 1)
    if (pk < 0 || pk + 1 >= W) continue;
    const float wgt = a.b(SMOOTHING)[(pk + 1) * O + o] ? 1.f : 0.f;
    const SE3 Ha = load_pose(a.f(HR) + 9 * (pk * O + o), a.f(HT) + 3 * (pk * O + o));
    const SE3 Hb = load_pose(a.f(HR) + 9 * ((pk + 1) * O + o), a.f(HT) + 3 * ((pk + 1) * O + o));
    between_jacobians_warp(Ha, Hb, nullptr, a.p + SMOOTH_SIG, m);
    const float* r = a.f(R_SMOOTH) + 6 * (pk * O + o);
    const float* Jk = side == 0 ? m.Ja : m.Jb;
    for (int i = lane; i < 36; i += 32) {
      D[i] = D[i] + gram_entry(wgt, Jk, Jk, i);
      if (side == 0) a.f(OMM1)[36 * (k * O + o) + i] = gram_entry(wgt, m.Ja, m.Jb, i);
    }
    if (lane < 6) D[36 + lane] = D[36 + lane] + grad_entry(wgt, Jk, r, lane);
    __syncwarp();
  }
  for (int i = lane; i < 36; i += 32) {
    a.f(DMM)[36 * (k * O + o) + i] = D[i];
    if (k < W - 2) a.f(OMM2)[36 * (k * O + o) + i] = 0.f;
  }
  if (lane < 6) a.f(B_MOT)[6 * (k * O + o) + lane] = -D[36 + lane];
}

__global__ void __launch_bounds__(THREADS) window_build_kernel(const Args a) {
  const BuildShape s = build_shape(a.W, a.NS, a.ND, a.O);
  int b = blockIdx.x;
  if (b < s.frame) {
    build_frame(a, b);
    return;
  }
  b -= s.frame;
  if (b < s.stat) {
    __shared__ float Xs[MAX_W][12];
    for (int i = threadIdx.x; i < 12 * a.W; i += THREADS) {
      const int k = i / 12, e = i % 12;
      Xs[k][e] = e < 9 ? a.f(XR)[9 * k + e] : a.f(XT)[3 * k + e - 9];
    }
    __syncthreads();
    const int n = b * THREADS + threadIdx.x;
    if (n < a.NS) build_static(a, n, Xs);
    return;
  }
  b -= s.stat;
  if (b < s.dyn) {
    const int i = b * THREADS + threadIdx.x;
    if (i < a.W * a.ND) build_dynamic(a, i / a.ND, i % a.ND);
    return;
  }
  b -= s.dyn;
  __shared__ PoseSmem osm[WARPS];
  __shared__ float oD[WARPS][42];
  const int warp = threadIdx.x >> 5, i = b * WARPS + warp;
  if (i < a.W * a.O) build_object(a, i / a.O, i % a.O, osm[warp], oD[warp]);
}

// ---------------------------------------------------------------- K8: step

__host__ __device__ inline int prep_track_blocks(int ND) { return ND; }

__host__ __device__ inline int chain_threads(int C) { return 32 * ((C + 31) / 32); }

// the forward sweep of every column of a track: 3 W x C floats
__host__ __device__ inline size_t chain_smem(int W, int C) { return sizeof(float) * 3 * W * C; }
__host__ __device__ inline int prep_static_blocks(int NS, int nc) { return (NS * (nc + 1) + THREADS - 1) / THREADS; }

struct TrackSmem {
  float alphaM[MAX_W], b2[MAX_W], delta[MAX_W];
  float BM[MAX_W][9], AUc[MAX_W][18], AUp[MAX_W][18], Bc[MAX_W][18], phi[MAX_W][3];
};

// the damped point diagonal's inverse 1 / (c + lam clamp(c + T_k + T_{k+1}))
// of (frame k, track d)
__device__ __forceinline__ float chain_inv_c(const Args& a, int k, int d, float lam) {
  const int kd = k * a.ND + d;
  const float cc = a.f(CHAIN_C)[kd], cT = a.f(CHAIN_T)[kd];
  const float cTn = k + 1 < a.W ? a.f(CHAIN_T)[kd + a.ND] : 0.f;
  return 1.f / (cc + lam * clamp_min((cc + cT) + cTn, a.p[FLOOR]));
}

// (frame k, track d) of the Woodbury elimination: inv_c, the object, the
// capacitance chain's diagonal alpha_M and coupling B_M, and the right
// side's blocks AU_cur (camera column k), AU_prev (column k-1), Bcol and
// phi_hat, into the scratch the chain, reduce and update passes read
__device__ void frame_track_prep(const Args& a, int k, int d) {
  const int ND = a.ND, O = a.O, kd = k * ND + d;
  const float lam = *a.f(LAM);
  const float invc = chain_inv_c(a, k, d, lam);
  const float invc_prev = k >= 1 ? chain_inv_c(a, k - 1, d, lam) : invc;
  const float sk = a.f(ST_S)[kd];
  const float sprev = k >= 1 ? a.f(ST_S)[kd - ND] : 0.f;
  int obj = -1;
  for (int o = 0; o < O; ++o)
    if (a.f(ONEHOT)[kd * O + o] != 0.f) obj = o;
  float RM[9], Rt[9], Rc[18], Rcp[18], G[18], bz[3], bzp[3], sphi[3];
  if (k == 0) {
    for (int i = 0; i < 9; ++i) RM[i] = (i % 4 == 0) ? 1.f : 0.f;
  } else {
    transpose3(a.f(ST_R) + 9 * (kd - ND), RM);
  }
  transpose3(a.f(ST_R) + 9 * kd, Rt);
  for (int i = 0; i < 18; ++i) {
    Rc[i] = a.f(RC)[18 * kd + i];
    Rcp[i] = k >= 1 ? a.f(RC)[18 * (kd - ND) + i] : 0.f;
    G[i] = a.f(ST_G)[18 * kd + i];
  }
  for (int i = 0; i < 3; ++i) {
    bz[i] = a.f(B_DP)[3 * kd + i] * invc;
    bzp[i] = k >= 1 ? a.f(B_DP)[3 * (kd - ND) + i] * invc_prev : 0.f;
    sphi[i] = a.f(ST_PHI)[3 * kd + i];
  }
  // all loads above, all stores below
  a.f(INV_C)[kd] = invc;
  a.i32(OBJ)[kd] = obj;
  a.f(ALPHA_M)[kd] = 1.f + (sk * sk) * (invc_prev + invc);
  const float coef = -((sprev * sk) * invc_prev);
  for (int i = 0; i < 9; ++i) a.f(BMAT)[9 * kd + i] = coef * RM[i];
  float RcC[18];
  for (int i = 0; i < 18; ++i) RcC[i] = Rc[i] * invc;
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 6; ++c) {
      const float m = (Rt[3 * i] * RcC[c] + Rt[3 * i + 1] * RcC[6 + c]) + Rt[3 * i + 2] * RcC[12 + c];
      a.f(AU_CUR)[18 * kd + 6 * i + c] = -sk * m;
    }
  for (int i = 0; i < 18; ++i) {
    a.f(AU_PREV)[18 * kd + i] = k >= 1 ? sk * (Rcp[i] * invc_prev) : 0.f;
    a.f(BCOL)[18 * kd + i] = sk * G[i];
  }
  float Rb[3];
  mv3(Rt, bz, Rb);
  for (int i = 0; i < 3; ++i) a.f(PHI_HAT)[3 * kd + i] = sk * (bzp[i] - Rb[i]) + sphi[i];
}

// one track's chain blocks into shared memory (all threads) and its pivots
// delta_k = alpha_k - |b_k|^2 / delta_{k-1} (thread 0)
__device__ __forceinline__ void load_track(const Args& a, int d, TrackSmem& t) {
  const int W = a.W, ND = a.ND;
  for (int i = threadIdx.x; i < 67 * W; i += blockDim.x) {
    const int k = i / 67, e = i % 67, kd = k * ND + d;
    if (e < 9) t.BM[k][e] = a.f(BMAT)[9 * kd + e];
    else if (e < 27) t.AUc[k][e - 9] = a.f(AU_CUR)[18 * kd + e - 9];
    else if (e < 45) t.AUp[k][e - 27] = a.f(AU_PREV)[18 * kd + e - 27];
    else if (e < 63) t.Bc[k][e - 45] = a.f(BCOL)[18 * kd + e - 45];
    else if (e < 66) t.phi[k][e - 63] = a.f(PHI_HAT)[3 * kd + e - 63];
    else t.alphaM[k] = a.f(ALPHA_M)[kd];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float dprev = 1.f;
    for (int k = 0; k < W; ++k) {
      const float b2 = (t.BM[k][0] * t.BM[k][0] + t.BM[k][1] * t.BM[k][1]) + t.BM[k][2] * t.BM[k][2];
      dprev = t.alphaM[k] - div0(b2, dprev);
      t.delta[k] = dprev;
    }
  }
  __syncthreads();
}

// one column c of the track's right side [AU_nc | Bcol_nc | phi_hat]: the
// block-Thomas forward substitution into shared memory `ys` (3 W x C),
// then the backward substitution, the solution written to Z
__device__ __forceinline__ void chain_column(const Args& a, int d, int c, const TrackSmem& t, float* ys) {
  const int W = a.W, ND = a.ND, nc = a.nc, C = a.C;
  float yp[3] = {0.f, 0.f, 0.f}, dprev = 1.f;
  for (int k = 0; k < W; ++k) {
    float rhs[3];
    for (int i = 0; i < 3; ++i) {
      float v = 0.f;
      if (c < nc) {
        const int cf = c / 6, cb = c % 6;
        if (cf == k) v = t.AUc[k][6 * i + cb];
        else if (cf == k - 1) v = t.AUp[k][6 * i + cb];
      } else if (c < 2 * nc) {
        const int cf = (c - nc) / 6, cb = (c - nc) % 6;
        if (cf == k) v = t.Bc[k][6 * i + cb];
      } else {
        v = t.phi[k][i];
      }
      rhs[i] = v;
    }
    const float u[3] = {div0(yp[0], dprev), div0(yp[1], dprev), div0(yp[2], dprev)};
    for (int i = 0; i < 3; ++i) {
      const float bu = (t.BM[k][i] * u[0] + t.BM[k][3 + i] * u[1]) + t.BM[k][6 + i] * u[2];
      yp[i] = rhs[i] - bu;
      ys[(3 * k + i) * C + c] = yp[i];
    }
    dprev = t.delta[k];
  }
  float xn[3] = {0.f, 0.f, 0.f};
  for (int k = W - 1; k >= 0; --k) {
    float x[3];
    for (int i = 0; i < 3; ++i) {
      const float y = ys[(3 * k + i) * C + c];
      if (k + 1 < W) {
        const float* B = t.BM[k + 1];
        const float bx = (B[3 * i] * xn[0] + B[3 * i + 1] * xn[1]) + B[3 * i + 2] * xn[2];
        x[i] = div0(y - bx, t.delta[k]);
      } else {
        x[i] = div0(y, t.delta[k]);
      }
    }
    float* z = a.f(ZBUF) + (size_t)3 * (k * ND + d) * C + c;
    for (int i = 0; i < 3; ++i) {
      z[(size_t)i * C] = x[i];
      xn[i] = x[i];
    }
  }
}

// static point n, column q of [Us_cols | b_sp]: Ys = inv3(Hll_s damped) @ column
__device__ void step_static(const Args& a, int n, int q) {
  const int nc = a.nc;
  const float lam = *a.f(LAM), floor_ = a.p[FLOOR];
  float H[9], Hi[9];
  for (int i = 0; i < 9; ++i) H[i] = a.f(HLL_S)[9 * n + i];
  for (int i = 0; i < 3; ++i) H[4 * i] = H[4 * i] + lam * clamp_min(H[4 * i], floor_);
  dyno::inv3(H, Hi);
  float col[3];
  if (q < nc) {
    const int k = q / 6, c = q % 6;
    for (int m = 0; m < 3; ++m) col[m] = a.f(US)[18 * (k * a.NS + n) + 3 * c + m];
  } else {
    for (int m = 0; m < 3; ++m) col[m] = a.f(B_SP)[3 * n + m];
  }
  float y[3];
  mv3(Hi, col, y);
  for (int m = 0; m < 3; ++m) {
    if (q < nc) a.f(YC_S)[(size_t)(3 * n + m) * nc + q] = y[m];
    else a.f(YB_S)[3 * n + m] = y[m];
  }
}

// a block per track: its chain blocks and pivots (`load_track`), then each
// thread solves one column's chain
__global__ void __launch_bounds__(256) window_step_chain_kernel(const Args a) {
  __shared__ TrackSmem t;
  extern __shared__ float ys[];
  const int d = blockIdx.x;
  load_track(a, d, t);
  for (int c = threadIdx.x; c < a.C; c += blockDim.x) chain_column(a, d, c, t, ys);
}

// a thread per (static point, column) of Ys
__global__ void __launch_bounds__(THREADS) window_step_static_kernel(const Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.NS * (a.nc + 1)) step_static(a, i / (a.nc + 1), i % (a.nc + 1));
}

// a thread per (frame, track) of the Woodbury blocks
__global__ void __launch_bounds__(THREADS) window_step_blocks_kernel(const Args a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < a.W * a.ND) frame_track_prep(a, i / a.ND, i % a.ND);
}

__device__ inline float zget(const Args& a, int k, int d, int i, int c) {
  return a.f(ZBUF)[((size_t)3 * (k * a.ND + d) + i) * a.C + c];
}

// the camera rows' sums over the points and tracks, split into SEGS
// segments of the point and track axes (a block per row and segment, a
// lane per column: column nc is the right side), and the pose diagonal's
// motion-factor term dd_t per (frame, segment); the reduce pass adds the
// segments in order
constexpr int SEGS = 32;

__host__ __device__ inline int cam_lanes(int nc) { return 32 * ((nc + 1 + 31) / 32); }

__host__ __device__ inline int partial_blocks(int nc, int W) { return (nc + W) * SEGS + W; }

// the tracks of frame k in a motion factor's chain (obj >= 0), in index
// order, and their count: the reduce pass's loops over tracks read these
__device__ void compact_active(const Args& a, int k) {
  __shared__ int wcount[4], wbase[4];
  __shared__ int base_s;
  const int ND = a.ND, lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int* obj = a.i32(OBJ) + k * ND;
  int* list = a.i32(ACT_LIST) + k * ND;
  if (threadIdx.x == 0) base_s = 0;
  __syncthreads();
  for (int d0 = 0; d0 < ND; d0 += blockDim.x) {
    const int d = d0 + threadIdx.x;
    const bool f = d < ND && obj[d] >= 0;
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    if (threadIdx.x == 0) {
      int b = base_s;
      for (int w = 0; w < nw; ++w) {
        wbase[w] = b;
        b += wcount[w];
      }
      base_s = b;
    }
    __syncthreads();
    if (f) list[wbase[warp] + __popc(bal & ((1u << lane) - 1u))] = d;
    __syncthreads();
  }
  if (threadIdx.x == 0) a.i32(ACT_COUNT)[k] = base_s;
}

__global__ void __launch_bounds__(128) window_step_partial_kernel(const Args a) {
  const int W = a.W, NS = a.NS, ND = a.ND, O = a.O, nc = a.nc;
  const float* st_s = a.f(ST_S);
  const int seg = blockIdx.x % SEGS, row = blockIdx.x / SEGS;
  const int ns_len = (NS + SEGS - 1) / SEGS, nd_len = (ND + SEGS - 1) / SEGS;
  const int n_lo = seg * ns_len, n_hi = min(NS, n_lo + ns_len);
  const int d_lo = seg * nd_len, d_hi = min(ND, d_lo + nd_len);
  const int q = threadIdx.x;
  if (blockIdx.x >= (nc + W) * SEGS) {
    compact_active(a, blockIdx.x - (nc + W) * SEGS);
    return;
  }
  if (row >= nc) {                                      // dd_t of frame k
    const int k = row - nc;
    if (q >= 6 * O) return;
    const int o = q / 6, ca = q % 6;
    float ddt = 0.f;
    for (int d = d_lo; d < d_hi; ++d) {
      const float oh = a.f(ONEHOT)[(k * ND + d) * O + o];
      if (oh == 0.f) continue;
      const float* G = a.f(ST_G) + 18 * (k * ND + d) + ca;
      const float g2 = (G[0] * G[0] + G[6] * G[6]) + G[12] * G[12];
      ddt += (a.f(CHAIN_T)[k * ND + d] * oh) * g2;
    }
    a.f(PART_DD)[(seg * W + k) * 6 * O + q] = ddt;
    return;
  }
  if (q > nc) return;
  const int p = row, j = p / 6, ca = p % 6;
  const int cz = q < nc ? q : 2 * nc;                   // the column of Z: camera q, or phi
  float dcs = 0.f, dc1 = 0.f, t = 0.f;
  // the column's entries of Ys (Yc_s column q, or yb_s) of point i: a point
  // unobserved in frame j has a zero Us row and adds exact zeros
  const float* Y = q < nc ? a.f(YC_S) + q : a.f(YB_S);
  const int ys = q < nc ? nc : 1;
#pragma unroll 8
  for (int i = n_lo; i < n_hi; ++i) {
    const float* u = a.f(US) + 18 * (j * NS + i) + 3 * ca;
    const float* y = Y + (size_t)3 * i * ys;
    dcs += (u[0] * y[0] + u[1] * y[ys]) + u[2] * y[2 * ys];
  }
  const bool diag_block = q < nc ? q / 6 == j : true;
#pragma unroll 4
  for (int d = d_lo; d < d_hi; ++d) {
    const int jd = j * ND + d;
    if (diag_block) {
      const float* R = a.f(RC) + 18 * jd;
      const float ic = a.f(INV_C)[jd];
      if (q < nc) {
        const int cb = q % 6;
        dc1 += ((R[ca] * ic) * R[cb] + (R[6 + ca] * ic) * R[6 + cb]) + (R[12 + ca] * ic) * R[12 + cb];
      } else {
        const float* bd = a.f(B_DP) + 3 * jd;
        dc1 += (R[ca] * (bd[0] * ic) + R[6 + ca] * (bd[1] * ic)) + R[12 + ca] * (bd[2] * ic);
      }
    }
    if (st_s[jd] != 0.f) {
      const float* A = a.f(AU_CUR) + 18 * jd + ca;
      t += (A[0] * zget(a, j, d, 0, cz) + A[6] * zget(a, j, d, 1, cz)) + A[12] * zget(a, j, d, 2, cz);
    }
    if (j + 1 < W && st_s[jd + ND] != 0.f) {
      const float* A = a.f(AU_PREV) + 18 * (jd + ND) + ca;
      t += (A[0] * zget(a, j + 1, d, 0, cz) + A[6] * zget(a, j + 1, d, 1, cz)) + A[12] * zget(a, j + 1, d, 2, cz);
    }
  }
  a.f(PART_CC)[((size_t)seg * nc + p) * (nc + 1) + q] = dcs + (dc1 - t);
}

__host__ __device__ inline long long reduce_threads(int nc, int nm, int O, int W) {
  return (long long)nc * nc + (long long)nc * O * 6 * W + (long long)nm * 6 * W + (nc + nm);
}

// the raw reduced system: each thread one entry (cc, cm, the object's mm
// row with zeros for the other objects, or the right side)
__global__ void __launch_bounds__(THREADS) window_step_reduce_kernel(const Args a) {
  const int W = a.W, ND = a.ND, O = a.O, nc = a.nc, nm = a.nm, n = a.n;
  const float lam = *a.f(LAM), floor_ = a.p[FLOOR];
  long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int* obj = a.i32(OBJ);
  float* Hraw = a.f(HRAW);
  if (idx < (long long)nc * nc) {                       // camera-camera
    const int p = idx / nc, q = idx % nc;
    float h = a.f(HCC)[p * nc + q];
    if (p == q) h = h + lam * clamp_min(h, floor_);
    float x = 0.f;
    for (int seg = 0; seg < SEGS; ++seg) x += a.f(PART_CC)[((size_t)seg * nc + p) * (nc + 1) + q];
    Hraw[(size_t)p * n + q] = h - x;
    return;
  }
  idx -= (long long)nc * nc;
  if (idx < (long long)nc * O * 6 * W) {                // camera-pose, both triangles
    const int gb = idx % (6 * W), o = (idx / (6 * W)) % O, p = idx / (6 * W * O);
    const int j = p / 6, ca = p % 6, g = gb / 6, cb = gb % 6;
    const int c = nc + gb;
    float acc = 0.f;
    for (int side = 0; side < 2; ++side) {
      const int k = j + side;                           // the factor row: AU_cur at j, AU_prev at j + 1
      if (k >= W) break;
      const int* list = a.i32(ACT_LIST) + k * ND;
      const int cnt = a.i32(ACT_COUNT)[k];
      const float* AU = a.f(side == 0 ? AU_CUR : AU_PREV);
      for (int i = 0; i < cnt; ++i) {
        const int d = list[i];
        if (obj[k * ND + d] != o || obj[g * ND + d] < 0) continue;
        const float* A = AU + 18 * (k * ND + d) + ca;
        acc += (A[0] * zget(a, k, d, 0, c) + A[6] * zget(a, k, d, 1, c)) + A[12] * zget(a, k, d, 2, c);
      }
    }
    const int m = (g * O + o) * 6 + cb;
    Hraw[(size_t)p * n + nc + m] = -acc;
    Hraw[(size_t)(nc + m) * n + p] = -acc;
    return;
  }
  idx -= (long long)nc * O * 6 * W;
  if (idx < (long long)nm * 6 * W) {                    // pose-pose, one object's band
    const int lb = idx % (6 * W), r = idx / (6 * W);
    const int k = r / (6 * O), o = (r / 6) % O, ca = r % 6, l = lb / 6, cb = lb % 6;
    const float* Dm = a.f(DMM) + 36 * (k * O + o);
    float band = 0.f;
    if (l == k) {
      float v = Dm[6 * ca + cb];
      if (ca == cb) {
        float ddt = 0.f;
        for (int seg = 0; seg < SEGS; ++seg) ddt += a.f(PART_DD)[(seg * W + k) * 6 * O + 6 * o + ca];
        v = v + lam * clamp_min(Dm[6 * ca + ca] + ddt, floor_);
      }
      band = v;
    }
    if (l == k + 1) band = band + a.f(OMM1)[36 * (k * O + o) + 6 * ca + cb];
    if (l == k - 1) band = band + a.f(OMM1)[36 * (l * O + o) + 6 * cb + ca];
    float chh = 0.f;
    const int c = nc + lb;
    const int* list = a.i32(ACT_LIST) + k * ND;
    const int cnt = a.i32(ACT_COUNT)[k];
    for (int i = 0; i < cnt; ++i) {
      const int d = list[i];
      if (obj[k * ND + d] != o || obj[l * ND + d] < 0) continue;
      const float* B = a.f(BCOL) + 18 * (k * ND + d) + ca;
      chh += (B[0] * zget(a, k, d, 0, c) + B[6] * zget(a, k, d, 1, c)) + B[12] * zget(a, k, d, 2, c);
    }
    float* row = Hraw + (size_t)(nc + r) * n + nc;
    for (int op = 0; op < O; ++op) row[(l * O + op) * 6 + cb] = op == o ? band - (-chh) : 0.f;
    return;
  }
  idx -= (long long)nm * 6 * W;
  if (idx < nc + nm) {                                   // the right side
    const int p = idx;
    const int Cphi = 2 * nc;
    if (p < nc) {
      float x = 0.f;
      for (int seg = 0; seg < SEGS; ++seg) x += a.f(PART_CC)[((size_t)seg * nc + p) * (nc + 1) + nc];
      a.f(BRED)[p] = a.f(B_CAM)[p] - x;
    } else {
      const int r = p - nc, k = r / (6 * O), o = (r / 6) % O, ca = r % 6;
      float bphi = 0.f;
      const int* list = a.i32(ACT_LIST) + k * ND;
      const int cnt = a.i32(ACT_COUNT)[k];
      for (int i = 0; i < cnt; ++i) {
        const int d = list[i];
        if (obj[k * ND + d] != o) continue;
        const float* B = a.f(BCOL) + 18 * (k * ND + d) + ca;
        bphi += (B[0] * zget(a, k, d, 0, Cphi) + B[6] * zget(a, k, d, 1, Cphi)) + B[12] * zget(a, k, d, 2, Cphi);
      }
      a.f(BRED)[p] = a.f(B_MOT)[r] - bphi;
    }
  }
}

// Hred = (Hraw + Hraw^T) / 2 + (rel max|diag| + tiny) I, a 32 x 32 tile a
// block (the tile and its transpose through shared memory)
constexpr int TILE = 32;

__host__ __device__ inline int finish_blocks(int n) {
  const int t = (n + TILE - 1) / TILE;
  return t * t;
}

__global__ void __launch_bounds__(256) window_step_finish_kernel(const Args a) {
  __shared__ float part[8];
  __shared__ float dmax_s;
  __shared__ float tA[TILE][TILE + 1], tB[TILE][TILE + 1];
  const int n = a.n;
  const float* Hraw = a.f(HRAW);
  float m = 0.f;
  for (int p = threadIdx.x; p < n; p += blockDim.x) m = nan_max(m, fabsf(Hraw[(size_t)p * n + p]));
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  const int tiles = (n + TILE - 1) / TILE;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x % tiles;
  const int c = threadIdx.x % TILE;
  for (int r = threadIdx.x / TILE; r < TILE; r += blockDim.x / TILE) {
    const int p = ti * TILE + r, q = tj * TILE + c, pt = tj * TILE + r, qt = ti * TILE + c;
    tA[r][c] = (p < n && q < n) ? Hraw[(size_t)p * n + q] : 0.f;
    tB[r][c] = (pt < n && qt < n) ? Hraw[(size_t)pt * n + qt] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = part[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = nan_max(v, part[w]);
    dmax_s = v;
  }
  __syncthreads();
  const float add = a.p[REL] * dmax_s + a.p[TINY];
  for (int r = threadIdx.x / TILE; r < TILE; r += blockDim.x / TILE) {
    const int p = ti * TILE + r, q = tj * TILE + c;
    if (p >= n || q >= n) continue;
    float v = 0.5f * (tA[r][c] + tB[c][r]);
    if (p == q) v = v + add;
    a.f(HRED)[(size_t)p * n + q] = v;
  }
}

// ---------------------------------------------------------------- K9: update

// offsets of the trial values and residuals in the TRIAL buffer, in the
// order of the state arrays they replace
struct TrialLayout {
  long long off[13];
};

__host__ __device__ inline TrialLayout trial_layout(int W, int NS, int ND, int O) {
  const long long sz[12] = {9LL * W, 3LL * W, 9LL * W * O, 3LL * W * O, 3LL * NS, 3LL * W * ND,
                            6, 6LL * (W - 1), 3LL * W * NS, 3LL * W * ND, 3LL * (W - 1) * ND, 6LL * (W - 1) * O};
  TrialLayout t;
  t.off[0] = 0;
  for (int i = 0; i < 12; ++i) t.off[i + 1] = t.off[i] + sz[i];
  return t;
}

struct UpdateShape {
  int frame, stat, track, obj;
};

__host__ __device__ inline UpdateShape update_shape(int W, int NS, int ND, int O) {
  return UpdateShape{1, (NS + THREADS - 1) / THREADS, (ND + WARPS - 1) / WARPS, (W * O + THREADS - 1) / THREADS};
}

__device__ inline float step_entry(const Args& a, int i, bool bad) {
  return bad ? __int_as_float(0x7fc00000) : a.f(SOL)[i];
}

__device__ float huber_loss3(const float* r, float k, float half_k2) {
  const float sq = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
  return dyno::huber_loss(sq, k, half_k2);
}

__device__ float none_loss6(const float* r) {
  float sq = 0.f;
  for (int i = 0; i < 6; ++i) sq += r[i] * r[i];
  return 0.5f * sq;
}

// the trial at the current values plus the step (`head`: at the current
// values, the LM head's residuals and error)
__global__ void __launch_bounds__(THREADS) window_update_trial_kernel(const Args a, int head) {
  __shared__ SE3 Xn[MAX_W];
  __shared__ float part[WARPS][N_FAMILY];
  __shared__ float tot[N_FAMILY];
  __shared__ float coef[WARPS][2 * 6 * MAX_W + 1];
  __shared__ float vsh[WARPS][MAX_W][3];
  __shared__ float dpn[WARPS][MAX_W][3];
  __shared__ int objs[WARPS][MAX_W];
  const int W = a.W, NS = a.NS, ND = a.ND, O = a.O, nc = a.nc, C = a.C;
  const bool bad = !head && *a.i32(INFO) != 0;          // a head has no step, sol and info are null
  const TrialLayout L = trial_layout(W, NS, ND, O);
  float* T = a.f(TRIAL);
  const UpdateShape s = update_shape(W, NS, ND, O);
  if (threadIdx.x < W) {
    const int k = threadIdx.x;
    float xi[6];
    for (int i = 0; i < 6; ++i) xi[i] = head ? 0.f : step_entry(a, 6 * k + i, bad);
    Xn[k] = head ? load_pose(a.f(XR) + 9 * k, a.f(XT) + 3 * k) : retract(a.f(XR) + 9 * k, a.f(XT) + 3 * k, xi);
  }
  __syncthreads();
  float loss[N_FAMILY] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (b < s.frame) {
    // camera values, anchor and odometry residuals
    const int k = threadIdx.x;
    if (k < W) {
      for (int i = 0; i < 9; ++i) T[L.off[0] + 9 * k + i] = Xn[k].R[i];
      for (int i = 0; i < 3; ++i) T[L.off[1] + 3 * k + i] = Xn[k].t[i];
      if (k + 1 < W) {
        float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (a.b(ODOMETRY)[k + 1]) {
          const SE3 Za = load_pose(a.f(XI_R) + 9 * k, a.f(XI_T) + 3 * k);
          const SE3 Zb = load_pose(a.f(XI_R) + 9 * (k + 1), a.f(XI_T) + 3 * (k + 1));
          const SE3 Z = dyno::se3_compose(dyno::se3_inverse(Za), Zb);
          const SE3 M = dyno::se3_compose(dyno::se3_inverse(Xn[k]), Xn[k + 1]);
          float e[6];
          se3_log(dyno::se3_compose(dyno::se3_inverse(Z), M), e);
          for (int i = 0; i < 6; ++i) r[i] = div0(e[i], a.p[ODO_SIG + i]);
        }
        for (int i = 0; i < 6; ++i) T[L.off[7] + 6 * k + i] = r[i];
        loss[1] = none_loss6(r);
      }
      if (k == 0) {
        const SE3 A = load_pose(a.f(ANCHOR_R), a.f(ANCHOR_T));
        float e[6], r[6];
        se3_log(dyno::se3_compose(dyno::se3_inverse(A), Xn[0]), e);
        const float* Lp = a.f(PRIOR_L);
        for (int i = 0; i < 6; ++i) {
          if (Lp) {
            float v = 0.f;
            for (int m = 0; m < 6; ++m) v += Lp[6 * m + i] * e[m];
            r[i] = v;
          } else {
            r[i] = e[i] * (1.f / a.p[PRIOR_SIGMA]);
          }
          T[L.off[6] + i] = r[i];
        }
        loss[0] = none_loss6(r);
      }
    }
  } else if ((b -= s.frame) < s.stat) {
    const int n = b * THREADS + threadIdx.x;
    if (n < NS) {
      float spn[3];
      for (int m = 0; m < 3; ++m) {
        if (head) {
          spn[m] = a.f(SP)[3 * n + m];
        } else {
          float acc = 0.f;
#pragma unroll 8
          for (int q = 0; q < nc; ++q) acc += a.f(YC_S)[(size_t)(3 * n + m) * nc + q] * step_entry(a, q, bad);
          spn[m] = a.f(SP)[3 * n + m] + (a.f(YB_S)[3 * n + m] - acc);
        }
      }
      for (int m = 0; m < 3; ++m) T[L.off[4] + 3 * n + m] = spn[m];
      const float inv_sig = 1.f / a.p[SIG_S];
      // each frame's mask and measurement loaded before the previous
      // frame's stores
      bool on = a.b(STATIC_OBS)[n];
      float zn[3] = {a.f(STATIC_XYZ)[3 * n], a.f(STATIC_XYZ)[3 * n + 1], a.f(STATIC_XYZ)[3 * n + 2]};
      for (int k = 0; k < W; ++k) {
        const bool o = on;
        const float z[3] = {zn[0], zn[1], zn[2]};
        if (k + 1 < W) {
          on = a.b(STATIC_OBS)[(k + 1) * NS + n];
          for (int i = 0; i < 3; ++i) zn[i] = a.f(STATIC_XYZ)[3 * ((k + 1) * NS + n) + i];
        }
        float r[3] = {0.f, 0.f, 0.f};
        if (o) {
          float y[3];
          to_local(Xn[k], spn, y);
          for (int i = 0; i < 3; ++i) r[i] = (y[i] - z[i]) * inv_sig;
        }
        for (int i = 0; i < 3; ++i) T[L.off[8] + 3 * (k * NS + n) + i] = r[i];
        loss[2] += huber_loss3(r, a.p[K_S], a.p[HALF_K2_S]);
      }
    }
  } else if ((b -= s.stat) < s.track) {
    const int d = b * WARPS + warp;
    if (d < ND) {
      if (lane < W) {
        int ob = -1;
        for (int o = 0; o < O; ++o)
          if (a.f(ONEHOT)[(lane * ND + d) * O + o] != 0.f) ob = o;
        objs[warp][lane] = ob;
      }
      __syncwarp();
      for (int c = lane; c < C && !head; c += 32) {
        float v;
        if (c < nc) {
          v = -step_entry(a, c, bad);
        } else if (c < 2 * nc) {
          const int g = (c - nc) / 6, cb = (c - nc) % 6, ob = objs[warp][g];
          v = ob >= 0 ? step_entry(a, nc + (g * O + ob) * 6 + cb, bad) : (bad ? step_entry(a, 0, bad) : 0.f);
        } else {
          v = 1.f;
        }
        coef[warp][c] = v;
      }
      __syncwarp();
      // v_k = Z_k coef: each lane's share of all 3W sums first (their loads
      // independent), then one butterfly each
      if (!head) {
        float acc[MAX_W][3];
#pragma unroll
        for (int k = 0; k < MAX_W; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.f;
        for (int c = lane; c < C; c += 32) {
          const float cf = coef[warp][c];
#pragma unroll
          for (int k = 0; k < MAX_W; ++k) {
            if (k < W) {
              const float* z = a.f(ZBUF) + (size_t)3 * (k * ND + d) * C + c;
              acc[k][0] += z[0] * cf;
              acc[k][1] += z[C] * cf;
              acc[k][2] += z[2 * C] * cf;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < MAX_W; ++k) {
          if (k < W) {
            for (int i = 0; i < 3; ++i) {
              const float v = dyno::warp_sum(acc[k][i]);
              if (lane == 0) vsh[warp][k][i] = v;
            }
          }
        }
      }
      __syncwarp();
      if (lane < W && head) {
        for (int i = 0; i < 3; ++i) {
          dpn[warp][lane][i] = a.f(DP)[3 * (lane * ND + d) + i];
          T[L.off[5] + 3 * (lane * ND + d) + i] = dpn[warp][lane][i];
        }
      } else if (lane < W) {
        const int k = lane, kd = k * ND + d;
        float Rv[3];
        mv3(a.f(ST_R) + 9 * kd, vsh[warp][k], Rv);
        const float sk = a.f(ST_S)[kd];
        const float sn = k + 1 < W ? a.f(ST_S)[kd + ND] : 0.f;
        const float* Rc = a.f(RC) + 18 * kd;
        for (int i = 0; i < 3; ++i) {
          const float vn = k + 1 < W ? vsh[warp][k + 1][i] : 0.f;
          const float atv = (-sk) * Rv[i] + sn * vn;
          float rdc = 0.f;
          for (int c = 0; c < 6; ++c) rdc += Rc[6 * i + c] * step_entry(a, 6 * k + c, bad);
          const float r1 = a.f(B_DP)[3 * kd + i] - rdc;
          const float ddp = (r1 - atv) * a.f(INV_C)[kd];
          dpn[warp][k][i] = a.f(DP)[3 * kd + i] + ddp;
          T[L.off[5] + 3 * kd + i] = dpn[warp][k][i];
        }
      }
      __syncwarp();
      if (lane < W) {
        const int k = lane, kd = k * ND + d;
        float r[3] = {0.f, 0.f, 0.f};
        if (a.b(DYN_OBS)[kd]) {
          float y[3];
          to_local(Xn[k], dpn[warp][k], y);
          const float* z = a.f(DYN_XYZ) + 3 * kd;
          const float inv_sig = 1.f / a.p[SIG_D];
          for (int i = 0; i < 3; ++i) r[i] = (y[i] - z[i]) * inv_sig;
        }
        for (int i = 0; i < 3; ++i) T[L.off[9] + 3 * kd + i] = r[i];
        loss[3] = huber_loss3(r, a.p[K_D], a.p[HALF_K2_D]);
        if (k >= 1) {
          float rt[3] = {0.f, 0.f, 0.f};
          if (a.b(TERNARY)[kd]) {
            const int ob = a.i32(DYN_OBJ)[kd];
            const bool sel = (a.b(TERNARY)[kd] || a.b(DYN_OBS)[kd]) && ob >= 0 && ob < O;
            SE3 Hn = dyno::se3_identity();
            if (sel) {
              float xi[6];
              for (int i = 0; i < 6; ++i) xi[i] = head ? 0.f : step_entry(a, nc + 6 * (k * O + ob) + i, bad);
              Hn = head ? load_pose(a.f(HR) + 9 * (k * O + ob), a.f(HT) + 3 * (k * O + ob))
                        : retract(a.f(HR) + 9 * (k * O + ob), a.f(HT) + 3 * (k * O + ob), xi);
            }
            float y[3];
            to_local(Hn, dpn[warp][k], y);
            const float inv_sig = 1.f / a.p[SIG_T];
            for (int i = 0; i < 3; ++i) rt[i] = (dpn[warp][k - 1][i] - y[i]) * inv_sig;
          }
          for (int i = 0; i < 3; ++i) T[L.off[10] + 3 * ((k - 1) * ND + d) + i] = rt[i];
          loss[4] = huber_loss3(rt, a.p[K_D], a.p[HALF_K2_D]);
        }
      }
    }
  } else {
    b -= s.track;
    const int i = b * THREADS + threadIdx.x;
    if (i < W * O) {
      const int k = i / O, o = i % O;
      float xi[6];
      for (int j = 0; j < 6; ++j) xi[j] = head ? 0.f : step_entry(a, nc + 6 * i + j, bad);
      const SE3 Hn = head ? load_pose(a.f(HR) + 9 * i, a.f(HT) + 3 * i) : retract(a.f(HR) + 9 * i, a.f(HT) + 3 * i, xi);
      for (int j = 0; j < 9; ++j) T[L.off[2] + 9 * i + j] = Hn.R[j];
      for (int j = 0; j < 3; ++j) T[L.off[3] + 3 * i + j] = Hn.t[j];
      if (k >= 1) {
        float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (a.b(SMOOTHING)[k * O + o]) {
          const int ip = (k - 1) * O + o;
          for (int j = 0; j < 6; ++j) xi[j] = head ? 0.f : step_entry(a, nc + 6 * ip + j, bad);
          const SE3 Hp = head ? load_pose(a.f(HR) + 9 * ip, a.f(HT) + 3 * ip)
                              : retract(a.f(HR) + 9 * ip, a.f(HT) + 3 * ip, xi);
          float e[6];
          se3_log(dyno::se3_compose(dyno::se3_inverse(Hp), Hn), e);
          for (int j = 0; j < 6; ++j) r[j] = div0(e[j], a.p[SMOOTH_SIG + j]);
        }
        for (int j = 0; j < 6; ++j) T[L.off[11] + 6 * ((k - 1) * O + o) + j] = r[j];
        loss[5] = none_loss6(r);
      }
    }
  }
  block_sum<N_FAMILY>(loss, part, tot);
  if (threadIdx.x < N_FAMILY) a.f(PARTIALS)[blockIdx.x * N_FAMILY + threadIdx.x] = tot[threadIdx.x];
}

// one block: the trial error from the partials (families in order, blocks
// in order), the step's finiteness and `_lm_tail`'s decisions
__global__ void __launch_bounds__(256) window_update_decide_kernel(const Args a, int nblocks, int head) {
  __shared__ float sums[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool bad = !head && *a.i32(INFO) != 0;
  float acc = 0.f;
  if (warp < N_FAMILY) {
    for (int b = lane; b < nblocks; b += 32) acc += a.f(PARTIALS)[b * N_FAMILY + warp];
  } else if (!head) {
    const int lo = warp == 6 ? 0 : a.nc, hi = warp == 6 ? a.nc : a.n;
    for (int i = lo + lane; i < hi; i += 32) acc += step_entry(a, i, bad);
  }
  acc = dyno::warp_sum(acc);
  if (lane == 0) sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x != 0) return;
  float e_new = sums[0];
  for (int f = 1; f < N_FAMILY; ++f) e_new = e_new + sums[f];
  if (head) {                                           // `_lm_head`
    *a.f(ERR) = e_new;
    *a.f(ERR_INIT) = e_new;
    *a.f(LAM) = a.p[INIT_LAMBDA];
    *a.f(LAM_MIN) = a.p[MIN_LAMBDA];
    *a.bw(DONE) = 0;
    return;
  }
  if (!isfinite(e_new)) e_new = __int_as_float(0x7f800000);
  const float err = *a.f(ERR), lam = *a.f(LAM);
  float lam_min = *a.f(LAM_MIN);
  const bool done = *a.b(DONE) != 0;
  const bool active = !done;
  const bool accept = (e_new < err) && active;
  const bool finite = isfinite(sums[6]) && isfinite(sums[7]);
  const bool step_nan = !finite && active;
  const float lf = a.p[LAMBDA_FACTOR];
  if (step_nan) lam_min = nan_max(lam_min, lam * lf);
  const float err_out = accept ? e_new : err;
  const float lam_out = accept ? nan_max(lam * (1.f / lf), lam_min) : clamp_max(lam * lf, a.p[MAX_LAMBDA]);
  const float change = fabsf(err - err_out);
  const bool converged = accept && ((change < a.p[REL_TOL] * clamp_min(err, 1e-30f)) || (change < a.p[ABS_TOL]));
  const bool done_out = done || converged || (active && lam_out >= a.p[MAX_LAMBDA]);
  *a.f(ERR) = err_out;
  *a.f(LAM) = active ? lam_out : lam;
  *a.f(LAM_MIN) = lam_min;
  *a.bw(DONE) = done_out;
  *a.bw(ACCEPT) = accept;
  a.bw(FLAGS)[0] = accept;
  a.bw(FLAGS)[1] = done_out;
}

// the trial values and residuals into the state where accepted
__global__ void __launch_bounds__(THREADS) window_update_commit_kernel(const Args a, int head) {
  if (!head && !*a.b(ACCEPT)) return;
  const TrialLayout L = trial_layout(a.W, a.NS, a.ND, a.O);
  const int dst[12] = {XR, XT, HR, HT, SP, DP, R_ANCHOR, R_ODO, R_STATIC, R_DYN, R_TERN, R_SMOOTH};
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < L.off[12];
       i += (long long)gridDim.x * THREADS) {
    int arr = 0;
    while (i >= L.off[arr + 1]) ++arr;
    a.f(dst[arr])[i - L.off[arr]] = a.f(TRIAL)[i];
  }
}

// ---------------------------------------------------------------- host side

cudaError_t make_args(const long long* ptrs, const int* dims, const float* params, Args& a) {
  a.W = dims[0];
  a.NS = dims[1];
  a.ND = dims[2];
  a.O = dims[3];
  if (a.W < 2 || a.W > MAX_W || a.NS < 1 || a.ND < 1 || a.O < 1 || a.O > 8 || a.NS > 1024 || a.ND > 1024)
    return cudaErrorInvalidValue;
  a.nc = 6 * a.W;
  a.nm = 6 * a.W * a.O;
  a.n = a.nc + a.nm;
  a.C = 2 * a.nc + 1;
  for (int i = 0; i < N_PARAM; ++i) a.p[i] = params[i];
  for (int i = 0; i < N_PTR; ++i) a.ptr[i] = reinterpret_cast<void*>(ptrs[i]);
  return cudaSuccess;
}

int grid_of(long long threads) { return (int)((threads + THREADS - 1) / THREADS); }

}  // namespace

// blocks and threads of each launch: build, static, partial, reduce,
// finish, trial, decide, commit; then the floats of the trial buffer, the
// blocks of error partials and the floats of the camera-row and dd_t
// partials; then the chain's and the Woodbury blocks' blocks and threads
extern "C" int dyno_window_launch_shape(const int* dims, int* out) {
  const int W = dims[0], NS = dims[1], ND = dims[2], O = dims[3];
  const int nc = 6 * W, nm = 6 * W * O, n = nc + nm;
  const BuildShape bs = build_shape(W, NS, ND, O);
  const UpdateShape us = update_shape(W, NS, ND, O);
  const TrialLayout tl = trial_layout(W, NS, ND, O);
  out[0] = bs.frame + bs.stat + bs.dyn + bs.obj;
  out[1] = THREADS;
  out[2] = prep_static_blocks(NS, nc);
  out[3] = THREADS;
  out[20] = prep_track_blocks(ND);
  out[21] = chain_threads(2 * nc + 1);
  out[22] = grid_of((long long)W * ND);
  out[23] = THREADS;
  out[4] = partial_blocks(nc, W);
  out[5] = cam_lanes(nc);
  out[6] = grid_of(reduce_threads(nc, nm, O, W));
  out[7] = THREADS;
  out[8] = finish_blocks(n);
  out[9] = 256;
  out[10] = us.frame + us.stat + us.track + us.obj;
  out[11] = THREADS;
  out[12] = 1;
  out[13] = 256;
  out[14] = 132;
  out[15] = THREADS;
  out[16] = (int)tl.off[12];
  out[17] = out[10];
  out[18] = SEGS * nc * (nc + 1);
  out[19] = SEGS * W * 6 * O;
  return 0;
}

extern "C" int dyno_window_build(const long long* ptrs, const int* dims, const float* params, void* stream) {
  Args a;
  cudaError_t e = make_args(ptrs, dims, params, a);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const BuildShape bs = build_shape(a.W, a.NS, a.ND, a.O);
  window_build_kernel<<<bs.frame + bs.stat + bs.dyn + bs.obj, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dyno_window_step(const long long* ptrs, const int* dims, const float* params, void* stream) {
  Args a;
  cudaError_t e = make_args(ptrs, dims, params, a);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  window_step_static_kernel<<<prep_static_blocks(a.NS, a.nc), THREADS, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_step_blocks_kernel<<<grid_of((long long)a.W * a.ND), THREADS, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_step_chain_kernel<<<prep_track_blocks(a.ND), chain_threads(a.C), chain_smem(a.W, a.C), s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_step_partial_kernel<<<partial_blocks(a.nc, a.W), cam_lanes(a.nc), 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_step_reduce_kernel<<<grid_of(reduce_threads(a.nc, a.nm, a.O, a.W)), THREADS, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_step_finish_kernel<<<finish_blocks(a.n), 256, 0, s>>>(a);
  return (int)cudaGetLastError();
}

static int update(const long long* ptrs, const int* dims, const float* params, void* stream, int head) {
  Args a;
  cudaError_t e = make_args(ptrs, dims, params, a);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const UpdateShape us = update_shape(a.W, a.NS, a.ND, a.O);
  const int nblocks = us.frame + us.stat + us.track + us.obj;
  window_update_trial_kernel<<<nblocks, THREADS, 0, s>>>(a, head);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_update_decide_kernel<<<1, 256, 0, s>>>(a, nblocks, head);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_update_commit_kernel<<<132, THREADS, 0, s>>>(a, head);
  return (int)cudaGetLastError();
}

extern "C" int dyno_window_update(const long long* ptrs, const int* dims, const float* params, void* stream) {
  return update(ptrs, dims, params, stream, 0);
}

// K9 at a zero step: the LM head (`_lm_head`), residuals and error at the
// current values, the initial error and lambda
extern "C" int dyno_window_head(const long long* ptrs, const int* dims, const float* params, void* stream) {
  return update(ptrs, dims, params, stream, 1);
}
