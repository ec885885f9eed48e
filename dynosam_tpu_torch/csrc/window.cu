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
//   K8 window_step   -- `schur_reduce`, two kernels.  The segment pass:
//        a CTA of 512 threads a segment of at most 8 static points and 8
//        tracks (about 128 CTAs, one an SM); it stages them in shared
//        memory, forms the damped static blocks' inverses (`_inv3`'s
//        adjugate) and Hll^-1 [Us | b_sp], and adds into its share of the
//        camera rows' sums (nc x (nc + 1), column nc the right side; a
//        thread a row and a strided set of columns, in registers) the
//        static elimination, the tracks' observation blocks and, for each
//        track in a motion factor's chain, AU^T M^-1 [AU | phi_hat] from
//        its chain solved for all 2 * 6W + 1 right sides in shared memory
//        (the Woodbury blocks and `chain_solve_scalar`'s pivots there
//        too), and the pose diagonal's motion-factor term; it writes its
//        share as one partial.  The chain solutions leave the chip only
//        for a (frame, track) with an object: its blocks and the motion
//        and phi columns (KEEP, 54 + 3 (6W + 1) floats), which the
//        camera-motion, motion-motion and motion right-side entries read,
//        per object, from the CTAs' lists of those tracks.  The assembly:
//        a warp per camera pair adds the partials (lanes over the CTAs,
//        then a butterfly) and writes both symmetrised entries; a block
//        per (frame, object, frame) sums the object's kept tracks for its
//        6x6 camera-motion and motion-motion blocks (both triangles, then
//        their mean) and writes the other objects' zeros; the last block
//        to finish (an integer ticket) adds the floor rel max|diag| +
//        tiny.  The factorisation stays `torch.linalg.cholesky_ex` /
//        `cholesky_solve` (cuSOLVER).
//   K9 window_update -- `schur_back` and `_lm_tail`, two kernels: the
//        back-substitution from the one right side the step needs (a static
//        point's Hll^-1 (b_sp - Us^T dc); a track's chain, its blocks
//        rebuilt from the system on a warp, solved for phi_hat - AU_nc dc +
//        Bcol_nc dm_sel on lane 0), written to the step buffer with the
//        camera and motion steps; retraction, trial residuals and their
//        robust error (per-block partials per family); the last block to
//        finish (a ticket) adds the partials in block order and takes the
//        accept, lambda, ratchet and convergence decisions; then a pass
//        commits the trial where accepted (the graphs keep the state's
//        fixed buffers, so the trial cannot be swapped in).  At a zero step
//        (`dyno_window_head`) the same kernels give the LM head.
//
// Bound on the card: latency.  A KITTI window (W 10, 1,024 static points,
// 1,024 tracks, 8 objects) needs ~0.05 GFLOP an iteration, microseconds of
// the card's float32 rate, and ~10 MB of traffic (the system, state,
// window, reduced system and step), a few microseconds of HBM.  An
// iteration is four launches of K8 and K9 and one of K7, besides the
// factorisation's; what is left is each launch's chain of dependent steps
// (global loads, barriers, a chain's 2 W substitutions) and the grid's
// drain between launches.  The design keeps every intermediate of the
// reduction on chip (the chain solutions of a window with motion factors
// were 15 MB written and read three times), puts each thread's loads
// before its stores (the compiler keeps a load behind a store to a pointer
// that may alias), and ends each kernel with its one global dependency
// taken by the last block.  Two other designs measured slower on the card
// (`testing/window_split.py`, `testing/kernel_phases.py --window`; PERF.md):
// the segment pass in thread block clusters adding their shares over
// distributed shared memory (the cluster launch and barriers cost more
// than the assembly's reading every CTA's partial), and a warp staging a
// track's rows for K9 (slower than each lane loading its own).  An IEEE division of a zero goes by a product (`div0`): the
// division's slow path on the zeros of motion-free chains is costly.
//
// No float atomics: every sum runs in a fixed order (index order within a
// thread, warp butterflies, warps and CTAs in order), so a launch repeats
// bit for bit; the integer counters in the state (`tickets`: each kernel's
// last-block ticket, the objects each frame carries, an OR) are reset by
// the last block.  Padding rows and masked factors give exact zeros, which
// the sums skip.  The products and sums are rounded one by one
// (`-fmad=false`), in the plain version's order where it is a short closed
// form; long sums differ in order, so the kernels agree with the plain
// versions within float32 spread, not bit for bit.  float32 only; W <= 16,
// NS <= 1024, ND <= 1024, O <= 8 (`kernels/window.py:check` raises on
// anything else).
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
constexpr int MAX_O = 8;
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
  ERR, LAM, LAM_MIN, DONE, ACCEPT, FLAGS, ERR_INIT, TICKETS,
  HRED, BRED, SOL, INFO, TRIAL, PARTIALS, PART, OBJ, ACT_LIST, ACT_COUNT, KEEP, STEP,
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

// one (frame, track) of a capacitance chain: the motion factor's scale s,
// the chain's diagonal alpha_M, its pivot delta and coupling B_M, and the
// right side's blocks AU_cur (camera column k), AU_prev (column k-1), Bcol
// (the motion of frame k) and phi_hat
struct ChainFrame {
  float s, alphaM, delta, BM[9], AUc[18], AUp[18], Bc[18], phi[3];
};

// the damped point diagonal's inverse 1 / (c + lam clamp(c + T_k + T_{k+1}))
// of one (frame, track) from its c, T and the next frame's T
__device__ __forceinline__ float inv_c_of(float cc, float cT, float cTn, float lam, float floor_) {
  return 1.f / (cc + lam * clamp_min((cc + cT) + cTn, floor_));
}

__device__ __forceinline__ float chain_inv_c(const Args& a, int k, int d, float lam) {
  const int kd = k * a.ND + d;
  return inv_c_of(a.f(CHAIN_C)[kd], a.f(CHAIN_T)[kd], k + 1 < a.W ? a.f(CHAIN_T)[kd + a.ND] : 0.f, lam, a.p[FLOOR]);
}

// the object of (frame k, track d) in a motion factor's chain, or -1
__device__ __forceinline__ int track_obj(const Args& a, int kd) {
  float oh[MAX_O];
#pragma unroll
  for (int o = 0; o < MAX_O; ++o) oh[o] = o < a.O ? a.f(ONEHOT)[kd * a.O + o] : 0.f;
  int obj = -1;
#pragma unroll
  for (int o = 0; o < MAX_O; ++o)
    if (oh[o] != 0.f) obj = o;
  return obj;
}

// (frame k, track d) of the Woodbury elimination into f (`schur_reduce`'s
// formulas, in their order), every load before the first store
__device__ void chain_frame(const Args& a, int k, int d, float lam, ChainFrame& f) {
  const int ND = a.ND, kd = k * ND + d, kp = k >= 1 ? kd - ND : kd;
  const bool later = k >= 1;
  float Rc[18], Rcp[18], G[18], R[9], Rp[9], bd[3], bdp[3], sphi[3];
  for (int i = 0; i < 18; ++i) {
    Rc[i] = a.f(RC)[18 * kd + i];
    Rcp[i] = a.f(RC)[18 * kp + i];
    G[i] = a.f(ST_G)[18 * kd + i];
  }
  for (int i = 0; i < 9; ++i) {
    R[i] = a.f(ST_R)[9 * kd + i];
    Rp[i] = a.f(ST_R)[9 * kp + i];
  }
  for (int i = 0; i < 3; ++i) {
    bd[i] = a.f(B_DP)[3 * kd + i];
    bdp[i] = a.f(B_DP)[3 * kp + i];
    sphi[i] = a.f(ST_PHI)[3 * kd + i];
  }
  const float sk = a.f(ST_S)[kd], sprev = later ? a.f(ST_S)[kp] : 0.f;
  const float invc = chain_inv_c(a, k, d, lam);
  const float invc_prev = later ? chain_inv_c(a, k - 1, d, lam) : invc;
  float RM[9], Rt[9], bz[3], bzp[3];
  if (!later) {
    for (int i = 0; i < 9; ++i) RM[i] = (i % 4 == 0) ? 1.f : 0.f;
  } else {
    transpose3(Rp, RM);
  }
  transpose3(R, Rt);
  for (int i = 0; i < 3; ++i) {
    bz[i] = bd[i] * invc;
    bzp[i] = later ? bdp[i] * invc_prev : 0.f;
  }
  f.s = sk;
  f.alphaM = 1.f + (sk * sk) * (invc_prev + invc);
  const float coef = -((sprev * sk) * invc_prev);
  for (int i = 0; i < 9; ++i) f.BM[i] = coef * RM[i];
  float RcC[18];
  for (int i = 0; i < 18; ++i) RcC[i] = Rc[i] * invc;
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 6; ++c) {
      const float m = (Rt[3 * i] * RcC[c] + Rt[3 * i + 1] * RcC[6 + c]) + Rt[3 * i + 2] * RcC[12 + c];
      f.AUc[6 * i + c] = -sk * m;
    }
  for (int i = 0; i < 18; ++i) {
    f.AUp[i] = later ? sk * (Rcp[i] * invc_prev) : 0.f;
    f.Bc[i] = sk * G[i];
  }
  float Rb[3];
  mv3(Rt, bz, Rb);
  for (int i = 0; i < 3; ++i) f.phi[i] = sk * (bzp[i] - Rb[i]) + sphi[i];
}

// `chain_solve_scalar`'s pivots delta_k = alpha_k - |b_k|^2 / delta_{k-1}
__device__ __forceinline__ void chain_pivots(ChainFrame* f, int W) {
  float dprev = 1.f;
  for (int k = 0; k < W; ++k) {
    const float b2 = (f[k].BM[0] * f[k].BM[0] + f[k].BM[1] * f[k].BM[1]) + f[k].BM[2] * f[k].BM[2];
    dprev = f[k].alphaM - div0(b2, dprev);
    f[k].delta = dprev;
  }
}

// one right side rhs(k, i) of a track's chain: the block-Thomas forward
// substitution into z[(3 k + i) * stride], then the backward substitution
// in place
template <class R>
__device__ __forceinline__ void chain_solve(const ChainFrame* f, int W, R rhs, float* z, int stride) {
  float yp[3] = {0.f, 0.f, 0.f}, dprev = 1.f;
  for (int k = 0; k < W; ++k) {
    const float u[3] = {div0(yp[0], dprev), div0(yp[1], dprev), div0(yp[2], dprev)};
    for (int i = 0; i < 3; ++i) {
      const float bu = (f[k].BM[i] * u[0] + f[k].BM[3 + i] * u[1]) + f[k].BM[6 + i] * u[2];
      yp[i] = rhs(k, i) - bu;
      z[(3 * k + i) * stride] = yp[i];
    }
    dprev = f[k].delta;
  }
  float xn[3] = {0.f, 0.f, 0.f};
  for (int k = W - 1; k >= 0; --k) {
    float x[3];
    for (int i = 0; i < 3; ++i) {
      const float y = z[(3 * k + i) * stride];
      if (k + 1 < W) {
        const float* B = f[k + 1].BM;
        const float bx = (B[3 * i] * xn[0] + B[3 * i + 1] * xn[1]) + B[3 * i + 2] * xn[2];
        x[i] = div0(y - bx, f[k].delta);
      } else {
        x[i] = div0(y, f[k].delta);
      }
    }
    for (int i = 0; i < 3; ++i) {
      z[(3 * k + i) * stride] = x[i];
      xn[i] = x[i];
    }
  }
}

// The segment pass: CTA b takes static points and tracks [b len, (b + 1)
// len) and forms, on chip, its share of the camera rows' sums nc x (nc + 1)
// (column nc the right side): the static elimination Us^T Hll^-1 [Us |
// b_sp], the tracks' Rc^T Kc^-1 [Rc | b_dp] and, for tracks in a motion
// factor's chain, AU^T M^-1 [AU | phi_hat] from the chain solved in shared
// memory; and the pose diagonal's motion-factor term dd_t per (frame,
// object, axis).  It writes its share as one partial, column-major.  A
// (frame, track) with an object keeps AU_cur, AU_prev, Bcol and the chain
// solution's motion and phi columns (KEEP) for the assembly's camera-motion,
// motion-motion and motion right-side entries, and the CTA lists those
// tracks per (frame, object): those entries sum over every track of an
// object at once, and a per-object accumulator in each CTA would hold
// (6W + 6W + 1) 6W floats for each object its tracks carry.
constexpr int SEG_THREADS = 512;
constexpr int SEG_PER = 8;          // points and tracks a CTA at most
constexpr int SEG_FILL = 128;       // CTAs a window should fill, one an SM
constexpr int STAGE_SLOTS = (2 * MAX_W * SEG_PER * 18 + 3 * SEG_PER + SEG_THREADS - 1) / SEG_THREADS;
constexpr int SEG_QJ_SMALL = 8;     // accumulator columns a thread for W <= 10
constexpr int SEG_QJ_MAX = 20;      // ... for W <= 16
constexpr int Z_BUDGET = 81920;     // bytes of shared memory for the chains solved at once

struct SegShape {
  int ctas, ns_len, nd_len, S, qj, tpar, E, krec;
  int o_us, o_rc, o_bsp, o_hi, o_y, o_ic, o_bd, o_cf, o_z, floats;
};

__host__ __device__ inline SegShape seg_shape(int W, int NS, int ND, int O) {
  SegShape s;
  const int nc = 6 * W, C = 2 * nc + 1, most = NS > ND ? NS : ND;
  // at most SEG_PER points and tracks a CTA, and as few as fill ~128 CTAs
  const int per = (most + SEG_FILL - 1) / SEG_FILL < SEG_PER ? (most + SEG_FILL - 1) / SEG_FILL : SEG_PER;
  s.ctas = (most + per - 1) / per;
  s.ns_len = (NS + s.ctas - 1) / s.ctas;
  s.nd_len = (ND + s.ctas - 1) / s.ctas;
  s.S = SEG_THREADS / nc;
  s.qj = (nc + 1 + s.S - 1) / s.S;
  int tp = SEG_THREADS / C, zmax = Z_BUDGET / (12 * W * C);
  tp = tp < zmax ? tp : zmax;
  s.tpar = tp < 1 ? 1 : (tp > SEG_PER ? SEG_PER : tp);
  s.E = nc * (nc + 1) + 6 * W * O;
  s.krec = 54 + 3 * (nc + 1);
  int o = 0;
  s.o_us = o;   o += s.ns_len * W * 18;
  s.o_rc = o;   o += s.nd_len * W * 18;
  s.o_bsp = o;  o += s.ns_len * 3;
  s.o_hi = o;   o += s.ns_len * 9;
  s.o_y = o;    o += s.ns_len * 3 * (nc + 1);
  s.o_ic = o;   o += s.nd_len * W;
  s.o_bd = o;   o += s.nd_len * W * 3;
  s.o_cf = o;   o += s.tpar * W * (int)(sizeof(ChainFrame) / sizeof(float));
  s.o_z = o;    o += s.tpar * 3 * W * C;
  s.floats = o;
  return s;
}

template <int QJ>
__global__ void __launch_bounds__(SEG_THREADS, 1) window_step_seg_kernel(const Args a, const SegShape sh) {
  extern __shared__ float sm[];
  __shared__ uint8_t sobs[SEG_PER][MAX_W], dobs[SEG_PER][MAX_W];
  __shared__ int8_t tobj[SEG_PER][MAX_W];
  __shared__ float soh[SEG_PER][MAX_W][MAX_O], sct[SEG_PER][MAX_W], sg2[SEG_PER][MAX_W][6];
  __shared__ bool tmot[SEG_PER][MAX_W];
  __shared__ int chained[SEG_PER], n_chained;
  const int W = a.W, NS = a.NS, ND = a.ND, O = a.O, nc = a.nc, C = a.C, tid = threadIdx.x;
  const float lam = *a.f(LAM), floor_ = a.p[FLOOR];
  // phase: begin
  const int b = blockIdx.x;
  const int n_lo = min(NS, b * sh.ns_len), np = min(NS, n_lo + sh.ns_len) - n_lo;
  const int d_lo = min(ND, b * sh.nd_len), nt = min(ND, d_lo + sh.nd_len) - d_lo;
  float* Us = sm + sh.o_us;      // [frame][point][18]
  float* Hi = sm + sh.o_hi;      // [point][9]: the damped block's inverse
  float* Bsp = sm + sh.o_bsp;    // [point][3]
  float* Y = sm + sh.o_y;        // [point][3][nc + 1]: Hll^-1 [Us_cols | b_sp]
  float* Rcs = sm + sh.o_rc;     // [frame][track][18]
  float* Ic = sm + sh.o_ic;      // [track][frame]: inv_c
  float* Bd = sm + sh.o_bd;      // [track][frame][3]
  ChainFrame* cf = reinterpret_cast<ChainFrame*>(sm + sh.o_cf);   // [chain][frame]
  float* Zs = sm + sh.o_z;       // [chain][3 W][C]
  float* part = a.f(PART) + (size_t)blockIdx.x * sh.E;   // this CTA's partial: [nc + 1][nc], then dd_t [W][O][6]

  // stage the segment's points and tracks, every load of a thread before
  // its first store (the compiler keeps loads behind stores to pointers
  // that may alias): the Us and Rc rows of each frame and b_sp, a slot a
  // load; a (frame, track)'s mask, one-hot row, st_G, T, s, c and b_dp;
  // a frame's static mask; on the last threads, a static block
  // phase: stage loads
  const int nu = W * np * 18, nr = W * nt * 18, nall = nu + nr + np * 3;
  float v[STAGE_SLOTS];
#pragma unroll
  for (int jj = 0; jj < STAGE_SLOTS; ++jj) {
    const int i = tid + jj * SEG_THREADS;
    // one load a slot, its source picked by selects
    const bool us = i < nu, rc = !us && i < nu + nr;
    const int r = us ? i : (rc ? i - nu : i - nu - nr), row = us ? np * 18 : nt * 18;
    const float* src = us ? a.f(US) + 18 * ((r / row) * NS + n_lo) + r % row
                          : (rc ? a.f(RC) + 18 * ((r / row) * ND + d_lo) + r % row : a.f(B_SP) + 3 * n_lo + r);
    v[jj] = i < nall ? *src : 0.f;
  }
  const bool track_item = tid < W * nt, static_item = tid >= W * nt && tid < W * nt + W * np;
  const int tk = track_item ? tid / nt : 0, tt = track_item ? tid % nt : 0, tkd = tk * ND + d_lo + tt;
  float oh[MAX_O], G[18], cT = 0.f, cc = 0.f, cTn = 0.f, sk = 0.f, bd[3] = {0.f, 0.f, 0.f};
  bool tob = false, sob = false;
  if (track_item) {
    tob = a.b(DYN_OBS)[tkd];
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) oh[o] = o < O ? a.f(ONEHOT)[tkd * O + o] : 0.f;
    for (int i = 0; i < 18; ++i) G[i] = a.f(ST_G)[18 * tkd + i];
    cT = a.f(CHAIN_T)[tkd];
    cc = a.f(CHAIN_C)[tkd];
    cTn = tk + 1 < W ? a.f(CHAIN_T)[tkd + ND] : 0.f;
    sk = a.f(ST_S)[tkd];
    for (int m = 0; m < 3; ++m) bd[m] = a.f(B_DP)[3 * tkd + m];
  }
  const int si = tid - W * nt, sf = static_item ? si / np : 0, spt = static_item ? si % np : 0;
  if (static_item) sob = a.b(STATIC_OBS)[sf * NS + n_lo + spt];
  const int th = tid - ((int)blockDim.x - np);
  float H[9];
  if (th >= 0)
    for (int i = 0; i < 9; ++i) H[i] = a.f(HLL_S)[9 * (n_lo + th) + i];
  // phase: stage stores
#pragma unroll
  for (int jj = 0; jj < STAGE_SLOTS; ++jj) {
    const int i = tid + jj * SEG_THREADS;
    if (i < nu) Us[i] = v[jj];
    else if (i < nu + nr) Rcs[i - nu] = v[jj];
    else if (i < nall) Bsp[i - nu - nr] = v[jj];
  }
  if (track_item) {
    int to = -1;
#pragma unroll
    for (int o = 0; o < MAX_O; ++o) {
      if (oh[o] != 0.f) to = o;
      soh[tt][tk][o] = oh[o];
    }
    for (int c = 0; c < 6; ++c) sg2[tt][tk][c] = (G[c] * G[c] + G[6 + c] * G[6 + c]) + G[12 + c] * G[12 + c];
    sct[tt][tk] = cT;
    dobs[tt][tk] = tob;
    tobj[tt][tk] = (int8_t)to;
    tmot[tt][tk] = sk != 0.f;
    Ic[tt * W + tk] = inv_c_of(cc, cT, cTn, lam, floor_);
    for (int m = 0; m < 3; ++m) Bd[(tt * W + tk) * 3 + m] = bd[m];
  }
  if (static_item) sobs[spt][sf] = sob;
  if (th >= 0) {
    for (int i = 0; i < 3; ++i) H[4 * i] = H[4 * i] + lam * clamp_min(H[4 * i], floor_);
    dyno::inv3(H, Hi + 9 * th);
  }
  // a track is solved on chip when any frame has a motion factor or an object
  __syncthreads();
  if (tid < 32) {
    bool on = false;
    for (int k = 0; k < W && tid < nt; ++k) on = on || tmot[tid][k] || tobj[tid][k] >= 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (tid == 0) {
      int m = 0;
      for (int ti = 0; ti < nt; ++ti)
        if ((bal >> ti) & 1u) chained[m++] = ti;
      n_chained = m;
    }
  }
  __syncthreads();
  // this CTA's tracks of each (frame, object) in index order, the assembly
  // concatenating the CTAs' lists in CTA order (ACT_LIST (W, O, CTAs,
  // SEG_PER), ACT_COUNT (W, O, CTAs)), and their objects (OBJ)
  for (int e = tid; e < W * O; e += blockDim.x) {
    const int k = e / O, o = e % O;
    int* sub = a.i32(ACT_LIST) + ((size_t)e * gridDim.x + b) * SEG_PER;
    int m = 0;
    for (int ti = 0; ti < nt; ++ti)
      if (tobj[ti][k] == o) sub[m++] = d_lo + ti;
    a.i32(ACT_COUNT)[e * gridDim.x + b] = m;
  }
  for (int i = tid; i < W * nt; i += blockDim.x) a.i32(OBJ)[(i / nt) * ND + d_lo + i % nt] = tobj[i % nt][i / nt];
  // which objects frame k's tracks carry, over every CTA (an integer OR:
  // its value does not depend on the order); the assembly's last block
  // clears it
  if (tid < W) {
    int bits = 0;
    for (int ti = 0; ti < nt; ++ti)
      if (tobj[ti][tid] >= 0) bits |= 1 << tobj[ti][tid];
    if (bits) atomicOr(a.i32(TICKETS) + 2 + tid, bits);
  }
  // phase: Y
  for (int i = tid; i < np * (nc + 1); i += blockDim.x) {
    const int pi = i / (nc + 1), q = i % (nc + 1);
    float col[3], y[3];
    for (int r = 0; r < 3; ++r) col[r] = q < nc ? Us[((q / 6) * np + pi) * 18 + 3 * (q % 6) + r] : Bsp[3 * pi + r];
    mv3(Hi + 9 * pi, col, y);
    for (int m = 0; m < 3; ++m) Y[(pi * 3 + m) * (nc + 1) + q] = y[m];
  }
  __syncthreads();

  // phase: sums
  // this thread's entries: row p, columns q = s + jj S
  const int p = tid % nc, s = tid / nc, j = p / 6, ca = p % 6;
  const bool rows = s < sh.S;
  float acc_s[QJ], acc_c[QJ], acc_t[QJ];
#pragma unroll
  for (int jj = 0; jj < QJ; ++jj) acc_s[jj] = acc_c[jj] = acc_t[jj] = 0.f;
  if (rows) {
    // static points in index order; a point unobserved in frame j has a
    // zero Us row there and would add exact zeros
    for (int pi = 0; pi < np; ++pi) {
      if (!sobs[pi][j]) continue;
      const float* u = Us + (j * np + pi) * 18 + 3 * ca;
      const float u0 = u[0], u1 = u[1], u2 = u[2];
      const float* y = Y + pi * 3 * (nc + 1);
#pragma unroll
      for (int jj = 0; jj < QJ; ++jj) {
        const int q = s + jj * sh.S;
        if (jj < sh.qj && q <= nc)
          acc_s[jj] += (u0 * y[q] + u1 * y[(nc + 1) + q]) + u2 * y[2 * (nc + 1) + q];
      }
    }
    // the tracks' observation blocks Rc^T Kc^-1 [Rc | b_dp] on frame j
    for (int ti = 0; ti < nt; ++ti) {
      if (!dobs[ti][j]) continue;
      const float* R = Rcs + (j * nt + ti) * 18;
      const float ic = Ic[ti * W + j];
      const float* bd = Bd + (ti * W + j) * 3;
      const float r0 = R[ca], r1 = R[6 + ca], r2 = R[12 + ca];
#pragma unroll
      for (int jj = 0; jj < QJ; ++jj) {
        const int q = s + jj * sh.S;
        if (jj < sh.qj && q < nc && q / 6 == j) {
          const int cb = q % 6;
          acc_c[jj] += ((r0 * ic) * R[cb] + (r1 * ic) * R[6 + cb]) + (r2 * ic) * R[12 + cb];
        } else if (jj < sh.qj && q == nc) {
          acc_c[jj] += (r0 * (bd[0] * ic) + r1 * (bd[1] * ic)) + r2 * (bd[2] * ic);
        }
      }
    }
  }

  // phase: chains
  // the chains of the segment's tracks in a motion factor's chain, tpar at
  // a time: blocks, pivots, every column of [AU_nc | Bcol_nc | phi_hat]
  const int zsz = 3 * W * C;
  for (int g0 = 0; g0 < n_chained; g0 += sh.tpar) {
    // phase: chain blocks
    const int ng = min(sh.tpar, n_chained - g0);
    for (int i = tid; i < ng * W; i += blockDim.x)
      chain_frame(a, i % W, d_lo + chained[g0 + i / W], lam, cf[(i / W) * W + i % W]);
    __syncthreads();
    // phase: pivots
    if (tid < ng) chain_pivots(cf + tid * W, W);
    __syncthreads();
    // phase: columns
    for (int i = tid; i < ng * C; i += blockDim.x) {
      const int g = i / C, c = i % C;
      const ChainFrame* f = cf + g * W;
      chain_solve(f, W, [&](int k, int r) {
        if (c < nc) {
          const int cf_ = c / 6, cb = c % 6;
          return cf_ == k ? f[k].AUc[6 * r + cb] : (cf_ == k - 1 ? f[k].AUp[6 * r + cb] : 0.f);
        }
        if (c < 2 * nc) return (c - nc) / 6 == k ? f[k].Bc[6 * r + (c - nc) % 6] : 0.f;
        return f[k].phi[r];
      }, Zs + g * zsz + c, C);
    }
    __syncthreads();
    // phase: chain sums
    if (rows) {
      for (int g = 0; g < ng; ++g) {
        const ChainFrame* f = cf + g * W;
        const float* Z = Zs + g * zsz;
        const bool cur = f[j].s != 0.f, nxt = j + 1 < W && f[j + 1].s != 0.f;
        const float A0 = f[j].AUc[ca], A1 = f[j].AUc[6 + ca], A2 = f[j].AUc[12 + ca];
        const float* Bn = nxt ? f[j + 1].AUp : f[j].AUp;
        const float B0 = Bn[ca], B1 = Bn[6 + ca], B2 = Bn[12 + ca];
#pragma unroll
        for (int jj = 0; jj < QJ; ++jj) {
          const int q = s + jj * sh.S;
          if (jj < sh.qj && q <= nc) {
            const int cz = q < nc ? q : 2 * nc;
            if (cur) acc_t[jj] += (A0 * Z[(3 * j) * C + cz] + A1 * Z[(3 * j + 1) * C + cz]) + A2 * Z[(3 * j + 2) * C + cz];
            if (nxt)
              acc_t[jj] += (B0 * Z[(3 * j + 3) * C + cz] + B1 * Z[(3 * j + 4) * C + cz]) + B2 * Z[(3 * j + 5) * C + cz];
          }
        }
      }
    }
    // KEEP for each (frame, track) with an object: AU_cur, AU_prev, Bcol,
    // then the solution's motion columns and phi, 3 x (nc + 1)
    // phase: keep
    for (int gk = tid >> 5; gk < ng * W; gk += blockDim.x >> 5) {
      const int g = gk / W, k = gk % W, ti = chained[g0 + g], ln = tid & 31;
      if (tobj[ti][k] < 0) continue;
      const ChainFrame& f = cf[gk];
      float* rec = a.f(KEEP) + (size_t)(k * ND + d_lo + ti) * sh.krec;
      if (ln < 18) {
        rec[ln] = f.AUc[ln];
        rec[18 + ln] = f.AUp[ln];
        rec[36 + ln] = f.Bc[ln];
      }
      const float* Zk = Zs + g * zsz + 3 * k * C + nc;
      for (int i = 0; i < 3; ++i)
        for (int c = ln; c <= nc; c += 32) rec[54 + i * (nc + 1) + c] = Zk[i * C + c];
    }
    __syncthreads();
  }

  // phase: dd_t
  // dd_t of the segment's tracks
  for (int e = tid; e < 6 * W * O; e += blockDim.x) {
    const int k = e / (6 * O), o = (e / 6) % O, cc = e % 6;
    float ddt = 0.f;
    for (int ti = 0; ti < nt; ++ti) {
      const float oh = soh[ti][k][o];
      if (oh != 0.f) ddt += (sct[ti][k] * oh) * sg2[ti][k][cc];
    }
    part[nc * (nc + 1) + e] = ddt;
  }
  // phase: partial
  if (rows) {
#pragma unroll
    for (int jj = 0; jj < QJ; ++jj) {
      const int q = s + jj * sh.S;
      if (jj < sh.qj && q <= nc) part[q * nc + p] = acc_s[jj] + (acc_c[jj] - acc_t[jj]);
    }
  }
  // phase: end
}

// The assembly: the damped reduced system and its right side from the
// segment partials, symmetrised, in two block roles, then the diagonal
// floor rel max|diag| + tiny from the last block to write diagonal entries
// (an integer ticket).
//  A: a warp per camera pair p <= q (its two entries, the segments' partials
//     added lane by lane and by a butterfly) and per camera right-side row;
//  B: a block per (frame j, object o, frame l): the 6x6 camera-motion block
//     (rows of frame j, the motion of (l, o)) and the motion-motion block
//     ((j, o), (l, o)) with both triangles' sums over the object's tracks in
//     KEEP (their lists, then their records a chunk at a time, staged in
//     shared memory), the zero blocks of the other objects, and at l == j
//     the motion right side.
constexpr int ASM_THREADS = 256;
constexpr int ASM_WARPS = ASM_THREADS / 32;
constexpr int ASM_CHUNK = 32;       // kept tracks staged at a time

__host__ __device__ inline int asm_a_blocks(int nc) { return (nc * (nc + 1) / 2 + nc + ASM_WARPS - 1) / ASM_WARPS; }

__host__ __device__ inline int asm_blocks(int W, int O) { return asm_a_blocks(6 * W) + W * O * W; }

// sum over a warp of the segments' partials x[c * E] (lanes over c, then a
// butterfly); every lane receives it
__device__ __forceinline__ float segment_total(const float* x, int nseg, int E) {
  float v = 0.f;
  for (int c = threadIdx.x & 31; c < nseg; c += 32) v += x[(size_t)c * E];
  return dyno::warp_sum(v);
}

// role B's three lists of object o's tracks, L for frames k[L] (the segment
// CTAs' lists concatenated in CTA order: scans of their counts, a thread a
// CTA), each with a second frame g[L]'s activity flag (its object >= 0),
// into smem ds[L], fl[L]; all three at once, each skipped where the frame
// carries no track of o (`on`); returns the counts in n
__device__ void stage_lists(const Args& a, int o, const int (&k)[3], const int (&g)[3], const bool (&on)[3],
                            int ctas, int* const (&ds)[3], uint8_t* const (&fl)[3], int (&n)[3]) {
  __shared__ int wsum[3][ASM_WARPS], total[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ND = a.ND;
  int c[3], x[3];
#pragma unroll
  for (int L = 0; L < 3; ++L)
    c[L] = on[L] && (int)threadIdx.x < ctas ? a.i32(ACT_COUNT)[(k[L] * a.O + o) * ctas + threadIdx.x] : 0;
#pragma unroll
  for (int L = 0; L < 3; ++L) {
    x[L] = c[L];
    for (int s = 1; s < 32; s <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x[L], s);
      if (lane >= s) x[L] += y;
    }
    if (lane == 31) wsum[L][warp] = x[L];
  }
  __syncthreads();
#pragma unroll
  for (int L = 0; L < 3; ++L) {
    for (int w = 0; w < warp; ++w) x[L] += wsum[L][w];
    if (threadIdx.x == blockDim.x - 1) total[L] = x[L];
  }
  // this CTA's entries, every load first
  int d[3][SEG_PER], fo[3][SEG_PER];
#pragma unroll
  for (int L = 0; L < 3; ++L)
#pragma unroll
    for (int t = 0; t < SEG_PER; ++t)
      d[L][t] = t < c[L] ? a.i32(ACT_LIST)[((size_t)(k[L] * a.O + o) * ctas + threadIdx.x) * SEG_PER + t] : 0;
#pragma unroll
  for (int L = 0; L < 3; ++L)
#pragma unroll
    for (int t = 0; t < SEG_PER; ++t) fo[L][t] = t < c[L] ? a.i32(OBJ)[g[L] * ND + d[L][t]] : -1;
#pragma unroll
  for (int L = 0; L < 3; ++L)
#pragma unroll
    for (int t = 0; t < SEG_PER; ++t)
      if (t < c[L]) {
        ds[L][x[L] - c[L] + t] = d[L][t];
        fl[L][x[L] - c[L] + t] = fo[L][t] >= 0;
      }
  __syncthreads();
#pragma unroll
  for (int L = 0; L < 3; ++L) n[L] = total[L];
}

__global__ void __launch_bounds__(ASM_THREADS) window_step_assemble_kernel(const Args a, const SegShape sh) {
  extern __shared__ int asm_sm[];
  __shared__ bool last;
  const int W = a.W, ND = a.ND, O = a.O, nc = a.nc, n = a.n, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float lam = *a.f(LAM), floor_ = a.p[FLOOR];
  const int nseg = sh.ctas, E = sh.E;
  const float* P = a.f(PART);
  float* H = a.f(HRED);
  const int na = asm_a_blocks(nc);
  if ((int)blockIdx.x < na) {
    // the diagonal pairs first, then p < q row by row
    const int w = blockIdx.x * ASM_WARPS + warp, npairs = nc * (nc + 1) / 2;
    if (w < npairs) {
      int p = w, q = w;
      if (w >= nc) {
        int rem = w - nc;
        p = 0;
        while (rem >= nc - 1 - p) rem -= nc - 1 - p++;
        q = p + 1 + rem;
      }
      const float xpq = segment_total(P + q * nc + p, nseg, E);
      const float xqp = segment_total(P + p * nc + q, nseg, E);
      float hpq = a.f(HCC)[p * nc + q], hqp = a.f(HCC)[q * nc + p];
      if (p == q) hpq = hqp = hpq + lam * clamp_min(hpq, floor_);
      const float v = 0.5f * ((hpq - xpq) + (hqp - xqp));
      if (lane == 0) {
        H[(size_t)p * n + q] = v;
        H[(size_t)q * n + p] = v;
      }
    } else if (w < npairs + nc) {
      const int p = w - npairs;
      const float x = segment_total(P + nc * nc + p, nseg, E);
      if (lane == 0) a.f(BRED)[p] = a.f(B_CAM)[p] - x;
    }
  } else {
    const int r = blockIdx.x - na, l = r % W, o = (r / W) % O, j = r / (W * O);
    int* d0 = asm_sm;                      // frame j's tracks of o, flag: active at l
    int* d1 = d0 + ND;                     // frame j + 1's, active at l
    int* d2 = d1 + ND;                     // frame l's, active at j
    uint8_t* f0 = reinterpret_cast<uint8_t*>(d2 + ND);
    uint8_t* f1 = f0 + ND;
    uint8_t* f2 = f1 + ND;
    float* buf = reinterpret_cast<float*>(asm_sm + 3 * ND + (3 * ND + 3) / 4);   // a chunk of staged records
    __shared__ float ddt[6];
    if (l == j && warp == 0) {               // the motion-factor term of the damping, segments by lanes
      float x[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c = lane; c < nseg; c += 32)
        for (int c6 = 0; c6 < 6; ++c6) x[c6] += P[(size_t)c * E + nc * (nc + 1) + (j * O + o) * 6 + c6];
      for (int c6 = 0; c6 < 6; ++c6) {
        const float t = dyno::warp_sum(x[c6]);
        if (lane == 0) ddt[c6] = t;
      }
    }
    __syncthreads();
    const int* bits = a.i32(TICKETS) + 2;     // the objects each frame carries (the segment pass's OR)
    const bool on[3] = {((bits[j] >> o) & 1) != 0, j + 1 < W && ((bits[j + 1] >> o) & 1) != 0,
                        ((bits[l] >> o) & 1) != 0};
    int ns[3] = {0, 0, 0};
    if (on[0] || on[1] || on[2]) {
      const int ks[3] = {j, j + 1 < W ? j + 1 : j, l}, gs[3] = {l, l, j};
      int* const dl[3] = {d0, d1, d2};
      uint8_t* const fls[3] = {f0, f1, f2};
      stage_lists(a, o, ks, gs, on, sh.ctas, dl, fls, ns);
    }
    const int n0 = ns[0], n1 = ns[1], n2 = ns[2];
    // threads 0-35: camera-motion (j, ca; l, o, cb); 36-71: motion-motion
    // ((j, o, ca); (l, o, cb)); 72-77 at l == j: the motion right side.
    // The three lists a chunk at a time: frame j's [AU_cur | Bcol | Z at
    // (l, .) | Z phi], frame j + 1's [AU_prev | Z at (l, .)], frame l's
    // [Bcol | Z at (j, .)] (the other triangle)
    const int kr = sh.krec, n1c = nc + 1, e = tid < 36 ? tid : tid - 36, ca = tid < 72 ? e / 6 : tid - 72, cb = e % 6;
    const float* K = a.f(KEEP);
    float cm0 = 0.f, cm1 = 0.f, rc = 0.f, cr = 0.f, bphi = 0.f;
    for (int c0 = 0; c0 < max(n0, max(n1, n2)); c0 += ASM_CHUNK) {
      const int ch0 = max(0, min(ASM_CHUNK, n0 - c0)), ch1 = max(0, min(ASM_CHUNK, n1 - c0));
      const int ch2 = max(0, min(ASM_CHUNK, n2 - c0)), e1 = 57 * ch0, e2 = e1 + 36 * ch1;
      float* B1 = buf + e1;
      float* B2 = buf + e2;
      __syncthreads();
      for (int i = tid; i < e2 + 36 * ch2; i += blockDim.x) {
        float v;
        if (i < e1) {
          const int t = i / 57, q = i % 57;
          const float* R = K + (size_t)(j * ND + d0[c0 + t]) * kr;
          v = q < 36 ? R[q < 18 ? q : 18 + q]
                     : (q < 54 ? R[54 + ((q - 36) / 6) * n1c + 6 * l + (q - 36) % 6] : R[54 + (q - 54) * n1c + nc]);
        } else if (i < e2) {
          const int t = (i - e1) / 36, q = (i - e1) % 36;
          const float* R = K + (size_t)((j + 1) * ND + d1[c0 + t]) * kr;
          v = q < 18 ? R[18 + q] : R[54 + ((q - 18) / 6) * n1c + 6 * l + (q - 18) % 6];
        } else {
          const int t = (i - e2) / 36, q = (i - e2) % 36;
          const float* R = K + (size_t)(l * ND + d2[c0 + t]) * kr;
          v = q < 18 ? R[36 + q] : R[54 + ((q - 18) / 6) * n1c + 6 * j + (q - 18) % 6];
        }
        buf[i] = v;
      }
      __syncthreads();
      if (tid < 36) {
        for (int t = 0; t < ch0; ++t) {
          const float* S = buf + 57 * t;
          const float v = (S[ca] * S[36 + cb] + S[6 + ca] * S[42 + cb]) + S[12 + ca] * S[48 + cb];
          cm0 += f0[c0 + t] ? v : 0.f;
        }
        for (int t = 0; t < ch1; ++t) {
          const float* S = B1 + 36 * t;
          const float v = (S[ca] * S[18 + cb] + S[6 + ca] * S[24 + cb]) + S[12 + ca] * S[30 + cb];
          cm1 += f1[c0 + t] ? v : 0.f;
        }
      } else if (tid < 72) {
        for (int t = 0; t < ch0; ++t) {
          const float* S = buf + 57 * t;
          const float v = (S[18 + ca] * S[36 + cb] + S[24 + ca] * S[42 + cb]) + S[30 + ca] * S[48 + cb];
          rc += f0[c0 + t] ? v : 0.f;
        }
        for (int t = 0; t < ch2; ++t) {
          const float* S = B2 + 36 * t;
          const float v = (S[cb] * S[18 + ca] + S[6 + cb] * S[24 + ca]) + S[12 + cb] * S[30 + ca];
          cr += f2[c0 + t] ? v : 0.f;
        }
      } else if (tid < 78) {
        for (int t = 0; t < ch0; ++t) {
          const float* S = buf + 57 * t;
          bphi += (S[18 + ca] * S[54] + S[24 + ca] * S[55]) + S[30 + ca] * S[56];
        }
      }
    }
    const float cm = cm0 + cm1;
    if (tid < 36) {
      const int p = 6 * j + ca, m = nc + (l * O + o) * 6 + cb;
      H[(size_t)p * n + m] = -cm;
      H[(size_t)m * n + p] = -cm;
    } else if (tid < 72) {
      float band = 0.f;
      if (l == j) {
        const float* Dm = a.f(DMM) + 36 * (j * O + o);
        band = Dm[6 * ca + cb];
        if (ca == cb) band = band + lam * clamp_min(Dm[6 * ca + ca] + ddt[ca], floor_);
      } else if (l == j + 1) {
        band = a.f(OMM1)[36 * (j * O + o) + 6 * ca + cb];
      } else if (l == j - 1) {
        band = a.f(OMM1)[36 * (l * O + o) + 6 * cb + ca];
      }
      H[(size_t)(nc + (j * O + o) * 6 + ca) * n + nc + (l * O + o) * 6 + cb] = 0.5f * ((band - (-rc)) + (band - (-cr)));
    } else if (tid < 78 && l == j) {
      a.f(BRED)[nc + (j * O + o) * 6 + ca] = a.f(B_MOT)[(j * O + o) * 6 + ca] - bphi;
    }
    // the other objects' motions in these rows are zero
    for (int i = tid; i < 36 * (O - 1); i += blockDim.x) {
      const int op = i / 36 + (i / 36 >= o), ca = (i % 36) / 6, cb = i % 6;
      H[(size_t)(nc + (j * O + o) * 6 + ca) * n + nc + (l * O + op) * 6 + cb] = 0.f;
    }
  }
  // the last of the blocks that write the diagonal (role A's first, role
  // B's at l == j) adds the floor
  const int na_diag = (nc + ASM_WARPS - 1) / ASM_WARPS;
  const int rb = (int)blockIdx.x - na;
  if (!((int)blockIdx.x < na_diag || (rb >= 0 && rb % W == (rb / W) / O))) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.i32(TICKETS), 1) == na_diag + W * O - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  __shared__ float part[ASM_WARPS];
  constexpr int DIAG = (6 * MAX_W * (1 + MAX_O) + ASM_THREADS - 1) / ASM_THREADS;   // diagonal entries a thread
  float dg[DIAG], m = 0.f;
#pragma unroll
  for (int t = 0; t < DIAG; ++t) {
    const int p = tid + t * ASM_THREADS;
    dg[t] = p < n ? __ldcg(H + (size_t)p * n + p) : 0.f;
    if (p < n) m = nan_max(m, fabsf(dg[t]));
  }
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) part[warp] = m;
  __syncthreads();
  float dmax = part[0];
  for (int w = 1; w < ASM_WARPS; ++w) dmax = nan_max(dmax, part[w]);
  const float add = a.p[REL] * dmax + a.p[TINY];
#pragma unroll
  for (int t = 0; t < DIAG; ++t) {
    const int p = tid + t * ASM_THREADS;
    if (p < n) H[(size_t)p * n + p] = dg[t] + add;
  }
  if (tid == 0) a.i32(TICKETS)[0] = 0;
  if (tid < W) a.i32(TICKETS)[2 + tid] = 0;
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

// `_lm_tail`'s decisions from the blocks' error partials (nblocks of them):
// the trial error (families in order, each family's blocks by lanes and a
// butterfly), the step's finiteness and the accept, lambda, ratchet and
// convergence updates; with `head`, `_lm_head`'s initial values
__device__ void lm_decide(const Args& a, int nblocks, bool head) {
  __shared__ float sums[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool bad = !head && *a.i32(INFO) != 0;
  // warp w (of 4) takes families w and w + 4 (w < 2), or the camera (w 2)
  // and motion (w 3) step sums, both in one pass over their loads
  const int r2 = warp + 4;
  float acc = 0.f, acc2 = 0.f;
  for (int b = lane; b < nblocks; b += 32) {
    acc += __ldcg(a.f(PARTIALS) + b * N_FAMILY + warp);
    if (r2 < N_FAMILY) acc2 += __ldcg(a.f(PARTIALS) + b * N_FAMILY + r2);
  }
  if (r2 >= N_FAMILY && !head) {
    const int lo = r2 == 6 ? 0 : a.nc, hi = r2 == 6 ? a.nc : a.n;
    for (int i = lo + lane; i < hi; i += 32) acc2 += step_entry(a, i, bad);
  }
  acc = dyno::warp_sum(acc);
  acc2 = dyno::warp_sum(acc2);
  if (lane == 0) {
    sums[warp] = acc;
    sums[r2] = acc2;
  }
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

// the trial at the current values plus the step (`head`: at the current
// values, the LM head's residuals and error), the step itself into STEP,
// and from the last block to finish (an integer ticket) the decisions
__global__ void __launch_bounds__(THREADS) window_update_trial_kernel(const Args a, int head) {
  __shared__ SE3 Xn[MAX_W];
  __shared__ float part[WARPS][N_FAMILY];
  __shared__ float tot[N_FAMILY];
  __shared__ float dcs[6 * MAX_W];
  __shared__ ChainFrame cfs[WARPS][MAX_W];
  __shared__ float rhs[WARPS][3 * MAX_W];
  __shared__ float dpn[WARPS][MAX_W][3];
  __shared__ int objs[WARPS][MAX_W];
  __shared__ bool last;
  const int W = a.W, NS = a.NS, ND = a.ND, O = a.O, nc = a.nc;
  const bool bad = !head && *a.i32(INFO) != 0;          // a head has no step, sol and info are null
  const float lam = *a.f(LAM);
  const TrialLayout L = trial_layout(W, NS, ND, O);
  float* T = a.f(TRIAL);
  float* St = a.f(STEP);                                // [X nc | P nm | sp 3 NS | dp 3 W ND]
  const UpdateShape s = update_shape(W, NS, ND, O);
  // phase: begin
  // the retracted poses on the block's last W threads (idle lanes of the
  // last warp in a track block)
  if ((int)threadIdx.x >= THREADS - W) {
    const int k = threadIdx.x - (THREADS - W);
    float xi[6];
    for (int i = 0; i < 6; ++i) xi[i] = head ? 0.f : step_entry(a, 6 * k + i, bad);
    Xn[k] = head ? load_pose(a.f(XR) + 9 * k, a.f(XT) + 3 * k) : retract(a.f(XR) + 9 * k, a.f(XT) + 3 * k, xi);
  }
  for (int q = threadIdx.x; q < nc && !head; q += THREADS) dcs[q] = step_entry(a, q, bad);
  // each role waits for the poses and the camera step (one barrier) only
  // after the work that needs neither
  float loss[N_FAMILY] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (b < s.frame) {
    // phase: frame
    // camera values, anchor and odometry residuals
    __syncthreads();
    const int k = threadIdx.x;
    if (k < W) {
      if (!head)
        for (int i = 0; i < 6; ++i) St[6 * k + i] = dcs[6 * k + i];
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
    // a static point: its step Hll^-1 (b_sp - Us^T dc), the damped block's
    // inverse as K8 forms it; unobserved frames' zero Us rows left out
    // phase: static step
    const int n = b * THREADS + threadIdx.x;
    float Hinv[9];
    if (n < NS && !head) {
      float H[9];
      for (int i = 0; i < 9; ++i) H[i] = a.f(HLL_S)[9 * n + i];
      for (int i = 0; i < 3; ++i) H[4 * i] = H[4 * i] + lam * clamp_min(H[4 * i], a.p[FLOOR]);
      dyno::inv3(H, Hinv);
    }
    __syncthreads();
    if (n < NS) {
      float spn[3];
      if (head) {
        for (int m = 0; m < 3; ++m) spn[m] = a.f(SP)[3 * n + m];
      } else {
        float acc[3] = {0.f, 0.f, 0.f}, r[3], dsp[3];
        for (int k = 0; k < W; ++k) {
          if (!a.b(STATIC_OBS)[k * NS + n]) continue;
          const float* U = a.f(US) + 18 * (k * NS + n);
          for (int c = 0; c < 6; ++c)
            for (int m = 0; m < 3; ++m) acc[m] += U[3 * c + m] * dcs[6 * k + c];
        }
        for (int m = 0; m < 3; ++m) r[m] = a.f(B_SP)[3 * n + m] - acc[m];
        mv3(Hinv, r, dsp);
        for (int m = 0; m < 3; ++m) {
          if (bad) dsp[m] = __int_as_float(0x7fc00000);
          St[a.n + 3 * n + m] = dsp[m];
          spn[m] = a.f(SP)[3 * n + m] + dsp[m];
        }
      }
      // phase: static residuals
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
    // a track on a warp: its chain solved for the one right side
    // phi_hat - AU_nc dc + Bcol_nc dm_sel (lanes the frames' blocks, lane 0
    // the chain), then the point steps
    // phase: track blocks
    const int d = b * WARPS + warp;
    ChainFrame* f = cfs[warp];
    if (d < ND && lane < W) {
      objs[warp][lane] = track_obj(a, lane * ND + d);
      if (!head) chain_frame(a, lane, d, lam, f[lane]);
    }
    __syncthreads();
    if (d < ND) {
      float* v = rhs[warp];
      if (lane < W && !head) {
        const int k = lane, ob = objs[warp][k];
        float dm[6];
        for (int c = 0; c < 6; ++c)
          dm[c] = ob >= 0 ? step_entry(a, nc + (k * O + ob) * 6 + c, bad) : (bad ? step_entry(a, 0, bad) : 0.f);
        for (int i = 0; i < 3; ++i) {
          float au = 0.f, bm = 0.f;
          for (int c = 0; c < 6; ++c) au += f[k].AUc[6 * i + c] * dcs[6 * k + c];
          if (k >= 1)
            for (int c = 0; c < 6; ++c) au += f[k].AUp[6 * i + c] * dcs[6 * (k - 1) + c];
          for (int c = 0; c < 6; ++c) bm += f[k].Bc[6 * i + c] * dm[c];
          v[3 * k + i] = (f[k].phi[i] - au) + bm;
        }
      }
      __syncwarp();
      // phase: track chain
      if (lane == 0 && !head) {
        chain_pivots(f, W);
        chain_solve(f, W, [&](int k, int i) { return v[3 * k + i]; }, v, 1);
      }
      __syncwarp();
      // phase: track steps
      if (lane < W && head) {
        for (int i = 0; i < 3; ++i) {
          dpn[warp][lane][i] = a.f(DP)[3 * (lane * ND + d) + i];
          T[L.off[5] + 3 * (lane * ND + d) + i] = dpn[warp][lane][i];
        }
      } else if (lane < W) {
        const int k = lane, kd = k * ND + d;
        const float* Rc = a.f(RC) + 18 * kd;
        float Rv[3];
        mv3(a.f(ST_R) + 9 * kd, v + 3 * k, Rv);
        const float sk = f[k].s;
        const float sn = k + 1 < W ? f[k + 1].s : 0.f;
        const float invc = chain_inv_c(a, k, d, lam);
        for (int i = 0; i < 3; ++i) {
          const float vn = k + 1 < W ? v[3 * (k + 1) + i] : 0.f;
          const float atv = (-sk) * Rv[i] + sn * vn;
          float rdc = 0.f;
          for (int c = 0; c < 6; ++c) rdc += Rc[6 * i + c] * dcs[6 * k + c];
          const float r1 = a.f(B_DP)[3 * kd + i] - rdc;
          const float ddp = (r1 - atv) * invc;
          St[a.n + 3 * NS + 3 * kd + i] = ddp;
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
    // phase: objects
    b -= s.track;
    const int i = b * THREADS + threadIdx.x;
    if (i < W * O) {
      const int k = i / O, o = i % O;
      float xi[6];
      for (int j = 0; j < 6; ++j) xi[j] = head ? 0.f : step_entry(a, nc + 6 * i + j, bad);
      if (!head)
        for (int j = 0; j < 6; ++j) St[nc + 6 * i + j] = xi[j];
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
  // phase: partials
  block_sum<N_FAMILY>(loss, part, tot);
  if (threadIdx.x < N_FAMILY) {
    a.f(PARTIALS)[blockIdx.x * N_FAMILY + threadIdx.x] = tot[threadIdx.x];
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.i32(TICKETS) + 1, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) {
    // phase: end
    return;
  }
  // phase: decide
  __threadfence();
  lm_decide(a, gridDim.x, head);
  if (threadIdx.x == 0) a.i32(TICKETS)[1] = 0;
  // phase: end
}

// the trial values and residuals into the state where accepted,
// COMMIT_PER entries a thread (every load before the stores)
constexpr int COMMIT_PER = 4;

__host__ __device__ inline int commit_blocks(int W, int NS, int ND, int O) {
  return (int)((trial_layout(W, NS, ND, O).off[12] + THREADS * COMMIT_PER - 1) / (THREADS * COMMIT_PER));
}

__device__ __forceinline__ float* commit_dst(const Args& a, int arr) {
  switch (arr) {
    case 0: return a.f(XR);
    case 1: return a.f(XT);
    case 2: return a.f(HR);
    case 3: return a.f(HT);
    case 4: return a.f(SP);
    case 5: return a.f(DP);
    case 6: return a.f(R_ANCHOR);
    case 7: return a.f(R_ODO);
    case 8: return a.f(R_STATIC);
    case 9: return a.f(R_DYN);
    case 10: return a.f(R_TERN);
    default: return a.f(R_SMOOTH);
  }
}

__global__ void __launch_bounds__(THREADS) window_update_commit_kernel(const Args a, int head) {
  if (!head && !*a.b(ACCEPT)) return;
  const TrialLayout L = trial_layout(a.W, a.NS, a.ND, a.O);
  const long long i0 = (long long)blockIdx.x * THREADS * COMMIT_PER + threadIdx.x;
  float v[COMMIT_PER];
#pragma unroll
  for (int c = 0; c < COMMIT_PER; ++c) {
    const long long i = i0 + c * THREADS;
    v[c] = i < L.off[12] ? a.f(TRIAL)[i] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < COMMIT_PER; ++c) {
    const long long i = i0 + c * THREADS;
    if (i >= L.off[12]) break;
    int arr = 0;
#pragma unroll
    for (int t = 1; t < 12; ++t) arr += i >= L.off[t];
    commit_dst(a, arr)[i - L.off[arr]] = v[c];
  }
}

// ---------------------------------------------------------------- host side

cudaError_t make_args(const long long* ptrs, const int* dims, const float* params, Args& a) {
  a.W = dims[0];
  a.NS = dims[1];
  a.ND = dims[2];
  a.O = dims[3];
  if (a.W < 2 || a.W > MAX_W || a.NS < 1 || a.ND < 1 || a.O < 1 || a.O > MAX_O || a.NS > 1024 || a.ND > 1024)
    return cudaErrorInvalidValue;
  a.nc = 6 * a.W;
  a.nm = 6 * a.W * a.O;
  a.n = a.nc + a.nm;
  a.C = 2 * a.nc + 1;
  for (int i = 0; i < N_PARAM; ++i) a.p[i] = params[i];
  for (int i = 0; i < N_PTR; ++i) a.ptr[i] = reinterpret_cast<void*>(ptrs[i]);
  return cudaSuccess;
}

size_t asm_smem(int ND) { return sizeof(int) * (3 * ND + (3 * ND + 3) / 4) + sizeof(float) * (57 + 36 + 36) * ASM_CHUNK; }

}  // namespace

// blocks and threads of each launch: build, segment, assembly, trial,
// commit; then the floats of the trial buffer, the blocks of error
// partials, the floats of the segment partials and of KEEP; the segment
// pass's dynamic shared memory in bytes, the chains it solves
// at once, the assembly's dynamic shared memory in bytes, and the ints of
// the per-CTA lists of tracks with an object and of their counts
extern "C" int dyno_window_launch_shape(const int* dims, int* out) {
  const int W = dims[0], NS = dims[1], ND = dims[2], O = dims[3];
  const BuildShape bs = build_shape(W, NS, ND, O);
  const SegShape ss = seg_shape(W, NS, ND, O);
  const UpdateShape us = update_shape(W, NS, ND, O);
  const TrialLayout tl = trial_layout(W, NS, ND, O);
  out[0] = bs.frame + bs.stat + bs.dyn + bs.obj;
  out[1] = THREADS;
  out[2] = ss.ctas;
  out[3] = SEG_THREADS;
  out[4] = asm_blocks(W, O);
  out[5] = ASM_THREADS;
  out[6] = us.frame + us.stat + us.track + us.obj;
  out[7] = THREADS;
  out[8] = commit_blocks(W, NS, ND, O);
  out[9] = THREADS;
  out[10] = (int)tl.off[12];
  out[11] = out[6];
  out[12] = ss.ctas * ss.E;
  out[13] = W * ND * ss.krec;
  out[14] = (int)(sizeof(float) * ss.floats);
  out[15] = ss.tpar;
  out[16] = (int)asm_smem(ND);
  out[17] = W * O * ss.ctas * SEG_PER;
  out[18] = W * O * ss.ctas;
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

static int seg_cache_small[16] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
static int seg_cache_max[16] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};

extern "C" int dyno_window_step(const long long* ptrs, const int* dims, const float* params, void* stream) {
  Args a;
  cudaError_t e = make_args(ptrs, dims, params, a);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const SegShape sh = seg_shape(a.W, a.NS, a.ND, a.O);
  const size_t smem = sizeof(float) * sh.floats;
  int limit = 0;
  if (sh.qj <= SEG_QJ_SMALL) {
    auto kern = window_step_seg_kernel<SEG_QJ_SMALL>;
    if ((e = dyno::dynamic_smem_limit((const void*)kern, seg_cache_small, &limit)) != cudaSuccess) return (int)e;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    kern<<<sh.ctas, SEG_THREADS, smem, s>>>(a, sh);
  } else {
    auto kern = window_step_seg_kernel<SEG_QJ_MAX>;
    if ((e = dyno::dynamic_smem_limit((const void*)kern, seg_cache_max, &limit)) != cudaSuccess) return (int)e;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    kern<<<sh.ctas, SEG_THREADS, smem, s>>>(a, sh);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_step_assemble_kernel<<<asm_blocks(a.W, a.O), ASM_THREADS, asm_smem(a.ND), s>>>(a, sh);
  return (int)cudaGetLastError();
}

static int update(const long long* ptrs, const int* dims, const float* params, void* stream, int head) {
  Args a;
  cudaError_t e = make_args(ptrs, dims, params, a);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const UpdateShape us = update_shape(a.W, a.NS, a.ND, a.O);
  window_update_trial_kernel<<<us.frame + us.stat + us.track + us.obj, THREADS, 0, s>>>(a, head);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  window_update_commit_kernel<<<commit_blocks(a.W, a.NS, a.ND, a.O), THREADS, 0, s>>>(a, head);
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
