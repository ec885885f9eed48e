// K5: the frontend's refinement rounds -- outlier rounds around a
// block-eliminated Levenberg-Marquardt -- for a batch of B independent
// problems, one thread block each, with no host read.  It replaces no
// Pallas kernel: it is the device-side form of the JAX package's nested
// `lax.while_loop`s, `dynosam_tpu/frontend/refine.py:57`
// (`optimize_flow_and_pose`) and `:186` (`optimize_motion_only`) around
// `dynosam_tpu/backend/small_schur.py:88` (`lm_optimize_eliminated`), which
// the port ran as host loops of small operators that read two flags a
// round and one an LM iteration (`frontend/refine.py:rounds_schedule`).
// Wrapper and plain version: `kernels/refine.py`.
//
// Kinds (template argument):
//   FlowPose   -- per-track flow (2) + one pose X; families: flow
//                 projection (Huber k, sigma s0) and flow prior (sigma s1);
//                 the chi^2 gate reads family 0;
//   MotionOnly -- per-track landmark pair (mp, mc) (6) + one motion H with
//                 the camera poses fixed; families: the two reprojections
//                 (sigma s0) and the ternary m_prev - H^-1 m_cur (sigma
//                 s1), all Huber k; the gate reads family 2.
//
// Contract (the plain version: `frontend/refine.py:_run_eagerly` over
// `backend/small_schur.py:lm_head` / `lm_iteration`), per problem:
//   rounds while it == 0 or (n_new > 0 and it <= outlier_rounds):
//     head: blocks from the carried ones, the global from its initial
//       value, error = sum over families of the robust losses;
//     up to max_iterations LM iterations until converged: IRLS square-root
//       weights at the linearisation point, per track U = Bm^T Bm,
//       W = Bm^T Gm, gb = Bm^T wr; V = sum Gm^T Gm, gg = sum Gm^T wr;
//       damping lam * clamp(diag, floor) + 1e-8 on U and V;
//       S = V_d - sum W^T U_d^-1 W, dg = -S^-1 (gg - sum W^T U_d^-1 gb),
//       db = -U_d^-1 (gb + W dg), with `inv_spd`'s closed forms; the trial
//       (blocks + db, glob Exp(dg)) is accepted if its error (non-finite:
//       inf) is lower; lambda / or * factor within [min, max]; converged on
//       an accepted step within rel or abs tolerance, or at max lambda.  A
//       rejected step leaves the point unchanged, so the next iteration's
//       linearisation, computed anew, equals the one the plain version
//       keeps;
//     tail: the gated family's chi^2 > gate marks new outliers among the
//       active rows; they leave the active set, the blocks carry over, the
//       round's global and error are the result, it += 1.
// Outputs: active, carried blocks (also the result's blocks), the result's
// global, error, n_new and it.
//
// Bound at the main path's shapes (FlowPose B 9 x N 2,048; MotionOnly B 8 x
// N 512): a few hundred FLOPs a row an LM iteration, ~0.1-0.5 GFLOP a call,
// 2-8 us of the card's float32 rate; but every LM iteration is a chain of
// two block reductions and a 6x6 solve, up to 25 a problem at the default
// settings (5 rounds of up to 5), so the kernel's time is that chain's
// latency.
//
// Design: one block of 256 threads per problem runs the whole loop; thread
// t owns rows t, t + 256, ... for the whole call, so the per-row state in
// global scratch (U_d^-1, W, gb, the trial blocks) is read back only by the
// thread that wrote it.  Sums over rows are fixed-order block sums
// (`block_sum`: a warp butterfly, then the warps in order), never atomics
// (fault F4 came from atomics), so a result repeats bit for bit, graphed or
// not.  Every thread forms the 6x6 solve, the retraction and the LM
// decisions from the same sums, so no broadcast is needed.
#include <cuda_runtime.h>

#include <cstdint>

#include "small.cuh"

namespace {

using dyno::Cam;
using dyno::SE3;

constexpr int THREADS = 256;

struct Params {
  Cam cam;
  float s0, s1;           // family sigmas (see the kinds)
  float k, half_k2;       // Huber threshold and 0.5 k^2
  float gate;             // chi^2 gate
  float lam0, factor, lam_max, lam_min, rel_tol, abs_tol, floor;
  int max_it, rounds;
  int B, N;
  const float* rows;      // (B, N, K::RC) per-row inputs
  const float* start;     // (B, N, K::BD) carried blocks before the first round
  const float* glob0;     // (B, 12) the global's initial value (R, t)
  const float* shared;    // MotionOnly: X_prev, X_cur (12 each)
  const uint8_t* valid;   // (B, N)
  float* carried;         // (B, N, K::BD) out: carried and result blocks
  uint8_t* active;        // (B, N) out
  float* glob;            // (B, 12) out: the result's global
  float* error;           // (B,) out
  long long* n_new;       // (B,) out
  long long* it;          // (B,) out
  float* scratch;         // (B, N, K::SC) per-row state of an LM iteration
};

// the pose a kind's residuals are evaluated at: the global, its inverse,
// and (MotionOnly) the inverses of the fixed camera poses
struct At {
  SE3 g, ginv, x0inv, x1inv;
};

struct FlowPose {
  // rows: kp_prev (2), depth_prev (1), flow_init (2), p_world (3)
  static constexpr int BD = 2, D = 4, NF = 2, GATED = 0, RC = 8;
  static constexpr int SC = BD * BD + BD * 6 + BD + BD;
  __host__ __device__ static constexpr int fam_begin(int f) { return f == 0 ? 0 : f == 1 ? 2 : 4; }
  __host__ __device__ static constexpr bool huber(int f) { return f == 0; }

  __device__ static void residual(const Params& p, const At& a, const float* row, const float* blk, bool act,
                                  float* r) {
    float pc[3], uv[2], z;
    dyno::se3_apply(a.ginv, row + 5, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    const bool g = act && z > 0.01f;
    const float r0 = (row[0] + blk[0]) - uv[0], r1 = (row[1] + blk[1]) - uv[1];
    r[0] = g ? r0 / p.s0 : 0.f;
    r[1] = g ? r1 / p.s0 : 0.f;
    r[2] = act ? (blk[0] - row[3]) / p.s1 : 0.f;
    r[3] = act ? (blk[1] - row[4]) / p.s1 : 0.f;
  }

  // unwhitened Jacobian rows: Bm (D x BD) on the flow, Gm (D x 6) on the pose
  __device__ static void jacobian(const Params& p, const At& a, const float* row, const float* blk, bool act,
                                  float* Bm, float* Gm) {
    float pc[3], uv[2], z, J[12];
    dyno::se3_apply(a.ginv, row + 5, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    const bool g = act && z > 0.01f;
    const float ps[3] = {pc[0], pc[1], z > 0.01f ? z : 1.f};
    dyno::project_jacobian_pose(p.cam, ps, J);
    const float i0 = 1.f / p.s0, z0 = 0.f / p.s0, i1 = 1.f / p.s1, z1 = 0.f / p.s1;
    Bm[0] = g ? i0 : 0.f;
    Bm[1] = g ? z0 : 0.f;
    Bm[2] = g ? z0 : 0.f;
    Bm[3] = g ? i0 : 0.f;
    Bm[4] = act ? i1 : 0.f;
    Bm[5] = act ? z1 : 0.f;
    Bm[6] = act ? z1 : 0.f;
    Bm[7] = act ? i1 : 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) Gm[i] = g ? (-J[i]) / p.s0 : 0.f;
#pragma unroll
    for (int i = 12; i < 24; ++i) Gm[i] = 0.f;
  }
};

struct MotionOnly {
  // rows: uv_prev (2), uv_cur (2); blocks: mp (3), mc (3)
  static constexpr int BD = 6, D = 7, NF = 3, GATED = 2, RC = 4;
  static constexpr int SC = BD * BD + BD * 6 + BD + BD;
  __host__ __device__ static constexpr int fam_begin(int f) { return f == 0 ? 0 : f == 1 ? 2 : f == 2 ? 4 : 7; }
  __host__ __device__ static constexpr bool huber(int) { return true; }

  __device__ static void residual(const Params& p, const At& a, const float* row, const float* blk, bool act,
                                  float* r) {
    float pc[3], uv[2], z, q[3];
    dyno::se3_apply(a.x0inv, blk, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    bool g = act && z > 0.01f;
    r[0] = g ? (uv[0] - row[0]) / p.s0 : 0.f;
    r[1] = g ? (uv[1] - row[1]) / p.s0 : 0.f;
    dyno::se3_apply(a.x1inv, blk + 3, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    g = act && z > 0.01f;
    r[2] = g ? (uv[0] - row[2]) / p.s0 : 0.f;
    r[3] = g ? (uv[1] - row[3]) / p.s0 : 0.f;
    dyno::se3_apply(a.ginv, blk + 3, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) r[4 + i] = act ? (blk[i] - q[i]) / p.s1 : 0.f;
  }

  // one reprojection's block (2 x 3): the point Jacobian times R^T, gated
  __device__ static void reproj_block(const Params& p, const SE3& xinv, const SE3& x_R_src, const float* m,
                                      bool act, float* PB) {
    float pc[3], uv[2], z, Jp[6];
    dyno::se3_apply(xinv, m, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    const bool g = act && z > 0.01f;
    const float ps[3] = {pc[0], pc[1], z > 0.01f ? z : 1.f};
    dyno::project_jacobian_point(p.cam, ps, Jp);
    const float* R = x_R_src.R;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float jr = (Jp[3 * i] * R[3 * c] + Jp[3 * i + 1] * R[3 * c + 1]) + Jp[3 * i + 2] * R[3 * c + 2];
        PB[3 * i + c] = g ? jr / p.s0 : 0.f;
      }
  }

  __device__ static void jacobian(const Params& p, const At& a, const float* row, const float* blk, bool act,
                                  float* Bm, float* Gm) {
    // the camera poses' rotations are the transposes of their inverses'
    SE3 x0, x1;
    dyno::transpose3(a.x0inv.R, x0.R);
    dyno::transpose3(a.x1inv.R, x1.R);
    float PB0[6], PB1[6], q[3], Hq[9];
    reproj_block(p, a.x0inv, x0, blk, act, PB0);
    reproj_block(p, a.x1inv, x1, blk + 3, act, PB1);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Bm[6 * i + c] = PB0[3 * i + c];
        Bm[6 * i + 3 + c] = 0.f;
        Bm[6 * (2 + i) + c] = 0.f;
        Bm[6 * (2 + i) + 3 + c] = PB1[3 * i + c];
      }
#pragma unroll
    for (int i = 0; i < 24; ++i) Gm[i] = 0.f;
    dyno::se3_apply(a.ginv, blk + 3, q);
    const float nq[3] = {-q[0], -q[1], -q[2]};
    dyno::so3_hat(nq, Hq);  // -hat(q)
    const float* Rt = a.ginv.R;  // H^T
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float e = (i == c) ? 1.f : 0.f;
        Bm[6 * (4 + i) + c] = act ? e / p.s1 : 0.f;
        Bm[6 * (4 + i) + 3 + c] = act ? (-Rt[3 * i + c]) / p.s1 : 0.f;
        Gm[6 * (4 + i) + c] = act ? Hq[3 * i + c] / p.s1 : 0.f;
        Gm[6 * (4 + i) + 3 + c] = act ? e / p.s1 : 0.f;
      }
  }
};

// the squared norm of family f of one row's residuals
template <class K>
__device__ __forceinline__ float family_sq(const float* r, int f) {
  float sq = r[K::fam_begin(f)] * r[K::fam_begin(f)];
#pragma unroll
  for (int d = K::fam_begin(f) + 1; d < K::fam_begin(f + 1); ++d) sq = sq + r[d] * r[d];
  return sq;
}

// robust losses of one row's residuals by family, added to `loss`
template <class K>
__device__ __forceinline__ void add_losses(const Params& p, const float* r, float* loss) {
#pragma unroll
  for (int f = 0; f < K::NF; ++f) {
    const float sq = family_sq<K>(r, f);
    loss[f] += K::huber(f) ? dyno::huber_loss(sq, p.k, p.half_k2) : 0.5f * sq;
  }
}

template <class K>
__device__ __forceinline__ float total_error(const float* loss) {
  float e = loss[0];
#pragma unroll
  for (int f = 1; f < K::NF; ++f) e = e + loss[f];
  return e;
}

template <int BD>
__device__ __forceinline__ void inv_small(const float* M, float* out) {
  if constexpr (BD == 2) dyno::inv2(M, out);
  else dyno::inv_spd6(M, out);
}

template <class K>
__global__ void __launch_bounds__(THREADS) refine_rounds_kernel(const __grid_constant__ Params p) {
  constexpr int BD = K::BD, D = K::D, SC = K::SC;
  constexpr int NA = 21 + 6 + 36 + 6;  // V (upper), gg, sum W^T U^-1 W, sum W^T U^-1 gb
  __shared__ float red[(THREADS / 32 + 1) * NA];
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long base = (long long)b * p.N;
  const float* rows = p.rows + base * K::RC;
  float* carried = p.carried + base * BD;
  uint8_t* active = p.active + base;
  float* scratch = p.scratch + base * SC;

  for (int n = tid; n < p.N; n += THREADS) {
    for (int i = 0; i < BD; ++i) carried[n * BD + i] = p.start[(base + n) * BD + i];
    active[n] = p.valid[base + n];
  }
  At at;
  if (p.shared != nullptr) {
    at.x0inv = dyno::se3_inverse(dyno::se3_load(p.shared));
    at.x1inv = dyno::se3_inverse(dyno::se3_load(p.shared + 12));
  }
  const SE3 g0 = dyno::se3_load(p.glob0 + b * 12);
  long long it = 0, n_new = 0;
  float err_out = 0.f;
  SE3 res = g0;

  while (it == 0 || (n_new > 0 && it <= p.rounds)) {
    // ---- head
    at.g = g0;
    at.ginv = dyno::se3_inverse(g0);
    float loss[K::NF];
#pragma unroll
    for (int f = 0; f < K::NF; ++f) loss[f] = 0.f;
    for (int n = tid; n < p.N; n += THREADS) {
      float r[D];
      K::residual(p, at, rows + n * K::RC, carried + n * BD, active[n] != 0, r);
      add_losses<K>(p, r, loss);
    }
    dyno::block_sum<K::NF>(loss, red);
    float err = total_error<K>(loss);
    float lam = p.lam0;
    bool done = false;

    for (int lit = 0; lit < p.max_it && !done; ++lit) {
      // ---- linearise, eliminate the tracks (pass A)
      float acc[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.f;
      for (int n = tid; n < p.N; n += THREADS) {
        const float* row = rows + n * K::RC;
        const float* blk = carried + n * BD;
        const bool act = active[n] != 0;
        float r[D], Bm[D * BD], Gm[D * 6], wr[D];
        K::residual(p, at, row, blk, act, r);
        K::jacobian(p, at, row, blk, act, Bm, Gm);
#pragma unroll
        for (int f = 0; f < K::NF; ++f) {
          const float w = K::huber(f) ? dyno::huber_sqrt_weight(sqrtf(family_sq<K>(r, f)), p.k) : 1.f;
#pragma unroll
          for (int d = K::fam_begin(f); d < K::fam_begin(f + 1); ++d) {
            wr[d] = w * r[d];
#pragma unroll
            for (int i = 0; i < BD; ++i) Bm[d * BD + i] = w * Bm[d * BD + i];
#pragma unroll
            for (int i = 0; i < 6; ++i) Gm[d * 6 + i] = w * Gm[d * 6 + i];
          }
        }
        float U[BD * BD], Wm[BD * 6], gb[BD];
#pragma unroll
        for (int i = 0; i < BD; ++i) {
#pragma unroll
          for (int j = 0; j < BD; ++j) {
            float s = Bm[i] * Bm[j];
#pragma unroll
            for (int d = 1; d < D; ++d) s = s + Bm[d * BD + i] * Bm[d * BD + j];
            U[i * BD + j] = s;
          }
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            float s = Bm[i] * Gm[j];
#pragma unroll
            for (int d = 1; d < D; ++d) s = s + Bm[d * BD + i] * Gm[d * 6 + j];
            Wm[i * 6 + j] = s;
          }
          float s = Bm[i] * wr[0];
#pragma unroll
          for (int d = 1; d < D; ++d) s = s + Bm[d * BD + i] * wr[d];
          gb[i] = s;
        }
        {
          int o = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = i; j < 6; ++j) {
              float s = Gm[i] * Gm[j];
#pragma unroll
              for (int d = 1; d < D; ++d) s = s + Gm[d * 6 + i] * Gm[d * 6 + j];
              acc[o++] += s;
            }
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float s = Gm[i] * wr[0];
#pragma unroll
            for (int d = 1; d < D; ++d) s = s + Gm[d * 6 + i] * wr[d];
            acc[21 + i] += s;
          }
        }
        // damped U, its inverse, and the track's part of S and of the rhs
#pragma unroll
        for (int i = 0; i < BD; ++i)
          U[i * BD + i] = U[i * BD + i] + (lam * dyno::clamp_min(U[i * BD + i], p.floor) + 1e-8f);
        float Ui[BD * BD];
        inv_small<BD>(U, Ui);
        float WtUi[6 * BD];
#pragma unroll
        for (int g = 0; g < 6; ++g)
#pragma unroll
          for (int c = 0; c < BD; ++c) {
            float s = Wm[g] * Ui[c];
#pragma unroll
            for (int a = 1; a < BD; ++a) s = s + Wm[a * 6 + g] * Ui[a * BD + c];
            WtUi[g * BD + c] = s;
          }
#pragma unroll
        for (int g = 0; g < 6; ++g) {
#pragma unroll
          for (int h = 0; h < 6; ++h) {
            float s = WtUi[g * BD] * Wm[h];
#pragma unroll
            for (int c = 1; c < BD; ++c) s = s + WtUi[g * BD + c] * Wm[c * 6 + h];
            acc[27 + g * 6 + h] += s;
          }
          float s = WtUi[g * BD] * gb[0];
#pragma unroll
          for (int c = 1; c < BD; ++c) s = s + WtUi[g * BD + c] * gb[c];
          acc[63 + g] += s;
        }
        float* sc = scratch + n * SC;
#pragma unroll
        for (int i = 0; i < BD * BD; ++i) sc[i] = Ui[i];
#pragma unroll
        for (int i = 0; i < BD * 6; ++i) sc[BD * BD + i] = Wm[i];
#pragma unroll
        for (int i = 0; i < BD; ++i) sc[BD * BD + BD * 6 + i] = gb[i];
      }
      dyno::block_sum<NA>(acc, red);

      // ---- the global step (every thread, from the same sums)
      float S[36], Si[36], rhs[6], dg[6];
      {
        int o = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = i; j < 6; ++j) {
            S[6 * i + j] = acc[o];
            S[6 * j + i] = acc[o];
            ++o;
          }
        for (int i = 0; i < 6; ++i) S[7 * i] = S[7 * i] + (lam * dyno::clamp_min(S[7 * i], p.floor) + 1e-8f);
        for (int i = 0; i < 36; ++i) S[i] = S[i] - acc[27 + i];
        for (int i = 0; i < 6; ++i) rhs[i] = acc[21 + i] - acc[63 + i];
        dyno::inv_spd6(S, Si);
        for (int i = 0; i < 6; ++i) {
          float s = Si[6 * i] * rhs[0];
          for (int j = 1; j < 6; ++j) s = s + Si[6 * i + j] * rhs[j];
          dg[i] = -s;
        }
      }
      At trial = at;
      trial.g = dyno::se3_retract(at.g, dg);
      trial.ginv = dyno::se3_inverse(trial.g);

      // ---- back-substitute the tracks, the trial's error (pass B)
#pragma unroll
      for (int f = 0; f < K::NF; ++f) loss[f] = 0.f;
      for (int n = tid; n < p.N; n += THREADS) {
        float* sc = scratch + n * SC;
        const float* Ui = sc;
        const float* Wm = sc + BD * BD;
        const float* gb = sc + BD * BD + BD * 6;
        float t1[BD], nb[BD], r[D];
#pragma unroll
        for (int a = 0; a < BD; ++a) {
          float s = Wm[a * 6] * dg[0];
#pragma unroll
          for (int g = 1; g < 6; ++g) s = s + Wm[a * 6 + g] * dg[g];
          t1[a] = gb[a] + s;
        }
#pragma unroll
        for (int a = 0; a < BD; ++a) {
          float s = Ui[a * BD] * t1[0];
#pragma unroll
          for (int c = 1; c < BD; ++c) s = s + Ui[a * BD + c] * t1[c];
          nb[a] = carried[n * BD + a] + (-s);
          sc[BD * BD + BD * 6 + BD + a] = nb[a];
        }
        K::residual(p, trial, rows + n * K::RC, nb, active[n] != 0, r);
        add_losses<K>(p, r, loss);
      }
      dyno::block_sum<K::NF>(loss, red);
      float new_err = total_error<K>(loss);
      if (!isfinite(new_err)) new_err = CUDART_INF_F;
      const bool accept = new_err < err;
      if (accept) {
        for (int n = tid; n < p.N; n += THREADS)
#pragma unroll
          for (int a = 0; a < BD; ++a) carried[n * BD + a] = scratch[n * SC + BD * BD + BD * 6 + BD + a];
        at = trial;
      }
      const float err_o = accept ? new_err : err;
      const float lam_o = accept ? dyno::clamp_min(lam / p.factor, p.lam_min) : dyno::clamp_max(lam * p.factor, p.lam_max);
      const float diff = fabsf(err - err_o);
      const bool rel_ok = diff < p.rel_tol * dyno::clamp_min(err, 1e-30f);
      const bool abs_ok = diff < p.abs_tol;
      done = (accept && (rel_ok || abs_ok)) || (lam_o >= p.lam_max);
      err = err_o;
      lam = lam_o;
    }

    // ---- tail: new outliers of the gated family
    float cnt[1] = {0.f};
    for (int n = tid; n < p.N; n += THREADS) {
      float r[D];
      const bool act = active[n] != 0;
      K::residual(p, at, rows + n * K::RC, carried + n * BD, act, r);
      if (act && family_sq<K>(r, K::GATED) > p.gate) {
        active[n] = 0;
        cnt[0] += 1.f;
      }
    }
    dyno::block_sum<1>(cnt, red);
    n_new = (long long)cnt[0];
    res = at.g;
    err_out = err;
    it += 1;
  }

  if (tid == 0) {
    for (int i = 0; i < 9; ++i) p.glob[b * 12 + i] = res.R[i];
    for (int i = 0; i < 3; ++i) p.glob[b * 12 + 9 + i] = res.t[i];
    p.error[b] = err_out;
    p.n_new[b] = n_new;
    p.it[b] = it;
  }
}

}  // namespace

// kind: 0 FlowPose, 1 MotionOnly.  fparams: fx, fy, cx, cy, s0, s1, k,
// half_k2, gate, lam0, factor, lam_max, lam_min, rel_tol, abs_tol, floor;
// iparams: max_iterations, outlier_rounds, B, N.  ptrs: rows, start,
// glob0, shared (0: none), valid, carried, active, glob, error, n_new, it,
// scratch.
extern "C" int dyno_refine_rounds(int kind, const float* fparams, const int* iparams, const long long* ptrs,
                                  void* stream) {
  Params p;
  p.cam = Cam{fparams[0], fparams[1], fparams[2], fparams[3]};
  p.s0 = fparams[4];
  p.s1 = fparams[5];
  p.k = fparams[6];
  p.half_k2 = fparams[7];
  p.gate = fparams[8];
  p.lam0 = fparams[9];
  p.factor = fparams[10];
  p.lam_max = fparams[11];
  p.lam_min = fparams[12];
  p.rel_tol = fparams[13];
  p.abs_tol = fparams[14];
  p.floor = fparams[15];
  p.max_it = iparams[0];
  p.rounds = iparams[1];
  p.B = iparams[2];
  p.N = iparams[3];
  p.rows = reinterpret_cast<const float*>(ptrs[0]);
  p.start = reinterpret_cast<const float*>(ptrs[1]);
  p.glob0 = reinterpret_cast<const float*>(ptrs[2]);
  p.shared = reinterpret_cast<const float*>(ptrs[3]);
  p.valid = reinterpret_cast<const uint8_t*>(ptrs[4]);
  p.carried = reinterpret_cast<float*>(ptrs[5]);
  p.active = reinterpret_cast<uint8_t*>(ptrs[6]);
  p.glob = reinterpret_cast<float*>(ptrs[7]);
  p.error = reinterpret_cast<float*>(ptrs[8]);
  p.n_new = reinterpret_cast<long long*>(ptrs[9]);
  p.it = reinterpret_cast<long long*>(ptrs[10]);
  p.scratch = reinterpret_cast<float*>(ptrs[11]);
  if (p.B <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (kind == 0)
    refine_rounds_kernel<FlowPose><<<p.B, THREADS, 0, s>>>(p);
  else
    refine_rounds_kernel<MotionOnly><<<p.B, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
