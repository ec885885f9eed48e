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
// N 512): a few hundred to a few thousand FLOPs a row an LM iteration,
// ~0.1-0.5 GFLOP a call, 2-8 us of the card's float32 rate.  The time is a
// chain's latency instead: every LM iteration of a problem is a pass over
// its rows, a sum over them, a 6x6 solve, a second pass and a second sum,
// up to 25 iterations a problem at the default settings (5 rounds of up
// to 5), all dependent.  On one block per problem the first pass took
// 70-75 % of the call (8 and 2 rows a thread, each row's state stored to
// global memory at a stride of 20 and 84 floats between threads).
//
// Design: one thread block cluster per problem, C CTAs of K::T threads
// (C = ceil(N / T), at most 8, the portable cluster size), so a thread
// owns about one row at the main path's shapes: FlowPose 8 x 256 threads
// for N 2,048, MotionOnly 4 x 128 for N 512.  CTA r owns rows
// [r S, r S + S), S = ceil(N / C), and thread t its rows t, t + T, ...
// for the whole call.  Each CTA loads its rows' inputs, carried blocks and
// active flags into dynamic shared memory once (structure of arrays, so a
// warp's accesses are conflict-free), keeps there every per-row state of
// an LM iteration (U_d^-1, W, gb and the trial blocks; an accepted step
// swaps the current and trial buffers) and writes the blocks and flags
// back once at the end: no global scratch.  Sums over rows are
// `dyno::cluster_sum`s (small.cuh): fixed-order warp, CTA and rank-ordered
// cluster sums over distributed shared memory, no atomics (fault F4), so
// every thread of every CTA holds the same bits and forms the 6x6 solve,
// the retraction and the LM and round decisions itself with no broadcast,
// and a result repeats bit for bit, graphed or not.  N is bounded by the
// shared memory of 8 CTAs (`dyno_refine_launch_shape`).  What remains is
// latency: per LM iteration the first pass (one row's chain, ~1.2 us for
// FlowPose, ~3.4 us for MotionOnly), two exchanges of ~0.5-1.4 us and
// the 6x6 solve and retraction, ~1 us, which every thread repeats.
//
// Rounding: a row's linearisation and elimination repeat the plain
// version's float operations as PyTorch runs them on the card, so a row's
// U_d^-1, W and gb equal the plain version's bit for bit (the golden
// scene's object blocks are so near singular that a last-bit difference
// in U moved a motion beyond its tolerance): the small sums over the
// residual axis and the block axis take `torch.sum`'s order
// (`dyno::sum_outer`, `dyno::sum_inner`), and a division by a sigma or by
// the lambda factor, a Python number there, is a product with its
// reciprocal (`fparams` carries the sigmas' reciprocals).  Only the sums
// over rows differ in order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "small.cuh"

namespace {

using dyno::Cam;
using dyno::SE3;


struct Params {
  Cam cam;
  // 1 / the family sigmas (see the kinds): PyTorch on the card divides a
  // tensor by a Python number as a product with its reciprocal
  float inv_s0, inv_s1;
  float k, half_k2;       // Huber threshold and 0.5 k^2
  float gate;             // chi^2 gate
  float lam0, factor, inv_factor, lam_max, lam_min, rel_tol, abs_tol, floor;   // inv_factor: lam / factor on the card
  int max_it, rounds;
  int B, N;
  int S;                  // rows a CTA owns: ceil(N / cluster size)
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
};

// the pose a kind's residuals are evaluated at: the global, its inverse,
// and (MotionOnly) the inverses of the fixed camera poses
struct At {
  SE3 g, ginv, x0inv, x1inv;
};

struct FlowPose {
  // rows: kp_prev (2), depth_prev (1), flow_init (2), p_world (3)
  static constexpr int BD = 2, D = 4, NF = 2, GATED = 0, RC = 8, T = 256;
  __host__ __device__ static constexpr int fam_begin(int f) { return f == 0 ? 0 : f == 1 ? 2 : 4; }
  __host__ __device__ static constexpr bool huber(int f) { return f == 0; }

  __device__ static void residual(const Params& p, const At& a, const float* row, const float* blk, bool act,
                                  float* r) {
    float pc[3], uv[2], z;
    dyno::se3_apply(a.ginv, row + 5, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    const bool g = act && z > 0.01f;
    const float r0 = (row[0] + blk[0]) - uv[0], r1 = (row[1] + blk[1]) - uv[1];
    r[0] = g ? r0 * p.inv_s0 : 0.f;
    r[1] = g ? r1 * p.inv_s0 : 0.f;
    r[2] = act ? (blk[0] - row[3]) * p.inv_s1 : 0.f;
    r[3] = act ? (blk[1] - row[4]) * p.inv_s1 : 0.f;
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
    const float i0 = p.inv_s0, z0 = 0.f, i1 = p.inv_s1, z1 = 0.f;
    Bm[0] = g ? i0 : 0.f;
    Bm[1] = g ? z0 : 0.f;
    Bm[2] = g ? z0 : 0.f;
    Bm[3] = g ? i0 : 0.f;
    Bm[4] = act ? i1 : 0.f;
    Bm[5] = act ? z1 : 0.f;
    Bm[6] = act ? z1 : 0.f;
    Bm[7] = act ? i1 : 0.f;
#pragma unroll
    for (int i = 0; i < 12; ++i) Gm[i] = g ? (-J[i]) * p.inv_s0 : 0.f;
#pragma unroll
    for (int i = 12; i < 24; ++i) Gm[i] = 0.f;
  }
};

struct MotionOnly {
  // rows: uv_prev (2), uv_cur (2); blocks: mp (3), mc (3)
  static constexpr int BD = 6, D = 7, NF = 3, GATED = 2, RC = 4, T = 128;
  __host__ __device__ static constexpr int fam_begin(int f) { return f == 0 ? 0 : f == 1 ? 2 : f == 2 ? 4 : 7; }
  __host__ __device__ static constexpr bool huber(int) { return true; }

  __device__ static void residual(const Params& p, const At& a, const float* row, const float* blk, bool act,
                                  float* r) {
    float pc[3], uv[2], z, q[3];
    dyno::se3_apply(a.x0inv, blk, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    bool g = act && z > 0.01f;
    r[0] = g ? (uv[0] - row[0]) * p.inv_s0 : 0.f;
    r[1] = g ? (uv[1] - row[1]) * p.inv_s0 : 0.f;
    dyno::se3_apply(a.x1inv, blk + 3, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    g = act && z > 0.01f;
    r[2] = g ? (uv[0] - row[2]) * p.inv_s0 : 0.f;
    r[3] = g ? (uv[1] - row[3]) * p.inv_s0 : 0.f;
    dyno::se3_apply(a.ginv, blk + 3, q);
#pragma unroll
    for (int i = 0; i < 3; ++i) r[4 + i] = act ? (blk[i] - q[i]) * p.inv_s1 : 0.f;
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
        // `torch.sum(Jp * R, -1)`
        const float jr = dyno::sum_inner<3>([&](int k) { return Jp[3 * i + k] * R[3 * c + k]; });
        PB[3 * i + c] = g ? jr * p.inv_s0 : 0.f;
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
        Bm[6 * (4 + i) + c] = act ? e * p.inv_s1 : 0.f;
        Bm[6 * (4 + i) + 3 + c] = act ? (-Rt[3 * i + c]) * p.inv_s1 : 0.f;
        Gm[6 * (4 + i) + c] = act ? Hq[3 * i + c] * p.inv_s1 : 0.f;
        Gm[6 * (4 + i) + 3 + c] = act ? e * p.inv_s1 : 0.f;
      }
  }
};

// the squared norm of family F of one row's residuals, as `torch.sum(r * r,
// -1)` and `vector_norm` add it
template <class K, int F>
__device__ __forceinline__ float family_sq(const float* r) {
  constexpr int b = K::fam_begin(F);
  return dyno::sum_inner<K::fam_begin(F + 1) - b>([&](int d) { return r[b + d] * r[b + d]; });
}

// every family's squared norm
template <class K>
__device__ __forceinline__ void family_sqs(const float* r, float* sq) {
  sq[0] = family_sq<K, 0>(r);
  sq[1] = family_sq<K, 1>(r);
  if constexpr (K::NF > 2) sq[2] = family_sq<K, 2>(r);
}

// robust losses of one row's residuals by family, added to `loss`
template <class K>
__device__ __forceinline__ void add_losses(const Params& p, const float* r, float* loss) {
  float sq[K::NF];
  family_sqs<K>(r, sq);
#pragma unroll
  for (int f = 0; f < K::NF; ++f) loss[f] += K::huber(f) ? dyno::huber_loss(sq[f], p.k, p.half_k2) : 0.5f * sq[f];
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

// the per-row fields a CTA keeps in dynamic shared memory, each an array
// of S floats: the row's inputs, two block buffers (current, trial), U_d^-1,
// W and gb; then S bytes of active flags
template <class K>
struct Fields {
  static constexpr int BLK = K::RC, UI = BLK + 2 * K::BD, W = UI + K::BD * K::BD, GB = W + K::BD * 6,
                       N = GB + K::BD;
  static constexpr int BYTES_PER_ROW = 4 * N + 1;
};

template <class K>
__global__ void __launch_bounds__(K::T) refine_rounds_kernel(const __grid_constant__ Params p) {
  namespace cg = cooperative_groups;
  constexpr int BD = K::BD, D = K::D, RC = K::RC, T = K::T;
  constexpr int NA = 21 + 6 + 36 + 6;  // V (upper), gg, sum W^T U^-1 W, sum W^T U^-1 gb
  using F = Fields<K>;
  __shared__ dyno::SumSpace<T / 32, NA> sums;
  extern __shared__ float sm[];
  // phase: begin
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x, S = p.S;
  const int nr = max(0, min(S, p.N - rank * S));   // rows this CTA owns
  const long long base = (long long)b * p.N + (long long)rank * S;
  uint8_t* active = reinterpret_cast<uint8_t*>(sm + F::N * S);
  auto at_ = [&](int field, int j) -> float& { return sm[field * S + j]; };

  for (int e = tid; e < nr * RC; e += T) dyno::copy4_async(&at_(e % RC, e / RC), p.rows + base * RC + e);
  for (int e = tid; e < nr * BD; e += T) dyno::copy4_async(&at_(F::BLK + e % BD, e / BD), p.start + base * BD + e);
#pragma unroll 4
  for (int j = tid; j < nr; j += T) active[j] = p.valid[base + j];
  int cur = 0;   // the block buffer that holds the current blocks (0 or 1)
  dyno::Exchange ex;   // the cluster exchanges' parity and barrier phases
  At at;
  if (p.shared != nullptr) {
    at.x0inv = dyno::se3_inverse(dyno::se3_load(p.shared));
    at.x1inv = dyno::se3_inverse(dyno::se3_load(p.shared + 12));
  }
  const SE3 g0 = dyno::se3_load(p.glob0 + b * 12);
  long long it = 0, n_new = 0;
  float err_out = 0.f;
  SE3 res = g0;
  dyno::copy_wait();
  dyno::cluster_sum_init(sums);   // also the barrier after the loads

  while (it == 0 || (n_new > 0 && it <= p.rounds)) {
    // phase: head
    at.g = g0;
    at.ginv = dyno::se3_inverse(g0);
    float loss[K::NF];
#pragma unroll
    for (int f = 0; f < K::NF; ++f) loss[f] = 0.f;
    for (int j = tid; j < nr; j += T) {
      float row[RC], blk[BD], r[D];
#pragma unroll
      for (int c = 0; c < RC; ++c) row[c] = at_(c, j);
#pragma unroll
      for (int c = 0; c < BD; ++c) blk[c] = at_(F::BLK + cur * BD + c, j);
      K::residual(p, at, row, blk, active[j] != 0, r);
      add_losses<K>(p, r, loss);
    }
    dyno::cluster_sum<K::NF>(loss, sums, ex);
    float err = total_error<K>(loss);
    float lam = p.lam0;
    bool done = false;

    for (int lit = 0; lit < p.max_it && !done; ++lit) {
      // phase: pass A
      // linearise, eliminate the tracks
      float acc[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] = 0.f;
      for (int j = tid; j < nr; j += T) {
        float row[RC], blk[BD];
#pragma unroll
        for (int c = 0; c < RC; ++c) row[c] = at_(c, j);
#pragma unroll
        for (int c = 0; c < BD; ++c) blk[c] = at_(F::BLK + cur * BD + c, j);
        const bool act = active[j] != 0;
        float r[D], Bm[D * BD], Gm[D * 6], wr[D];
        K::residual(p, at, row, blk, act, r);
        K::jacobian(p, at, row, blk, act, Bm, Gm);
        float sq[K::NF];
        family_sqs<K>(r, sq);
#pragma unroll
        for (int f = 0; f < K::NF; ++f) {
          const float w = K::huber(f) ? dyno::huber_sqrt_weight(sqrtf(sq[f]), p.k) : 1.f;
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
          for (int jj = 0; jj < BD; ++jj)
            U[i * BD + jj] = dyno::sum_outer<D>([&](int d) { return Bm[d * BD + i] * Bm[d * BD + jj]; });
#pragma unroll
          for (int jj = 0; jj < 6; ++jj)
            Wm[i * 6 + jj] = dyno::sum_outer<D>([&](int d) { return Bm[d * BD + i] * Gm[d * 6 + jj]; });
          gb[i] = dyno::sum_outer<D>([&](int d) { return Bm[d * BD + i] * wr[d]; });
        }
        {
          int o = 0;
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int jj = i; jj < 6; ++jj) {
              float s = Gm[i] * Gm[jj];
#pragma unroll
              for (int d = 1; d < D; ++d) s = s + Gm[d * 6 + i] * Gm[d * 6 + jj];
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
          for (int c = 0; c < BD; ++c)
            WtUi[g * BD + c] = dyno::sum_outer<BD>([&](int a) { return Wm[a * 6 + g] * Ui[a * BD + c]; });
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
#pragma unroll
        for (int i = 0; i < BD * BD; ++i) at_(F::UI + i, j) = Ui[i];
#pragma unroll
        for (int i = 0; i < BD * 6; ++i) at_(F::W + i, j) = Wm[i];
#pragma unroll
        for (int i = 0; i < BD; ++i) at_(F::GB + i, j) = gb[i];
      }
      // phase: NA sum
      dyno::cluster_sum<NA>(acc, sums, ex);

      // phase: global step
      // every thread, from the same sums
      float S_[36], Si[36], rhs[6], dg[6];
      {
        int o = 0;
        for (int i = 0; i < 6; ++i)
          for (int jj = i; jj < 6; ++jj) {
            S_[6 * i + jj] = acc[o];
            S_[6 * jj + i] = acc[o];
            ++o;
          }
        for (int i = 0; i < 6; ++i) S_[7 * i] = S_[7 * i] + (lam * dyno::clamp_min(S_[7 * i], p.floor) + 1e-8f);
        for (int i = 0; i < 36; ++i) S_[i] = S_[i] - acc[27 + i];
        for (int i = 0; i < 6; ++i) rhs[i] = acc[21 + i] - acc[63 + i];
        dyno::inv_spd6(S_, Si);
        for (int i = 0; i < 6; ++i) dg[i] = -dyno::sum_inner<6>([&](int jj) { return Si[6 * i + jj] * rhs[jj]; });
      }
      At trial = at;
      trial.g = dyno::se3_retract(at.g, dg);
      trial.ginv = dyno::se3_inverse(trial.g);

      // phase: pass B
      // back-substitute the tracks into the trial buffer, the trial's error
#pragma unroll
      for (int f = 0; f < K::NF; ++f) loss[f] = 0.f;
      for (int j = tid; j < nr; j += T) {
        float t1[BD], nb[BD], r[D], row[RC];
#pragma unroll
        for (int a = 0; a < BD; ++a)
          t1[a] = at_(F::GB + a, j) + dyno::sum_inner<6>([&](int g) { return at_(F::W + a * 6 + g, j) * dg[g]; });
#pragma unroll
        for (int a = 0; a < BD; ++a) {
          const float s = dyno::sum_inner<BD>([&](int c) { return at_(F::UI + a * BD + c, j) * t1[c]; });
          nb[a] = at_(F::BLK + cur * BD + a, j) + (-s);
          at_(F::BLK + (cur ^ 1) * BD + a, j) = nb[a];
        }
#pragma unroll
        for (int c = 0; c < RC; ++c) row[c] = at_(c, j);
        K::residual(p, trial, row, nb, active[j] != 0, r);
        add_losses<K>(p, r, loss);
      }
      // phase: NF sum
      dyno::cluster_sum<K::NF>(loss, sums, ex);
      // phase: accept
      float new_err = total_error<K>(loss);
      if (!isfinite(new_err)) new_err = CUDART_INF_F;
      const bool accept = new_err < err;
      if (accept) {
        cur ^= 1;
        at = trial;
      }
      const float err_o = accept ? new_err : err;
      const float lam_o = accept ? dyno::clamp_min(lam * p.inv_factor, p.lam_min) : dyno::clamp_max(lam * p.factor, p.lam_max);
      const float diff = fabsf(err - err_o);
      const bool rel_ok = diff < p.rel_tol * dyno::clamp_min(err, 1e-30f);
      const bool abs_ok = diff < p.abs_tol;
      done = (accept && (rel_ok || abs_ok)) || (lam_o >= p.lam_max);
      err = err_o;
      lam = lam_o;
    }

    // phase: tail
    // new outliers of the gated family
    float cnt[1] = {0.f};
    for (int j = tid; j < nr; j += T) {
      float row[RC], blk[BD], r[D];
#pragma unroll
      for (int c = 0; c < RC; ++c) row[c] = at_(c, j);
#pragma unroll
      for (int c = 0; c < BD; ++c) blk[c] = at_(F::BLK + cur * BD + c, j);
      const bool act = active[j] != 0;
      K::residual(p, at, row, blk, act, r);
      if (act && family_sq<K, K::GATED>(r) > p.gate) {
        active[j] = 0;
        cnt[0] += 1.f;
      }
    }
    dyno::cluster_sum<1>(cnt, sums, ex);
    n_new = (long long)cnt[0];
    res = at.g;
    err_out = err;
    it += 1;
  }

  // phase: end
  for (int e = tid; e < nr * BD; e += T) p.carried[base * BD + e] = at_(F::BLK + cur * BD + e % BD, e / BD);
  for (int j = tid; j < nr; j += T) p.active[base + j] = active[j];
  if (rank == 0 && tid == 0) {
    for (int i = 0; i < 9; ++i) p.glob[b * 12 + i] = res.R[i];
    for (int i = 0; i < 3; ++i) p.glob[b * 12 + 9 + i] = res.t[i];
    p.error[b] = err_out;
    p.n_new[b] = n_new;
    p.it[b] = it;
  }
  cluster.sync();   // no CTA leaves while another may still write into it
}

// the launch shape for B problems of N rows: cluster size, CTAs, threads,
// dynamic shared memory (bytes) and the largest N the kernel takes
template <class K>
cudaError_t launch_shape(int B, int N, int* out) {
  static int limit_cache[16] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  int limit = 0;
  const cudaError_t e = dyno::dynamic_smem_limit((const void*)refine_rounds_kernel<K>, limit_cache, &limit);
  if (e != cudaSuccess) return e;
  const int C = N <= 0 ? 1 : std::min(dyno::MAX_CLUSTER_SIZE, (N + K::T - 1) / K::T);
  const int S = N <= 0 ? 0 : (N + C - 1) / C;
  out[0] = C;
  out[1] = B * C;
  out[2] = K::T;
  out[3] = S * Fields<K>::BYTES_PER_ROW;
  out[4] = dyno::MAX_CLUSTER_SIZE * (limit / Fields<K>::BYTES_PER_ROW);
  return cudaSuccess;
}

template <class K>
cudaError_t launch(Params p, cudaStream_t s) {
  int shape[5];
  const cudaError_t e = launch_shape<K>(p.B, p.N, shape);
  if (e != cudaSuccess) return e;
  if (p.N > shape[4]) return cudaErrorInvalidValue;
  p.S = shape[3] / Fields<K>::BYTES_PER_ROW;
  return dyno::launch_clusters(refine_rounds_kernel<K>, shape[1], shape[0], shape[2], (size_t)shape[3], s, p);
}

}  // namespace

// kind: 0 FlowPose, 1 MotionOnly.  out: cluster size, CTAs, threads a CTA,
// dynamic shared memory a CTA (bytes), the largest N taken.
extern "C" int dyno_refine_launch_shape(int kind, int B, int N, int* out) {
  return (int)(kind == 0 ? launch_shape<FlowPose>(B, N, out) : launch_shape<MotionOnly>(B, N, out));
}

// kind: 0 FlowPose, 1 MotionOnly.  fparams: fx, fy, cx, cy, s0, s1, k,
// half_k2, gate, lam0, factor, lam_max, lam_min, rel_tol, abs_tol, floor,
// 1 / s0, 1 / s1 (taken in double);
// iparams: max_iterations, outlier_rounds, B, N.  ptrs: rows, start,
// glob0, shared (0: none), valid, carried, active, glob, error, n_new, it.
extern "C" int dyno_refine_rounds(int kind, const float* fparams, const int* iparams, const long long* ptrs,
                                  void* stream) {
  Params p;
  p.cam = Cam{fparams[0], fparams[1], fparams[2], fparams[3]};
  p.inv_s0 = fparams[16];
  p.inv_s1 = fparams[17];
  p.k = fparams[6];
  p.half_k2 = fparams[7];
  p.gate = fparams[8];
  p.lam0 = fparams[9];
  p.factor = fparams[10];
  p.inv_factor = (float)(1.0 / (double)fparams[10]);
  p.lam_max = fparams[11];
  p.lam_min = fparams[12];
  p.rel_tol = fparams[13];
  p.abs_tol = fparams[14];
  p.floor = fparams[15];
  p.max_it = iparams[0];
  p.rounds = iparams[1];
  p.B = iparams[2];
  p.N = iparams[3];
  p.S = 0;
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
  if (p.B <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t e = kind == 0 ? launch<FlowPose>(p, s) : launch<MotionOnly>(p, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
