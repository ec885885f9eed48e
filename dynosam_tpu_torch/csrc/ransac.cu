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
// 1.5 us of the card's float32 rate; inputs and outputs are < 0.2 MB.  The
// polish is a chain of 5 dependent sums over the rows and 6x6 solves per
// problem, so its latency, not a rate, bounds it.  With a warp a
// hypothesis reading its rows from global memory, the ego scoring took
// 29 us: each lane's 48 dependent row loads waited on L2.
//
// Design: (a) `ransac_score_kernel`, blocks of SCORE_T threads, each over
// a few hypotheses of one problem: the block stages the problem's rows
// (src, dst or uv, valid) in shared memory as they lie in memory, TILE rows
// at a time, with 16-byte loads, lists the tile's valid rows (a block scan
// of their flags: invalid rows count for nothing, and object problems are
// mostly padding), and G warps score each hypothesis over the list, every
// lane about SCORE_ROWS rows of a tile (each lane solves the minimal set;
// the warps' integer counts are exact in any order).  At the ego shape
// (500 hypotheses of 1,536 rows) that is 4 warps a hypothesis and 250
// blocks, so the call spreads over the card.
// (b) `ransac_polish_kernel`, one thread block cluster per problem, C CTAs
// of POLISH_T threads (C = ceil(N / POLISH_T), at most 8), CTA r owning
// rows [r S, r S + S), which it stages in its shared memory with their
// inlier flags (N is bounded by that memory): every CTA takes the argmax
// of the K counts itself (the first maximum: the same k_best everywhere)
// and solves the best hypothesis again (the same device code as (a), so
// the same bits); each Gauss-Newton step is one `dyno::cluster_sum` of the
// 21 + 6 entries of A and g (fixed-order warp, CTA and rank-ordered
// cluster sums over distributed shared memory, no atomics), after which
// every thread forms the same 6x6 solve and retraction; the final inlier
// pass, its counts and the status are split and summed the same way.  The
// result is the same on every run.  A step costs ~1.9 us at the main
// path's shapes: rows ~0.4-0.6, the exchange ~0.6, the solve ~0.7.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "small.cuh"

namespace {

using dyno::Cam;
using dyno::SE3;

constexpr int POLISH_T = 128;     // threads a polish CTA
constexpr int TILE = 1536;        // rows a scoring block stages at a time (the main path's capped ego rows)
// a polish row's shared memory: src (3) and uv (2) or dst (3) floats, valid and inlier bytes
constexpr int polish_row_bytes(bool reproj) { return 4 * (3 + (reproj ? 2 : 3)) + 2; }
constexpr int SCORE_T = 256;       // threads a scoring block
constexpr int SCORE_ROWS = 16;     // rows a lane scores in a tile, about

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

// the scoring error of a row (src s; uv, 3d2d, or dst d, 3d3d) under
// hypothesis h (see the contract)
template <bool REPROJ>
__device__ __forceinline__ float score_error(const Problem& p, const SE3& h, const float* s, const float* d) {
  if (REPROJ) {
    float diff[3], pc[3], uv[2], z;
    sub3(s, h.t, diff);
    // p_cam = R^T diff, as `torch.sum(Rt * diff, -1)`
#pragma unroll
    for (int i = 0; i < 3; ++i) pc[i] = (h.R[i] * diff[0] + h.R[3 + i] * diff[1]) + h.R[6 + i] * diff[2];
    dyno::project_local(p.cam, pc, uv, &z);
    const float e = norm2(uv[0] - d[0], uv[1] - d[1]);
    return z > 0.05f ? e : CUDART_INF_F;
  }
  float m[3];
  dyno::mv3(h.R, s, m);
  const float e0 = (m[0] + h.t[0]) - d[0], e1 = (m[1] + h.t[1]) - d[1], e2 = (m[2] + h.t[2]) - d[2];
  return sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
}

// the final error of row n under the polished pose T (3d2d: through
// `se3_inverse(T)` applied, as the plain version's last pass)
template <bool REPROJ>
__device__ __forceinline__ float final_error(const Problem& p, const SE3& Tinv, const SE3& T, const float* s,
                                             const float* d) {
  float q[3];
  if (REPROJ) {
    float uv[2], z;
    dyno::se3_apply(Tinv, s, q);
    dyno::project_local(p.cam, q, uv, &z);
    const float e = norm2(uv[0] - d[0], uv[1] - d[1]);
    return z > 0.05f ? e : CUDART_INF_F;
  }
  dyno::se3_apply(T, s, q);
  const float e0 = q[0] - d[0], e1 = q[1] - d[1], e2 = q[2] - d[2];
  return sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
}

template <bool REPROJ>
__global__ void __launch_bounds__(SCORE_T)
    ransac_score_kernel(const __grid_constant__ Problem p, int G, int* __restrict__ counts) {
  constexpr int ND = REPROJ ? 2 : 3;
  // a tile of the problem's rows as they lie in memory: lane j's rows at
  // stride 3 (src) and ND floats are conflict-free or 2-way
  __shared__ __align__(16) float ts[3 * TILE], td[3 * TILE];
  __shared__ uint16_t list[TILE];   // the tile's valid rows, in order
  __shared__ int part[SCORE_T / 32], n_valid;
  // G warps score a hypothesis, each a G-th of the tile's valid rows
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * (SCORE_T / 32 / G) + warp / G, share = warp % G;
  const bool live = k < p.K;
  const long long base = (long long)b * p.N;
  int c = 0;
  bool proper = false;
  SE3 hyp;
  for (int t0 = 0; t0 < p.N; t0 += TILE) {
    const int nt = min(TILE, p.N - t0);
    __syncthreads();  // every warp is done with the previous tile
    dyno::copy_to_shared(ts, p.src + (base + t0) * 3, nt * 3);
    dyno::copy_to_shared(td, REPROJ ? p.uv + (base + t0) * 2 : p.dst + (base + t0) * 3, nt * ND);
    // thread t's PER rows j0 .. j0 + PER - 1: their valid flags, and their
    // place in the list from a block scan of the counts
    constexpr int PER = (TILE + SCORE_T - 1) / SCORE_T;
    const int j0 = threadIdx.x * PER;
    bool f[PER];
    int mine = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      f[i] = j0 + i < nt && p.valid[base + t0 + j0 + i] != 0;
      mine += f[i] ? 1 : 0;
    }
    if (t0 == 0 && live) hyp = hypothesis<REPROJ>(p, b, k, &proper);   // while the tile's loads are in flight
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) part[warp] = incl;
    dyno::copy_wait();
    __syncthreads();
    int at = incl - mine;
    for (int w = 0; w < warp; ++w) at += part[w];
    if (threadIdx.x == SCORE_T - 1) n_valid = at + mine;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (f[i]) list[at++] = (uint16_t)(j0 + i);
    __syncthreads();
    const int nv = n_valid;
    if (live && proper)
#pragma unroll 2
      for (int q = share * 32 + lane; q < nv; q += 32 * G) {
        const int j = list[q];
        c += score_error<REPROJ>(p, hyp, ts + 3 * j, td + ND * j) < p.threshold ? 1 : 0;
      }
  }
  __syncthreads();  // part[] is reused for the counts
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) part[warp] = c;
  __syncthreads();
  if (live && share == 0 && lane == 0) {
    int total = part[warp];
    for (int w = 1; w < G; ++w) total += part[warp + w];
    counts[(long long)b * p.K + k] = total;
  }
}

// Gauss-Newton rows of one correspondence at T (the plain version's
// polish): residuals r (ND of them) and Jacobian rows J (ND x 6); w the
// row weight (0 or 1)
template <bool REPROJ>
__device__ __forceinline__ void polish_row(const Problem& p, const SE3& T, const SE3& Tinv, const float* s,
                                           const float* d, bool best_inl, float* r, float* J, float* w) {
  if (REPROJ) {
    float pc[3], uv[2], z;
    dyno::se3_apply(Tinv, s, pc);
    dyno::project_local(p.cam, pc, uv, &z);
    r[0] = uv[0] - d[0];
    r[1] = uv[1] - d[1];
    *w = (best_inl && z > 0.05f) ? 1.f : 0.f;
    const float ps[3] = {pc[0], pc[1], z > 0.05f ? z : 1.f};
    dyno::project_jacobian_pose(p.cam, ps, J);
  } else {
    float q[3], H[9], RH[9];
    dyno::se3_apply(T, s, q);
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
__global__ void __launch_bounds__(POLISH_T)
    ransac_polish_kernel(const __grid_constant__ Problem p, const int* __restrict__ counts, int refine_steps,
                         int min_inliers, int S, float* __restrict__ R_out, float* __restrict__ t_out,
                         uint8_t* __restrict__ inliers, int* __restrict__ n_out, int* __restrict__ status_out) {
  namespace cg = cooperative_groups;
  constexpr int ND = REPROJ ? 2 : 3, NW = POLISH_T / 32;
  __shared__ dyno::SumSpace<NW, 27> sums;
  __shared__ int arg_c[NW], arg_k[NW];
  // this CTA's rows: src (3 a row) and uv or dst (ND a row) as they lie in
  // memory, valid, and the best hypothesis's inliers, then the final ones
  extern __shared__ __align__(16) float rows_sm[];
  // phase: begin
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C, tid = threadIdx.x, lane = tid & 31;
  const int nr = max(0, min(S, p.N - rank * S));
  const long long base = (long long)b * p.N + (long long)rank * S;
  float* rs = rows_sm;
  float* rd = rows_sm + 3 * S;
  uint8_t* valid = reinterpret_cast<uint8_t*>(rows_sm + (3 + ND) * S);
  uint8_t* inl = valid + S;
  dyno::Exchange ex;
  dyno::copy_to_shared(rs, p.src + base * 3, nr * 3);
  dyno::copy_to_shared(rd, REPROJ ? p.uv + base * 2 : p.dst + base * 3, nr * ND);
#pragma unroll 4
  for (int j = tid; j < nr; j += POLISH_T) valid[j] = p.valid[base + j];

  // phase: argmax
  // the first hypothesis of the most inliers, in every CTA
  int bc = -1, bk = 0;
#pragma unroll 4
  for (int k = tid; k < p.K; k += POLISH_T) {
    const int c = counts[(long long)b * p.K + k];
    if (c > bc) {
      bc = c;
      bk = k;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, bc, o), ok = __shfl_xor_sync(0xffffffffu, bk, o);
    if (oc > bc || (oc == bc && ok < bk)) {
      bc = oc;
      bk = ok;
    }
  }
  if (lane == 0) {
    arg_c[tid >> 5] = bc;
    arg_k[tid >> 5] = bk;
  }
  __syncthreads();
  bc = arg_c[0];
  int k_best = arg_k[0];
  for (int w = 1; w < NW; ++w)
    if (arg_c[w] > bc || (arg_c[w] == bc && arg_k[w] < k_best)) {
      bc = arg_c[w];
      k_best = arg_k[w];
    }
  // phase: best inliers
  bool proper;
  SE3 T = hypothesis<REPROJ>(p, b, k_best, &proper);
  dyno::copy_wait();
  dyno::cluster_sum_init(sums);   // also the barrier after the rows' loads
  for (int j = tid; j < nr; j += POLISH_T)
    inl[j] = (proper && valid[j] && score_error<REPROJ>(p, T, rs + 3 * j, rd + ND * j) < p.threshold) ? 1 : 0;

  for (int step = 0; step < refine_steps; ++step) {
    // phase: GN rows
    const SE3 Tinv = dyno::se3_inverse(T);
    float acc[27];  // A's upper triangle (21, row-major), then g (6)
#pragma unroll
    for (int i = 0; i < 27; ++i) acc[i] = 0.f;
    for (int j = tid; j < nr; j += POLISH_T) {
      if (!inl[j]) continue;   // weight 0: its terms are +0, so leaving them out keeps every bit
      float r[ND], J[ND * 6], w;
      polish_row<REPROJ>(p, T, Tinv, rs + 3 * j, rd + ND * j, true, r, J, &w);
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        float Jw[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) Jw[i] = J[6 * dd + i] * w;
        int o = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int jj = i; jj < 6; ++jj) acc[o++] += Jw[i] * J[6 * dd + jj];
#pragma unroll
        for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r[dd];
      }
    }
    // phase: GN sum
    dyno::cluster_sum<27>(acc, sums, ex);
    // phase: GN solve
    // every thread, from the same sums
    float A[36], Ai[36], xi[6];
    int o = 0;
    for (int i = 0; i < 6; ++i)
      for (int jj = i; jj < 6; ++jj) {
        A[6 * i + jj] = acc[o];
        A[6 * jj + i] = acc[o];
        ++o;
      }
    for (int i = 0; i < 6; ++i) A[7 * i] = A[7 * i] + 1e-6f;
    dyno::inv_spd6(A, Ai);
    for (int i = 0; i < 6; ++i) {
      float s = Ai[6 * i] * acc[21];
      for (int jj = 1; jj < 6; ++jj) s += Ai[6 * i + jj] * acc[21 + jj];
      xi[i] = -s;
    }
    T = dyno::se3_retract(T, xi);
  }

  // phase: final
  // final inliers, counts, status and pose
  const SE3 Tinv = dyno::se3_inverse(T);
  float cnt[2] = {0.f, 0.f};   // final inliers, valid rows (exact integers in float32)
  for (int j = tid; j < nr; j += POLISH_T) {
    const bool v = valid[j] != 0;
    const bool in = v && final_error<REPROJ>(p, Tinv, T, rs + 3 * j, rd + ND * j) < p.threshold;
    inl[j] = in ? 1 : 0;
    cnt[0] += in ? 1.f : 0.f;
    cnt[1] += v ? 1.f : 0.f;
  }
  dyno::cluster_sum<2>(cnt, sums, ex);
  const int tot_fin = (int)cnt[0], tot_val = (int)cnt[1];
  const int status = tot_val < 5 ? 1 : (tot_fin >= min_inliers ? 0 : 2);
  const bool ok = status == 0;
  for (int j = tid; j < nr; j += POLISH_T) inliers[base + j] = ok ? inl[j] : 0;
  if (rank == 0 && tid == 0) {
    const SE3 out = ok ? T : dyno::se3_identity();
    for (int i = 0; i < 9; ++i) R_out[b * 9 + i] = out.R[i];
    for (int i = 0; i < 3; ++i) t_out[b * 3 + i] = out.t[i];
    n_out[b] = tot_fin;
    status_out[b] = status;
  }
  // phase: end
  cluster.sync();   // no CTA leaves while another may still write into it
}

// the launch shape for B problems of N rows and K hypotheses: scoring
// blocks, threads a block and warps a hypothesis; polish cluster size,
// CTAs, threads a CTA and dynamic shared memory (bytes)
cudaError_t launch_shape(int B, int N, int K, bool reproj, int* out) {
  static int limit_cache[2][16] = {{-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},
                                   {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1}};
  int limit = 0;
  cudaError_t e = reproj ? dyno::dynamic_smem_limit((const void*)ransac_polish_kernel<true>, limit_cache[1], &limit)
                         : dyno::dynamic_smem_limit((const void*)ransac_polish_kernel<false>, limit_cache[0], &limit);
  if (e != cudaSuccess) return e;
  // G: the power of two <= 8 that leaves a lane about SCORE_ROWS rows of a tile
  const int tile_rows = std::min(N, TILE);
  int G = 1;
  while (G < SCORE_T / 32 && 32 * SCORE_ROWS * G < tile_rows) G *= 2;
  const int per_block = SCORE_T / 32 / G;
  const int C = N <= 0 ? 1 : std::min(dyno::MAX_CLUSTER_SIZE, (N + POLISH_T - 1) / POLISH_T);
  const int S = N <= 0 ? 0 : (N + C - 1) / C;
  out[0] = B * ((K + per_block - 1) / per_block);
  out[1] = SCORE_T;
  out[2] = G;
  out[3] = C;
  out[4] = B * C;
  out[5] = POLISH_T;
  out[6] = S * polish_row_bytes(reproj);
  return out[6] > limit ? cudaErrorInvalidValue : cudaSuccess;
}

}  // namespace

// out: scoring blocks, threads a scoring block, warps a hypothesis; polish
// cluster size, CTAs, threads a CTA, dynamic shared memory a CTA (bytes).
extern "C" int dyno_ransac_launch_shape(int B, int N, int K, int reproj, int* out) {
  return (int)launch_shape(B, N, K, reproj != 0, out);
}

// uv == 0 selects 3d3d.  counts: (B, K) int32 scratch.
extern "C" int dyno_ransac(const float* src, const float* dst, const float* uv, const uint8_t* valid,
                           const long long* idx, int B, int N, int K, float fx, float fy, float cx, float cy,
                           float threshold, int refine_steps, int min_inliers, int* counts, float* R_out,
                           float* t_out, uint8_t* inliers, int* n_out, int* status_out, void* stream) {
  Problem p{src, dst, uv, valid, idx, B, N, K, Cam{fx, fy, cx, cy}, threshold};
  if (B <= 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool reproj = uv != nullptr;
  int shape[7];
  cudaError_t e = launch_shape(B, N, K, reproj, shape);
  if (e != cudaSuccess) return (int)e;
  const dim3 score_grid(shape[0] / B, B);
  const int S = shape[6] / polish_row_bytes(reproj);
  if (reproj) {
    ransac_score_kernel<true><<<score_grid, shape[1], 0, s>>>(p, shape[2], counts);
    e = dyno::launch_clusters(ransac_polish_kernel<true>, shape[4], shape[3], shape[5], (size_t)shape[6], s, p,
                              (const int*)counts, refine_steps, min_inliers, S, R_out, t_out, inliers, n_out,
                              status_out);
  } else {
    ransac_score_kernel<false><<<score_grid, shape[1], 0, s>>>(p, shape[2], counts);
    e = dyno::launch_clusters(ransac_polish_kernel<false>, shape[4], shape[3], shape[5], (size_t)shape[6], s, p,
                              (const int*)counts, refine_steps, min_inliers, S, R_out, t_out, inliers, n_out,
                              status_out);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
