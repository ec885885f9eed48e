// Small fixed-size float32 algebra for the port's solver kernels (K5
// `refine.cu`, K6 `ransac.cu`): SE(3) on 3x3 row-major rotations, the
// pinhole projection and its Jacobians, the closed-form small inverses and
// the robust kernels; the fixed-order sums over a thread block cluster
// and the cluster launch that K5 and K6 share.
//
// Each function repeats the operation order of its PyTorch counterpart
// (`core/lie.py`, `core/camera.py`, `ops/linalg.py`, `ops/robust.py`,
// `backend/solver.py:robust_loss`) as it runs on the card: a 3-term sum is
// ((a + b) + c), a product of a Python constant and two tensors is
// ((k * x) * y), a division stays a division but for a tensor divided by
// a Python number, which PyTorch on the card multiplies by the number's
// reciprocal, and the small `torch.sum`s that K5's per-row elimination
// feeds to an inverse add their terms in PyTorch's order (`sum_outer`,
// `sum_inner`), since the inverse of a nearly singular block magnifies a
// last-bit difference.  The sources that include this header are compiled
// with `-fmad=false`, so no multiply-add is contracted and every product
// and sum rounds as the separate PyTorch operations do.  Sums over rows
// and the transcendental functions still differ from PyTorch's in the last
// bits; the kernels' tolerances say by how much.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

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
  // `sq / 6.0` on the card: sq times the reciprocal (taken in double)
  const float a = small ? 1.f - sq * (float)(1.0 / 6.0) : s / th;
  const float b = small ? 0.5f - sq * (float)(1.0 / 24.0) : (1.f - c) / sq_safe;
  const float cc = small ? (1.f / 6.f) - sq * (float)(1.0 / 120.0) : (th - s) / (sq_safe * th);
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

// `torch.sum` over a few terms, in the order PyTorch's reduction takes on
// the card, so a sum that an ill-conditioned inverse follows rounds as the
// plain version's does.  Over an axis that is not the innermost: four
// accumulators, term i into accumulator i % 4, then ((a0 + a1) + a2) + a3.
template <int N, class F>
__device__ __forceinline__ float sum_outer(F term) {
  float a[4];
#pragma unroll
  for (int i = 0; i < 4 && i < N; ++i) a[i] = term(i);
#pragma unroll
  for (int i = 4; i < N; ++i) a[i - 4] = a[i - 4] + term(i);
  float s = a[0];
#pragma unroll
  for (int i = 1; i < 4 && i < N; ++i) s = s + a[i];
  return s;
}

// ... over the innermost axis (and `vector_norm`'s squares): a pairwise
// tree over the terms padded with zeros to a power of two, halves first:
// three terms are (t0 + t2) + t1
template <int N, class F>
__device__ __forceinline__ float sum_inner(F term) {
  constexpr int P = N <= 1 ? 1 : N <= 2 ? 2 : N <= 4 ? 4 : 8;
  float v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) v[i] = i < N ? term(i) : 0.f;
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < off; ++i) v[i] = v[i] + v[i + off];
  return v[0];
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
  float Ai[9], AiB[9], BtAiB[9], S[9], Si[9], P[9], Q[9];
  inv3(A, Ai);
  mm3(Ai, B, AiB);
  mm3(Bt, AiB, BtAiB);
#pragma unroll
  for (int i = 0; i < 9; ++i) S[i] = C[i] - BtAiB[i];
  inv3(S, Si);
  mm3(AiB, Si, P);
  // `_mm(P, AiB^T)`: the transposed view puts the reduced axis innermost,
  // so PyTorch adds its three terms as (t0 + t2) + t1
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Q[3 * i + j] = (P[3 * i] * AiB[3 * j] + P[3 * i + 2] * AiB[3 * j + 2]) + P[3 * i + 1] * AiB[3 * j + 1];
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
// norm `norm` (`k / safe` is `safe.reciprocal() * k` in PyTorch)
__device__ __forceinline__ float huber_sqrt_weight(float norm, float k) {
  const float safe = clamp_min(norm, 1e-30f);
  return sqrtf(norm <= k ? 1.f : (1.f / safe) * k);
}

// `backend/solver.py:robust_loss` from the squared norm; `half_k2` is
// 0.5 k^2 rounded from double, as PyTorch passes the Python constant
__device__ __forceinline__ float huber_loss(float sq, float k, float half_k2) {
  const float norm = sqrtf(clamp_min(sq, 1e-30f));
  return norm <= k ? 0.5f * sq : k * norm - half_k2;
}

// ---- sums over the rows of a problem spread over a thread block cluster
//
// `cluster_sum<NV>` adds NV per-thread values over every thread of every
// CTA of the cluster in a fixed order, so every thread of every CTA
// receives the same bits on every run (fault F4 came from atomics):
//   1. within each warp, a reduce-scatter butterfly (NV > 8: five halving
//      exchanges leave lane l the warp's sums of entries Q l .. Q l + Q - 1,
//      Q = ceil(NV / 32), about NV shuffles a warp; NV <= 8: a butterfly
//      per entry), stored to `warp`; one barrier;
//   2. threads 0..NV-1 add the warps' partials in warp order and store the
//      CTA's partial into slot `recv[parity][rank]` of every CTA of the
//      cluster (`st.async` over distributed shared memory, which counts the
//      bytes on that CTA's mbarrier `bar[parity]`);
//   3. every thread waits on its CTA's `bar[parity]` until all C partials
//      have arrived, then threads 0..NV-1 add them in rank order 0..C-1
//      into `tot`; one barrier; every thread reads the totals.
// Every CTA forms the same totals in the same order, so the decisions
// taken from them agree across the cluster with no broadcast.  No cluster
// barrier is needed, which on the card cost more than the rest of an
// exchange (`testing/kernel_phases.py`: K5 FlowPose's five three-value
// exchanges took 4.9 us with one, 3.4 us this way).  The slots and
// barriers are double-buffered by the parity of the exchange: a CTA sends
// into parity p again two exchanges later, only after it has received
// every CTA's partial of the exchange between, which each CTA sends after
// it has read its slots of parity p.  `Exchange` carries the parity and
// the barriers' phases; `cluster_sum_init` sets the barriers up before the
// first exchange, and a kernel ends with `cluster.sync()`, so that no CTA
// leaves while another may still write into it.
constexpr int MAX_CLUSTER_SIZE = 8;   // the portable cluster size, which K5 and K6 keep to

template <int NW, int CAP>
struct SumSpace {
  float warp[NW][CAP];
  float recv[2][MAX_CLUSTER_SIZE][CAP];
  float tot[CAP];
  unsigned long long bar[2];
};

struct Exchange {
  int parity = 0;
  unsigned phases = 0;   // bit p: the phase bar[p] completes next
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of a shared variable of this CTA in CTA `rank` of the cluster
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

template <int NW, int CAP>
__device__ __forceinline__ void cluster_sum_init(SumSpace<NW, CAP>& s) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(&s.bar[0])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_addr(&s.bar[1])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cooperative_groups::this_cluster().sync();
}

// one halving exchange of the reduce-scatter (lanes `off` apart), then
// the next: lane bit `off` set keeps the upper half of its entries
template <int P, int LEV>
__device__ __forceinline__ void scatter_level(float* w, int lane) {
  if constexpr (LEV < 5) {
    constexpr int off = 16 >> LEV, h = P >> (LEV + 1);
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? w[i] : w[i + h];
      const float keep = up ? w[i + h] : w[i];
      w[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    scatter_level<P, LEV + 1>(w, lane);
  }
}

// the warp's sums of NV per-lane values into out[0..NV-1]
template <int NV>
__device__ __forceinline__ void warp_partial(const float* v, float* out) {
  const int lane = threadIdx.x & 31;
  if constexpr (NV <= 8) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float x = v[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) out[i] = x;
    }
  } else {
    constexpr int Q = (NV + 31) / 32, P = 32 * Q;
    float w[P];
#pragma unroll
    for (int i = 0; i < P; ++i) w[i] = i < NV ? v[i] : 0.f;
    scatter_level<P, 0>(w, lane);   // lane l now holds entries Q l .. Q l + Q - 1
#pragma unroll
    for (int i = 0; i < Q; ++i)
      if (Q * lane + i < NV) out[Q * lane + i] = w[i];
  }
}

template <int NV, int NW, int CAP>
__device__ __forceinline__ void cluster_sum(float* v, SumSpace<NW, CAP>& s, Exchange& x) {
  static_assert(NV <= CAP, "SumSpace too small");
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank(), p = x.parity;
  warp_partial<NV>(v, s.warp[threadIdx.x >> 5]);
  __syncthreads();
  const unsigned bar = shared_addr(&s.bar[p]);
  if (threadIdx.x == 0)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(C * NV * 4) : "memory");
  if (threadIdx.x < NV) {
    float a = s.warp[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NW; ++w) a = a + s.warp[w][threadIdx.x];
    const unsigned slot = shared_addr(&s.recv[p][rank][threadIdx.x]);
    for (int r = 0; r < C; ++r)
      asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
                   ::"r"(cluster_addr(slot, r)), "r"(__float_as_uint(a)), "r"(cluster_addr(bar, r)) : "memory");
  }
  asm volatile("{\n .reg .pred done;\n WAIT%=:\n"
               " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
               " @!done bra WAIT%=;\n}" ::"r"(bar), "r"((x.phases >> p) & 1u) : "memory");
  x.phases ^= 1u << p;
  if (threadIdx.x < NV) {
    float a = s.recv[p][0][threadIdx.x];
    for (int r = 1; r < C; ++r) a = a + s.recv[p][r][threadIdx.x];
    s.tot[threadIdx.x] = a;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = s.tot[i];
  x.parity ^= 1;
}

// The most dynamic shared memory `kernel` may take on the current device;
// the first call for a kernel and device raises the kernel's limit to it
// (above 48 KB a kernel must ask).  `cache` holds one entry per device,
// -1 until set.
inline cudaError_t dynamic_smem_limit(const void* kernel, int* cache, int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 16) return cudaErrorInvalidDevice;
  if (cache[dev] < 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != cudaSuccess) return e;
    if ((e = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess) return e;
    const int lim = optin - (int)fa.sharedSizeBytes;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lim)) != cudaSuccess)
      return e;
    cache[dev] = lim;
  }
  *limit = cache[dev];
  return cudaSuccess;
}

// Asynchronous copies from global to shared memory (`cp.async`): the
// issuing thread goes on without waiting for the data, so a block's
// staging overlaps the loads and arithmetic that follow; `copy_wait` and a
// barrier end them.
__device__ __forceinline__ void copy4_async(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(shared_addr(smem)),
               "l"(__cvta_generic_to_global(gmem)) : "memory");
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(shared_addr(smem)),
               "l"(__cvta_generic_to_global(gmem)) : "memory");
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// n floats from global to shared memory by the block's threads (16-byte
// copies where both ends are aligned)
__device__ __forceinline__ void copy_to_shared(float* dst, const float* __restrict__ src, int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    done = 4 * (n / 4);
    for (int i = 4 * threadIdx.x; i < done; i += 4 * blockDim.x) copy16_async(dst + i, src + i);
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) copy4_async(dst + i, src + i);
}

// Launch `kernel` on a grid of `ctas` blocks of `threads` in clusters of
// `cluster` blocks with `smem` bytes of dynamic shared memory.
template <class... Args>
inline cudaError_t launch_clusters(void (*kernel)(Args...), int ctas, int cluster, int threads, size_t smem,
                                   cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace dyno
