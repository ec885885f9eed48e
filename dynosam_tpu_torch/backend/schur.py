"""Direct reduced (Schur-complement) LM for backend windows, both
formulations, with the stable (Woodbury) dynamic elimination (port of the
production path of `dynosam_tpu/backend/schur.py`).

Each LM iteration solves the damped normal equations exactly:

  * every Jacobian block is a closed form: pose-to-point wrt the pose
    tangent is ``[hat(y) | -I]`` (y the point in the camera frame), the
    motion factors' are rotations and ``[hat | I]`` blocks, and the
    pose-pose families (anchor, odometry, smoothing, pose triplets,
    kinematic) use the SE(3) right Jacobian inverse of their residual
    (the JAX package differentiates those with `jacfwd`);
  * static points have independent 3x3 blocks, eliminated at once;
  * dynamic tracklets are chains along frames coupled by the ternary
    (WorldMotion) or motion-pose (WorldPose) factor.  The ~1e10-scale
    normal blocks of that factor are never formed: it stays in
    square-root form (``st_*`` fields) and every reduced term is a product
    through the capacitance chain ``M = I + A~ Klam^-1 A~^T`` (scalar
    diagonal, scaled rotations off it), solved by a scalar block-Thomas
    recursion;
  * the reduced system over {X (W, 6), P (W, O, 6)} (P the object motions
    H or poses L) is assembled densely and solved by one Cholesky;
    landmarks follow by back-substitution.

Damping is applied to the full-system diagonal before the reduction, and
the normal system is rebuilt only after an accepted step.  A failed
Cholesky gives a NaN step, which the LM rejects and which raises the
lowest lambda it returns to (the NaN ratchet), as in the JAX package.
The anchor is isotropic or, with `anchor_prior_L`, the fixed-lag boundary
marginal (`backend/fixed_lag.py`).

The build and the step are written without in-place writes into fresh
tensors, so `lm_optimize_schur_batched` maps them over a leading window
axis with `torch.func.vmap`: batched Cholesky and contractions solve every
window at once, and the host reads all windows' flags once per iteration.

`world_motion_normal_product` and `world_pose_normal_product` apply the
same closed-form blocks as the matrix-free J^T W J product of the LM-PCG
(`solver.lm_optimize`).

On the card `lm_optimize_schur` replays each LM iteration as a CUDA
graph: `_WindowLM` keeps one window shape's LM state in fixed tensors, so
its head and both iteration variants (with and without the normal-system
rebuild) are captured once per process and shape and replayed from the
same host loop, one host read per iteration.  A WorldMotion iteration
there is three hand-written kernels around cuSOLVER's factorisation
(`window_iteration`): K7 builds the normal system (`window_build`), K8
reduces it (`window_step`, the plain version `schur_reduce`), K9 takes the
back-substitution, the trial and the LM decisions (`window_update`:
`schur_back` and `_lm_tail`); `csrc/window.cu` states their contract.

`lm_optimize_schur(overrides=...)` runs the same LM schedule over the
per-rank residual, error, build and step of the distributed solve
(`parallel/schur_dist.py`); `chain_solve` is the generic block-Thomas
that solve's SPIKE elimination holds itself against.

Not ported (ROADMAP.md, "not ported, by the port rules"): the subtractive
elimination and the chain-solver overrides behind the JAX package's
environment switches.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..core.lie import SE3, se3_adjoint, se3_between, se3_compose, se3_identity, se3_inverse, so3_hat
from ..ops import factors
from ..utils.config import BackendConfig
from .formulation import (
    WindowMasks,
    kinematic_mask,
    object_onehot,
    odometry_measurements,
    pose_key,
    pose_sigmas,
    pose_triple,
    select_motions,
    shift_prev,
    world_motion_families,
    world_motion_residuals,
    world_pose_families,
    world_pose_residuals,
)
from ..kernels import window as window_kernels
from ..utils import graphs
from ..utils.graphs import signature, tree_clone, tree_copy_
from .map import WindowData
from .solver import LMConfig, LMResult, retract_tree, sqrt_weights, total_error


def _floor_consts(dtype):
    """(relative, absolute) diagonal floors keeping structurally empty rows
    positive definite; the float64 values are small enough that a float64
    check pins the elimination algebra against a dense solve."""
    if torch.finfo(dtype).eps > 1e-10:
        return 1e-7, 1e-8
    return 1e-15, 1e-16


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3x3 blocks."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = 1.0 / (a * A + b * B + c * C)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _next(x: torch.Tensor) -> torch.Tensor:
    """Row k of the result is row k+1 of x; the last row is zero."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)


def _place(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """x with `before` zero rows above and `after` below (rows of x land at
    [before, before + len(x)) of the result)."""
    return torch.cat([x.new_zeros((before, *x.shape[1:])), x, x.new_zeros((after, *x.shape[1:]))], dim=0)


def _band(W: int, k: int, like: torch.Tensor) -> torch.Tensor:
    """(W, W) matrix with ones on diagonal k (k > 0 above the diagonal)."""
    return torch.diag(torch.ones(W - abs(k), dtype=like.dtype, device=like.device), k)


# --------------------------------------------------------------------------
# Chain solves: generic block-Thomas and the scalar-diagonal capacitance chain M
# --------------------------------------------------------------------------


def chain_solve(A: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve every symmetric block-tridiagonal chain with diagonal blocks
    A (W, N, 3, 3), (k-1, k) couplings B (W, N, 3, 3) (B[0] zero) and a
    matrix RHS (W, N, 3, M): block-Thomas forward elimination with
    adjugate 3x3 inverses, then back substitution."""
    W = A.shape[0]
    Dinv = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape[1], 3, 3)
    y = torch.zeros_like(rhs[0])
    Dinvs, ys = [], []
    for k in range(W):
        Bt = B[k].transpose(-1, -2)
        Dinv_new = _inv3(A[k] - Bt @ (Dinv @ B[k]))
        y = rhs[k] - Bt @ (Dinv @ y)
        Dinv = Dinv_new
        Dinvs.append(Dinv)
        ys.append(y)
    x = [None] * W
    x_next = torch.zeros_like(rhs[0])
    for k in reversed(range(W)):
        r = ys[k] - B[k + 1] @ x_next if k + 1 < W else ys[k]
        x_next = Dinvs[k] @ r
        x[k] = x_next
    return torch.stack(x)


def chain_solve_scalar(alpha: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve every chain with diagonal blocks alpha_k I and (k-1, k)
    coupling B_k = b_k Q_k (Q orthogonal, B[0] zero), symmetric, for a
    matrix RHS: alpha (W, N), B (W, N, 3, 3), rhs (W, N, 3, M).  The pivots
    follow delta_k = alpha_k - |b_k|^2 / delta_{k-1}."""
    b2 = torch.sum(B[:, :, 0, :] ** 2, dim=-1)                 # (W, N)
    d_prev = torch.ones_like(alpha[0])
    deltas = []
    for k in range(alpha.shape[0]):
        d_prev = alpha[k] - b2[k] / d_prev
        deltas.append(d_prev)
    return _chain_scalar_core(torch.stack(deltas), B, rhs)


def _chain_scalar_core(delta: torch.Tensor, B: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Forward and backward substitution of the scalar-diagonal block-Thomas
    with pivots `delta` (W, N): one (3, 3) @ (3, M) product per frame."""
    W = delta.shape[0]
    Bt = B.transpose(-1, -2)
    ys = []
    y_prev = torch.zeros_like(rhs[0])
    d_prev = torch.ones_like(delta[0])
    for k in range(W):
        y_prev = rhs[k] - Bt[k] @ (y_prev / d_prev[:, None, None])
        d_prev = delta[k]
        ys.append(y_prev)
    x = [None] * W
    x_next = torch.zeros_like(rhs[0])
    for k in reversed(range(W)):
        if k + 1 < W:
            x_next = (ys[k] - B[k + 1] @ x_next) / delta[k][:, None, None]
        else:
            x_next = ys[k] / delta[k][:, None, None]
        x[k] = x_next
    return torch.stack(x)


# --------------------------------------------------------------------------
# Normal system
# --------------------------------------------------------------------------


class NormalSystem(NamedTuple):
    """The blocks of J^T W J and -J^T W r of one window that the stable
    step reads; "pose" is the per-object variable (H for WorldMotion, L
    for WorldPose).  Dmm/Omm1/Omm2/b_mot/b_dp hold the smoothing and
    observation parts only; the ternary or motion-pose information lives
    in the square-root st_* fields.  (The JAX package's Ad, Bd, Rpp, Rpc,
    Rcp and Rcc serve the subtractive elimination and are zero on this
    path.)"""

    Hcc: torch.Tensor      # (W, 6, W, 6) direct camera-camera
    Dmm: torch.Tensor      # (W, O, 6, 6) direct pose diagonal blocks
    Omm1: torch.Tensor     # (W-1, O, 6, 6) pose (k, k+1) coupling
    Omm2: torch.Tensor     # (W-2, O, 6, 6) pose (k, k+2) coupling (WorldPose triplets)
    b_cam: torch.Tensor    # (W, 6)
    b_mot: torch.Tensor    # (W, O, 6)
    Hll_s: torch.Tensor    # (NS, 3, 3) static point blocks (undamped)
    Us: torch.Tensor       # (W, NS, 6, 3) camera-static couplings
    b_sp: torch.Tensor     # (NS, 3)
    Rc: torch.Tensor       # (W, ND, 3, 6) chain row k -> camera k
    b_dp: torch.Tensor     # (W, ND, 3) observation part of the point gradient
    onehot: torch.Tensor   # (W, ND, O) object one-hot per (frame, track)
    chain_c: torch.Tensor  # (W, ND) observation diagonal scalar (+ tiny floor)
    chain_T: torch.Tensor  # (W, ND) motion-factor information scalar, row k = factor (k-1, k)
    st_s: torch.Tensor     # (W, ND) sqrt(w_k) / sigma_t
    st_R: torch.Tensor     # (W, ND, 3, 3) H_k rotation (WorldMotion) or L_k L_{k-1}^-1 rotation (WorldPose)
    st_G: torch.Tensor     # (W, ND, 3, 6) sigma_t x the pose Jacobian of the factor
    st_phi: torch.Tensor   # (W, ND, 3) whitened sqrt-weighted motion-factor residual


def _pose_point_jacobians(X: SE3, pts: torch.Tensor, sigma: float):
    """Whitened Jacobians of e = X^-1 p - z: J_xi = [hat(y) | -I] / sigma
    (W, N, 3, 6) with y = X^-1 p, and J_p = R^T / sigma (W, 3, 3)."""
    Rt = X.R.transpose(-1, -2)
    y = torch.einsum("wij,wnj->wni", Rt, pts - X.t[:, None, :])
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device).expand(*y.shape, 3)
    return torch.cat([so3_hat(y), -eye], dim=-1) / sigma, Rt / sigma


# Jr^-1(xi) = sum_k c_k ad_xi^k with c_k = (-1)^k B_k / k! (Bernoulli
# numbers): I + ad/2 + ad^2 (c_2 + c_4 ad^2 + ... + c_14 ad^12).  The first
# term left out, 3.4e-13 theta^16, is 2.2e-8 at 2 rad and 1.5e-5 at 3 rad;
# the pose families' residual angles are far smaller.
_JR_INV_EVEN = (1.0 / 12, -1.0 / 720, 1.0 / 30240, -1.0 / 1209600, 1.0 / 47900160,
                -691.0 / 1307674368000, 1.0 / 74724249600)


def _se3_ad(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [omega, v] -> (..., 6, 6) adjoint ad_xi = [[w^, 0], [v^, w^]]."""
    W, V = so3_hat(xi[..., :3]), so3_hat(xi[..., 3:])
    return torch.cat([torch.cat([W, torch.zeros_like(W)], -1), torch.cat([V, W], -1)], -2)


def _right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 6, 6): d Log(T Exp(d)) / dd at 0 for Log(T) = xi
    (Horner's scheme in ad^2 over `_JR_INV_EVEN`)."""
    ad = _se3_ad(xi)
    ad2 = ad @ ad
    eye = torch.eye(6, dtype=xi.dtype, device=xi.device)
    P = _JR_INV_EVEN[-1] * eye.expand(ad.shape)
    for c in reversed(_JR_INV_EVEN[:-1]):
        P = ad2 @ P + c * eye
    return eye + 0.5 * ad + ad2 @ P


def _between_jacobians(a: SE3, b: SE3, Z: SE3, sigma: torch.Tensor):
    """Whitened Jacobians of e = Log(Z^-1 a^-1 b) / sigma wrt the right
    tangents of a and b at 0 (the odometry and, with Z = I, the smoothing
    factor): J_b = Jr^-1(e), J_a = -Jr^-1(e) Ad((a^-1 b)^-1); two (..., 6, 6)."""
    M = se3_between(a, b)
    Jinv = _right_jacobian_inv(factors.between_residual(a, b, Z)) / sigma[:, None]
    return -Jinv @ se3_adjoint(se3_inverse(M)), Jinv


def _triplet_jacobians(La: SE3, Lb: SE3, Lc: SE3, sigma: torch.Tensor):
    """Whitened Jacobians of the pose-smoothing residual Log(E) / sigma,
    E = La Lb^-1 Lc Lb^-1, wrt the right tangents of (L_{k-2}, L_{k-1},
    L_k): J_a = Jr^-1 Ad(E^-1 La), J_c = Jr^-1 Ad(Lb), J_b = -(J_a + J_c)."""
    E = se3_compose(se3_compose(La, se3_inverse(Lb)), se3_compose(Lc, se3_inverse(Lb)))
    Jinv = _right_jacobian_inv(factors.landmark_pose_smoothing_residual(La, Lb, Lc)) / sigma[:, None]
    Ja = Jinv @ se3_adjoint(se3_compose(se3_inverse(E), La))
    Jc = Jinv @ se3_adjoint(Lb)
    return Ja, -(Ja + Jc), Jc


def _kinematic_jacobians(Hm: SE3, La: SE3, Lb: SE3, sigma: float):
    """Whitened Jacobians of e = Log(Lb^-1 Hm La) / sigma wrt the right
    tangents of (L_{k-1}, L_k): J_a = Jr^-1(e), J_b = -Jr^-1(e) Ad(E^-1)."""
    E = se3_compose(se3_inverse(Lb), se3_compose(Hm, La))
    Jinv = _right_jacobian_inv(factors.object_kinematic_residual(Hm, La, Lb)) / sigma
    return Jinv, -Jinv @ se3_adjoint(se3_inverse(E))


def _anchor_jacobian(X0: SE3, anchor: SE3, cfg: BackendConfig, anchor_prior_L=None) -> torch.Tensor:
    """(6, 6) whitened Jacobian of the anchor prior Log(anchor^-1 X_0)."""
    J = _right_jacobian_inv(factors.prior_residual(X0, anchor))
    return J / cfg.initial_pose_prior_sigma if anchor_prior_L is None else anchor_prior_L.T @ J


def _band_blocks(diag: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """(W, n, W, n) symmetric block-tridiagonal matrix from its diagonal
    (W, n, n) and (k, k+1) blocks (W-1, n, n)."""
    W = diag.shape[0]
    return (torch.einsum("kab,kl->kalb", diag, _band(W, 0, diag))
            + torch.einsum("kab,kl->kalb", _place(off, 0, 1), _band(W, 1, diag))
            + torch.einsum("kab,kl->kalb", _place(off.transpose(-1, -2), 1, 0), _band(W, -1, diag)))


def _camera_blocks(X: SE3, w: WindowData, masks: WindowMasks, cfg: BackendConfig, anchor: SE3, res0: list,
                   wgt_static, wgt_dyn, Jx_s, Jx_d, anchor_prior_L=None):
    """Hcc (W, 6, W, 6) and b_cam (W, 6) of the families both formulations
    share: anchor, odometry and the pose-to-point observations."""
    r_anchor, r_odo, r_static, r_dyn = res0[:4]
    dtype, dev = X.t.dtype, X.t.device
    pose_sigma, _ = pose_sigmas(cfg, dtype, dev)
    wgt_odo = masks.odometry[1:].to(dtype)
    Ja, Jb = _between_jacobians(X[:-1], X[1:], odometry_measurements(w), pose_sigma)  # (W-1, 6, 6)
    J_anchor = _anchor_jacobian(X[0], anchor, cfg, anchor_prior_L)

    diag = (_place(torch.einsum("k,kra,krb->kab", wgt_odo, Ja, Ja), 0, 1)
            + _place(torch.einsum("k,kra,krb->kab", wgt_odo, Jb, Jb), 1, 0)
            + _place((J_anchor.T @ J_anchor)[None], 0, X.t.shape[0] - 1)
            + torch.einsum("kn,knra,knrb->kab", wgt_static, Jx_s, Jx_s)
            + torch.einsum("kn,knra,knrb->kab", wgt_dyn, Jx_d, Jx_d))
    Hcc = _band_blocks(diag, torch.einsum("k,kra,krb->kab", wgt_odo, Ja, Jb))
    g_cam = (_place(torch.einsum("k,kra,kr->ka", wgt_odo, Ja, r_odo), 0, 1)
             + _place(torch.einsum("k,kra,kr->ka", wgt_odo, Jb, r_odo), 1, 0)
             + _place((J_anchor.T @ r_anchor[0])[None], 0, X.t.shape[0] - 1)
             + torch.einsum("kn,knra,knr->ka", wgt_static, Jx_s, r_static)
             + torch.einsum("kn,knra,knr->ka", wgt_dyn, Jx_d, r_dyn))
    return Hcc, -g_cam


def _pair_blocks(wgt, Ja, Jb, r):
    """Contributions of pose-pair factors (rows (k, k+1), weights (W-1, O)):
    diagonal (W, O, 6, 6), (k, k+1) coupling (W-1, O, 6, 6) and gradient
    (W, O, 6)."""
    D = (_place(torch.einsum("ko,kora,korb->koab", wgt, Ja, Ja), 0, 1)
         + _place(torch.einsum("ko,kora,korb->koab", wgt, Jb, Jb), 1, 0))
    g = (_place(torch.einsum("ko,kora,kor->koa", wgt, Ja, r), 0, 1)
         + _place(torch.einsum("ko,kora,kor->koa", wgt, Jb, r), 1, 0))
    return D, torch.einsum("ko,kora,korb->koab", wgt, Ja, Jb), g


def _static_blocks(wgt_static, Jx_s, Jp_s, r_static):
    """Static landmark blocks: Hll_s is a scalar multiple of I per landmark
    (J_p = R^T / sigma is orthogonal up to scale)."""
    _, tiny = _floor_consts(Jx_s.dtype)
    eye3 = torch.eye(3, dtype=Jx_s.dtype, device=Jx_s.device)
    scale = torch.einsum("kra,krb->kab", Jp_s, Jp_s)            # (W, 3, 3) = I / sigma^2
    Hll_s = torch.einsum("kn,kab->nab", wgt_static, scale) + tiny * eye3
    Us = torch.einsum("kn,knra,krb->knab", wgt_static, Jx_s, Jp_s)
    b_sp = -torch.einsum("kn,kra,knr->na", wgt_static, Jp_s, r_static)
    return Hll_s, Us, b_sp


def _point_blocks(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                  anchor: SE3, res0: list, anchor_prior_L):
    """The blocks of the shared families: Hcc, b_cam, the static
    elimination blocks, and the dynamic chains' observation part (Rc,
    b_dp, chain_c), with the motion factor's weight (W-1, ND) and sqrt
    weight (W-1, ND)."""
    X: SE3 = values["X"]
    sp, dp = values["sp"], values["dp"]
    dtype = sp.dtype
    W = masks.frame.shape[0]
    _, tiny = _floor_consts(dtype)
    wgt_static = sqrt_w[2] ** 2 * masks.static_obs.to(dtype)
    wgt_dyn = sqrt_w[3] ** 2 * masks.dyn_obs.to(dtype)
    Jx_s, Jp_s = _pose_point_jacobians(X, sp[None].expand(W, *sp.shape), cfg.static_point_noise_sigma)
    Jx_d, Jp_d = _pose_point_jacobians(X, dp, cfg.dynamic_point_noise_sigma)
    Hcc, b_cam = _camera_blocks(X, w, masks, cfg, anchor, res0, wgt_static, wgt_dyn, Jx_s, Jx_d, anchor_prior_L)
    Hll_s, Us, b_sp = _static_blocks(wgt_static, Jx_s, Jp_s, res0[2])
    Rc = torch.einsum("kd,kra,kdrb->kdab", wgt_dyn, Jp_d, Jx_d)
    b_dp = -torch.einsum("kd,kra,kdr->kda", wgt_dyn, Jp_d, res0[3])
    chain_c = wgt_dyn / cfg.dynamic_point_noise_sigma ** 2 + tiny
    return dict(Hcc=Hcc, b_cam=b_cam, Hll_s=Hll_s, Us=Us, b_sp=b_sp, Rc=Rc, b_dp=b_dp, chain_c=chain_c)


def _square_root_chain(sqrt_w_t, wgt_t, masks: WindowMasks, r_t, R, G, sig_t: float):
    """The motion factor in square-root form (~1e5 scale, exact in float32
    to relative 1e-7): chain_T, st_s, st_R, st_G and st_phi, row k =
    factor (k-1, k), row 0 empty."""
    zrow = torch.zeros_like(wgt_t[:1])
    sqw = sqrt_w_t * masks.ternary[1:].to(wgt_t.dtype)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    return dict(
        chain_T=torch.cat([zrow, wgt_t / sig_t ** 2], dim=0),
        st_s=torch.cat([zrow, sqw / sig_t], dim=0),
        st_R=torch.cat([eye3.expand(1, *R.shape[1:]), R], dim=0),
        st_G=torch.cat([torch.zeros_like(G[:1]), G], dim=0),
        st_phi=torch.cat([torch.zeros_like(r_t[:1]), sqw[..., None] * r_t], dim=0),
    )


def build_normal_system(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks,
                        cfg: BackendConfig, anchor: SE3, res0: list, anchor_prior_L=None) -> NormalSystem:
    """WorldMotion normal system at `values` {X, H, sp, dp}, with the IRLS
    square-root weights `sqrt_w` and the residuals `res0` of
    `world_motion_residuals` (same family order).  The ternary factor
    e = m_{k-1} - H^-1 m_k has J_H = [-hat(y) | I] / sigma_t (y = H^-1 m_k),
    J_{m_{k-1}} = I / sigma_t and J_{m_k} = -R_H^T / sigma_t."""
    H: SE3 = values["H"]
    dp = values["dp"]
    dtype, dev = dp.dtype, dp.device
    _, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    sig_t = cfg.motion_ternary_factor_noise_sigma
    blocks = _point_blocks(values, sqrt_w, w, masks, cfg, anchor, res0, anchor_prior_L)

    # selected motion per (frame, track): a frame takes part in factor f-1
    # (as current frame) or factor f (as previous frame)
    H_sel, onehot = select_motions(H, w.dyn_obj, masks.ternary | _next(masks.ternary))
    Hc = H_sel[1:]                                              # (W-1, ND)
    y_t = torch.einsum("...ba,...b->...a", Hc.R, dp[1:] - Hc.t)  # H^-1 m_cur
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    G = torch.cat([-so3_hat(y_t), eye3.expand(*y_t.shape, 3)], dim=-1)
    wgt_tern = sqrt_w[4] ** 2 * masks.ternary[1:].to(dtype)

    identity = se3_identity((), dtype, dev)
    Ja, Jb = _between_jacobians(H[:-1], H[1:], identity, smooth_sigma)   # (W-1, O, 6, 6)
    Dmm, Omm1, g_mot = _pair_blocks(masks.smoothing[1:].to(dtype), Ja, Jb, res0[5])
    W, O = H.batch_shape
    return NormalSystem(
        Dmm=Dmm, Omm1=Omm1, Omm2=Dmm.new_zeros((max(W - 2, 0), O, 6, 6)), b_mot=-g_mot, onehot=onehot,
        **blocks, **_square_root_chain(sqrt_w[4], wgt_tern, masks, res0[4], Hc.R, G, sig_t),
    )


def _pose_direct_blocks(L: SE3, w: WindowData, masks: WindowMasks, cfg: BackendConfig, r_ps, r_kin):
    """Direct pose blocks of the WorldPose formulation: the pose-smoothing
    triplets and the optional kinematic factor, closed form.  Returns Dmm
    (W, O, 6, 6), Omm1 (W-1, O, 6, 6), Omm2 (W-2, O, 6, 6) and the pose
    gradient (W, O, 6)."""
    dtype, dev = L.t.dtype, L.t.device
    _, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    triple = pose_triple(masks).to(dtype)                       # (W-2, O)
    Ja, Jb, Jc = _triplet_jacobians(L[:-2], L[1:-1], L[2:], smooth_sigma)
    blocks = {"a": Ja, "b": Jb, "c": Jc}
    offset = {"a": (0, 2), "b": (1, 1), "c": (2, 0)}

    def gram(x, y):
        return torch.einsum("to,tora,torb->toab", triple, blocks[x], blocks[y])

    Dmm = sum(_place(gram(x, x), *offset[x]) for x in "abc")
    Omm1 = _place(gram("a", "b"), 0, 1) + _place(gram("b", "c"), 1, 0)
    Omm2 = gram("a", "c")
    g_mot = sum(_place(torch.einsum("to,tora,tor->toa", triple, blocks[x], r_ps), *offset[x]) for x in "abc")
    if r_kin is not None:
        Ja_k, Jb_k = _kinematic_jacobians(w.motion_init[1:], L[:-1], L[1:], cfg.object_kinematic_sigma)
        D_k, O_k, g_k = _pair_blocks(kinematic_mask(w, masks).to(dtype), Ja_k, Jb_k, r_kin)
        Dmm, Omm1, g_mot = Dmm + D_k, Omm1 + O_k, g_mot + g_k
    return Dmm, Omm1, Omm2, g_mot


def _motion_pose_blocks(L: SE3, dp: torch.Tensor, w: WindowData, active: torch.Tensor):
    """The motion-pose factor e = m_k - L_k L_{k-1}^-1 m_{k-1} per row k
    (W-1, ND): with q = L_{k-1}^-1 m_{k-1} and rel = L_k L_{k-1}^-1,
    J_{m_{k-1}} = -R_rel, J_{m_k} = I, J_{L_{k-1}} = G = [-R_Lk hat(q) | R_Lk]
    and J_{L_k} = -G (all over sigma_t).  Returns (R_rel, G, one-hot)."""
    L_sel, onehot = select_motions(L, w.dyn_obj, active)
    Lp, Lc = L_sel[:-1], L_sel[1:]
    rel_R = Lc.R @ Lp.R.transpose(-1, -2)
    q = torch.einsum("...ba,...b->...a", Lp.R, dp[:-1] - Lp.t)
    return rel_R, torch.cat([-(Lc.R @ so3_hat(q)), Lc.R], dim=-1), onehot


def build_normal_system_pose(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks,
                             cfg: BackendConfig, anchor: SE3, res0: list, anchor_prior_L=None) -> NormalSystem:
    """WorldPose (LLWorld) normal system at `values` {X, L, sp, dp} with
    the residuals of `world_pose_residuals`.  The motion-pose factor is
    carried in square-root form: A~_k = s_k [-R_rel at m_{k-1}, +I at m_k]
    (st_R = R_rel) and B~_k = s_k [+G at L_{k-1}, -G at L_k] (st_G = G);
    the pose-smoothing triplets give bandwidth-2 direct pose blocks."""
    L: SE3 = values["L"]
    dp = values["dp"]
    dtype = dp.dtype
    sig_t = cfg.motion_ternary_factor_noise_sigma
    blocks = _point_blocks(values, sqrt_w, w, masks, cfg, anchor, res0, anchor_prior_L)
    rel_R, G, onehot = _motion_pose_blocks(L, dp, w, masks.ternary | _next(masks.ternary))
    wgt_mp = sqrt_w[4] ** 2 * masks.ternary[1:].to(dtype)
    r_kin = res0[6] if cfg.use_object_kinematic_factor and len(res0) > 6 else None
    Dmm, Omm1, Omm2, g_mot = _pose_direct_blocks(L, w, masks, cfg, res0[5], r_kin)
    return NormalSystem(
        Dmm=Dmm, Omm1=Omm1, Omm2=Omm2, b_mot=-g_mot, onehot=onehot,
        **blocks, **_square_root_chain(sqrt_w[4], wgt_mp, masks, res0[4], rel_R, G, sig_t),
    )


# --------------------------------------------------------------------------
# Matrix-free products of the LM-PCG solve
# --------------------------------------------------------------------------


def _shared_rows(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig, anchor: SE3):
    """(J, Jt) of the shared families [anchor, odometry, static, dynamic]:
    J(d) -> their rows, Jt(u) -> {X, sp, dp} gradient parts."""
    X: SE3 = values["X"]
    sp, dp = values["sp"], values["dp"]
    W = X.t.shape[0]
    pose_sigma, _ = pose_sigmas(cfg, sp.dtype, sp.device)
    J_anchor = _anchor_jacobian(X[0], anchor, cfg)
    Ja_o, Jb_o = _between_jacobians(X[:-1], X[1:], odometry_measurements(w), pose_sigma)
    Jx_s, Jp_s = _pose_point_jacobians(X, sp[None].expand(W, *sp.shape), cfg.static_point_noise_sigma)
    Jx_d, Jp_d = _pose_point_jacobians(X, dp, cfg.dynamic_point_noise_sigma)

    def J(d: dict) -> list:
        dX, dsp, ddp = d["X"], d["sp"], d["dp"]
        return [
            J_anchor @ dX[0],
            torch.einsum("kab,kb->ka", Ja_o, dX[:-1]) + torch.einsum("kab,kb->ka", Jb_o, dX[1:]),
            torch.einsum("knab,kb->kna", Jx_s, dX) + torch.einsum("kab,nb->kna", Jp_s, dsp),
            torch.einsum("knab,kb->kna", Jx_d, dX) + torch.einsum("kab,knb->kna", Jp_d, ddp),
        ]

    def Jt(u: list) -> dict:
        u_a, u_o, u_s, u_d = u
        gX = torch.einsum("knab,kna->kb", Jx_s, u_s) + torch.einsum("knab,kna->kb", Jx_d, u_d)
        gX[0] += J_anchor.T @ u_a
        gX[:-1] += torch.einsum("kab,ka->kb", Ja_o, u_o)
        gX[1:] += torch.einsum("kab,ka->kb", Jb_o, u_o)
        return {"X": gX, "sp": torch.einsum("kab,kna->nb", Jp_s, u_s),
                "dp": torch.einsum("kab,kna->knb", Jp_d, u_d)}

    return J, Jt


def _shared_weights(sqrt_w: list, masks: WindowMasks, dtype) -> list:
    """IRLS weight x activation mask of each shared factor row."""
    return [sqrt_w[0][0] ** 2, (sqrt_w[1] ** 2 * masks.odometry[1:].to(dtype))[:, None],
            (sqrt_w[2] ** 2 * masks.static_obs.to(dtype))[..., None],
            (sqrt_w[3] ** 2 * masks.dyn_obs.to(dtype))[..., None]]


def _normal_product(J: Callable, Jt: Callable, weights: list, res0: list):
    """(JtJ_mv, g) from the row map J, its transpose Jt and the per-row
    weights; g = J^T W r0 (the anchor's residual row is res0[0][0])."""
    def JtJ_mv(d: dict) -> dict:
        return Jt([wt * u for wt, u in zip(weights, J(d))])

    r_anchor, *rest = res0
    return JtJ_mv, Jt([wt * r for wt, r in zip(weights, [r_anchor[0], *rest])])


def world_motion_normal_product(values: dict, sqrt_w: list, res0: list, w: WindowData,
                                masks: WindowMasks, cfg: BackendConfig, anchor: SE3):
    """(JtJ_mv, g) of the WorldMotion families at `values` with the IRLS
    weights `sqrt_w` frozen: JtJ_mv(d) = J^T W J d on tangent dicts {X (W,
    6), H (W, O, 6), sp (NS, 3), dp (W, ND, 3)} and g = J^T W r0 for the
    residuals `res0` of `world_motion_residuals` (what the JAX LM-PCG gets
    from `jax.linearize` + `jax.linear_transpose`).  The whitened Jacobian
    blocks of every family are built here once; each product is then
    batched contractions and gathers, with no host read and no float
    atomic (a CUDA run repeats bit for bit)."""
    H: SE3 = values["H"]
    dp = values["dp"]
    dtype, dev = dp.dtype, dp.device
    W, O = H.batch_shape
    ND = dp.shape[1]
    _, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    sig_t = cfg.motion_ternary_factor_noise_sigma
    J_sh, Jt_sh = _shared_rows(values, w, masks, cfg, anchor)
    Ja_m, Jb_m = _between_jacobians(H[:-1], H[1:], se3_identity((), dtype, dev), smooth_sigma)
    # ternary row k (factor (k-1, k)): d/dm_{k-1} = I, d/dm_k = -R^T,
    # d/dH_k^{obj} = G = [-hat(y) | I] with y = H^-1 m_k; all over sigma_t
    Hk, _ = select_motions(H, w.dyn_obj, masks.ternary | masks.dyn_obs)
    Rm = Hk.R[1:]                                               # (W-1, ND, 3, 3)
    y_t = torch.einsum("...ba,...b->...a", Rm, dp[1:] - Hk.t[1:])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    G = torch.cat([-so3_hat(y_t), eye3.expand(*y_t.shape, 3)], dim=-1)
    obj_idx = (torch.arange(1, W, device=dev)[:, None] * O + w.dyn_obj[1:].clamp(min=0)).reshape(-1)
    onehot = object_onehot(w.dyn_obj[1:].clamp(min=0), O).to(dtype)    # (W-1, ND, O): obj_idx's slot

    def J(d: dict) -> list:
        dH, ddp = d["H"], d["dp"]
        dH_sel = dH.reshape(W * O, 6)[obj_idx].reshape(W - 1, ND, 6)
        return J_sh(d) + [
            (ddp[:-1] - torch.einsum("knba,knb->kna", Rm, ddp[1:])
             + torch.einsum("knab,knb->kna", G, dH_sel)) / sig_t,
            torch.einsum("koab,kob->koa", Ja_m, dH[:-1]) + torch.einsum("koab,kob->koa", Jb_m, dH[1:]),
        ]

    def Jt(u: list) -> dict:
        """J^T of weighted rows u (each already multiplied by its weight)."""
        g = Jt_sh(u[:4])
        u_t, u_m = u[4] / sig_t, u[5]
        g["dp"][:-1] += u_t
        g["dp"][1:] -= torch.einsum("knab,knb->kna", Rm, u_t)
        # the per-object sums as a contraction over tracks, not an
        # `index_add_`, whose float atomics sum in a different order on
        # every CUDA run
        gH = _place(torch.einsum("kno,knb->kob", onehot, torch.einsum("knab,kna->knb", G, u_t)), 1, 0)
        gH[:-1] += torch.einsum("koab,koa->kob", Ja_m, u_m)
        gH[1:] += torch.einsum("koab,koa->kob", Jb_m, u_m)
        return {"X": g["X"], "H": gH, "sp": g["sp"], "dp": g["dp"]}

    weights = _shared_weights(sqrt_w, masks, dtype) + [
        (sqrt_w[4] ** 2 * masks.ternary[1:].to(dtype))[..., None],
        (sqrt_w[5] ** 2 * masks.smoothing[1:].to(dtype))[..., None]]
    return _normal_product(J, Jt, weights, res0)


def world_pose_normal_product(values: dict, sqrt_w: list, res0: list, w: WindowData,
                              masks: WindowMasks, cfg: BackendConfig, anchor: SE3):
    """(JtJ_mv, g) of the WorldPose families, as `world_motion_normal_product`,
    on tangent dicts {X, L (W, O, 6), sp, dp} for the residuals of
    `world_pose_residuals`: the motion-pose rows of `_motion_pose_blocks`,
    the pose-smoothing triplets and the optional kinematic pairs."""
    L: SE3 = values["L"]
    dp = values["dp"]
    dtype, dev = dp.dtype, dp.device
    W, O = L.batch_shape
    ND = dp.shape[1]
    _, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    sig_t = cfg.motion_ternary_factor_noise_sigma
    J_sh, Jt_sh = _shared_rows(values, w, masks, cfg, anchor)
    rel_R, G, _ = _motion_pose_blocks(L, dp, w, masks.ternary | masks.dyn_obs)
    obj = w.dyn_obj[1:].clamp(min=0)
    rows = torch.arange(1, W, device=dev)[:, None] * O
    idx_c = (rows + obj).reshape(-1)                            # L_k^{obj} of row k
    idx_p = idx_c - O                                           # L_{k-1}^{obj}
    onehot = object_onehot(obj, O).to(dtype)                    # (W-1, ND, O)
    Ja_t, Jb_t, Jc_t = _triplet_jacobians(L[:-2], L[1:-1], L[2:], smooth_sigma)
    kin = cfg.use_object_kinematic_factor
    if kin:
        Ja_k, Jb_k = _kinematic_jacobians(w.motion_init[1:], L[:-1], L[1:], cfg.object_kinematic_sigma)

    def pair(Ja, Jb, x):
        return torch.einsum("koab,kob->koa", Ja, x[:-1]) + torch.einsum("koab,kob->koa", Jb, x[1:])

    def J(d: dict) -> list:
        dL, ddp = d["L"], d["dp"]
        flat = dL.reshape(W * O, 6)
        dL_rel = (flat[idx_p] - flat[idx_c]).reshape(W - 1, ND, 6)
        rows_ = J_sh(d) + [
            (ddp[1:] - torch.einsum("knab,knb->kna", rel_R, ddp[:-1])
             + torch.einsum("knab,knb->kna", G, dL_rel)) / sig_t,
            (torch.einsum("toab,tob->toa", Ja_t, dL[:-2]) + torch.einsum("toab,tob->toa", Jb_t, dL[1:-1])
             + torch.einsum("toab,tob->toa", Jc_t, dL[2:])),
        ]
        return rows_ + [pair(Ja_k, Jb_k, dL)] if kin else rows_

    def Jt(u: list) -> dict:
        g = Jt_sh(u[:4])
        u_mp, u_ps = u[4] / sig_t, u[5]
        g["dp"][:-1] -= torch.einsum("knba,knb->kna", rel_R, u_mp)
        g["dp"][1:] += u_mp
        # per-object sums as contractions (deterministic on CUDA, unlike
        # `index_add_`'s float atomics): +G^T u at L_{k-1}, -G^T u at L_k
        GtU = torch.einsum("kno,knb->kob", onehot, torch.einsum("knab,kna->knb", G, u_mp))
        gL = _place(GtU, 0, 1) - _place(GtU, 1, 0)
        gL[:-2] += torch.einsum("toab,toa->tob", Ja_t, u_ps)
        gL[1:-1] += torch.einsum("toab,toa->tob", Jb_t, u_ps)
        gL[2:] += torch.einsum("toab,toa->tob", Jc_t, u_ps)
        if kin:
            gL[:-1] += torch.einsum("koab,koa->kob", Ja_k, u[6])
            gL[1:] += torch.einsum("koab,koa->kob", Jb_k, u[6])
        return {"X": g["X"], "L": gL, "sp": g["sp"], "dp": g["dp"]}

    weights = _shared_weights(sqrt_w, masks, dtype) + [
        (sqrt_w[4] ** 2 * masks.ternary[1:].to(dtype))[..., None],
        (sqrt_w[5] ** 2 * pose_triple(masks).to(dtype))[..., None]]
    if kin:
        weights.append((sqrt_w[6] ** 2 * kinematic_mask(w, masks).to(dtype))[..., None])
    return _normal_product(J, Jt, weights, res0)


# --------------------------------------------------------------------------
# Damped Schur step
# --------------------------------------------------------------------------


def _damp_blocks(Hb: torch.Tensor, lam, floor: float) -> torch.Tensor:
    """H + lam * diag(max(diag(H), floor)) for (..., n, n) blocks."""
    d = torch.diagonal(Hb, dim1=-2, dim2=-1)
    return Hb + torch.diag_embed(lam * torch.clamp(d, min=floor))


def assemble_reduced(sys: NormalSystem, Hcc_d, Dmm_d, d_cc, d_bc, d_cm, d_mm, d_bm):
    """Dense reduced system over {X (W, 6), P (W, O, 6)} from the damped
    direct blocks minus the landmark-elimination corrections."""
    W, O = Dmm_d.shape[:2]
    dtype, dev = Hcc_d.dtype, Hcc_d.device
    nc, nm = 6 * W, 6 * W * O
    n = nc + nm
    eyeO = torch.eye(O, dtype=dtype, device=dev)
    # per-object bands (k, l) of the direct pose blocks, then -d_mm
    band = (torch.einsum("koab,kl->kloab", Dmm_d, _band(W, 0, Dmm_d))
            + torch.einsum("koab,kl->kloab", _place(sys.Omm1, 0, 1), _band(W, 1, Dmm_d))
            + torch.einsum("koab,kl->lkoba", _place(sys.Omm1, 0, 1), _band(W, 1, Dmm_d)))
    if W >= 3:
        band = (band + torch.einsum("koab,kl->kloab", _place(sys.Omm2, 0, 2), _band(W, 2, Dmm_d))
                + torch.einsum("koab,kl->lkoba", _place(sys.Omm2, 0, 2), _band(W, 2, Dmm_d)))
    Hmm = torch.einsum("kloab,op->koalpb", band, eyeO) - torch.einsum("koagb,op->koagpb", d_mm, eyeO)

    cm = d_cm.reshape(nc, nm)
    Hred = torch.cat([torch.cat([Hcc_d.reshape(nc, nc) - d_cc, -cm], dim=1),
                      torch.cat([-cm.T, Hmm.reshape(nm, nm)], dim=1)], dim=0)
    Hred = 0.5 * (Hred + Hred.T)
    bred = torch.cat([sys.b_cam.reshape(nc) - d_bc, (sys.b_mot - d_bm).reshape(nm)])

    # absolute floor so structurally empty rows (inactive motion slots,
    # frames past the sequence end) keep the Cholesky positive definite;
    # their gradient is zero, so their step stays exactly zero
    rel, tiny = _floor_consts(dtype)
    dmax = torch.max(torch.abs(torch.diagonal(Hred)))
    Hred = Hred + (rel * dmax + tiny) * torch.eye(n, dtype=dtype, device=dev)
    return Hred, bred


def _couple(Brow: torch.Tensor, oh: torch.Tensor, Rdot: torch.Tensor) -> torch.Tensor:
    """sum over (d, i) of Brow[k, d, i, a] oh[k, d, o] Rdot[k, d, i, c]:
    (W, ND, 3, 6), (W, ND, O), (W, ND, 3, 6W) -> (W, O, 6, W, 6)."""
    W = Brow.shape[0]
    out = torch.einsum("kdia,kdo,kdic->koac", Brow, oh, Rdot)
    return out.reshape(W, oh.shape[-1], 6, W, 6)


def schur_step(sys: NormalSystem, lam: torch.Tensor, floor: float, formulation: int = 0,
               with_reduced: bool = False):
    """One damped Gauss-Newton step by landmark elimination: the tangent
    dict {X (W, 6), P (W, O, 6), sp (NS, 3), dp (W, ND, 3)} solving
    (H + lam D) delta = b.  A failed Cholesky gives a NaN step.

    `formulation` must match the build (0 `build_normal_system`, 1
    `build_normal_system_pose`): it orients the capacitance bands
    (WorldMotion: the rotation on the current side, one pose column per
    factor; WorldPose: the rotation on the previous side, +/- pose columns
    at frames k-1 and k).  `with_reduced` also returns the assembled
    reduced system (Hred, bred), whose Schur complement is the fixed-lag
    boundary marginal (`backend/fixed_lag.py`).

    The step is `schur_reduce`, one Cholesky of the reduced system and
    `schur_back`: the plain versions of kernels K8 and K9's first half
    (`window_step`, `window_update`)."""
    Hred, bred, back = schur_reduce(sys, lam, floor, formulation)
    L, info = torch.linalg.cholesky_ex(Hred)
    sol = torch.cholesky_solve(bred[:, None], L)[:, 0]
    delta = schur_back(sys, back, sol, info, formulation)
    return (delta, (Hred, bred)) if with_reduced else delta


def schur_reduce(sys: NormalSystem, lam: torch.Tensor, floor: float, formulation: int = 0):
    """The damped reduced system of `schur_step`: (Hred (n, n), bred (n,),
    back), n = 6W (1 + O), `back` holding what `schur_back` reads: the
    static elimination's columns `Yc_s` (NS, 3, 6W) and `yb_s` (NS, 3), the
    chains' solutions `Z` (W, ND, 3, 2 * 6W + 1) and the damped point
    diagonal's inverse `inv_c` (W, ND).  The plain version of K8
    (`window_step`)."""
    W, NS = sys.Us.shape[:2]
    ND = sys.Rc.shape[1]
    dtype, dev = sys.Hcc.dtype, sys.Hcc.device
    nc = 6 * W
    eyeW = _band(W, 0, sys.Hcc)
    dnW = _band(W, -1, sys.Hcc)                                 # [k, k-1] = 1

    # damp the full-system diagonal first (Schur of the damped system)
    Hll_s = _damp_blocks(sys.Hll_s, lam, floor)
    cam_diag = torch.diagonal(torch.diagonal(sys.Hcc, dim1=0, dim2=2), dim1=0, dim2=1)   # (W, 6)
    Hcc = sys.Hcc + torch.einsum("ka,kl,ab->kalb", lam * torch.clamp(cam_diag, min=floor), eyeW,
                                 torch.eye(6, dtype=dtype, device=dev))

    # static elimination: all 6W camera coupling columns + the gradient
    Us_cols = sys.Us.transpose(-1, -2).permute(1, 2, 0, 3).reshape(NS, 3, nc)
    Ys = _inv3(Hll_s) @ torch.cat([Us_cols, sys.b_sp[..., None]], dim=-1)
    Yc_s, yb_s = Ys[..., :nc], Ys[..., nc]
    d_cc_s = torch.einsum("knam,nmq->kaq", sys.Us, Yc_s).reshape(nc, nc)
    d_bc_s = torch.einsum("knam,nm->ka", sys.Us, yb_s).reshape(nc)

    oh = sys.onehot
    act = oh.sum(-1)                                            # (W, ND) 0/1

    # stable dynamic elimination (Woodbury on the motion factors).  With
    # the factor as A~ z + B~ h + phi and Klam the damped observation-only
    # point diagonal, through M = I + A~ Klam^-1 A~^T:
    #   S_hh corr = -B~^T M^-1 B~
    #   S_xh corr = -(A~ Klam^-1 U)^T M^-1 B~
    #   S_xx corr = -U^T Klam^-1 U + (A~ Klam^-1 U)^T M^-1 (A~ Klam^-1 U)
    #   b_h  corr = -B~^T M^-1 phi_hat,  phi_hat = A~ Klam^-1 b_zo + phi
    #   b_x  corr = -U^T Klam^-1 b_zo + (A~ Klam^-1 U)^T M^-1 phi_hat
    # (U = Rc, b_zo = b_dp).  WorldMotion: A~_k = s_k [+I at m_{k-1},
    # -R_k^T at m_k], B~_k = s_k G_k at pose column k.  WorldPose:
    # A~_k = s_k [-R_k at m_{k-1}, +I at m_k], B~_k = s_k [+G_k at pose
    # column k-1, -G_k at column k].
    s = sys.st_s
    R = sys.st_R
    Rt = R.transpose(-1, -2)
    alpha_z = sys.chain_c + sys.chain_T + _next(sys.chain_T)
    inv_c = 1.0 / (sys.chain_c + lam * torch.clamp(alpha_z, min=floor))
    inv_c_prev = torch.cat([inv_c[:1], inv_c[:-1]], dim=0)
    alpha_M = 1.0 + s * s * (inv_c_prev + inv_c)
    if formulation == 0:
        RM = torch.cat([torch.eye(3, dtype=dtype, device=dev).expand(1, ND, 3, 3), Rt[:-1]], dim=0)
    else:
        RM = Rt
    B_M = -(shift_prev(s) * s * inv_c_prev)[..., None, None] * RM    # M_{k-1,k}

    RcC = sys.Rc * inv_c[..., None, None]
    bzoC = sys.b_dp * inv_c[..., None]
    Bcol = s[..., None, None] * sys.st_G
    Bcol_k = (Bcol[:, :, :, None, :] * eyeW[:, None, None, :, None]).reshape(W, ND, 3, nc)
    if formulation == 0:
        AU_prev = s[..., None, None] * shift_prev(RcC)               # camera column k-1
        AU_cur = -s[..., None, None] * (Rt @ RcC)                    # camera column k
        phi_hat = s[..., None] * (shift_prev(bzoC) - torch.einsum("kdab,kdb->kda", Rt, bzoC)) + sys.st_phi
        Bcol_nc = Bcol_k
    else:
        AU_prev = -s[..., None, None] * (R @ shift_prev(RcC))
        AU_cur = s[..., None, None] * RcC
        phi_hat = s[..., None] * (bzoC - torch.einsum("kdab,kdb->kda", R, shift_prev(bzoC))) + sys.st_phi
        Bcol_nc = (Bcol[:, :, :, None, :] * dnW[:, None, None, :, None]).reshape(W, ND, 3, nc) - Bcol_k
    AU_nc = (AU_prev[:, :, :, None, :] * dnW[:, None, None, :, None]
             + AU_cur[:, :, :, None, :] * eyeW[:, None, None, :, None]).reshape(W, ND, 3, nc)
    Z = chain_solve_scalar(alpha_M, B_M, torch.cat([AU_nc, Bcol_nc, phi_hat[..., None]], dim=-1))
    Z_U = Z[..., :nc]
    Nh = Z[..., nc:2 * nc].reshape(W, ND, 3, W, 6)
    Z_phi = Z[..., -1]

    d_cc1 = torch.einsum("kdia,kd,kdib->kab", sys.Rc, inv_c, sys.Rc)
    d_cc1 = torch.einsum("kab,kl->kalb", d_cc1, eyeW).reshape(nc, nc)
    d_cc_d = d_cc1 - AU_nc.reshape(-1, nc).T @ Z_U.reshape(-1, nc)
    d_bc_d = (torch.einsum("kdia,kdi->ka", sys.Rc, bzoC).reshape(nc)
              - torch.einsum("kdic,kdi->c", AU_nc, Z_phi))

    Rdot = (Nh * act.T[None, :, None, :, None]).reshape(W, ND, 3, nc)
    cm = _couple(AU_cur, oh, Rdot) + _next(_couple(AU_prev, oh, Rdot))   # camera rows k and k-1
    d_cm = cm.permute(0, 2, 3, 1, 4).reshape(nc, W, sys.Dmm.shape[1], 6)
    C_hh = _couple(Bcol, oh, Rdot)
    bphi = torch.einsum("kdia,kdi,kdo->koa", Bcol, Z_phi, oh)
    dd_t = torch.einsum("kd,kdo,kda->koa", sys.chain_T, oh, torch.sum(sys.st_G ** 2, dim=2))
    if formulation == 0:
        d_mm, d_bm, ddiag_t = -C_hh, bphi, dd_t
    else:
        # B~'s rows live at pose frames k-1 (+) and k (-): shift the
        # factor-row-k terms accordingly (factor row 0 is empty)
        d_mm, d_bm, ddiag_t = C_hh - _next(C_hh), _next(bphi) - bphi, _next(dd_t) + dd_t

    # the pose blocks are damped with the full diagonal (direct + motion
    # factor) while the matrix itself stays smoothing-only
    diag_full = torch.diagonal(sys.Dmm, dim1=-2, dim2=-1) + ddiag_t
    Dmm = sys.Dmm + torch.diag_embed(lam * torch.clamp(diag_full, min=floor))

    Hred, bred = assemble_reduced(sys, Hcc, Dmm, d_cc_s + d_cc_d, d_bc_s + d_bc_d, d_cm, d_mm, d_bm)
    return Hred, bred, dict(Yc_s=Yc_s, yb_s=yb_s, Z=Z, inv_c=inv_c)


def schur_back(sys: NormalSystem, back: dict, sol: torch.Tensor, info: torch.Tensor, formulation: int = 0) -> dict:
    """The back-substitution of `schur_step` from the reduced solution
    `sol` (n,) and the factorisation's `info` (non-zero: a NaN step), with
    `back` from `schur_reduce`: the tangent dict {X, P, sp, dp}."""
    W = sys.Us.shape[0]
    ND = sys.Rc.shape[1]
    nc = 6 * W
    Yc_s, yb_s, Z, inv_c = back["Yc_s"], back["yb_s"], back["Z"], back["inv_c"]
    Z_U = Z[..., :nc]
    Nh = Z[..., nc:2 * nc].reshape(W, ND, 3, W, 6)
    Z_phi = Z[..., -1]
    oh = sys.onehot
    s = sys.st_s
    R = sys.st_R
    Rt = R.transpose(-1, -2)
    delta_p = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
    dc = delta_p[:nc]
    dm = delta_p[nc:].reshape(W, -1, 6)

    # back-substitution
    d_sp = yb_s - torch.einsum("nmq,q->nm", Yc_s, dc)
    dm_sel = torch.einsum("gdo,gob->gdb", oh, dm)
    v = Z_phi - torch.einsum("kdic,c->kdi", Z_U, dc) + torch.einsum("kdigb,gdb->kdi", Nh, dm_sel)
    if formulation == 0:
        Atv = -s[..., None] * torch.einsum("kdab,kdb->kda", R, v) + _next(s)[..., None] * _next(v)
    else:
        Atv = s[..., None] * v - _next(s)[..., None] * torch.einsum("kdab,kdb->kda", _next(Rt), _next(v))
    r1 = sys.b_dp - torch.einsum("kdia,ka->kdi", sys.Rc, dc.reshape(W, 6))
    d_dp = (r1 - Atv) * inv_c[..., None]
    return {"X": dc.reshape(W, 6), "P": dm, "sp": d_sp, "dp": d_dp}


# --------------------------------------------------------------------------
# LM driver
# --------------------------------------------------------------------------


def _tree_where(mask: torch.Tensor, a, b):
    """Per-problem selection between two trees (tensors, SE3 and other
    NamedTuples, dicts, lists): `mask` covers the leading (problem) dims."""
    if isinstance(a, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)
    if isinstance(a, dict):
        return {k: _tree_where(mask, a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_tree_where(mask, x, y) for x, y in zip(a, b)]
    return type(a)(*(_tree_where(mask, x, y) for x, y in zip(a, b)))


def _formulation(formulation: int):
    """(families, residuals, build, pose key) of updater 0 or 1; the build
    functions are looked up at call time."""
    if formulation == 0:
        return world_motion_families, world_motion_residuals, build_normal_system, pose_key(0)
    return world_pose_families, world_pose_residuals, build_normal_system_pose, pose_key(1)


class _LMProblem(NamedTuple):
    """One LM problem's pieces: ``residuals(vals) -> res``,
    ``build(vals, res) -> system``, ``step(sys, lam) -> {X, P, sp, dp}``,
    ``error(res) -> error``, the retraction, the values' pose key, the LM
    settings and the batch shape (() for one problem, (B,) for B
    independent ones)."""

    residuals: Callable
    build: Callable
    step: Callable
    error: Callable
    retract: Callable
    pose_key: str
    lm_cfg: LMConfig
    batch_shape: tuple


def _lm_head(values: dict, p: _LMProblem) -> dict:
    """The LM state at `values` before the first iteration: residuals,
    error (also the initial error), lambda, lowest lambda, done."""
    res = p.residuals(values)
    err = p.error(res)
    dev = err.device
    return dict(vals=values, res=res, err=err, err_init=err,
                lam=torch.full(p.batch_shape, p.lm_cfg.initial_lambda, dtype=torch.float32, device=dev),
                lam_min=torch.full(p.batch_shape, p.lm_cfg.min_lambda, dtype=torch.float32, device=dev),
                done=torch.zeros(p.batch_shape, dtype=torch.bool, device=dev))


def _lm_iteration(s: dict, rebuild: bool, p: _LMProblem) -> dict:
    """The device half of one LM iteration on the state `s` (`_lm_head`'s,
    and from the second iteration on the normal system `sys` and
    `accept`): the normal system rebuilt if asked (in a batch, for the
    problems that accepted), the Schur step, retraction, trial residuals
    and error; then the JAX package's schedule: accept on a lower robust
    error, raise the lowest lambda on a non-finite step (the NaN ratchet),
    scale lambda, the gtsam-style convergence tests, problems already done
    keeping their state.  Returns the next state, with `flags` the
    (2, problems) accept and done flags the host reads."""
    sys = s.get("sys")
    if rebuild:
        new = p.build(s["vals"], s["res"])
        sys = new if sys is None or not p.batch_shape else _tree_where(s["accept"], new, sys)
    return _lm_tail(s, sys, p.step(sys, s["lam"]), p)


def _lm_tail(s: dict, sys, d: dict, p: _LMProblem) -> dict:
    """`_lm_iteration` after the step `d` ({X, P, sp, dp}) of the system
    `sys`: the retraction, trial residuals and error, and the LM schedule's
    decisions (the plain version of K9's second half, `window_update`)."""
    vals, res, err, lam, lam_min, done = (s[k] for k in ("vals", "res", "err", "lam", "lam_min", "done"))
    cfg = p.lm_cfg
    delta = {"X": d["X"], p.pose_key: d["P"], "sp": d["sp"], "dp": d["dp"]}
    new_vals = p.retract(vals, delta)
    new_res = p.residuals(new_vals)
    new_err = p.error(new_res)
    # a failed Cholesky (NaN step) must reject, not poison the state
    new_err = torch.where(torch.isfinite(new_err), new_err, torch.full_like(new_err, float("inf")))
    active = ~done
    accept = (new_err < err) & active
    # ratchet only on a non-finite step, not on a divergent trial
    finite = [torch.isfinite(delta[k].reshape(*p.batch_shape, -1).sum(-1)) for k in ("X", p.pose_key)]
    step_nan = ~(finite[0] & finite[1]) & active
    lam_min = torch.where(step_nan, torch.maximum(lam_min, lam * cfg.lambda_factor), lam_min)
    err_out = torch.where(accept, new_err, err)
    lam_out = torch.where(accept, torch.maximum(lam / cfg.lambda_factor, lam_min),
                          torch.clamp(lam * cfg.lambda_factor, max=cfg.max_lambda))
    change = torch.abs(err - err_out)
    converged = accept & ((change < cfg.rel_error_tol * torch.clamp(err, min=1e-30)) | (change < cfg.abs_error_tol))
    done = done | converged | (active & (lam_out >= cfg.max_lambda))
    return dict(vals=_tree_where(accept, new_vals, vals), res=_tree_where(accept, new_res, res), err=err_out,
                lam=torch.where(active, lam_out, lam), lam_min=lam_min, done=done, sys=sys, accept=accept,
                flags=torch.stack([accept, done]).reshape(2, -1))


def _lm_schedule(head: Callable, iteration: Callable, lm_cfg: LMConfig, n_problems: int = 1):
    """The host half of the LM loop, the JAX package's `lax.while_loop`:
    `head()`, then `iteration(rebuild)`, which returns the (2, problems)
    accept and done flags on the device, with the normal system rebuilt on
    the first iteration and after any accepted step, until every problem
    is done or the iteration cap.  Reading the flags is the loop's one
    host read an iteration.  Returns (iterations per problem, each frozen
    at its convergence as a vmapped while loop freezes it; done per
    problem)."""
    head()
    its, done, accepted = [0] * n_problems, [False] * n_problems, [True]
    n = 0
    while n < lm_cfg.max_iterations and not all(done):
        accepted, done_new = iteration(any(accepted)).tolist()   # the one host read
        its = [i + (not d) for i, d in zip(its, done)]
        done = done_new
        n += 1
    return its, done


def _lm_loop(values: dict, residuals: Callable, build: Callable, step: Callable, specs, lm_cfg: LMConfig,
             pose_key: str, batch_shape: tuple, error: Callable | None = None):
    """The LM loop over one problem (`batch_shape` ()) or a batch of
    independent ones (leading dim B), eagerly: `_lm_schedule` over
    `_lm_head` and `_lm_iteration`.  `error(res)` replaces the robust total
    of the residual families.  Returns (values, error, initial error,
    iterations per problem, lambda, done per problem)."""
    if error is None:
        def error(r):
            return total_error(r, specs, batch_dims=len(batch_shape))
    p = _LMProblem(residuals, build, step, error, retract_tree, pose_key, lm_cfg, batch_shape)
    s = {}

    def iteration(rebuild):
        s.update(_lm_iteration(s, rebuild, p))
        return s["flags"]

    its, done = _lm_schedule(lambda: s.update(_lm_head(values, p)), iteration, lm_cfg,
                             max(1, int(torch.Size(batch_shape).numel())))
    return s["vals"], s["err"], s["err_init"], its, s["lam"], done


# --------------------------------------------------------------------------
# K7-K9: the WorldMotion LM iteration on the card
# --------------------------------------------------------------------------


class WindowArgs(NamedTuple):
    """One window LM's state and inputs as K7-K9 and their plain versions
    take them: `s` the LM state (`_lm_head`'s and `_lm_iteration`'s keys,
    with the normal system `sys`), the window, masks, anchor, fixed-lag
    prior (or None) and the settings.  The kernels read and write the
    state's tensors in place."""

    s: dict
    w: WindowData
    masks: WindowMasks
    anchor: SE3
    prior: torch.Tensor | None
    cfg: BackendConfig
    lm_cfg: LMConfig


def kernel_tensors(a: WindowArgs) -> dict:
    """The named tensors of `kernels/window.py:POINTERS` of `a`: views of
    the state, window, masks and anchor (no copies)."""
    v, res, w, mk = a.s["vals"], a.s["res"], a.w, a.masks
    names = ("r_anchor", "r_odo", "r_static", "r_dyn", "r_tern", "r_smooth")
    return dict(
        XR=v["X"].R, Xt=v["X"].t, HR=v["H"].R, Ht=v["H"].t, sp=v["sp"], dp=v["dp"], **dict(zip(names, res)),
        static_xyz=w.static_xyz, dyn_xyz=w.dyn_xyz, dyn_obj=w.dyn_obj, XiR=w.X_init.R, Xit=w.X_init.t,
        static_obs=mk.static_obs, dyn_obs=mk.dyn_obs, ternary=mk.ternary, smoothing=mk.smoothing,
        odometry=mk.odometry, anchor_R=a.anchor.R, anchor_t=a.anchor.t, prior_L=a.prior, **a.s["sys"]._asdict(),
        **{k: a.s[k] for k in ("err", "lam", "lam_min", "done", "accept", "flags", "err_init", "tickets")})


def kernel_params(cfg: BackendConfig, lm_cfg: LMConfig) -> dict:
    """The float settings of `kernels/window.py:PARAMS`, each the number
    the plain version's float32 arithmetic uses."""
    rel, tiny = _floor_consts(torch.float32)
    ks, kd = cfg.huber_k_static, cfg.huber_k_dynamic
    odo = [cfg.odometry_rotation_sigma] * 3 + [cfg.odometry_translation_sigma] * 3
    smooth = [cfg.constant_object_motion_rotation_sigma] * 3 + [cfg.constant_object_motion_translation_sigma] * 3
    return dict(
        sig_s=cfg.static_point_noise_sigma, sig_d=cfg.dynamic_point_noise_sigma,
        sig_t=cfg.motion_ternary_factor_noise_sigma, sig_d2=cfg.dynamic_point_noise_sigma ** 2,
        sig_t2=cfg.motion_ternary_factor_noise_sigma ** 2, prior_sigma=cfg.initial_pose_prior_sigma,
        k_s=ks, k_d=kd, half_k2_s=0.5 * (ks * ks), half_k2_d=0.5 * (kd * kd),
        **{f"odo_sig{i}": x for i, x in enumerate(odo)}, **{f"smooth_sig{i}": x for i, x in enumerate(smooth)},
        floor=lm_cfg.diag_floor, tiny=tiny, rel=rel, lambda_factor=lm_cfg.lambda_factor,
        max_lambda=lm_cfg.max_lambda, rel_tol=lm_cfg.rel_error_tol, abs_tol=lm_cfg.abs_error_tol,
        initial_lambda=lm_cfg.initial_lambda, min_lambda=lm_cfg.min_lambda)


def _window_problem(a: WindowArgs) -> _LMProblem:
    specs = world_motion_families(a.cfg).robust
    return _LMProblem(lambda v: world_motion_residuals(v, a.w, a.masks, a.cfg, a.anchor, a.prior),
                      None, None, lambda res: total_error(res, specs), retract_tree, pose_key(0), a.lm_cfg, ())


def window_head(a: WindowArgs) -> None:
    """The LM head on the kernel route: K9 at a zero step (residuals and
    robust error at the state's values, the initial error, lambda and its
    floor) on CUDA tensors, counted as a launch of K9; on CPU tensors the
    plain version, `window_head_plain`."""
    if a.s["err"].device.type == "cpu":
        return window_head_plain(a)
    window_kernels.head(kernel_tensors(a), kernel_params(a.cfg, a.lm_cfg))


def window_head_plain(a: WindowArgs) -> None:
    """The head's plain version: `_lm_head` into the state."""
    tree_copy_(a.s, _lm_head(a.s["vals"], _window_problem(a)))


def window_build(a: WindowArgs) -> None:
    """K7's wrapper: the normal system at the state's values and residuals
    into the state's `sys`.  On CUDA tensors one launch of K7
    (`kernels/window.py:build`, which raises if it cannot build or
    launch); on CPU tensors the plain version, `window_build_plain`."""
    if a.s["err"].device.type == "cpu":
        return window_build_plain(a)
    window_kernels.build(kernel_tensors(a), kernel_params(a.cfg, a.lm_cfg))


def window_build_plain(a: WindowArgs) -> None:
    """K7's plain version: `build_normal_system` with `sqrt_weights`."""
    v, res = a.s["vals"], a.s["res"]
    sw = sqrt_weights(res, world_motion_families(a.cfg).robust)
    tree_copy_(a.s["sys"], build_normal_system(v, sw, a.w, a.masks, a.cfg, a.anchor, res, a.prior))


def window_step(a: WindowArgs):
    """K8's wrapper: (Hred, bred, back) of the state's system at its
    lambda (`schur_reduce`'s).  On CUDA tensors one launch of K8, whose
    `back` is empty (K9 rebuilds what it needs from the system); on CPU
    tensors the plain version, `window_step_plain`."""
    if a.s["err"].device.type == "cpu":
        return window_step_plain(a)
    return window_kernels.step(kernel_tensors(a), kernel_params(a.cfg, a.lm_cfg))


def window_step_plain(a: WindowArgs):
    """K8's plain version: `schur_reduce`."""
    return schur_reduce(a.s["sys"], a.s["lam"], a.lm_cfg.diag_floor, 0)


def window_update(a: WindowArgs, sol: torch.Tensor, info: torch.Tensor, back: dict) -> dict:
    """K9's wrapper: from the reduced solution `sol` and the
    factorisation's `info`, the back-substitution, retraction, trial
    residuals and error and the LM decisions, written into the state;
    returns the step taken ({X, P, sp, dp}).  On CUDA tensors one launch of
    K9; on CPU tensors the plain version, `window_update_plain`, with
    `back` from `window_step_plain`."""
    if a.s["err"].device.type == "cpu":
        return window_update_plain(a, sol, info, back)
    return window_kernels.update(kernel_tensors(a), kernel_params(a.cfg, a.lm_cfg), sol, info)


def window_update_plain(a: WindowArgs, sol: torch.Tensor, info: torch.Tensor, back: dict) -> dict:
    """K9's plain version: `schur_back`, then `_lm_tail`; returns
    `schur_back`'s step."""
    d = schur_back(a.s["sys"], back, sol, info, 0)
    tree_copy_(a.s, _lm_tail(a.s, a.s["sys"], d, _window_problem(a)))
    return d


def window_iteration(a: WindowArgs, rebuild: bool) -> None:
    """One LM iteration of the window through K7-K9 (their plain versions
    on the CPU), with the factorisation between K8 and K9: in place on
    the state, as `_lm_iteration` followed by a copy into it."""
    if rebuild:
        window_build(a)
    Hred, bred, back = window_step(a)
    L, info = torch.linalg.cholesky_ex(Hred)
    window_update(a, torch.cholesky_solve(bred[:, None], L)[:, 0], info, back)


def _contiguous(tree):
    """A copy of `tree` (tensors in dicts, lists and tuples) with every
    tensor in contiguous memory of its own."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device).copy_(tree)
    if isinstance(tree, dict):
        return {k: _contiguous(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_contiguous(v) for v in tree]
    if isinstance(tree, tuple):
        items = [_contiguous(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def _kernel_route(formulation: int, dtype) -> bool:
    """Whether a window LM goes through K7-K9: WorldMotion in float32 (the
    kernels' type; float64 solves are the checks'), with every piece
    `_pieces` resolves the module's own.  A piece replaced for a run (the
    benchmark's controls round `retract_tree`'s output, a test negates the
    built system) runs the ATen iteration it replaces."""
    return formulation == 0 and dtype == torch.float32 and _pieces(0) == _KERNEL_PIECES


class _WindowLM:
    """The direct-Schur LM of one window shape, its state in tensors it
    allocates once: the inputs (values, window, masks, anchor, prior; the
    values double as the current values) and the LM state of `_lm_head`
    and `_lm_iteration` (residuals, error, initial error, lambda, lowest
    lambda, done, the normal system, accept, the flags and K8's and K9's
    tickets).

    `head` and `iteration(rebuild)` run `_lm_head` and `_lm_iteration`
    and copy their results into that state, so each reads and writes only
    those tensors and can be captured once as a CUDA graph (`capture`) and
    replayed for every window of the shape.  On the kernel route
    (`_kernel_route`: WorldMotion in float32 with the module's own pieces)
    the head is `window_head` and an iteration `window_iteration` on the
    state, which K7-K9 read and write in place (on the card in contiguous
    copies of the inputs and state), or their plain versions on the CPU.
    `solve` copies a window into
    the inputs and runs `_lm_schedule`, the host loop `_lm_loop` runs,
    over them (or their graphs); the result is cloned out of the state.
    Without `capture` the same functions run eagerly, on any device."""

    def __init__(self, values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig, lm_cfg: LMConfig,
                 anchor: SE3, formulation: int = 0, anchor_prior_L=None):
        families, residual_fn, build_fn, pose_key, sqrt_w, step_fn, error_fn, retract = _pieces(formulation)
        specs = families(cfg).robust
        # on the card, K7-K9 read and write the state in place: every tensor
        # in contiguous memory of its own
        self.kernels = _kernel_route(formulation, values["X"].t.dtype)
        dense = self.kernels and values["X"].t.is_cuda
        self.inputs = (_contiguous if dense else tree_clone)((values, w, masks, anchor, anchor_prior_L))
        vals, w, masks, anchor, prior = self.inputs
        self.p = _LMProblem(lambda v: residual_fn(v, w, masks, cfg, anchor, prior),
                            lambda v, res: build_fn(v, sqrt_w(res, specs), w, masks, cfg, anchor, res, prior),
                            lambda sys, lam: step_fn(sys, lam, lm_cfg.diag_floor, formulation),
                            lambda res: error_fn(res, specs), retract, pose_key, lm_cfg, ())
        head = _lm_head(vals, self.p)
        self.s = dict(_contiguous(head) if dense else tree_clone(head), vals=vals)
        dev = self.s["err"].device
        sys = self.p.build(vals, self.s["res"])
        # `tickets`: K8's and K9's integer counters, zero between launches
        self.s.update(sys=_contiguous(sys) if dense else sys, accept=torch.zeros((), dtype=torch.bool, device=dev),
                      flags=torch.zeros((2, 1), dtype=torch.bool, device=dev),
                      tickets=torch.zeros((window_kernels.TICKETS,), dtype=torch.int32, device=dev))
        self.args = WindowArgs(self.s, w, masks, anchor, prior, cfg, lm_cfg) if self.kernels else None
        self.graphs = None

    def head(self) -> None:
        if self.kernels:
            window_head(self.args)
        else:
            tree_copy_(self.s, _lm_head(self.s["vals"], self.p))

    def iteration(self, rebuild: bool) -> None:
        if self.kernels:
            window_iteration(self.args, rebuild)
        else:
            tree_copy_(self.s, _lm_iteration(self.s, rebuild, self.p))

    def _variants(self) -> dict:
        return {"head": self.head, "build": lambda: self.iteration(True), "step": lambda: self.iteration(False)}

    def capture(self) -> None:
        """Capture the head and both iteration variants as CUDA graphs
        (`utils/graphs.py:capture`: one memory pool, two eager rounds on
        the capture stream first, thread-local).  The state is left as the
        warm-up leaves it: `solve` loads it anew."""
        self.graphs = graphs.capture(self._variants(), self.s["err"].device)

    def _run(self, name: str) -> None:
        if self.graphs is None:
            self._variants()[name]()
        else:
            self.graphs[name].replay()
            graphs.count("window", "replays")

    def _iterate(self, rebuild: bool) -> torch.Tensor:
        self._run("build" if rebuild else "step")
        return self.s["flags"]

    def solve(self, values: dict, w: WindowData, masks: WindowMasks, anchor: SE3, anchor_prior_L=None) -> LMResult:
        tree_copy_(self.inputs, (values, w, masks, anchor, anchor_prior_L))
        its, done = _lm_schedule(lambda: self._run("head"), self._iterate, self.p.lm_cfg)
        s = self.s
        return LMResult(values=tree_clone(s["vals"]), error=s["err"].clone(), initial_error=s["err_init"].clone(),
                        iterations=its[0], lam=s["lam"].clone(), converged=done[0])


# Captured window LMs by everything a capture bakes in, least recently
# used first: a fresh backend (a benchmark's next rep, a CLI user's next
# run) reuses the captures of the process's earlier windows.
_WINDOW_LMS: OrderedDict = OrderedDict()
_WINDOW_LMS_MAX = 4


def graph_counts() -> dict:
    """{"captures", "replays"}: window-LM graph sets captured and graphs
    replayed in this process (head, rebuild and step variants each count
    as one replay)."""
    return graphs.counts("window")


def _pieces(formulation: int) -> tuple:
    """(families, residuals, build, pose key, sqrt_weights, schur_step,
    total_error, retract_tree): every function a window LM's iteration
    reaches through this module's names, resolved now.  A capture bakes in
    the ones resolved when it was made, so they belong to its cache key: a
    function replaced for a run (as the benchmark's controls round
    `retract_tree`'s output) captures anew."""
    return (*_formulation(formulation), sqrt_weights, schur_step, total_error, retract_tree)


# the pieces K7-K9 stand for, as this module defines them
_KERNEL_PIECES = _pieces(0)


def _captured_window_lm(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig, lm_cfg: LMConfig,
                        anchor: SE3, formulation: int, anchor_prior_L) -> _WindowLM:
    """The cached `_WindowLM` of this window's shape and settings, captured
    on first use (warm-up and capture run on the window itself)."""
    key = (values["X"].t.device, formulation, _pieces(formulation), cfg, lm_cfg,
           signature((values, w, masks, anchor, anchor_prior_L)))

    def make():
        lm = _WindowLM(values, w, masks, cfg, lm_cfg, anchor, formulation, anchor_prior_L)
        lm.capture()
        graphs.count("window", "captures")
        return lm

    return graphs.lru(_WINDOW_LMS, key, make, _WINDOW_LMS_MAX)


def lm_optimize_schur(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                      lm_cfg: LMConfig, anchor: SE3, formulation: int = 0,
                      chain_solver=None, overrides=None, anchor_prior_L=None, _graphs: bool = True) -> LMResult:
    """Levenberg-Marquardt with direct Schur steps, WorldMotion
    (`formulation` 0) or WorldPose (1), the anchor isotropic or the
    (6, 6) Cholesky factor `anchor_prior_L` of a full-information prior.

    The JAX package's `lax.while_loop`: IRLS weights frozen per
    linearisation, accept/reject on the true robust cost, the normal
    system rebuilt only after an accepted step, the NaN ratchet on lambda,
    gtsam-style convergence tests.  Here the loop runs on the host and
    reads the device once per iteration (the accept and done flags in one
    transfer), so `iterations` is also the solve's count of host reads.
    `lam` stays a float32 tensor on the device, as in the JAX package.

    On a CUDA device (without `overrides`) each iteration's device work is
    a CUDA graph replay (`_WindowLM`): the head, the iteration with the
    normal-system rebuild and the one without it are captured once per
    process for each window shape and setting, and every later window of
    that shape copies its inputs into the graphs' buffers and replays
    them, with the same kernels in the same order as the eager loop.
    A WorldMotion iteration there is kernels K7-K9 around cuSOLVER's
    factorisation (`window_iteration`), graphed or, with `_graphs=False`,
    eager: both launch the same kernels on buffers of the same layout, so
    they agree bit for bit.  The ATen pieces run, eagerly, for WorldPose
    or float64 with `_graphs=False`, under a `TorchDispatchMode` (`utils/debug.py:
    nan_debug`, which must see every operator), with `overrides` (an empty
    dict replaces no piece: the plain loop of the module's functions), and
    where a piece of `_pieces` is replaced for a run (`_kernel_route`).
    The batched solve (`lm_optimize_schur_batched`) keeps the ATen pieces
    too.

    `overrides` replaces the per-iteration pieces and keeps this schedule
    (the distributed solve, `parallel/schur_dist.py`, whose pieces work on
    one rank's blocks with explicit collectives): ``residual_fn(vals) ->
    res list``, ``error_fn(res) -> scalar``, ``build_fn(vals, sqrt_w, res0)
    -> system`` and ``step_fn(sys, lam) -> {X, P, sp, dp}``; `w` and
    `masks` are then unused by the replaced pieces.  `chain_solver` is
    refused: the JAX package accepts it only with the subtractive
    elimination (`DYNO_SCHUR_STABLE=0`), which the port rules leave out."""
    if chain_solver is not None:
        raise NotImplementedError(
            "chain_solver needs the subtractive elimination (DYNO_SCHUR_STABLE=0), which the port "
            "leaves out (ROADMAP.md, not ported by the port rules); the stable step solves its own chains")
    # a dispatch mode (`utils/debug.py:nan_debug`) must see every operator,
    # which a graph replay would not dispatch
    if overrides is None and values["X"].t.is_cuda and _get_current_dispatch_mode() is None:
        if _graphs:
            return _captured_window_lm(values, w, masks, cfg, lm_cfg, anchor, formulation, anchor_prior_L).solve(
                values, w, masks, anchor, anchor_prior_L)
        if _kernel_route(formulation, values["X"].t.dtype):
            return _WindowLM(values, w, masks, cfg, lm_cfg, anchor, formulation, anchor_prior_L).solve(
                values, w, masks, anchor, anchor_prior_L)
    ov = overrides or {}
    families, residual_fn, build_fn, pose_key = _formulation(formulation)
    specs = families(cfg).robust

    def residuals(v):
        return residual_fn(v, w, masks, cfg, anchor, anchor_prior_L)

    def build(v, res):
        if "build_fn" in ov:
            return ov["build_fn"](v, sqrt_weights(res, specs), res)
        return build_fn(v, sqrt_weights(res, specs), w, masks, cfg, anchor, res, anchor_prior_L)

    vals, err, err_init, its, lam, done = _lm_loop(
        values, ov.get("residual_fn", residuals), build,
        ov.get("step_fn", lambda sys, lam: schur_step(sys, lam, lm_cfg.diag_floor, formulation)),
        specs, lm_cfg, pose_key, (), error=ov.get("error_fn"))
    return LMResult(values=vals, error=err, initial_error=err_init, iterations=its[0], lam=lam, converged=done[0])


def lm_optimize_schur_batched(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                              lm_cfg: LMConfig, anchor: SE3, formulation: int = 0) -> list:
    """`lm_optimize_schur` over B windows of equal shape stacked on a
    leading axis of every leaf (values, window data, masks, anchors): the
    JAX package's vmapped solve.  Residuals, build and step are mapped
    over the window axis with `torch.func.vmap`, so each is one set of
    batched launches for all windows; every window freezes at its own
    convergence, and the host reads all windows' flags once per LM
    iteration.  Returns one `LMResult` per window."""
    families, residual_fn, build_fn, pose_key = _formulation(formulation)
    specs = families(cfg).robust
    wf = tuple(w)[:-1]                       # the tensor fields; `start` plays no part in the solve

    def window(fields):
        return WindowData(*fields, start=0)

    residuals = torch.func.vmap(lambda v, f, mk, a: residual_fn(v, window(f), mk, cfg, a))
    build_b = torch.func.vmap(lambda v, res, f, mk, a: build_fn(v, sqrt_weights(res, specs), window(f), mk,
                                                                cfg, a, res))
    step = torch.func.vmap(lambda sys, lam: schur_step(sys, lam, lm_cfg.diag_floor, formulation))
    vals, err, err_init, its, lam, done = _lm_loop(
        values, lambda v: residuals(v, wf, masks, anchor), lambda v, res: build_b(v, res, wf, masks, anchor),
        step, specs, lm_cfg, pose_key, (anchor.t.shape[0],))
    return [LMResult(values={k: v[i] for k, v in vals.items()}, error=err[i], initial_error=err_init[i],
                     iterations=its[i], lam=lam[i], converged=done[i]) for i in range(len(its))]
