"""Direct reduced (Schur-complement) LM for backend windows, WorldMotion
formulation with the stable (Woodbury) dynamic elimination (port of the
production path of `dynosam_tpu/backend/schur.py`).

Each LM iteration solves the damped normal equations exactly:

  * the point families' Jacobian blocks are closed forms (pose-to-point
    wrt the pose tangent is ``[hat(y) | -I]``, y the point in the camera
    frame); the small pose-pose families (anchor, odometry, smoothing)
    use the SE(3) right Jacobian inverse of their residual (the JAX
    package differentiates those with `jacfwd`);
  * static points have independent 3x3 blocks, eliminated at once;
  * dynamic tracklets are chains along frames coupled by the ternary
    motion factor.  The ~1e10-scale ternary normal blocks are never
    formed: the factor stays in square-root form (``st_*`` fields) and
    every reduced term is a product through the capacitance chain
    ``M = I + A~ Klam^-1 A~^T`` (scalar diagonal, scaled rotations off
    it), solved by a scalar block-Thomas recursion;
  * the reduced system over {X (W, 6), H (W, O, 6)} is assembled densely
    and solved by one Cholesky; landmarks follow by back-substitution.

Damping is applied to the full-system diagonal before the reduction, and
the normal system is rebuilt only after an accepted step.  A failed
Cholesky gives a NaN step, which the LM rejects and which raises the
lowest lambda it returns to (the NaN ratchet), as in the JAX package.

`world_motion_normal_product` applies the same closed-form blocks as the
matrix-free J^T W J product of the LM-PCG (`solver.lm_optimize`).

Not ported (ROADMAP.md): the WorldPose build (item 11), the subtractive
elimination and the generic chain solvers behind the JAX package's
environment switches, and the distributed overrides (item 16).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import SE3, se3_between, se3_identity, se3_inverse, so3_hat
from ..ops import factors
from ..utils.config import BackendConfig
from .formulation import (
    WindowMasks,
    odometry_measurements,
    pose_sigmas,
    select_motions,
    shift_prev,
    world_motion_families,
    world_motion_residuals,
)
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


# --------------------------------------------------------------------------
# Scalar-diagonal chain solve (the capacitance chain M)
# --------------------------------------------------------------------------


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
    step reads.  Dmm/b_mot/b_dp hold the smoothing and observation parts
    only; the ternary information lives in the square-root st_* fields.
    (The JAX package's Omm2, Ad, Bd, Rpp, Rpc, Rcp and Rcc serve WorldPose
    or the subtractive elimination and are zero on this path.)"""

    Hcc: torch.Tensor      # (W, 6, W, 6) direct camera-camera
    Dmm: torch.Tensor      # (W, O, 6, 6) direct motion diagonal blocks (smoothing)
    Omm1: torch.Tensor     # (W-1, O, 6, 6) motion (k, k+1) coupling
    b_cam: torch.Tensor    # (W, 6)
    b_mot: torch.Tensor    # (W, O, 6)
    Hll_s: torch.Tensor    # (NS, 3, 3) static point blocks (undamped)
    Us: torch.Tensor       # (W, NS, 6, 3) camera-static couplings
    b_sp: torch.Tensor     # (NS, 3)
    Rc: torch.Tensor       # (W, ND, 3, 6) chain row k -> camera k
    b_dp: torch.Tensor     # (W, ND, 3) observation part of the point gradient
    onehot: torch.Tensor   # (W, ND, O) object one-hot per (frame, track)
    chain_c: torch.Tensor  # (W, ND) observation diagonal scalar (+ tiny floor)
    chain_T: torch.Tensor  # (W, ND) ternary information scalar, row k = factor (k-1, k)
    st_s: torch.Tensor     # (W, ND) sqrt(wt_k) / sigma_t
    st_R: torch.Tensor     # (W, ND, 3, 3) selected motion rotation (I where inactive)
    st_G: torch.Tensor     # (W, ND, 3, 6) sigma_t * J_H = [-hat(y) | I]
    st_phi: torch.Tensor   # (W, ND, 3) whitened sqrt-weighted ternary residual


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


def _se3_Ad(T: SE3) -> torch.Tensor:
    """(...,) poses -> (..., 6, 6) Adjoint [[R, 0], [t^ R, R]] ([omega, v] order)."""
    return torch.cat([torch.cat([T.R, torch.zeros_like(T.R)], -1),
                      torch.cat([so3_hat(T.t) @ T.R, T.R], -1)], -2)


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
    return -Jinv @ _se3_Ad(se3_inverse(M)), Jinv


def _odo_anchor_blocks(X: SE3, w: WindowData, masks: WindowMasks, cfg: BackendConfig, anchor: SE3,
                       r_anchor, r_odo):
    """Odometry and anchor contributions to the camera-camera Hessian and
    the camera gradient (g, not yet negated)."""
    W = masks.frame.shape[0]
    dtype, dev = X.t.dtype, X.t.device
    pose_sigma, _ = pose_sigmas(cfg, dtype, dev)
    wgt_odo = masks.odometry[1:].to(dtype)
    Ja, Jb = _between_jacobians(X[:-1], X[1:], odometry_measurements(w), pose_sigma)  # (W-1, 6, 6)
    J_anchor = _right_jacobian_inv(factors.prior_residual(X[0], anchor)) / cfg.initial_pose_prior_sigma

    diag = torch.zeros((W, 6, 6), dtype=dtype, device=dev)
    diag[0] += J_anchor.T @ J_anchor
    diag[:-1] += torch.einsum("k,kra,krb->kab", wgt_odo, Ja, Ja)
    diag[1:] += torch.einsum("k,kra,krb->kab", wgt_odo, Jb, Jb)
    Hab = torch.einsum("k,kra,krb->kab", wgt_odo, Ja, Jb)
    g_cam = torch.zeros((W, 6), dtype=dtype, device=dev)
    g_cam[0] += J_anchor.T @ r_anchor[0]
    g_cam[:-1] += torch.einsum("k,kra,kr->ka", wgt_odo, Ja, r_odo)
    g_cam[1:] += torch.einsum("k,kra,kr->ka", wgt_odo, Jb, r_odo)
    return diag, Hab, g_cam


def _smoothing_blocks(H: SE3, wgt_smooth, r_smooth, smooth_sigma):
    """Motion-smoothing contributions: Dmm (W, O, 6, 6), Omm1 (W-1, O, 6, 6)
    and the motion gradient g_mot (W, O, 6)."""
    W, O = H.batch_shape
    identity = se3_identity((), H.t.dtype, H.t.device)
    Ja, Jb = _between_jacobians(H[:-1], H[1:], identity, smooth_sigma)   # (W-1, O, 6, 6)
    Dmm = torch.zeros((W, O, 6, 6), dtype=H.t.dtype, device=H.t.device)
    Dmm[:-1] += torch.einsum("ko,kora,korb->koab", wgt_smooth, Ja, Ja)
    Dmm[1:] += torch.einsum("ko,kora,korb->koab", wgt_smooth, Jb, Jb)
    Omm1 = torch.einsum("ko,kora,korb->koab", wgt_smooth, Ja, Jb)
    g_mot = torch.zeros((W, O, 6), dtype=H.t.dtype, device=H.t.device)
    g_mot[:-1] += torch.einsum("ko,kora,kor->koa", wgt_smooth, Ja, r_smooth)
    g_mot[1:] += torch.einsum("ko,kora,kor->koa", wgt_smooth, Jb, r_smooth)
    return Dmm, Omm1, g_mot


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


def build_normal_system(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks,
                        cfg: BackendConfig, anchor: SE3, res0: list) -> NormalSystem:
    """WorldMotion normal system at `values` {X, H, sp, dp}, with the IRLS
    square-root weights `sqrt_w` and the residuals `res0` of
    `world_motion_residuals` (same family order)."""
    X: SE3 = values["X"]
    H: SE3 = values["H"]
    sp, dp = values["sp"], values["dp"]
    dtype, dev = sp.dtype, sp.device
    W = masks.frame.shape[0]
    r_anchor, r_odo, r_static, r_dyn, r_tern, r_smooth = res0
    _, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    _, tiny = _floor_consts(dtype)

    # IRLS weight x activation mask (sigma whitening lives in J and r)
    wgt_static = sqrt_w[2] ** 2 * masks.static_obs.to(dtype)
    wgt_dyn = sqrt_w[3] ** 2 * masks.dyn_obs.to(dtype)
    wgt_tern = sqrt_w[4] ** 2 * masks.ternary[1:].to(dtype)
    wgt_smooth = masks.smoothing[1:].to(dtype)

    Jx_s, Jp_s = _pose_point_jacobians(X, sp[None].expand(W, *sp.shape), cfg.static_point_noise_sigma)
    Jx_d, Jp_d = _pose_point_jacobians(X, dp, cfg.dynamic_point_noise_sigma)

    # selected motion per (frame, track): a frame takes part in factor f-1
    # (as current frame) or factor f (as previous frame)
    sig_t = cfg.motion_ternary_factor_noise_sigma
    H_sel, onehot = select_motions(H, w.dyn_obj, masks.ternary | _next(masks.ternary))
    Hc = H_sel[1:]                                              # (W-1, ND)
    y_t = torch.einsum("...ba,...b->...a", Hc.R, dp[1:] - Hc.t)  # H^-1 m_cur

    # direct camera blocks
    diag, Hab, g_cam = _odo_anchor_blocks(X, w, masks, cfg, anchor, r_anchor, r_odo)
    diag += (torch.einsum("kn,knra,knrb->kab", wgt_static, Jx_s, Jx_s)
             + torch.einsum("kn,knra,knrb->kab", wgt_dyn, Jx_d, Jx_d))
    idx = torch.arange(W, device=dev)
    Hcc = torch.zeros((W, 6, W, 6), dtype=dtype, device=dev)
    Hcc[idx, :, idx, :] = diag
    Hcc[idx[:-1], :, idx[1:], :] = Hab
    Hcc[idx[1:], :, idx[:-1], :] = Hab.transpose(-1, -2)
    g_cam = (g_cam + torch.einsum("kn,knra,knr->ka", wgt_static, Jx_s, r_static)
             + torch.einsum("kn,knra,knr->ka", wgt_dyn, Jx_d, r_dyn))

    Dmm, Omm1, g_mot = _smoothing_blocks(H, wgt_smooth, r_smooth, smooth_sigma)
    Hll_s, Us, b_sp = _static_blocks(wgt_static, Jx_s, Jp_s, r_static)

    # dynamic chains: observation part, then the ternary factor in
    # square-root form (~1e5 scale, exact in f32 to relative 1e-7)
    Rc = torch.einsum("kd,kra,kdrb->kdab", wgt_dyn, Jp_d, Jx_d)
    g_dp = torch.einsum("kd,kra,kdr->kda", wgt_dyn, Jp_d, r_dyn)
    zrow = torch.zeros_like(wgt_tern[:1])
    chain_T = torch.cat([zrow, wgt_tern / sig_t ** 2], dim=0)
    chain_c = wgt_dyn / cfg.dynamic_point_noise_sigma ** 2 + tiny
    sqw_t = sqrt_w[4] * masks.ternary[1:].to(dtype)
    st_s = torch.cat([zrow, sqw_t / sig_t], dim=0)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    st_R = torch.cat([eye3.expand(1, *Hc.R.shape[1:]), Hc.R], dim=0)
    G = torch.cat([-so3_hat(y_t), eye3.expand(*y_t.shape, 3)], dim=-1)
    st_G = torch.cat([torch.zeros_like(G[:1]), G], dim=0)
    st_phi = torch.cat([torch.zeros_like(r_tern[:1]), sqw_t[..., None] * r_tern], dim=0)
    return NormalSystem(
        Hcc=Hcc, Dmm=Dmm, Omm1=Omm1, b_cam=-g_cam, b_mot=-g_mot, Hll_s=Hll_s, Us=Us, b_sp=b_sp,
        Rc=Rc, b_dp=-g_dp, onehot=onehot, chain_c=chain_c, chain_T=chain_T,
        st_s=st_s, st_R=st_R, st_G=st_G, st_phi=st_phi,
    )


# --------------------------------------------------------------------------
# Matrix-free product of the LM-PCG solve
# --------------------------------------------------------------------------


def world_motion_normal_product(values: dict, sqrt_w: list, res0: list, w: WindowData,
                                masks: WindowMasks, cfg: BackendConfig, anchor: SE3):
    """(JtJ_mv, g) of the WorldMotion families at `values` with the IRLS
    weights `sqrt_w` frozen: JtJ_mv(d) = J^T W J d on tangent dicts {X (W,
    6), H (W, O, 6), sp (NS, 3), dp (W, ND, 3)} and g = J^T W r0 for the
    residuals `res0` of `world_motion_residuals` (what the JAX LM-PCG gets
    from `jax.linearize` + `jax.linear_transpose`).  The whitened Jacobian
    blocks of every family are built here once; each product is then
    batched contractions, gathers and `index_add_`, with no host read."""
    X: SE3 = values["X"]
    H: SE3 = values["H"]
    sp, dp = values["sp"], values["dp"]
    dtype, dev = sp.dtype, sp.device
    W, O = H.batch_shape
    ND = dp.shape[1]
    pose_sigma, smooth_sigma = pose_sigmas(cfg, dtype, dev)
    sig_t = cfg.motion_ternary_factor_noise_sigma

    # IRLS weight x activation mask of each factor row
    w_anchor = sqrt_w[0][0] ** 2
    w_odo = sqrt_w[1] ** 2 * masks.odometry[1:].to(dtype)
    w_s = sqrt_w[2] ** 2 * masks.static_obs.to(dtype)
    w_d = sqrt_w[3] ** 2 * masks.dyn_obs.to(dtype)
    w_t = sqrt_w[4] ** 2 * masks.ternary[1:].to(dtype)
    w_sm = sqrt_w[5] ** 2 * masks.smoothing[1:].to(dtype)

    J_anchor = _right_jacobian_inv(factors.prior_residual(X[0], anchor)) / cfg.initial_pose_prior_sigma
    Ja_o, Jb_o = _between_jacobians(X[:-1], X[1:], odometry_measurements(w), pose_sigma)
    Jx_s, Jp_s = _pose_point_jacobians(X, sp[None].expand(W, *sp.shape), cfg.static_point_noise_sigma)
    Jx_d, Jp_d = _pose_point_jacobians(X, dp, cfg.dynamic_point_noise_sigma)
    Ja_m, Jb_m = _between_jacobians(H[:-1], H[1:], se3_identity((), dtype, dev), smooth_sigma)
    # ternary row k (factor (k-1, k)): d/dm_{k-1} = I, d/dm_k = -R^T,
    # d/dH_k^{obj} = G = [-hat(y) | I] with y = H^-1 m_k; all over sigma_t
    Hk, _ = select_motions(H, w.dyn_obj, masks.ternary | masks.dyn_obs)
    Rm = Hk.R[1:]                                               # (W-1, ND, 3, 3)
    y_t = torch.einsum("...ba,...b->...a", Rm, dp[1:] - Hk.t[1:])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    G = torch.cat([-so3_hat(y_t), eye3.expand(*y_t.shape, 3)], dim=-1)
    obj_idx = (torch.arange(1, W, device=dev)[:, None] * O + w.dyn_obj[1:].clamp(min=0)).reshape(-1)

    def J(d: dict) -> list:
        dX, dH, dsp, ddp = d["X"], d["H"], d["sp"], d["dp"]
        dH_sel = dH.reshape(W * O, 6)[obj_idx].reshape(W - 1, ND, 6)
        return [
            J_anchor @ dX[0],
            torch.einsum("kab,kb->ka", Ja_o, dX[:-1]) + torch.einsum("kab,kb->ka", Jb_o, dX[1:]),
            torch.einsum("knab,kb->kna", Jx_s, dX) + torch.einsum("kab,nb->kna", Jp_s, dsp),
            torch.einsum("knab,kb->kna", Jx_d, dX) + torch.einsum("kab,knb->kna", Jp_d, ddp),
            (ddp[:-1] - torch.einsum("knba,knb->kna", Rm, ddp[1:])
             + torch.einsum("knab,knb->kna", G, dH_sel)) / sig_t,
            torch.einsum("koab,kob->koa", Ja_m, dH[:-1]) + torch.einsum("koab,kob->koa", Jb_m, dH[1:]),
        ]

    def Jt(u: list) -> dict:
        """J^T of weighted rows u (each already multiplied by its weight)."""
        u_a, u_o, u_s, u_d, u_t, u_m = u
        gX = torch.einsum("knab,kna->kb", Jx_s, u_s) + torch.einsum("knab,kna->kb", Jx_d, u_d)
        gX[0] += J_anchor.T @ u_a
        gX[:-1] += torch.einsum("kab,ka->kb", Ja_o, u_o)
        gX[1:] += torch.einsum("kab,ka->kb", Jb_o, u_o)
        g_sp = torch.einsum("kab,kna->nb", Jp_s, u_s)
        g_dp = torch.einsum("kab,kna->knb", Jp_d, u_d)
        u_t = u_t / sig_t
        g_dp[:-1] += u_t
        g_dp[1:] -= torch.einsum("knab,knb->kna", Rm, u_t)
        gH = torch.zeros((W * O, 6), dtype=dtype, device=dev)
        gH.index_add_(0, obj_idx, torch.einsum("knab,kna->knb", G, u_t).reshape(-1, 6))
        gH = gH.reshape(W, O, 6)
        gH[:-1] += torch.einsum("koab,koa->kob", Ja_m, u_m)
        gH[1:] += torch.einsum("koab,koa->kob", Jb_m, u_m)
        return {"X": gX, "H": gH, "sp": g_sp, "dp": g_dp}

    weights = (w_anchor, w_odo[:, None], w_s[..., None], w_d[..., None], w_t[..., None], w_sm[..., None])

    def JtJ_mv(d: dict) -> dict:
        return Jt([wt * u for wt, u in zip(weights, J(d))])

    r_anchor, *rest = res0
    g = Jt([wt * r for wt, r in zip(weights, [r_anchor[0], *rest])])
    return JtJ_mv, g


# --------------------------------------------------------------------------
# Damped Schur step
# --------------------------------------------------------------------------


def _damp_blocks(Hb: torch.Tensor, lam, floor: float) -> torch.Tensor:
    """H + lam * diag(max(diag(H), floor)) for (..., n, n) blocks."""
    d = torch.diagonal(Hb, dim1=-2, dim2=-1)
    dd = lam * torch.clamp(d, min=floor)
    return Hb + dd[..., None] * torch.eye(Hb.shape[-1], dtype=Hb.dtype, device=Hb.device)


def assemble_reduced(sys: NormalSystem, Hcc_d, Dmm_d, d_cc, d_bc, d_cm, d_mm, d_bm):
    """Dense reduced system over {X (W, 6), H (W, O, 6)} from the damped
    direct blocks minus the landmark-elimination corrections."""
    W, O = Dmm_d.shape[:2]
    dtype, dev = Hcc_d.dtype, Hcc_d.device
    nc, nm = 6 * W, 6 * W * O
    n = nc + nm
    eyeO = torch.eye(O, dtype=dtype, device=dev)
    Hmm = torch.einsum("koagb,op->koagpb", -d_mm, eyeO)         # (W, O, 6, W, O, 6)
    k = torch.arange(W, device=dev)[:, None]
    o = torch.arange(O, device=dev)[None, :]
    Hmm[k, o, :, k, o, :] += Dmm_d
    Hmm[k[:-1], o, :, k[1:], o, :] += sys.Omm1
    Hmm[k[1:], o, :, k[:-1], o, :] += sys.Omm1.transpose(-1, -2)

    Hred = torch.zeros((n, n), dtype=dtype, device=dev)
    Hred[:nc, :nc] = Hcc_d.reshape(nc, nc) - d_cc
    cm = d_cm.reshape(nc, nm)
    Hred[:nc, nc:] = -cm
    Hred[nc:, :nc] = -cm.T
    Hred[nc:, nc:] = Hmm.reshape(nm, nm)
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


def schur_step(sys: NormalSystem, lam: torch.Tensor, floor: float) -> dict:
    """One damped Gauss-Newton step by landmark elimination: the tangent
    dict {X (W, 6), P (W, O, 6), sp (NS, 3), dp (W, ND, 3)} solving
    (H + lam D) delta = b.  A failed Cholesky gives a NaN step."""
    W, NS = sys.Us.shape[:2]
    ND = sys.Rc.shape[1]
    O = sys.Dmm.shape[1]
    dtype, dev = sys.Hcc.dtype, sys.Hcc.device
    nc = 6 * W
    eyeW = torch.eye(W, dtype=dtype, device=dev)
    dnW = torch.diag(torch.ones(W - 1, dtype=dtype, device=dev), -1)   # [k, k-1] = 1

    # damp the full-system diagonal first (Schur of the damped system)
    Hll_s = _damp_blocks(sys.Hll_s, lam, floor)
    idx = torch.arange(W, device=dev)
    Hcc = sys.Hcc.clone()
    Hcc[idx, :, idx, :] = _damp_blocks(sys.Hcc[idx, :, idx, :], lam, floor)

    # static elimination: all 6W camera coupling columns + the gradient
    Us_cols = sys.Us.transpose(-1, -2).permute(1, 2, 0, 3).reshape(NS, 3, nc)
    Ys = _inv3(Hll_s) @ torch.cat([Us_cols, sys.b_sp[..., None]], dim=-1)
    Yc_s, yb_s = Ys[..., :nc], Ys[..., nc]
    d_cc_s = torch.einsum("knam,nmq->kaq", sys.Us, Yc_s).reshape(nc, nc)
    d_bc_s = torch.einsum("knam,nm->ka", sys.Us, yb_s).reshape(nc)

    oh = sys.onehot
    act = oh.sum(-1)                                            # (W, ND) 0/1

    # stable dynamic elimination (Woodbury on the ternary factors).  With
    # the ternary factor as A~ z + B~ h + phi and Klam the damped
    # observation-only point diagonal, through M = I + A~ Klam^-1 A~^T:
    #   S_hh corr = -B~^T M^-1 B~
    #   S_xh corr = -(A~ Klam^-1 U)^T M^-1 B~
    #   S_xx corr = -U^T Klam^-1 U + (A~ Klam^-1 U)^T M^-1 (A~ Klam^-1 U)
    #   b_h  corr = -B~^T M^-1 phi_hat,  phi_hat = A~ Klam^-1 b_zo + phi
    #   b_x  corr = -U^T Klam^-1 b_zo + (A~ Klam^-1 U)^T M^-1 phi_hat
    # (U = Rc, b_zo = b_dp); A~_k = s_k [+I at m_{k-1}, -R_k^T at m_k],
    # B~_k = s_k G_k at the motion column k.
    s = sys.st_s
    Rt = sys.st_R.transpose(-1, -2)
    alpha_z = sys.chain_c + sys.chain_T + _next(sys.chain_T)
    inv_c = 1.0 / (sys.chain_c + lam * torch.clamp(alpha_z, min=floor))
    inv_c_prev = torch.cat([inv_c[:1], inv_c[:-1]], dim=0)
    alpha_M = 1.0 + s * s * (inv_c_prev + inv_c)
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(1, ND, 3, 3)
    RM = torch.cat([eye3, Rt[:-1]], dim=0)
    B_M = -(shift_prev(s) * s * inv_c_prev)[..., None, None] * RM    # M_{k-1,k}

    RcC = sys.Rc * inv_c[..., None, None]
    bzoC = sys.b_dp * inv_c[..., None]
    Bcol = s[..., None, None] * sys.st_G
    AU_prev = s[..., None, None] * shift_prev(RcC)                   # camera column k-1
    AU_cur = -s[..., None, None] * (Rt @ RcC)                   # camera column k
    phi_hat = s[..., None] * (shift_prev(bzoC) - torch.einsum("kdab,kdb->kda", Rt, bzoC)) + sys.st_phi
    Bcol_nc = (Bcol[:, :, :, None, :] * eyeW[:, None, None, :, None]).reshape(W, ND, 3, nc)
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
    cm_cur = _couple(AU_cur, oh, Rdot)
    cm_prev = _couple(AU_prev, oh, Rdot)                        # camera row k-1
    cm_cur[:-1] += cm_prev[1:]
    d_cm = cm_cur.permute(0, 2, 3, 1, 4).reshape(nc, W, O, 6)
    d_mm = -_couple(Bcol, oh, Rdot)
    d_bm = torch.einsum("kdia,kdi,kdo->koa", Bcol, Z_phi, oh)
    dd_t = torch.einsum("kd,kdo,kda->koa", sys.chain_T, oh, torch.sum(sys.st_G ** 2, dim=2))

    # the motion blocks are damped with the full diagonal (direct +
    # ternary) while the matrix itself stays smoothing-only
    diag_full = torch.diagonal(sys.Dmm, dim1=-2, dim2=-1) + dd_t
    Dmm = sys.Dmm + (lam * torch.clamp(diag_full, min=floor))[..., None] * torch.eye(6, dtype=dtype, device=dev)

    Hred, bred = assemble_reduced(sys, Hcc, Dmm, d_cc_s + d_cc_d, d_bc_s + d_bc_d, d_cm, d_mm, d_bm)
    L, info = torch.linalg.cholesky_ex(Hred)
    sol = torch.cholesky_solve(bred[:, None], L)[:, 0]
    delta_p = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
    dc = delta_p[:nc]
    dm = delta_p[nc:].reshape(W, O, 6)

    # back-substitution
    d_sp = yb_s - torch.einsum("nmq,q->nm", Yc_s, dc)
    dm_sel = torch.einsum("gdo,gob->gdb", oh, dm)
    v = Z_phi - torch.einsum("kdic,c->kdi", Z_U, dc) + torch.einsum("kdigb,gdb->kdi", Nh, dm_sel)
    Atv = -s[..., None] * torch.einsum("kdab,kdb->kda", sys.st_R, v) + (_next(s)[..., None] * _next(v))
    r1 = sys.b_dp - torch.einsum("kdia,ka->kdi", sys.Rc, dc.reshape(W, 6))
    d_dp = (r1 - Atv) * inv_c[..., None]
    return {"X": dc.reshape(W, 6), "P": dm, "sp": d_sp, "dp": d_dp}


# --------------------------------------------------------------------------
# LM driver
# --------------------------------------------------------------------------


def lm_optimize_schur(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                      lm_cfg: LMConfig, anchor: SE3, formulation: int = 0,
                      chain_solver=None, overrides=None) -> LMResult:
    """Levenberg-Marquardt with direct Schur steps, WorldMotion.

    The JAX package's `lax.while_loop`: IRLS weights frozen per
    linearisation, accept/reject on the true robust cost, the normal
    system rebuilt only after an accepted step, the NaN ratchet on lambda,
    gtsam-style convergence tests.  Here the loop runs on the host and
    reads the device once per iteration (the accept and done flags in one
    transfer), so `iterations` is also the solve's count of host reads.
    `lam` stays a float32 tensor on the device, as in the JAX package."""
    if formulation != 0:
        raise NotImplementedError(
            "the WorldPose formulation (updater 1) is ported by ROADMAP.md item 11")
    if chain_solver is not None or overrides is not None:
        raise NotImplementedError(
            "chain_solver and overrides serve the distributed solve, ported by ROADMAP.md item 16")
    specs = world_motion_families(cfg).robust
    dev = values["sp"].device

    def residuals(v):
        return world_motion_residuals(v, w, masks, cfg, anchor)

    res = residuals(values)
    err = total_error(res, specs)
    err_init = err
    lam = torch.full((), lm_cfg.initial_lambda, dtype=torch.float32, device=dev)
    lam_min = torch.full((), lm_cfg.min_lambda, dtype=torch.float32, device=dev)
    vals, sys, rebuild, it, done = values, None, True, 0, False
    while it < lm_cfg.max_iterations and not done:
        if rebuild:
            sys = build_normal_system(vals, sqrt_weights(res, specs), w, masks, cfg, anchor, res)
        step = schur_step(sys, lam, lm_cfg.diag_floor)
        new_vals = retract_tree(vals, {"X": step["X"], "H": step["P"], "sp": step["sp"], "dp": step["dp"]})
        new_res = residuals(new_vals)
        new_err = total_error(new_res, specs)
        # a failed Cholesky (NaN step) must reject, not poison the state
        new_err = torch.where(torch.isfinite(new_err), new_err, torch.full_like(new_err, float("inf")))
        accept = new_err < err
        # ratchet only on a non-finite step, not on a divergent trial
        step_nan = ~(torch.isfinite(step["X"].sum()) & torch.isfinite(step["P"].sum()))
        lam_min = torch.where(step_nan, torch.maximum(lam_min, lam * lm_cfg.lambda_factor), lam_min)
        err_out = torch.where(accept, new_err, err)
        lam_out = torch.where(accept, torch.maximum(lam / lm_cfg.lambda_factor, lam_min),
                              torch.clamp(lam * lm_cfg.lambda_factor, max=lm_cfg.max_lambda))
        change = torch.abs(err - err_out)
        converged = accept & ((change < lm_cfg.rel_error_tol * torch.clamp(err, min=1e-30))
                              | (change < lm_cfg.abs_error_tol))
        done_t = converged | (lam_out >= lm_cfg.max_lambda)
        accepted, done = torch.stack([accept, done_t]).tolist()     # the iteration's one host read
        if accepted:
            vals, res = new_vals, new_res
        err, lam, rebuild, it = err_out, lam_out, accepted, it + 1
    return LMResult(values=vals, error=err, initial_error=err_init, iterations=it, lam=lam, converged=done)
