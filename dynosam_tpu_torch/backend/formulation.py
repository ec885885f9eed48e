"""Graph construction of the backend window, WorldMotion formulation
(port of `dynosam_tpu/backend/formulation.py`, updater 0).

Values {X_k, H_k^j, m^w_{i,k}}; factors PoseToPoint per static and dynamic
observation, LandmarkMotionTernary(m_{k-1}, m_k, H_k), Between(H_{k-1},
H_k, I) smoothing, frontend odometry and a prior anchoring the first pose.
The graph is the masked (frame x slot) grid: each factor family is one
dense batched residual with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.lie import SE3, se3_apply, se3_compose, se3_identity, se3_inverse, se3_where
from ..ops import factors
from ..utils.config import BackendConfig
from .map import WindowData
from .solver import RobustSpec


class WindowMasks(NamedTuple):
    """Factor-activation masks derived from a WindowData."""

    static_obs: torch.Tensor     # (W, NS) pose-to-point factors on static points
    dyn_obs: torch.Tensor        # (W, ND) pose-to-point factors on dynamic points
    ternary: torch.Tensor        # (W, ND) motion factor rows (k-1, k); row 0 False
    smoothing: torch.Tensor      # (W, O)  motion smoothing rows (k-1, k); row 0 False
    motion_active: torch.Tensor  # (W, O)  H_k^j participates in any factor
    odometry: torch.Tensor       # (W,)    odometry factor between k-1, k; row 0 False
    frame: torch.Tensor          # (W,)    frame has data


def shift_prev(x: torch.Tensor) -> torch.Tensor:
    """Row k of the result is row k-1 of x; row 0 is zero (False)."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)


def object_onehot(obj: torch.Tensor, no: int) -> torch.Tensor:
    """(..., no) bool one-hot of object slots; INVALID_ID (-1) gives a zero
    row, as `jax.nn.one_hot` does (`torch.nn.functional.one_hot` raises)."""
    return obj[..., None] == torch.arange(no, dtype=obj.dtype, device=obj.device)


def build_masks(w: WindowData, cfg: BackendConfig) -> WindowMasks:
    fvalid = w.frame_valid
    # static: obs valid & tracklet seen >= min_static times in the window
    s_valid = w.static_valid & fvalid[:, None]
    static_obs = s_valid & (s_valid.sum(0) >= cfg.min_static_observations)[None, :]

    # dynamic: labelled, seen >= min_dynamic times
    d_valid = w.dyn_valid & fvalid[:, None] & (w.dyn_obj >= 0)
    gated = d_valid & (d_valid.sum(0) >= cfg.min_dynamic_observations)[None, :]
    # ternary motion factor (k-1, k): both observations gated, same object
    same_obj = torch.cat([torch.zeros_like(gated[:1]), w.dyn_obj[1:] == w.dyn_obj[:-1]], dim=0)
    ternary = gated & shift_prev(gated) & same_obj

    no = w.motion_valid.shape[1]
    motion_active = object_onehot(torch.where(ternary, w.dyn_obj, -1), no).any(1)
    if cfg.use_smoothing_factor:
        smoothing = motion_active & shift_prev(motion_active)
    else:
        smoothing = torch.zeros_like(motion_active)
    odometry = fvalid & shift_prev(fvalid)
    if not cfg.use_vo_factor:
        odometry = torch.zeros_like(odometry)
    return WindowMasks(static_obs=static_obs, dyn_obs=gated, ternary=ternary, smoothing=smoothing,
                       motion_active=motion_active, odometry=odometry, frame=fvalid)


# --------------------------------------------------------------------------
# Initial values
# --------------------------------------------------------------------------


def _first_valid_world_point(xyz: torch.Tensor, valid: torch.Tensor, X: SE3) -> torch.Tensor:
    """(W, N, 3), (W, N), (W,) poses -> (N, 3): each tracklet's first valid
    observation taken to the world by its frame's pose (0 where none)."""
    W = valid.shape[0]
    world = se3_apply(X[:, None], xyz)                          # (W, N, 3)
    rows = torch.arange(W, device=valid.device)[:, None]
    first = torch.where(valid, rows, W).amin(0)                 # (N,)
    pts = torch.gather(world, 0, first.clamp(max=W - 1)[None, :, None].expand(1, -1, 3))[0]
    return torch.where((first < W)[:, None], pts, torch.zeros_like(pts))


def init_values(w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                prev: Optional[dict] = None, prev_mask: Optional[dict] = None) -> dict:
    """Linearisation point of a window: X from frontend odometry, H identity
    (`init_H_with_identity`) or the frontend motions, points through the
    frontend poses; `prev` overrides wherever `prev_mask` is set (the
    sliding-window warm start)."""
    X = w.X_init
    if cfg.init_H_with_identity:
        H = se3_identity(w.motion_init.batch_shape, w.motion_init.dtype, w.motion_init.t.device)
    else:
        H = w.motion_init
    sp = _first_valid_world_point(w.static_xyz, masks.static_obs, X)
    dp = se3_apply(X[:, None], w.dyn_xyz)                       # (W, ND, 3)
    dp = torch.where(masks.dyn_obs[..., None], dp, torch.zeros_like(dp))
    vals = {"X": X, "H": H, "sp": sp, "dp": dp}
    if prev is None:
        return vals

    def merge(new, old, m):
        if isinstance(new, SE3):
            return se3_where(m, old, new)
        return torch.where(m[..., None], old, new)

    return {k: merge(vals[k], prev[k], prev_mask[k]) for k in vals}


# --------------------------------------------------------------------------
# Residual families
# --------------------------------------------------------------------------


class FamilySpec(NamedTuple):
    names: tuple
    robust: tuple


def world_motion_families(cfg: BackendConfig) -> FamilySpec:
    return FamilySpec(
        names=("anchor", "odometry", "static_obs", "dyn_obs", "ternary", "smoothing"),
        robust=(RobustSpec(), RobustSpec(), RobustSpec("huber", cfg.huber_k_static),
                RobustSpec("huber", cfg.huber_k_dynamic), RobustSpec("huber", cfg.huber_k_dynamic),
                RobustSpec()),
    )


def pose_sigmas(cfg: BackendConfig, dtype, device):
    """(odometry, smoothing) sigmas as (6,) [rotation x3, translation x3],
    filled on the device (a tensor from a Python list would be a
    host-to-device copy, which waits for the device)."""
    def six(rot, trans):
        return torch.cat([torch.full((3,), rot, dtype=dtype, device=device),
                          torch.full((3,), trans, dtype=dtype, device=device)])

    return (six(cfg.odometry_rotation_sigma, cfg.odometry_translation_sigma),
            six(cfg.constant_object_motion_rotation_sigma, cfg.constant_object_motion_translation_sigma))


def odometry_measurements(w: WindowData) -> SE3:
    """(W-1,) frontend relative poses X_{k-1}^-1 X_k."""
    return se3_compose(se3_inverse(w.X_init[:-1]), w.X_init[1:])


def select_motions(H: SE3, obj: torch.Tensor, active: torch.Tensor):
    """Per-(frame, track) motion H_k^{obj} where `active`, identity
    elsewhere; also the (W, ND, O) float one-hot of the selection."""
    no = H.batch_shape[1]
    onehot = object_onehot(torch.where(active, obj, -1), no)
    sel = onehot.any(-1)
    idx = obj.clamp(min=0).long()
    R = torch.gather(H.R, 1, idx[..., None, None].expand(-1, -1, 3, 3))
    t = torch.gather(H.t, 1, idx[..., None].expand(-1, -1, 3))
    eye = torch.eye(3, dtype=H.t.dtype, device=H.t.device)
    R = torch.where(sel[..., None, None], R, eye)
    t = torch.where(sel[..., None], t, torch.zeros_like(t))
    return SE3(R, t), onehot.to(H.t.dtype)


def world_motion_residuals(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                           anchor: Optional[SE3] = None) -> list:
    """The six residual families, whitened and masked:
    [anchor (1, 6), odometry (W-1, 6), static (W, NS, 3), dynamic (W, ND, 3),
    ternary (W-1, ND, 3), smoothing (W-1, O, 6)]."""
    X: SE3 = values["X"]
    H: SE3 = values["H"]
    sp, dp = values["sp"], values["dp"]
    pose_sigma, smooth_sigma = pose_sigmas(cfg, sp.dtype, sp.device)
    zero = torch.zeros((), dtype=sp.dtype, device=sp.device)

    anchor_pose = anchor if anchor is not None else w.X_init[0]
    r_anchor = factors.prior_residual(X[0], anchor_pose)[None, :] / cfg.initial_pose_prior_sigma

    r_odo = factors.between_residual(X[:-1], X[1:], odometry_measurements(w)) / pose_sigma
    r_odo = torch.where(masks.odometry[1:, None], r_odo, zero)

    r_static = factors.pose_to_point_residual(X[:, None], sp[None], w.static_xyz)
    r_static = torch.where(masks.static_obs[..., None], r_static / cfg.static_point_noise_sigma, zero)

    r_dyn = factors.pose_to_point_residual(X[:, None], dp, w.dyn_xyz)
    r_dyn = torch.where(masks.dyn_obs[..., None], r_dyn / cfg.dynamic_point_noise_sigma, zero)

    Hk, _ = select_motions(H, w.dyn_obj, masks.ternary | masks.dyn_obs)
    r_tern = factors.landmark_motion_ternary_residual(dp[:-1], dp[1:], Hk[1:])
    r_tern = torch.where(masks.ternary[1:, ..., None],
                         r_tern / cfg.motion_ternary_factor_noise_sigma, zero)

    r_smooth = factors.motion_smoothing_residual(H[:-1], H[1:]) / smooth_sigma
    r_smooth = torch.where(masks.smoothing[1:, ..., None], r_smooth, zero)
    return [r_anchor, r_odo, r_static, r_dyn, r_tern, r_smooth]


# --------------------------------------------------------------------------
# Analytic Gauss-Newton diagonal (damping + Jacobi preconditioner)
# --------------------------------------------------------------------------


def _skew_sq_diag(y: torch.Tensor) -> torch.Tensor:
    """diag(hat(y)^T hat(y)) = (y_y^2+y_z^2, y_x^2+y_z^2, y_x^2+y_y^2)."""
    x2, y2, z2 = y[..., 0] ** 2, y[..., 1] ** 2, y[..., 2] ** 2
    return torch.stack([y2 + z2, x2 + z2, x2 + y2], dim=-1)


def world_motion_gn_diag(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks,
                         cfg: BackendConfig) -> dict:
    """Exact-to-leading-order diag(J^T W J) of the WorldMotion families,
    in the JAX package's arithmetic: pose-to-point Jacobians [hat(y) | -I]
    with y the measured local point, orthonormal point Jacobians, and
    1/sigma^2 per component for the pose-pose factors.  Family order is
    that of `world_motion_residuals`."""
    dtype, dev = values["sp"].dtype, values["sp"].device
    W_, O = masks.smoothing.shape
    w_anchor, w_odo, w_static, w_dyn, w_tern, w_smooth = [s ** 2 for s in sqrt_w]
    pose_sig, smooth_sig = pose_sigmas(cfg, dtype, dev)

    # X (W, 6)
    dX = torch.zeros((W_, 6), dtype=dtype, device=dev)
    dX[0] += w_anchor[0] / cfg.initial_pose_prior_sigma ** 2
    odo_w = (w_odo * masks.odometry[1:].to(dtype))[:, None] / pose_sig ** 2
    dX[:-1] += odo_w
    dX[1:] += odo_w
    ws = w_static * masks.static_obs.to(dtype) / cfg.static_point_noise_sigma ** 2
    wd = w_dyn * masks.dyn_obs.to(dtype) / cfg.dynamic_point_noise_sigma ** 2
    for wgt, xyz in ((ws, w.static_xyz), (wd, w.dyn_xyz)):
        rot = torch.einsum("kn,knd->kd", wgt, _skew_sq_diag(xyz))
        dX = dX + torch.cat([rot, wgt.sum(1)[:, None].expand(-1, 3)], dim=-1)

    # sp (NS, 3), dp (W, ND, 3): orthonormal point Jacobians
    dsp = ws.sum(0)[:, None].expand(-1, 3)
    wt = w_tern * masks.ternary[1:].to(dtype) / cfg.motion_ternary_factor_noise_sigma ** 2   # (W-1, ND)
    ddp = wd[..., None].expand(-1, -1, 3).clone()
    ddp[:-1] += wt[..., None]                   # m_{k-1} slot (identity J)
    ddp[1:] += wt[..., None]                    # m_k slot (rotation J)

    # H (W, O, 6): ternary J_H = -[hat(y) | -I], y = H^-1 m_k ~ m_{k-1}
    onehot = object_onehot(torch.where(masks.ternary[1:], w.dyn_obj[1:], -1), O).to(dtype)
    rot_H = torch.einsum("kn,kno,knd->kod", wt, onehot, _skew_sq_diag(values["dp"][:-1]))
    trans_H = torch.einsum("kn,kno->ko", wt, onehot)[..., None].expand(-1, -1, 3)
    dH = torch.zeros((W_, O, 6), dtype=dtype, device=dev)
    dH[1:] += torch.cat([rot_H, trans_H], dim=-1)
    sm_w = (w_smooth * masks.smoothing[1:].to(dtype))[..., None] / smooth_sig ** 2
    dH[:-1] += sm_w
    dH[1:] += sm_w
    return {"X": dX, "H": dH, "sp": dsp, "dp": ddp}
