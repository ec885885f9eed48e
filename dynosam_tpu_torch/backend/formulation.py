"""Graph construction of the backend window (port of
`dynosam_tpu/backend/formulation.py`), both formulations:

  * WorldMotion (updater 0): values {X_k, H_k^j, m^w_{i,k}}; factors
    PoseToPoint per static and dynamic observation,
    LandmarkMotionTernary(m_{k-1}, m_k, H_k), Between(H_{k-1}, H_k, I)
    smoothing;
  * WorldPose (updater 1): values {X_k, L_k^j, m^w_{i,k}}; factors
    PoseToPoint, LandmarkMotionPose(m_{k-1}, m_k, L_{k-1}, L_k),
    LandmarkPoseSmoothing on L triplets and the optional ObjectKinematic
    factor;

both with frontend odometry and a prior anchoring the first pose
(isotropic, or the fixed-lag boundary marginal in square-root form).
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
    return _merge_prev({"X": X, "H": H, "sp": sp, "dp": dp}, prev, prev_mask)


def init_values_world_pose(w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                           prev: Optional[dict] = None, prev_mask: Optional[dict] = None) -> dict:
    """WorldPose linearisation point: L from the frontend-propagated object
    poses, X and points as `init_values`; `prev` (keys X, L, sp, dp)
    overrides wherever `prev_mask` is set."""
    vals = init_values(w, masks, cfg)
    return _merge_prev({"X": vals["X"], "L": w.obj_pose_init, "sp": vals["sp"], "dp": vals["dp"]},
                       prev, prev_mask)


def _merge_prev(vals: dict, prev: Optional[dict], prev_mask: Optional[dict]) -> dict:
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


def pose_key(updater: int) -> str:
    """The per-object value of a formulation: H (updater 0) or L (1)."""
    return "H" if updater == 0 else "L"


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
    """Per-(frame, track) object value (motion H_k^{obj} or pose
    L_k^{obj}) where `active`, identity elsewhere; also the (W, ND, O)
    float one-hot of the selection."""
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


def world_pose_families(cfg: BackendConfig) -> FamilySpec:
    names = ["anchor", "odometry", "static_obs", "dyn_obs", "motion_pose", "pose_smoothing"]
    robust = [RobustSpec(), RobustSpec(), RobustSpec("huber", cfg.huber_k_static),
              RobustSpec("huber", cfg.huber_k_dynamic), RobustSpec("huber", cfg.huber_k_dynamic), RobustSpec()]
    if cfg.use_object_kinematic_factor:
        names.append("kinematic")
        robust.append(RobustSpec())
    return FamilySpec(names=tuple(names), robust=tuple(robust))


def _camera_point_residuals(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                            anchor: Optional[SE3], anchor_prior_L: Optional[torch.Tensor]) -> list:
    """The families both formulations share: [anchor (1, 6), odometry
    (W-1, 6), static (W, NS, 3), dynamic (W, ND, 3)].  The anchor is
    whitened by 1 / `initial_pose_prior_sigma`, or by the transposed
    Cholesky factor `anchor_prior_L` (6, 6) of a full-information prior
    (the fixed-lag boundary marginal)."""
    X: SE3 = values["X"]
    sp, dp = values["sp"], values["dp"]
    pose_sigma, _ = pose_sigmas(cfg, sp.dtype, sp.device)
    zero = torch.zeros((), dtype=sp.dtype, device=sp.device)

    anchor_pose = anchor if anchor is not None else w.X_init[0]
    r_anchor = factors.prior_residual(X[0], anchor_pose)
    if anchor_prior_L is None:
        r_anchor = r_anchor[None, :] / cfg.initial_pose_prior_sigma
    else:
        r_anchor = (anchor_prior_L.T @ r_anchor)[None, :]

    r_odo = factors.between_residual(X[:-1], X[1:], odometry_measurements(w)) / pose_sigma
    r_odo = torch.where(masks.odometry[1:, None], r_odo, zero)

    r_static = factors.pose_to_point_residual(X[:, None], sp[None], w.static_xyz)
    r_static = torch.where(masks.static_obs[..., None], r_static / cfg.static_point_noise_sigma, zero)

    r_dyn = factors.pose_to_point_residual(X[:, None], dp, w.dyn_xyz)
    r_dyn = torch.where(masks.dyn_obs[..., None], r_dyn / cfg.dynamic_point_noise_sigma, zero)
    return [r_anchor, r_odo, r_static, r_dyn]


def world_motion_residuals(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                           anchor: Optional[SE3] = None, anchor_prior_L: Optional[torch.Tensor] = None) -> list:
    """The six WorldMotion families, whitened and masked: the shared four
    of `_camera_point_residuals`, ternary (W-1, ND, 3) and smoothing
    (W-1, O, 6)."""
    H: SE3 = values["H"]
    dp = values["dp"]
    _, smooth_sigma = pose_sigmas(cfg, dp.dtype, dp.device)
    zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
    shared = _camera_point_residuals(values, w, masks, cfg, anchor, anchor_prior_L)

    Hk, _ = select_motions(H, w.dyn_obj, masks.ternary | masks.dyn_obs)
    r_tern = factors.landmark_motion_ternary_residual(dp[:-1], dp[1:], Hk[1:])
    r_tern = torch.where(masks.ternary[1:, ..., None],
                         r_tern / cfg.motion_ternary_factor_noise_sigma, zero)

    r_smooth = factors.motion_smoothing_residual(H[:-1], H[1:]) / smooth_sigma
    r_smooth = torch.where(masks.smoothing[1:, ..., None], r_smooth, zero)
    return shared + [r_tern, r_smooth]


def pose_triple(masks: WindowMasks) -> torch.Tensor:
    """(W-2, O) pose-smoothing triplets (k-2, k-1, k): three consecutive
    active frames of the object."""
    return masks.smoothing[1:-1] & masks.smoothing[2:]


def kinematic_mask(w: WindowData, masks: WindowMasks) -> torch.Tensor:
    """(W-1, O) ObjectKinematic factor rows (k-1, k)."""
    return masks.smoothing[1:] & w.motion_valid[1:]


def world_pose_residuals(values: dict, w: WindowData, masks: WindowMasks, cfg: BackendConfig,
                         anchor: Optional[SE3] = None, anchor_prior_L: Optional[torch.Tensor] = None) -> list:
    """The WorldPose families, whitened and masked: the shared four,
    motion-pose (W-1, ND, 3), pose smoothing on triplets (W-2, O, 6) and,
    with `use_object_kinematic_factor`, kinematic (W-1, O, 6) against the
    frontend's measured motions."""
    L: SE3 = values["L"]
    dp = values["dp"]
    _, smooth_sigma = pose_sigmas(cfg, dp.dtype, dp.device)
    zero = torch.zeros((), dtype=dp.dtype, device=dp.device)
    out = _camera_point_residuals(values, w, masks, cfg, anchor, anchor_prior_L)

    Lk, _ = select_motions(L, w.dyn_obj, masks.ternary | masks.dyn_obs)
    r_mp = factors.landmark_motion_pose_residual(dp[:-1], dp[1:], Lk[:-1], Lk[1:])
    out.append(torch.where(masks.ternary[1:, ..., None], r_mp / cfg.motion_ternary_factor_noise_sigma, zero))

    r_ps = factors.landmark_pose_smoothing_residual(L[:-2], L[1:-1], L[2:]) / smooth_sigma
    out.append(torch.where(pose_triple(masks)[..., None], r_ps, zero))

    if cfg.use_object_kinematic_factor:
        r_kin = factors.object_kinematic_residual(w.motion_init[1:], L[:-1], L[1:]) / cfg.object_kinematic_sigma
        out.append(torch.where(kinematic_mask(w, masks)[..., None], r_kin, zero))
    return out


# --------------------------------------------------------------------------
# Analytic Gauss-Newton diagonal (damping + Jacobi preconditioner)
# --------------------------------------------------------------------------


def _skew_sq_diag(y: torch.Tensor) -> torch.Tensor:
    """diag(hat(y)^T hat(y)) = (y_y^2+y_z^2, y_x^2+y_z^2, y_x^2+y_y^2)."""
    x2, y2, z2 = y[..., 0] ** 2, y[..., 1] ** 2, y[..., 2] ** 2
    return torch.stack([y2 + z2, x2 + z2, x2 + y2], dim=-1)


def _camera_point_diag(sqrt_w: list, w: WindowData, masks: WindowMasks, cfg: BackendConfig):
    """The shared families' part of diag(J^T W J): X (W, 6) from the anchor,
    odometry and pose-to-point factors (Jacobians [hat(y) | -I], y the
    measured local point), sp (NS, 3) and the observation part of dp
    (W, ND, 3) (orthonormal point Jacobians)."""
    w_anchor, w_odo, w_static, w_dyn = [s ** 2 for s in sqrt_w[:4]]
    dtype, dev = w_static.dtype, w_static.device
    W_ = masks.frame.shape[0]
    pose_sig, _ = pose_sigmas(cfg, dtype, dev)
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
    return dX, ws.sum(0)[:, None].expand(-1, 3), wd[..., None].expand(-1, -1, 3).clone()


def world_motion_gn_diag(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks,
                         cfg: BackendConfig) -> dict:
    """Exact-to-leading-order diag(J^T W J) of the WorldMotion families,
    in the JAX package's arithmetic: pose-to-point Jacobians [hat(y) | -I]
    with y the measured local point, orthonormal point Jacobians, and
    1/sigma^2 per component for the pose-pose factors.  Family order is
    that of `world_motion_residuals`."""
    dtype, dev = values["sp"].dtype, values["sp"].device
    W_, O = masks.smoothing.shape
    w_tern, w_smooth = [s ** 2 for s in sqrt_w[4:]]
    _, smooth_sig = pose_sigmas(cfg, dtype, dev)
    dX, dsp, ddp = _camera_point_diag(sqrt_w, w, masks, cfg)

    wt = w_tern * masks.ternary[1:].to(dtype) / cfg.motion_ternary_factor_noise_sigma ** 2   # (W-1, ND)
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


def world_pose_gn_diag(values: dict, sqrt_w: list, w: WindowData, masks: WindowMasks,
                       cfg: BackendConfig) -> dict:
    """diag(J^T W J) of the WorldPose families in the JAX package's
    arithmetic: the camera and point parts of `world_motion_gn_diag`; the
    motion-pose factor's pose Jacobians [R hat(z) | -R], z the point in
    the object frame approximated by the world point minus the object
    translation, add skew-sq-diag(z) and 1 per component to both L_{k-1}
    and L_k; pose-smoothing triplets and kinematic pairs add 1/sigma^2 per
    component to each of their poses."""
    L: SE3 = values["L"]
    dp = values["dp"]
    dtype, dev = dp.dtype, dp.device
    W_, O = masks.smoothing.shape
    w_mp, w_ps, *w_rest = [s ** 2 for s in sqrt_w[4:]]
    _, smooth_sig = pose_sigmas(cfg, dtype, dev)
    dX, dsp, ddp = _camera_point_diag(sqrt_w, w, masks, cfg)

    wm = w_mp * masks.ternary[1:].to(dtype) / cfg.motion_ternary_factor_noise_sigma ** 2   # (W-1, ND)
    ddp[:-1] += wm[..., None]
    ddp[1:] += wm[..., None]

    onehot = object_onehot(torch.where(masks.ternary[1:], w.dyn_obj[1:], -1), O).to(dtype)   # (W-1, ND, O)
    z = dp[:-1] - torch.einsum("kno,kod->knd", onehot, L.t[:-1])
    rot_L = torch.einsum("kn,kno,knd->kod", wm, onehot, _skew_sq_diag(z))
    trans_L = torch.einsum("kn,kno->ko", wm, onehot)[..., None].expand(-1, -1, 3)
    contrib = torch.cat([rot_L, trans_L], dim=-1)
    dL = torch.zeros((W_, O, 6), dtype=dtype, device=dev)
    dL[:-1] += contrib
    dL[1:] += contrib
    ps_w = (w_ps * pose_triple(masks).to(dtype))[..., None] / smooth_sig ** 2
    dL[:-2] += ps_w
    dL[1:-1] += ps_w
    dL[2:] += ps_w
    if cfg.use_object_kinematic_factor and w_rest:
        kin_w = (w_rest[0] * kinematic_mask(w, masks).to(dtype))[..., None] / cfg.object_kinematic_sigma ** 2
        dL[:-1] += kin_w
        dL[1:] += kin_w
    return {"X": dX, "L": dL, "sp": dsp, "dp": ddp}
