"""Factor residuals of the frontend refiners and the backend formulations
(port of `dynosam_tpu/ops/factors.py`).

Pose residuals use the [omega, v] tangent ordering of `core/lie.py`."""

from __future__ import annotations

import torch

from ..core.camera import CameraParams, backproject, project_local
from ..core.lie import SE3, se3_apply, se3_between, se3_compose, se3_inverse, se3_local, se3_log


def pose_to_point_residual(X: SE3, p_world: torch.Tensor, measured_local: torch.Tensor):
    """e = X^-1 p_w - z (gtsam PoseToPointFactor)."""
    return se3_apply(se3_inverse(X), p_world) - measured_local


def between_residual(a: SE3, b: SE3, measured: SE3):
    """e = Log(Z^-1 a^-1 b) (gtsam BetweenFactor)."""
    return se3_local(measured, se3_between(a, b))


def prior_residual(x: SE3, prior: SE3):
    """e = Log(prior^-1 x)."""
    return se3_local(prior, x)


def motion_smoothing_residual(H_prev: SE3, H_cur: SE3):
    """Constant-motion BetweenFactor(H_{k-1}, H_k, I) of the WorldMotion
    formulation."""
    return se3_log(se3_between(H_prev, H_cur))


def landmark_motion_ternary_residual(m_prev: torch.Tensor, m_cur: torch.Tensor, H: SE3):
    """e = m_{k-1} - H^-1 m_k (LandmarkMotionTernaryFactor)."""
    return m_prev - se3_apply(se3_inverse(H), m_cur)


def landmark_motion_pose_residual(m_prev: torch.Tensor, m_cur: torch.Tensor, L_prev: SE3, L_cur: SE3):
    """e = m_k - L_k L_{k-1}^-1 m_{k-1} (LandmarkMotionPoseFactor)."""
    return m_cur - se3_apply(se3_compose(L_cur, se3_inverse(L_prev)), m_prev)


def landmark_pose_smoothing_residual(L_km2: SE3, L_km1: SE3, L_k: SE3):
    """Constant-motion smoothing over an object pose triplet:
    Log((L_{k-1} L_{k-2}^-1)^-1 L_k L_{k-1}^-1)."""
    H_a = se3_compose(L_km1, se3_inverse(L_km2))
    H_b = se3_compose(L_k, se3_inverse(L_km1))
    return se3_log(se3_between(H_a, H_b))


def object_kinematic_residual(H: SE3, L_prev: SE3, L_cur: SE3):
    """e = Log(L_k^-1 H L_{k-1}) (ObjectKinematicFactor)."""
    return se3_log(se3_compose(se3_inverse(L_cur), se3_compose(H, L_prev)))


def flow_projection_residual(
    flow: torch.Tensor,
    X_cur: SE3,
    kp_prev: torch.Tensor,
    depth_prev: torch.Tensor,
    X_prev: SE3,
    cam: CameraParams,
):
    """e = (kp_{k-1} + flow) - pi(X_k^-1 X_{k-1} backproject(kp_{k-1}, d));
    returns (residual (..., 2), depth in the current camera (...,))."""
    p_world = se3_apply(X_prev, backproject(cam, kp_prev, depth_prev))
    p_cur = se3_apply(se3_inverse(X_cur), p_world)
    predicted, z = project_local(cam, p_cur)
    return (kp_prev + flow) - predicted, z


def reprojection_residual(X: SE3, p_world: torch.Tensor, uv: torch.Tensor, cam: CameraParams):
    """e = pi(X^-1 p_w) - uv; returns (e, depth)."""
    predicted, z = project_local(cam, se3_apply(se3_inverse(X), p_world))
    return predicted - uv, z
