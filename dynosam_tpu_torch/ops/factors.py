"""Factor residuals used by the frontend refiners (port of the matching
functions of `dynosam_tpu/ops/factors.py`)."""

from __future__ import annotations

import torch

from ..core.camera import CameraParams, backproject, project_local
from ..core.lie import SE3, se3_apply, se3_inverse


def landmark_motion_ternary_residual(m_prev: torch.Tensor, m_cur: torch.Tensor, H: SE3):
    """e = m_{k-1} - H^-1 m_k (LandmarkMotionTernaryFactor)."""
    return m_prev - se3_apply(se3_inverse(H), m_cur)


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
