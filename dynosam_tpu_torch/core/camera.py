"""Batched pinhole camera model (port of `dynosam_tpu/core/camera.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import SE3, se3_apply, se3_inverse


class CameraParams(NamedTuple):
    """Pinhole intrinsics (zero skew).  fx, fy, cx, cy are Python floats so
    they broadcast against tensors on any device; width/height are ints."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, width=0, height=0) -> "CameraParams":
        return CameraParams(
            float(fx), float(fy), float(cx), float(cy), int(width), int(height)
        )


class StereoParams(NamedTuple):
    """Rectified stereo rig: left pinhole + baseline (metres)."""

    left: CameraParams
    baseline: float


def project_local(params: CameraParams, p_cam: torch.Tensor, eps: float = 1e-9):
    """Camera-frame points (..., 3) -> (uv (..., 2), depth (...,)).  Points
    behind the camera give a negative depth; callers mask on it."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zs = torch.where(
        torch.abs(z) < eps,
        torch.where(z < 0, torch.full_like(z, -eps), torch.full_like(z, eps)),
        z,
    )
    u = params.fx * x / zs + params.cx
    v = params.fy * y / zs + params.cy
    return torch.stack([u, v], dim=-1), z


def project(params: CameraParams, pose_w_c: SE3, p_world: torch.Tensor):
    """World points through the camera at pose ``X_wc`` (camera-to-world)."""
    return project_local(params, se3_apply(se3_inverse(pose_w_c), p_world))


def backproject(
    params: CameraParams, uv: torch.Tensor, depth: torch.Tensor
) -> torch.Tensor:
    """Pixels (..., 2) + metric depth (...,) -> camera-frame points (..., 3)."""
    u, v = uv[..., 0], uv[..., 1]
    x = (u - params.cx) / params.fx * depth
    y = (v - params.cy) / params.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project_jacobian_point(params: CameraParams, p_cam: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(p_cam): (..., 2, 3)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = params.fx, params.fy
    zr = torch.zeros_like(x)
    row_u = torch.stack([fx * iz, zr, -fx * x * iz2], dim=-1)
    row_v = torch.stack([zr, fy * iz, -fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def project_jacobian_pose(params: CameraParams, p_cam: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(xi) for uv = pi(Exp(-xi) X^-1 p_w), xi = [w, v] on the pose:
    (..., 2, 6)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy = params.fx, params.fy
    zr = torch.zeros_like(x)
    ru = torch.stack(
        [
            fx * x * y * iz2,
            -fx * (1.0 + x * x * iz2),
            fx * y * iz,
            -fx * iz,
            zr,
            fx * x * iz2,
        ],
        dim=-1,
    )
    rv = torch.stack(
        [
            fy * (1.0 + y * y * iz2),
            -fy * x * y * iz2,
            -fy * x * iz,
            zr,
            -fy * iz,
            fy * y * iz2,
        ],
        dim=-1,
    )
    return torch.stack([ru, rv], dim=-2)


def camera_params_from_yaml(path: str) -> CameraParams:
    """Pinhole intrinsics from a CameraParams.yaml-style file
    (`Camera.fx/fy/cx/cy/width/height` keys, the reference's
    `CameraParams::fromYamlFile` surface)."""
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f) or {}

    def get(*keys, default=None):
        for k in keys:
            if k in y:
                return y[k]
        return default

    return CameraParams.create(
        get("Camera.fx", "fx"), get("Camera.fy", "fy"), get("Camera.cx", "cx"), get("Camera.cy", "cy"),
        int(get("Camera.width", "width", default=0)), int(get("Camera.height", "height", default=0)),
    )


def distortion_from_yaml(path: str):
    """Optional lens distortion from the same CameraParams.yaml surface
    (`Camera.distortion_coefficients` + `Camera.distortion_model`, the
    reference's `CameraParams::fromYamlFile` distortion block): a
    `core.distortion.Distortion`, or None when the rig is rectified (absent
    or all-zero coefficients).  Coefficients are rounded to float32, as the
    JAX package stores them."""
    import numpy as np
    import yaml

    from .distortion import Distortion

    with open(path) as f:
        y = yaml.safe_load(f) or {}
    coeffs = y.get("Camera.distortion_coefficients", y.get("distortion_coefficients"))
    if coeffs is None or not any(float(c) != 0.0 for c in coeffs):
        return None
    model = str(y.get("Camera.distortion_model", y.get("distortion_model", "radtan")))
    if model in ("plumb_bob", "radial-tangential", "radial_tangential"):
        model = "radtan"
    c = np.zeros(4, np.float32)
    c[: min(4, len(coeffs))] = [float(x) for x in coeffs[:4]]
    return Distortion(coeffs=tuple(float(x) for x in c), model=model)
