"""Lens distortion models and undistortion (port of
`dynosam_tpu/core/distortion.py`, the analog of the reference's
`UndistorterRectifier`, `frontend/vision/UndistortRectifier.hpp:58`).

  * `distort_radtan` / `distort_equidistant`: normalized coords -> distorted
  * `undistort_points`: the fixed-iteration inverse cv::undistortPoints uses
  * `undistort_rectify_map` + `remap_bilinear`: dense image undistortion
    (the map is built once, applied per frame as one point sample)

Coefficients are Python floats, so the models run in the dtype of the
points on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .camera import CameraParams


class Distortion(NamedTuple):
    """Distortion coefficients; model 'radtan' (k1 k2 p1 p2) or
    'equidistant' (k1 k2 k3 k4)."""

    coeffs: tuple          # 4 floats
    model: str = "radtan"


def distort_radtan(xy: torch.Tensor, d) -> torch.Tensor:
    """Normalized (..., 2) -> distorted normalized coords (radtan/plumb-bob)."""
    k1, k2, p1, p2 = (float(c) for c in d)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def distort_equidistant(xy: torch.Tensor, d) -> torch.Tensor:
    """Kannala-Brandt equidistant (fisheye) model."""
    k1, k2, k3, k4 = (float(c) for c in d)
    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=1e-12))
    th = torch.arctan(r)
    th2 = th * th
    th_d = th * (1.0 + k1 * th2 + k2 * th2**2 + k3 * th2**3 + k4 * th2**4)
    scale = torch.where(r > 1e-8, th_d / r, torch.ones_like(r))
    return xy * scale[..., None]


def _distort(xy: torch.Tensor, dist: Distortion) -> torch.Tensor:
    if dist.model == "radtan":
        return distort_radtan(xy, dist.coeffs)
    if dist.model == "equidistant":
        return distort_equidistant(xy, dist.coeffs)
    raise ValueError(dist.model)


def _normalize(uv: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def _to_pixels(x: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    return torch.stack([x[..., 0] * cam.fx + cam.cx, x[..., 1] * cam.fy + cam.cy], dim=-1)


def undistort_points(uv: torch.Tensor, cam: CameraParams, dist: Distortion, iters: int = 8) -> torch.Tensor:
    """Distorted pixels -> undistorted pixels (same intrinsics): the
    fixed-point iteration x_{n+1} = x_d - (D(x_n) - x_n) of
    cv::undistortPoints, `iters` times."""
    xd = _normalize(uv, cam)
    x = xd
    for _ in range(iters):
        x = xd - (_distort(x, dist) - x)
    return _to_pixels(x, cam)


def distort_points(uv: torch.Tensor, cam: CameraParams, dist: Distortion) -> torch.Tensor:
    """Ideal (undistorted) pixels -> distorted pixels."""
    return _to_pixels(_distort(_normalize(uv, cam), dist), cam)


def pixel_grid(h: int, w: int, device=None) -> torch.Tensor:
    """(H * W, 2) float32 (x, y) of every pixel, row-major."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xx, yy], dim=-1).reshape(-1, 2)


def undistort_rectify_map(cam: CameraParams, dist: Distortion, device=None) -> torch.Tensor:
    """(H, W, 2) float32 map: for each undistorted pixel, where to sample
    the distorted image (built once per camera, like
    initUndistortRectifyMap)."""
    h, w = cam.height, cam.width
    return distort_points(pixel_grid(h, w, device), cam, dist).reshape(h, w, 2)


def remap_bilinear(img: torch.Tensor, mapping: torch.Tensor) -> torch.Tensor:
    """Apply an undistortion map to an (H, W) image with bilinear sampling
    (one K2 launch on the card)."""
    from ..ops.klt import bilinear_sample

    h, w = img.shape
    return bilinear_sample(img, mapping.reshape(-1, 2)).reshape(h, w)
