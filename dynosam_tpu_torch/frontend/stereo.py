"""Dense stereo depth (port of `dynosam_tpu/frontend/stereo.py`): the
framework component behind the reference's `StereoCamera` +
`StereoMatcher::denseStereoReconstruction` (`common/StereoCamera.hpp:38`,
used by the ClusterSLAM provider, `ClusterSlamDataProvider.cc:298-318`).

  * `block_match`: the plane-sweep block matcher of the JAX package's
    `block_match_jax`, in plain PyTorch on the tensors' device: SAD over
    D disparity hypotheses, (2r+1)^2 box costs, winner by argmin, a
    uniqueness test against the second best outside d +- 1, and a
    sub-pixel parabola.  The cost volume (D, H, W) float32 is the one full
    volume held; shifted images and SADs are made a chunk of disparities
    at a time.
  * `sgbm_cv2`: OpenCV SGBM on the host (the reference's engine).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.camera import StereoParams

_CHUNK = 8   # disparities per chunk of shifted images and SADs


class StereoResult(NamedTuple):
    disparity: torch.Tensor   # (H, W) float, <= 0 invalid
    depth: torch.Tensor       # (H, W) float metric, 0 invalid


def _box(x: torch.Tensor, r: int) -> torch.Tensor:
    """Sum over the (2r+1)^2 window centred on each pixel of (..., H, W),
    zeros outside (separable: rows, then columns)."""
    h, w = x.shape[-2:]
    p = F.pad(x, (0, 0, r, r))
    y = p[..., 0:h, :]
    for i in range(1, 2 * r + 1):
        y = y + p[..., i:i + h, :]
    p = F.pad(y, (r, r, 0, 0))
    z = p[..., :, 0:w]
    for i in range(1, 2 * r + 1):
        z = z + p[..., :, i:i + w]
    return z


def block_match(left: torch.Tensor, right: torch.Tensor, max_disparity: int = 64, block_radius: int = 3,
                uniqueness: float = 0.95) -> torch.Tensor:
    """SAD plane sweep: (H, W) disparity, -1 where invalid.  Disparity d
    matches left[y, x] with right[y, x - d] (clamped at the border)."""
    h, w = left.shape
    dev = left.device
    xs = torch.arange(w, device=dev)
    cost = torch.empty((max_disparity, h, w), dtype=left.dtype, device=dev)
    for d0 in range(0, max_disparity, _CHUNK):
        ds = torch.arange(d0, min(d0 + _CHUNK, max_disparity), device=dev)
        cols = torch.clamp(xs[None, :] - ds[:, None], 0, w - 1)             # (c, W)
        shifted = right[:, cols].permute(1, 0, 2)                           # (c, H, W)
        cost[d0:d0 + len(ds)] = _box(torch.abs(shifted - left[None]), block_radius)
    cmin, best = torch.min(cost, dim=0)          # the first minimum, as argmin
    # uniqueness: the second best outside best +- 1 must be clearly worse
    c2 = torch.full_like(cmin, float("inf"))
    for d0 in range(0, max_disparity, _CHUNK):
        ds = torch.arange(d0, min(d0 + _CHUNK, max_disparity), device=dev)
        near = torch.abs(ds[:, None, None] - best[None]) <= 1
        c2 = torch.minimum(c2, torch.where(near, float("inf"), cost[d0:d0 + len(ds)]).amin(0))
    ok = (cmin < uniqueness * c2) & (best > 0) & (xs[None, :] >= best)
    # sub-pixel parabola
    dm = torch.clamp(best, 1, max_disparity - 2)
    c_prev = torch.gather(cost, 0, (dm - 1)[None])[0]
    c_0 = torch.gather(cost, 0, dm[None])[0]
    c_next = torch.gather(cost, 0, (dm + 1)[None])[0]
    denom = torch.clamp(c_prev - 2 * c_0 + c_next, min=1e-6)
    delta = torch.clamp(0.5 * (c_prev - c_next) / denom, -0.5, 0.5)
    return torch.where(ok, dm.to(left.dtype) + delta, torch.full_like(delta, -1.0))


def disparity_to_depth(disp: torch.Tensor, stereo: StereoParams) -> torch.Tensor:
    # fx * baseline as one float32 product, as the JAX package forms it
    fxb = float(np.float32(stereo.left.fx) * np.float32(stereo.baseline))
    safe = torch.clamp(disp, min=1e-6)
    # a true division (`scalar / tensor` multiplies by the reciprocal)
    return torch.where(disp > 0, torch.full_like(safe, fxb) / safe, torch.zeros_like(disp))


def dense_stereo(left: torch.Tensor, right: torch.Tensor, stereo: StereoParams,
                 max_disparity: int = 64) -> StereoResult:
    disp = block_match(left, right, max_disparity=max_disparity)
    return StereoResult(disparity=disp, depth=disparity_to_depth(disp, stereo))


def sgbm_cv2(left, right, stereo: StereoParams, max_disparity: int = 128) -> StereoResult:
    """Host-side OpenCV SGBM (the reference's engine); CPU tensors."""
    import cv2

    sg = cv2.StereoSGBM_create(minDisparity=0, numDisparities=max_disparity, blockSize=7,
                               P1=8 * 49, P2=32 * 49, uniquenessRatio=10)
    disp = sg.compute(np.asarray(left, np.uint8), np.asarray(right, np.uint8)).astype(np.float32) / 16.0
    disp_t = torch.as_tensor(np.where(disp > 0.5, disp, -1.0).astype(np.float32))
    return StereoResult(disparity=disp_t, depth=disparity_to_depth(disp_t, stereo))
