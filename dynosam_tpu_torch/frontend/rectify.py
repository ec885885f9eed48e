"""Image undistortion / rectification pre-pass (port of
`dynosam_tpu/frontend/rectify.py`, the analog of the reference's
`UndistorterRectifier`, `frontend/vision/UndistortRectifier.hpp:58`: build
the remap once per camera, remap every incoming frame before tracking).

The JAX package runs this step on the host because a dense gather
serialises on the TPU; here it runs on the rectifier's device, where gray,
flow and depth of a frame are one launch of kernel K2 over the H * W map
points.  The mask is gathered by the same rounded index where it lies: a
loader's host mask stays on the host, so that a host-side relabeller
(ByteTrack, `pipeline.DynoPipeline`) reads no device memory.

Channel semantics:
  * gray: bilinear resample through the undistortion map;
  * depth / mask: nearest neighbour (bilinear across a depth edge or an
    instance-id boundary fabricates values);
  * flow: resampled and vector-corrected: dense flow on the distorted grid
    maps distorted k-pixels to distorted k+1-positions, so the rectified
    flow is U(M(u_r) + flow_d(M(u_r))) - u_r, with M the rectified ->
    distorted map and U the iterative point undistortion;
  * pixels whose source falls outside the distorted image get depth 0
    (invalid), mask 0 (background) and flow 0.
"""

from __future__ import annotations

import torch

from ..core.camera import CameraParams
from ..core.distortion import Distortion, pixel_grid, undistort_points, undistort_rectify_map
from ..ops.klt import sample_channels
from ..utils.device import resolve_device
from .frontend import FrameImages, to_device


def make_rectifier(cam: CameraParams, dist: Distortion, device=None):
    """The per-camera rectifier, FrameImages -> FrameImages on `device`
    (the card unless the caller asks for another), but for the mask, which
    stays on its own device.  The map is built once in float32; per frame,
    gray, both flow planes and depth are sampled in one K2 launch
    (bilinear, bilinear, bilinear, nearest: the nearest mode rounds half to
    even and clamps, the JAX package's rounded index), and the mask is
    gathered by that same index."""
    dev = resolve_device(device)
    flat = undistort_rectify_map(cam, dist, dev).reshape(-1, 2).contiguous()
    h, w = cam.height, cam.width
    inside = (
        (flat[:, 0] >= 0.0) & (flat[:, 0] <= w - 1.0)
        & (flat[:, 1] >= 0.0) & (flat[:, 1] <= h - 1.0)
    )
    grid_r = pixel_grid(h, w, dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    # the mask's source pixel per map point (K2's nearest index), -1 outside
    near = (torch.clamp(torch.round(flat[:, 1]), 0, h - 1) * w
            + torch.clamp(torch.round(flat[:, 0]), 0, w - 1)).long()
    near = torch.where(inside, near, -1)
    near_on = {near.device: near}

    def rectify_mask(mask: torch.Tensor) -> torch.Tensor:
        if mask.device not in near_on:
            near_on[mask.device] = near.to(mask.device)
        idx = near_on[mask.device]
        out = mask.reshape(-1).to(torch.int32)[idx.clamp(min=0)]
        return torch.where(idx >= 0, out, torch.zeros_like(out)).reshape(h, w)

    def rectify(images: FrameImages) -> FrameImages:
        mask = images.mask
        images = to_device(images._replace(mask=None), dev)
        gray, fx_d, fy_d, depth = sample_channels(
            (images.gray, *images.flow.unbind(-1), images.depth),
            ("bilinear", "bilinear", "bilinear", "nearest"), flat,
        )
        dest_r = undistort_points(flat + torch.stack([fx_d, fy_d], dim=-1), cam, dist)
        flow = torch.where(inside[:, None], dest_r - grid_r, zero)
        return FrameImages(
            gray=gray.reshape(h, w),
            depth=torch.where(inside, depth, zero.to(depth.dtype)).reshape(h, w),
            flow=flow.reshape(h, w, 2),
            mask=rectify_mask(mask),
        )

    return rectify
