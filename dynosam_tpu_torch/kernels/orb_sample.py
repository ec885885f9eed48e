"""K4 — ORB orientation and steered-BRIEF sampling at keypoints.

Replaces the Pallas kernel
`dynosam_tpu/ops/pallas/orb_sample.py:orb_orientation_descriptors` (body
`_make_kernel`), the frame's single canvas-packed call of
`dynosam_tpu/frontend/orb.py:extract_orb`.  CUDA source:
`csrc/orb_sample.cu`.

Contract (the Pallas kernel's), per keypoint (x, y) in canvas pixels:

* moments m10, m01 = sum of raw[clip(round(y) + oy), clip(round(x) + ox)]
  times ox resp. oy over the 31x31 offsets inside the radius-15 disc, and
  the angle atan2(m01, m10);
* (ca, sa) = (m10, m01) / r with r = |(m10, m01)|, (1, 0) when r is 0;
* the 512 pattern taps (the a taps of the 256 BRIEF pairs, then the b taps)
  rotated by (ca, sa), bilinear-sampled on the blurred canvas with the
  coordinates clipped to the canvas; bit j is +1 where tap a_j < tap b_j,
  else -1.

Everything is float32.  The plain version repeats the kernel's arithmetic
operation for operation (the moment sums in the kernel's order: each of
32 disc columns summed over its 31 rows top to bottom, then a butterfly
over the 32 columns; no fused multiply-adds), so on the card the two agree
bit for bit unless `atan2` differs in its last place.

Bound on the card: bytes -- the distinct pixels the discs and taps read
(a few MB at 2000 keypoints), tens of kB of coordinates and outputs; what
holds it back is each keypoint's short chain of dependent steps.  One warp
per keypoint (4 per block), so a frame's keypoints are resident in one
wave: the disc is 31 coalesced row loads, one column per lane; the blurred
29x29 window and the 512 pattern taps are copied into shared memory with
`cp.async` while the moments are summed.

`orb_orientation_descriptors` launches the kernel for CUDA tensors and runs
`orb_orientation_descriptors_plain` for CPU tensors; there is no fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .point_sample import bilinear_gather

launches = 0   # kernel launches by `orb_orientation_descriptors` (CUDA tensors only)

HALF_PATCH = 15               # orientation patch radius (ORBextractor HALF_PATCH_SIZE)
_PATTERN_SIGMA = 31.0 / 5.0   # BRIEF: sigma^2 = patch^2 / 25
_PATTERN_CLIP = 12.0          # keep rotated taps inside the blurred patch
N_BITS = 256


def brief_pattern(n_bits: int = N_BITS, seed: int = 42) -> np.ndarray:
    """(n_bits, 2, 2) float32 sample-point pairs, Gaussian around the
    keypoint (`dynosam_tpu/frontend/orb.py:_brief_pattern`, same draw)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATTERN_SIGMA, size=(n_bits, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norm > _PATTERN_CLIP, pts * (_PATTERN_CLIP / norm), pts)
    return pts.astype(np.float32)


PATTERN = brief_pattern()
# the 512 taps de-interleaved: the a tap of every pair, then the b taps
TAPS = np.ascontiguousarray(np.concatenate([PATTERN[:, 0], PATTERN[:, 1]], axis=0))

# disc weights over 31 rows (oy = -15..15) by 32 columns (ox = -15..16),
# the kernel's one column per lane; column 16 lies outside the disc
OFF_Y = np.arange(-HALF_PATCH, HALF_PATCH + 1)
OFF_X = np.arange(-HALF_PATCH, HALF_PATCH + 2)
_circ = (OFF_X[None, :] ** 2 + OFF_Y[:, None] ** 2) <= HALF_PATCH ** 2
W_X = (OFF_X[None, :] * _circ).astype(np.float32)
W_Y = (OFF_Y[:, None] * _circ).astype(np.float32)

_consts: dict = {}


def _device_consts(dev) -> dict:
    """The pattern and disc tables as tensors on `dev`, made once."""
    c = _consts.get(dev)
    if c is None:
        c = _consts[dev] = {
            "taps": torch.as_tensor(TAPS, device=dev),
            "off_x": torch.as_tensor(OFF_X, dtype=torch.float32, device=dev),
            "off_y": torch.as_tensor(OFF_Y, dtype=torch.float32, device=dev),
            "w_x": torch.as_tensor(W_X, device=dev),
            "w_y": torch.as_tensor(W_Y, device=dev),
        }
    return c


def _kernel_order_sum(p: torch.Tensor) -> torch.Tensor:
    """(N, 31, 32) -> (N,): the kernel's summation order.  Lane l adds the
    31 rows of column l top to bottom; a shuffle butterfly then halves the
    32 lanes five times, lane l adding lane l + half."""
    acc = p[:, 0]
    for k in range(1, p.shape[1]):
        acc = acc + p[:, k]
    for half in (16, 8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half:2 * half]
    return acc[:, 0]


def orb_orientation_descriptors_plain(raw: torch.Tensor, blur: torch.Tensor, uv: torch.Tensor):
    """Plain PyTorch version of K4: (H, W) raw and blurred canvases, (N, 2)
    keypoints -> (angle (N,) float32, desc (N, 256) int8 in {-1, +1})."""
    h, w = raw.shape
    c = _device_consts(uv.device)
    uv = torch.nan_to_num(uv, nan=0.0)
    px, py = uv[:, 0:1], uv[:, 1:2]
    # intensity-centroid moments over the clipped disc of the raw canvas
    rows = torch.clamp(torch.round(py)[:, :, None] + c["off_y"][:, None], 0, h - 1)   # (N, 31, 1)
    cols = torch.clamp(torch.round(px)[:, :, None] + c["off_x"][None, :], 0, w - 1)   # (N, 1, 32)
    vals = raw.reshape(-1)[rows.long() * w + cols.long()]                  # (N, 31, 32)
    m10 = _kernel_order_sum(vals * c["w_x"])
    m01 = _kernel_order_sum(vals * c["w_y"])
    r = torch.sqrt(m10 * m10 + m01 * m01)
    r_ok = r > 0.0
    r_safe = torch.where(r_ok, r, torch.ones_like(r))
    ca = torch.where(r_ok, m10 / r_safe, torch.ones_like(r))[:, None]
    sa = torch.where(r_ok, m01 / r_safe, torch.zeros_like(r))[:, None]
    # the 512 steered taps, bilinear on the blurred canvas
    taps = c["taps"]
    tx = px + ca * taps[None, :, 0] - sa * taps[None, :, 1]
    ty = py + sa * taps[None, :, 0] + ca * taps[None, :, 1]
    v = bilinear_gather(blur, torch.stack([tx, ty], dim=-1))               # (N, 512)
    bits = v[:, :N_BITS] < v[:, N_BITS:]
    desc = torch.where(bits, 1, -1).to(torch.int8)
    return torch.atan2(m01, m10), desc


def orb_orientation_descriptors(raw: torch.Tensor, blur: torch.Tensor, uv: torch.Tensor):
    """K4 wrapper: (H, W) float32 raw and blurred canvases, (N, 2) float32
    (x, y) keypoints in canvas pixels -> (angle (N,), desc (N, 256) int8)."""
    global launches
    if raw.dim() != 2 or raw.dtype != torch.float32 or blur.shape != raw.shape or blur.dtype != torch.float32:
        raise ValueError("raw and blur must be (H, W) float32 of one shape")
    if uv.dim() != 2 or uv.shape[1] != 2 or uv.dtype != torch.float32:
        raise ValueError("uv must be (N, 2) float32")
    if raw.device.type == "cpu":
        return orb_orientation_descriptors_plain(raw, blur, uv)
    if raw.device.type != "cuda" or blur.device != raw.device or uv.device != raw.device:
        raise ValueError("raw, blur and uv must lie on the same CUDA device")
    h, w = raw.shape
    n = uv.shape[0]
    raw, blur, uv = raw.contiguous(), blur.contiguous(), uv.contiguous()
    taps = _device_consts(raw.device)["taps"]
    angle = torch.empty((n,), dtype=torch.float32, device=uv.device)
    desc = torch.empty((n, N_BITS), dtype=torch.int8, device=uv.device)
    code = build.load().dyno_orb_sample(
        raw.data_ptr(), blur.data_ptr(), h, w, uv.data_ptr(), n, taps.data_ptr(),
        angle.data_ptr(), desc.data_ptr(), build.stream_handle(uv),
    )
    build.check(code, "orb_orientation_descriptors")
    launches += 1
    return angle, desc
