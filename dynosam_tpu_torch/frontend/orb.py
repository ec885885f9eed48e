"""ORB extractor: pyramid FAST, intensity-centroid orientation, steered
BRIEF-256 (port of `dynosam_tpu/frontend/orb.py`).

Per pyramid level (the base image resized by 1.2^-l, antialiased bilinear
as `jax.image.resize`): FAST-9/16 at both thresholds with the per-cell
init -> min fallback, a keep-away border, grid NMS with a geometric
per-level quota.  The levels' images and blurred images are then stacked
into one canvas (each level at the left edge, one under the other) and
kernel K4 (`kernels.orb_sample`) computes every keypoint's angle and
descriptor in one launch.  Detected keypoints keep EDGE_THRESHOLD = 19 px
from their level's edges while the disc reaches 15 px and the taps 13 px,
so no valid keypoint reads across a level band.

Descriptors are (N, 256) int8 in {-1, +1}, so the Hamming distance is
(256 - A @ B^T) / 2 and all-pairs matching is one matrix product
(`match_descriptors`).  Everything is static-shaped: exactly `n_features`
rows with a validity mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.orb_sample import OFF_X, OFF_Y, W_X, W_Y, orb_orientation_descriptors
from ..kernels.orb_sample import PATTERN as _PATTERN  # noqa: F401
from ..kernels.orb_sample import brief_pattern as _brief_pattern  # noqa: F401
from .detect import Detections, _shift, detect_grid_nms, fast_response_pair

EDGE_THRESHOLD = 19      # detection keep-away border per level


class OrbFeatures(NamedTuple):
    uv: torch.Tensor        # (N, 2) float32 keypoint coords in BASE image pixels
    response: torch.Tensor  # (N,) FAST strength at the detection level
    angle: torch.Tensor     # (N,) radians, intensity-centroid orientation
    level: torch.Tensor     # (N,) int32 pyramid octave
    scale: torch.Tensor     # (N,) float32 level scale factor (uv = uv_level*scale)
    desc: torch.Tensor      # (N, 256) int8 in {-1, +1}; rotated-BRIEF bits
    valid: torch.Tensor     # (N,) bool


class OrbPyramid(NamedTuple):
    """The detection stage of `extract_orb` and K4's inputs."""

    blocks: list            # per level: (uv_base, response, level, scale, valid, live)
    canvas_raw: torch.Tensor    # (sum of live level heights, W) level images
    canvas_blur: torch.Tensor   # the same, Gaussian-blurred
    canvas_uv: torch.Tensor     # (live keypoints, 2) in canvas pixels


def features_per_level(n_features: int, n_levels: int, scale_factor: float) -> list:
    """Geometric per-level quota (the reference's `mnFeaturesPerLevel`):
    most features at full resolution, 1/scale per level up, the remainder
    into the coarsest level."""
    inv = 1.0 / scale_factor
    first = n_features * (1.0 - inv) / (1.0 - inv ** n_levels)
    quotas = []
    acc = 0
    for lvl in range(n_levels - 1):
        q = int(round(first * inv ** lvl))
        quotas.append(q)
        acc += q
    quotas.append(max(n_features - acc, 0))
    return quotas


def _cell_max(resp: torch.Tensor, cell: int) -> torch.Tensor:
    """Per-cell max broadcast back to pixel resolution (pad-to-multiple)."""
    h, w = resp.shape
    r = F.pad(resp, (0, -w % cell, 0, -h % cell), value=0.0)
    hh, ww = r.shape
    m = r.reshape(hh // cell, cell, ww // cell, cell).amax(dim=(1, 3))
    # broadcast by expand: `repeat_interleave` would read its output size
    # back from the device
    return m[:, None, :, None].expand(-1, cell, -1, cell).reshape(hh, ww)[:h, :w]


def _sample_bilinear(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img[y, x] at float coords xy (..., 2), clipped to
    [0, size - 1.001] (the JAX package's per-level XLA form)."""
    h, w = img.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx


_TAPS7 = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2)
_TAPS7 = (_TAPS7 / _TAPS7.sum()).astype(np.float32)


def _gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian, sigma 2, edge-replicated (the pre-BRIEF
    blur, `GaussianBlur(7, 7, 2, 2)` in the reference)."""
    out = torch.zeros_like(img)
    for i, t in enumerate(_TAPS7):
        out = out + float(t) * _shift(img, i - 3, 0)
    img2 = out
    out = torch.zeros_like(img)
    for i, t in enumerate(_TAPS7):
        out = out + float(t) * _shift(img2, 0, i - 3)
    return out


def _orientations(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle atan2(m01, m10) over the radius-15 disc of
    one level image (the JAX package's per-level XLA form)."""
    h, w = img.shape
    dev = uv.device
    xi = torch.round(uv[:, 0]).long()
    yi = torch.round(uv[:, 1]).long()
    # K4's disc tables: 31 rows by 32 columns, the last column weight 0
    xs = torch.clamp(xi[:, None, None] + torch.as_tensor(OFF_X, device=dev), 0, w - 1)
    ys = torch.clamp(yi[:, None, None] + torch.as_tensor(OFF_Y, device=dev)[:, None], 0, h - 1)
    vals = img[ys, xs].reshape(uv.shape[0], -1)
    m10 = vals @ torch.as_tensor(W_X.reshape(-1), device=dev)
    m01 = vals @ torch.as_tensor(W_Y.reshape(-1), device=dev)
    return torch.atan2(m01, m10)


def _descriptors(blurred: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 on one level image (the JAX package's per-level
    XLA form): rotate the pattern by each angle, sample both taps, compare."""
    pat = torch.as_tensor(_PATTERN, device=uv.device)                 # (256, 2, 2)
    ca, sa = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], dim=-2)
    off = torch.einsum("nij,bpj->nbpi", rot, pat)
    vals = _sample_bilinear(blurred, uv[:, None, None, :] + off)       # (N, 256, 2)
    return torch.where(vals[..., 0] < vals[..., 1], 1, -1).to(torch.int8)


def orb_pyramid(
    gray: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    init_threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell_size: int = 35,
) -> OrbPyramid:
    """Detect per level and stack the live levels into K4's canvas.  The
    level loop has static shapes: quotas and NMS cells come from Python."""
    h, w = gray.shape
    dev = gray.device
    quotas = features_per_level(n_features, n_levels, scale_factor)
    img = gray.float()
    blocks, raws, blurs, uvs = [], [], [], []
    y = 0
    level_img = img
    for lvl in range(n_levels):
        scale = scale_factor ** lvl
        lh, lw = level_img.shape
        q = max(quotas[lvl], 0)
        lev = torch.full((q,), lvl, dtype=torch.int32, device=dev)
        sc = torch.full((q,), scale, dtype=torch.float32, device=dev)
        if min(lh, lw) < 2 * EDGE_THRESHOLD + 8 or q == 0:
            # level too small: an all-invalid quota block
            z = torch.zeros((q,), dtype=torch.float32, device=dev)
            blocks.append((torch.zeros((q, 2), device=dev), z, lev, sc,
                           torch.zeros((q,), dtype=torch.bool, device=dev), False))
        else:
            # FAST with the per-cell init -> min threshold fallback
            r_init, r_min = fast_response_pair(level_img, init_threshold, min_threshold)
            resp = torch.where(_cell_max(r_init, cell_size) > 0.0, r_init, r_min)
            e = EDGE_THRESHOLD
            border = torch.ones((lh, lw), dtype=torch.bool, device=dev)
            border[e:lh - e, e:lw - e].fill_(False)
            # NMS cell sized for ~4x the quota in cells
            nms_cell = max(4, min(int(math.sqrt(lh * lw / max(4 * q, 1))), cell_size))
            dets = detect_grid_nms(resp, border, max_corners=q, cell_size=nms_cell, quality_level=0.0)
            blocks.append((dets.uv * scale, dets.score, lev, sc, dets.valid & (dets.score > 0.0), True))
            raws.append(F.pad(level_img, (0, w - lw)))
            blurs.append(F.pad(_gaussian_blur7(level_img), (0, w - lw)))
            uvs.append(torch.stack([dets.uv[:, 0], dets.uv[:, 1] + float(y)], dim=1))
            y += lh
        if lvl + 1 < n_levels:
            nh = max(int(round(h / scale_factor ** (lvl + 1))), 1)
            nw = max(int(round(w / scale_factor ** (lvl + 1))), 1)
            level_img = F.interpolate(img[None, None], size=(nh, nw), mode="bilinear",
                                      antialias=True, align_corners=False)[0, 0]
    if raws:
        canvas_raw, canvas_blur = torch.cat(raws, 0), torch.cat(blurs, 0)
        canvas_uv = torch.cat(uvs, 0)
    else:
        canvas_raw = canvas_blur = torch.zeros((0, w), device=dev)
        canvas_uv = torch.zeros((0, 2), device=dev)
    return OrbPyramid(blocks, canvas_raw, canvas_blur, canvas_uv)


def extract_orb(
    gray: torch.Tensor,
    n_features: int = 1000,
    n_levels: int = 8,
    scale_factor: float = 1.2,
    init_threshold: float = 20.0,
    min_threshold: float = 7.0,
    cell_size: int = 35,
) -> OrbFeatures:
    """ORB keypoints and descriptors of a (H, W) grey image: exactly
    `n_features` rows (per-level geometric quotas) with a validity mask.
    Angles and descriptors come from one K4 call over the level canvas."""
    pyr = orb_pyramid(gray, n_features, n_levels, scale_factor, init_threshold, min_threshold, cell_size)
    dev = gray.device
    if pyr.canvas_uv.shape[0]:
        ang_all, desc_all = orb_orientation_descriptors(pyr.canvas_raw, pyr.canvas_blur, pyr.canvas_uv)
    ats, dts = [], []
    o = 0
    for uv, _, _, _, _, live in pyr.blocks:
        n = uv.shape[0]
        if live:
            ats.append(ang_all[o:o + n])
            dts.append(desc_all[o:o + n])
            o += n
        else:
            ats.append(torch.zeros((n,), device=dev))
            dts.append(torch.zeros((n, 256), dtype=torch.int8, device=dev))
    cols = list(zip(*pyr.blocks))
    return OrbFeatures(
        uv=torch.cat(cols[0], 0), response=torch.cat(cols[1], 0), angle=torch.cat(ats, 0),
        level=torch.cat(cols[2], 0), scale=torch.cat(cols[3], 0), desc=torch.cat(dts, 0),
        valid=torch.cat(cols[4], 0),
    )


def response_order(feats: OrbFeatures) -> torch.Tensor:
    """Row order by descending response, valid rows first, ties in row
    order (the stable `jnp.argsort` of the JAX package)."""
    key = torch.where(feats.valid, -feats.response, torch.full_like(feats.response, float("inf")))
    return torch.sort(key, stable=True).indices


def orb_detections(feats: OrbFeatures) -> Detections:
    """The extractor output as a detector candidate list, sorted by
    response so budget cuts keep the strongest corners."""
    order = response_order(feats)
    return Detections(uv=feats.uv[order], score=feats.response[order], valid=feats.valid[order])


class Matches(NamedTuple):
    index: torch.Tensor     # (NA,) int32 best match in B for each A row
    distance: torch.Tensor  # (NA,) float32 Hamming distance (0..256)
    ok: torch.Tensor        # (NA,) bool: gates + mutual consistency


def match_descriptors(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    max_hamming: float = 64.0,
    ratio: float = 0.8,
    cross_check: bool = True,
) -> Matches:
    """All-pairs Hamming matching as one product of the +-1 descriptors:
    ham = (256 - A @ B^T) / 2 (exact in float32: integer sums <= 256), then
    the best/second-best (Lowe ratio) gate and the mutual cross-check.
    `argmin` takes the first minimum, as `jnp.argmin`."""
    n_bits = desc_a.shape[1]
    sim = desc_a.float() @ desc_b.float().T
    ham = (n_bits - sim) * 0.5
    big = float(n_bits + 1)
    ham = torch.where(valid_a[:, None] & valid_b[None, :], ham, torch.full_like(ham, big))
    best = torch.argmin(ham, dim=1)
    d_best = torch.amin(ham, dim=1)
    oh = (best[:, None] == torch.arange(ham.shape[1], device=ham.device)).to(ham.dtype)   # no host range check
    d_second = torch.amin(ham + oh * big, dim=1)
    ok = (d_best <= max_hamming) & (d_best <= ratio * d_second)
    if cross_check:
        best_rev = torch.argmin(ham, dim=0)
        ok = ok & (best_rev[best] == torch.arange(ham.shape[0], device=ham.device))
    return Matches(index=best.to(torch.int32), distance=d_best, ok=ok)
