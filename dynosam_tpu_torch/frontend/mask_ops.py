"""Instance-mask tensor operations: propagation, boundaries, boxes (port of
`dynosam_tpu/frontend/mask_ops.py`).

  * `propagate_mask` (`FeatureTracker::propogateMask`,
    `src/frontend/vision/FeatureTracker.cc:344-492`): carry the previous
    frame's labels forward through the dense flow so objects keep their
    label when the segmenter drops them; one scatter-max and a label
    reconciliation instead of the reference's pixel loop.
  * `mask_boundary`, `object_bboxes`, `shrink_mask`, `label_counts`
    (`src/frontend/vision/VisionTools.cc:440+`).
"""

from __future__ import annotations

import torch

LABEL_CAP = 256


def label_counts(mask: torch.Tensor, label_cap: int) -> torch.Tensor:
    """Pixel count per instance label, labels clipped to [0, label_cap):
    (label_cap,) int32, scattered into a fixed-size table (`bincount` would
    read the largest label to the host to size its output)."""
    lab = torch.clamp(mask.reshape(-1), 0, label_cap - 1).long()
    ones = torch.ones_like(lab, dtype=torch.int32)
    return torch.zeros(label_cap, dtype=torch.int32, device=mask.device).index_add_(0, lab, ones)


def propagate_mask(prev_mask: torch.Tensor, flow_prev: torch.Tensor, cur_mask: torch.Tensor,
                   min_overlap_frac: float = 0.3) -> torch.Tensor:
    """Warp the labels of k-1 into frame k and, where the segmenter lost an
    object (a label with more than `min_overlap_frac * 100` pixels at k-1
    and none at k), paint the warped label onto background pixels; where
    labels disagree the current segmentation wins.  Targets are rounded
    half to even and clipped to the image (not dropped); collisions keep
    the largest label (an order-free max)."""
    h, w = prev_mask.shape
    dev = prev_mask.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    tx = torch.clamp(torch.round(xx + flow_prev[..., 0]).long(), 0, w - 1)
    ty = torch.clamp(torch.round(yy + flow_prev[..., 1]).long(), 0, h - 1)
    warped = torch.zeros(h * w, dtype=prev_mask.dtype, device=dev).scatter_reduce(
        0, (ty * w + tx).reshape(-1), prev_mask.reshape(-1), reduce="amax", include_self=True,
    ).reshape(h, w)
    lost = (label_counts(cur_mask, LABEL_CAP) == 0) & (label_counts(prev_mask, LABEL_CAP) > min_overlap_frac * 100)
    lost[0] = False
    warped_is_lost = lost[torch.clamp(warped, 0, LABEL_CAP - 1).long()]
    return torch.where((cur_mask == 0) & warped_is_lost, warped, cur_mask)


def _shifted(m: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """m shifted by (dy, dx) with edge replication."""
    h, w = m.shape
    rows = torch.clamp(torch.arange(h, device=m.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=m.device) + dx, 0, w - 1)
    return m[rows][:, cols]


def mask_boundary(mask: torch.Tensor, thickness: int = 1) -> torch.Tensor:
    """(H, W) bool mask of object boundary pixels (label transitions within
    `thickness`, edges replicated)."""
    out = torch.zeros(mask.shape, dtype=torch.bool, device=mask.device)
    for dy in range(-thickness, thickness + 1):
        for dx in range(-thickness, thickness + 1):
            if dx or dy:
                out = out | (_shifted(mask, dy, dx) != mask)
    return out & (mask > 0)


def object_bboxes(mask: torch.Tensor, max_objects: int = 256):
    """Per-label [x1, y1, x2, y2] boxes and pixel counts, fixed size:
    (boxes (L, 4) int32, counts (L,) int32), L = max_objects; empty labels
    and label 0 have count 0."""
    h, w = mask.shape
    dev = mask.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=dev),
                            torch.arange(w, dtype=torch.int32, device=dev), indexing="ij")
    lab = torch.clamp(mask.reshape(-1), 0, max_objects - 1).long()
    xs, ys = xx.reshape(-1), yy.reshape(-1)
    big = torch.iinfo(torch.int32).max

    def reduce(init, src, how):
        return torch.full((max_objects,), init, dtype=torch.int32, device=dev).scatter_reduce(
            0, lab, src, reduce=how, include_self=True)

    x1, y1 = reduce(big, xs, "amin"), reduce(big, ys, "amin")
    x2, y2 = reduce(0, xs, "amax"), reduce(0, ys, "amax")
    counts = label_counts(mask, max_objects)
    boxes = torch.stack([x1, y1, x2 + 1, y2 + 1], dim=-1)
    boxes = torch.where(counts[:, None] > 0, boxes, torch.zeros_like(boxes))
    counts[0] = 0
    return boxes, counts


def shrink_mask(mask: torch.Tensor, erode: int) -> torch.Tensor:
    """Erode object regions by `erode` pixels (a (2e+1)^2 minimum over the
    window inside the image), the analog of sampling away from mask
    boundaries."""
    if erode <= 0:
        return mask
    on = (mask > 0).to(torch.float32)
    win = 2 * erode + 1
    eroded = -torch.nn.functional.max_pool2d(-on[None, None], win, stride=1, padding=erode)[0, 0]
    return torch.where(eroded > 0.5, mask, torch.zeros_like(mask))
