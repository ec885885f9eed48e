"""Dense feature detection (port of the Shi-Tomasi path of
`dynosam_tpu/frontend/detect.py`).

The response map comes from kernel K3 (`kernels.response`), whose plain
version holds the ported `sobel_gradients_fast` / `_box_sum` /
`shi_tomasi_response_fast`; they are re-exported here under the JAX
package's names.  Harris and FAST wait for the alternate-detector slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.response import box_sum as _box_sum  # noqa: F401
from ..kernels.response import shi_tomasi_response  # noqa: F401
from ..kernels.response import shi_tomasi_response_plain as shi_tomasi_response_fast  # noqa: F401
from ..kernels.response import sobel_gradients_fast  # noqa: F401


class Detections(NamedTuple):
    uv: torch.Tensor      # (K, 2) float pixel coords (x, y)
    score: torch.Tensor   # (K,)
    valid: torch.Tensor   # (K,) bool


def detect_grid_nms(
    response: torch.Tensor,
    occupied_or_invalid: torch.Tensor,
    max_corners: int = 1000,
    cell_size: int = 16,
    quality_level: float = 0.001,
) -> Detections:
    """Grid-NMS corner selection: the best pixel of every cell, then the top
    `max_corners` cells above `quality_level * max`.  Ties keep the lower
    index first (first maximum in a cell, stable descending sort over
    cells), as `jnp.argmax` / `lax.top_k` do."""
    h, wd = response.shape
    neg_inf = torch.tensor(-float("inf"), dtype=response.dtype, device=response.device)
    resp = torch.where(occupied_or_invalid, neg_inf, response)
    ph = -h % cell_size
    pw = -wd % cell_size
    resp_p = F.pad(resp, (0, pw, 0, ph), value=-float("inf"))
    hh, ww = resp_p.shape
    ch, cw = hh // cell_size, ww // cell_size
    cells = resp_p.reshape(ch, cell_size, cw, cell_size).permute(0, 2, 1, 3).reshape(ch, cw, -1)
    win = torch.argmax(cells, dim=-1)                      # first maximum
    win_score = torch.gather(cells, -1, win[..., None])[..., 0]
    dev = response.device
    cy = torch.arange(ch, device=dev)[:, None] * cell_size + win // cell_size
    cx = torch.arange(cw, device=dev)[None, :] * cell_size + win % cell_size
    flat_score = win_score.reshape(-1)
    flat_uv = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1).to(response.dtype)

    k = min(max_corners, flat_score.shape[0])
    order = torch.sort(flat_score, descending=True, stable=True).indices[:k]
    top_score = flat_score[order]
    top_uv = flat_uv[order]
    thresh = quality_level * torch.clamp(torch.max(top_score), min=1e-12)
    valid = torch.isfinite(top_score) & (top_score > thresh)
    if k < max_corners:
        pad = max_corners - k
        top_uv = F.pad(top_uv, (0, 0, 0, pad))
        top_score = F.pad(top_score, (0, pad))
        valid = F.pad(valid, (0, pad))
    return Detections(uv=top_uv, score=top_score, valid=valid)


def occupancy_mask(shape, uv: torch.Tensor, valid: torch.Tensor, radius: int) -> torch.Tensor:
    """(H, W) bool: a (2r+1)^2 square around each valid feature (the
    reference's keep-away binning)."""
    h, w = shape
    xi = torch.clamp(torch.round(uv[:, 0]), 0, w - 1).long()
    yi = torch.clamp(torch.round(uv[:, 1]), 0, h - 1).long()
    grid = torch.zeros((h * w,), dtype=torch.float32, device=uv.device)
    grid.scatter_reduce_(0, yi * w + xi, valid.float(), reduce="amax")
    grid = grid.reshape(h, w)
    if radius > 0:
        k = 2 * radius + 1
        grid = F.max_pool2d(grid[None, None], k, stride=1, padding=radius)[0, 0]
    return grid > 0.5


def occupancy_at_grid(shape, uv, valid, radius: int, step: int, off: int) -> torch.Tensor:
    """`occupancy_mask(shape, uv, valid, radius)[off::step, off::step]`."""
    return occupancy_mask(shape, uv, valid, radius)[off::step, off::step]


def grid_subsample_i32(img: torch.Tensor, step: int, off: int) -> torch.Tensor:
    """`img[off::step, off::step]`."""
    return img[off::step, off::step]


def border_mask(shape, shrink_row: int, shrink_col: int, device=None) -> torch.Tensor:
    """(H, W) bool: True where detection is forbidden (image border)."""
    h, w = shape
    r = torch.zeros((h, w), dtype=torch.bool, device=device)
    if shrink_row > 0:
        r[:shrink_row, :] = True
        r[-shrink_row:, :] = True
    if shrink_col > 0:
        r[:, :shrink_col] = True
        r[:, -shrink_col:] = True
    return r
