"""Dense feature detection (port of `dynosam_tpu/frontend/detect.py`).

The Shi-Tomasi response comes from kernel K3 (`kernels.response`), whose
plain version holds the ported `sobel_gradients_fast` / `_box_sum` /
`shi_tomasi_response_fast`; they are re-exported here under the JAX
package's names.  The Harris response (convolutions) and the FAST-9/16
ring test of the ORB detector are plain PyTorch: the JAX package has no
Pallas kernel for them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.response import box_sum as _box_sum  # noqa: F401
from ..kernels.response import shi_tomasi_response  # noqa: F401
from ..kernels.response import shi_tomasi_response_plain as shi_tomasi_response_fast  # noqa: F401
from ..kernels.response import sobel_gradients_fast  # noqa: F401


def _conv2(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Single-channel 2D cross-correlation with SAME zero padding (odd
    kernels), as `jax.lax.conv_general_dilated`."""
    kh, kw = kernel.shape
    out = F.conv2d(img[None, None], kernel[None, None].to(img.dtype), padding=(kh // 2, kw // 2))
    return out[0, 0]


_SOBEL: dict = {}


def sobel_gradients(gray: torch.Tensor):
    # the kernel is made once per dtype and device: a tensor built from host
    # data is a copy from pageable memory, which a CUDA graph cannot capture
    key = (gray.dtype, gray.device)
    if key not in _SOBEL:
        _SOBEL[key] = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                                   dtype=gray.dtype, device=gray.device) / 8.0
    kx = _SOBEL[key]
    return _conv2(gray, kx), _conv2(gray, kx.T)


def harris_response(gray: torch.Tensor, window: int = 5, k: float = 0.04) -> torch.Tensor:
    ix, iy = sobel_gradients(gray)
    box = torch.full((window, window), 1.0 / (window * window), dtype=gray.dtype, device=gray.device)
    sxx = _conv2(ix * ix, box)
    syy = _conv2(iy * iy, box)
    sxy = _conv2(ix * iy, box)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[i, j] = img[clip(i + dy), clip(j + dx)]: a shifted copy with the
    edge replicated."""
    h, w = img.shape
    a_t, a_b = max(-dy, 0), max(dy, 0)
    a_l, a_r = max(-dx, 0), max(dx, 0)
    p = F.pad(img[None, None], (a_l, a_r, a_t, a_b), mode="replicate")[0, 0]
    return p[dy + a_t:dy + a_t + h, dx + a_l:dx + a_l + w]


# Bresenham circle of radius 3 (the FAST-9/16 test ring), (dx, dy)
_FAST_RING = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


def _windowed_all(x: torch.Tensor, width: int) -> torch.Tensor:
    """AND over every length-`width` window along dim 0, log-depth:
    out[i] = all(x[i : i + width]); shape (L - width + 1, ...)."""
    tbl = {1: x}
    w = 1
    while w * 2 <= width:
        t = tbl[w]
        tbl[w * 2] = t[:-w] & t[w:]
        w *= 2
    n_out = x.shape[0] - width + 1
    res = None
    off = 0
    rem = width
    for p in sorted(tbl, reverse=True):
        while rem >= p:
            seg = tbl[p][off:off + n_out]
            res = seg if res is None else (res & seg)
            off += p
            rem -= p
    return res


def _fast_from_diff(diff: torch.Tensor, threshold: float, arc: int) -> torch.Tensor:
    """FAST criterion and strength from the (16, H, W) ring differences: a
    circular run of >= arc brighter (or darker) ring pixels is a length-arc
    window of the wrapped ring that is all True."""
    brighter = diff > threshold
    darker = diff < -threshold

    def ok_arc(flags):
        doubled = torch.cat([flags, flags[:arc - 1]], dim=0)
        return torch.any(_windowed_all(doubled, arc), dim=0)

    ok = ok_arc(brighter) | ok_arc(darker)
    strength = torch.sum(torch.abs(diff) * (brighter | darker), dim=0)
    return torch.where(ok, strength, torch.zeros_like(strength))


def _fast_ring_diff(gray: torch.Tensor) -> torch.Tensor:
    ring = torch.stack([_shift(gray, dy, dx) for (dx, dy) in _FAST_RING], dim=0)
    return ring - gray[None]


def fast_response(gray: torch.Tensor, threshold: float = 20.0, arc: int = 9) -> torch.Tensor:
    """Dense FAST-N: the sum of absolute ring differences of the pixels past
    the threshold where the FAST criterion holds, 0 elsewhere."""
    return _fast_from_diff(_fast_ring_diff(gray), threshold, arc)


def fast_response_pair(gray: torch.Tensor, t_init: float, t_min: float, arc: int = 9):
    """`fast_response` at both ORB thresholds from one ring build."""
    diff = _fast_ring_diff(gray)
    return _fast_from_diff(diff, t_init, arc), _fast_from_diff(diff, t_min, arc)


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
    resp = torch.where(occupied_or_invalid, -float("inf"), response)
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
    # fills, not assignments of a Python scalar, which the card copies
    # from host memory (a CUDA graph of the frontend step captures this)
    if shrink_row > 0:
        r[:shrink_row, :].fill_(True)
        r[-shrink_row:, :].fill_(True)
    if shrink_col > 0:
        r[:, :shrink_col].fill_(True)
        r[:, -shrink_col:].fill_(True)
    return r
