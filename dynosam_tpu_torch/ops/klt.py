"""Pyramidal Lucas-Kanade and point sampling (port of `dynosam_tpu/ops/klt.py`).

Every (N, 2) point query goes through kernel K2 (`kernels.point_sample`):
on a CUDA tensor that launches the kernel, on a CPU tensor it runs the
plain version.  `klt_track` is the JAX package's XLA-form tracker (every
slot iterates, no early stop); `klt_track_lk` is the contract of
`ops/pallas/lk.py:klt_track_pallas` and runs each level through kernel K1
(`kernels.lk.lk_level`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.lk import lk_level, lk_level_plain
from ..kernels.point_sample import (
    BILINEAR,
    DTYPE_CODES,
    NEAREST,
    bilinear_gather,
    nearest_gather,
    point_sample,
)


def gaussian_blur(img: torch.Tensor) -> torch.Tensor:
    """5x5 binomial blur (separable), zero padding ("SAME" convolution)."""
    k = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
    h, w = img.shape
    p = torch.nn.functional.pad(img, (0, 0, 2, 2))
    x = sum(k[i] * p[i:i + h, :] for i in range(5))
    p = torch.nn.functional.pad(x, (2, 2, 0, 0))
    return sum(k[i] * p[:, i:i + w] for i in range(5))


def build_pyramid(gray: torch.Tensor, levels: int) -> list:
    """Level 0 = full resolution, each next level blurred and halved."""
    pyr = [gray]
    for _ in range(levels - 1):
        pyr.append(gaussian_blur(pyr[-1])[::2, ::2].contiguous())
    return pyr


def _point_query(img: torch.Tensor, xy: torch.Tensor) -> bool:
    return img.dim() == 2 and xy.dim() == 2 and xy.shape[-1] == 2


def _as_read(img: torch.Tensor) -> torch.Tensor:
    """`img` as K2 takes it: float32, int32, bool and uint8 images are read
    in place, any strides; another dtype is read as float32."""
    return img if img.dtype in DTYPE_CODES else img.float()


def bilinear_sample(
    img: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Sample (..., 2) float (x, y) locations of a (H, W) image, clamped;
    rows masked off by `valid` come back 0."""
    if _point_query(img, xy):
        return point_sample(
            (_as_read(img),), xy.float(), (BILINEAR,), valid
        )[:, 0].to(img.dtype)
    out = bilinear_gather(img, xy)
    if valid is not None:
        out = torch.where(valid, out, torch.zeros_like(out))
    return out


def nearest_at(
    img: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Nearest-neighbour sample (label/mask images); dtype preserved (int
    labels below 2^24 round-trip exactly through f32)."""
    if _point_query(img, uv):
        return point_sample(
            (_as_read(img),), uv.float(), (NEAREST,), valid
        )[:, 0].to(img.dtype)
    out = nearest_gather(img, uv)
    if valid is not None:
        out = torch.where(valid, out, torch.zeros_like(out))
    return out


def flow_at(
    flow: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor | None = None
) -> torch.Tensor:
    """Sample a dense flow field (H, W, 2) at (N, 2) positions -> (N, 2);
    K2 reads the field's two planes in place."""
    return point_sample(
        _as_read(flow).unbind(-1), uv.float(), (BILINEAR, BILINEAR), valid
    ).to(flow.dtype)


def sample_channels(imgs, modes, uv: torch.Tensor, valid: torch.Tensor | None = None):
    """Sample several (H, W) channels at shared (N, 2) positions in ONE K2
    launch, each read in place; returns a list aligned with `imgs`, dtypes
    preserved."""
    imgs = list(imgs)
    out = point_sample([_as_read(im) for im in imgs], uv.float(), tuple(modes), valid)
    return [out[:, i].to(im.dtype) for i, im in enumerate(imgs)]


class KLTResult(NamedTuple):
    uv: torch.Tensor      # (N, 2) tracked positions in the current image
    ok: torch.Tensor      # (N,) bool: valid, in bounds, finite, err < max_error
    error: torch.Tensor   # (N,) mean abs photometric residual


def _finish(uv_prev, g, err, valid, cur_gray, max_error) -> KLTResult:
    uv_cur = uv_prev + g
    h, w = cur_gray.shape
    inb = (
        (uv_cur[:, 0] >= 0)
        & (uv_cur[:, 0] <= w - 1)
        & (uv_cur[:, 1] >= 0)
        & (uv_cur[:, 1] <= h - 1)
    )
    ok = valid & inb & (err < max_error) & torch.all(torch.isfinite(uv_cur), dim=-1)
    return KLTResult(uv=uv_cur, ok=ok, error=err)


def klt_track(
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    uv_prev: torch.Tensor,
    valid: torch.Tensor,
    win: int = 21,
    levels: int = 3,
    iters: int = 10,
    max_error: float = 20.0,
    g0: torch.Tensor | None = None,
) -> KLTResult:
    """All-feature-batched pyramidal LK in the XLA form of the JAX package:
    every slot iterates `iters` times per level, no early stop."""
    pyr_prev = build_pyramid(prev_gray, levels)
    pyr_cur = build_pyramid(cur_gray, levels)
    n = uv_prev.shape[0]
    if g0 is None:
        g = torch.zeros((n, 2), dtype=prev_gray.dtype, device=prev_gray.device)
    else:
        g = g0.to(prev_gray.dtype) / (2.0 ** (levels - 1))
    err = None
    for lvl in range(levels - 1, -1, -1):
        g, err = lk_level_plain(
            pyr_prev[lvl], pyr_cur[lvl], uv_prev / (2.0 ** lvl), g, None,
            win, iters, 0.0,
        )
        if lvl > 0:
            g = g * 2.0
    return _finish(uv_prev, g, err, valid, cur_gray, max_error)


def klt_track_lk(
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    uv_prev: torch.Tensor,
    valid: torch.Tensor,
    win: int = 21,
    levels: int = 3,
    iters: int = 30,
    max_error: float = 20.0,
    eps: float = 0.0,
    g0: torch.Tensor | None = None,
) -> KLTResult:
    """The `klt_track_pallas` contract: each level through kernel K1, with
    inactive slots frozen and the per-slot eps stop."""
    pyr_prev = build_pyramid(prev_gray, levels)
    pyr_cur = build_pyramid(cur_gray, levels)
    n = uv_prev.shape[0]
    if g0 is None:
        g = torch.zeros((n, 2), dtype=prev_gray.dtype, device=prev_gray.device)
    else:
        g = g0.to(prev_gray.dtype) / (2.0 ** (levels - 1))
    err = None
    for lvl in range(levels - 1, -1, -1):
        g, err = lk_level(
            pyr_prev[lvl], pyr_cur[lvl], (uv_prev / (2.0 ** lvl)).contiguous(),
            g.contiguous(), valid, win=win, iters=iters, eps=eps,
        )
        if lvl > 0:
            g = g * 2.0
    return _finish(uv_prev, g, err, valid, cur_gray, max_error)
