"""Contrast-limited adaptive histogram equalization (port of
`dynosam_tpu/ops/clahe.py`).

Same algorithm and the same arithmetic: per-tile histograms, clip at
`clip_limit * area / bins` with uniform redistribution, and the equalised
value of each pixel as a soft-CDF product over half-tile-shifted blocks, each
of which interpolates the same four tile LUTs.  The JAX package rounds the
soft-CDF basis G and the tile histograms to bf16 before their product; the
port reproduces that rounding so both give the same image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_edge(x: torch.Tensor, top: int, bottom: int, left: int, right: int):
    return F.pad(x[None, None], (left, right, top, bottom), mode="replicate")[0, 0]


def clahe(
    gray: torch.Tensor,
    clip_limit: float = 2.0,
    tiles: tuple = (8, 8),
    n_bins: int = 256,
) -> torch.Tensor:
    """Equalise a (H, W) grayscale image with values in [0, 255]."""
    h, w = gray.shape
    dtype, dev = gray.dtype, gray.device
    ty, tx = tiles
    th = -(-h // ty)
    tw = -(-w // tx)
    hp, wp = th * ty, tw * tx
    img = _pad_edge(gray, 0, hp - h, 0, wp - w)
    v = torch.clamp(img, 0.0, 255.0)
    s = 256.0 / n_bins

    qb = torch.clamp((v / s).to(torch.int32), max=n_bins - 1).long()
    tile_vals = qb.reshape(ty, th, tx, tw).permute(0, 2, 1, 3).reshape(ty * tx, th * tw)
    hist = torch.zeros((ty * tx, n_bins), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, tile_vals, torch.ones_like(tile_vals, dtype=torch.float32))

    area = float(th * tw)
    limit = max(clip_limit * area / n_bins, 1.0)
    clipped = torch.clamp(hist, max=limit)
    excess = area - torch.sum(clipped, dim=-1, keepdim=True)
    clipped = clipped + excess / n_bins
    Hs = (clipped * (255.0 / area)).reshape(ty, tx, n_bins)

    pt, pb = th // 2, th - th // 2
    pl, pr = tw // 2, tw - tw // 2
    vpad = _pad_edge(v, pt, pb, pl, pr)
    by, bx = ty + 1, tx + 1
    blocks = vpad.reshape(by, th, bx, tw).permute(0, 2, 1, 3).reshape(by * bx, th * tw)

    bins = torch.arange(n_bins, device=dev)
    edges = (bins.to(dtype) * s)[None, None, :]
    G = torch.clamp((blocks[:, :, None] + 1.0 - edges) / s, 0.0, 1.0)

    ar_y, ar_x = torch.arange(by, device=dev), torch.arange(bx, device=dev)
    ri0 = torch.clamp(ar_y - 1, 0, ty - 1)
    ri1 = torch.clamp(ar_y, 0, ty - 1)
    cj0 = torch.clamp(ar_x - 1, 0, tx - 1)
    cj1 = torch.clamp(ar_x, 0, tx - 1)
    H4 = torch.stack(
        [
            Hs[ri0][:, cj0],
            Hs[ri0][:, cj1],
            Hs[ri1][:, cj0],
            Hs[ri1][:, cj1],
        ],
        dim=-1,
    ).reshape(by * bx, n_bins, 4)

    # bf16-rounded operands, f32 products and sums (the JAX package's
    # bf16 MXU operands with f32 accumulation)
    Gq = G.to(torch.bfloat16).float()
    Hq = H4.to(torch.bfloat16).float()
    vals = torch.bmm(Gq, Hq)                                 # (B, P, 4)

    fy = ((torch.arange(th, dtype=torch.float32, device=dev) + 0.5) / th)[:, None]
    fx = ((torch.arange(tw, dtype=torch.float32, device=dev) + 0.5) / tw)[None, :]
    wgt = torch.stack(
        [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx], dim=-1
    ).reshape(1, th * tw, 4)
    out = torch.sum(vals * wgt, dim=-1)
    out = out.reshape(by, bx, th, tw).permute(0, 2, 1, 3).reshape(by * th, bx * tw)
    return out[pt:pt + h, pl:pl + w].to(dtype)
