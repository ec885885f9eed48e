"""Closed-form small-matrix inverses (port of the parts of
`dynosam_tpu/ops/linalg.py` the frontend needs).

The port keeps the closed forms where a RANSAC hypothesis batch may hold
near-singular blocks: there the closed form and an LU solve give different
garbage, and the gates downstream were tuned on the closed form's."""

from __future__ import annotations

import torch


def inv2(M: torch.Tensor) -> torch.Tensor:
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of (..., 3, 3) (general)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj * (1.0 / det)[..., None, None]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def inv_spd(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of small SPD blocks (..., n, n): adjugates for
    n <= 3, recursive 2x2 block-Schur above."""
    n = M.shape[-1]
    if n == 1:
        return 1.0 / M
    if n == 2:
        return inv2(M)
    if n == 3:
        return inv3(M)
    m = n // 2
    A = M[..., :m, :m]
    B = M[..., :m, m:]
    C = M[..., m:, m:]
    Ai = inv_spd(A)
    AiB = _mm(Ai, B)
    S = C - _mm(B.transpose(-1, -2), AiB)
    Si = inv_spd(S)
    TL = Ai + _mm(_mm(AiB, Si), AiB.transpose(-1, -2))
    TR = -_mm(AiB, Si)
    BL = TR.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)
