"""Batched homography RANSAC for static-track verification (port of
`dynosam_tpu/ops/homography.py`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .linalg import inv3, inv_spd


def _normalize(p: torch.Tensor, w: torch.Tensor):
    """Hartley normalization; p (..., N, 2), w (..., N) -> (p_norm, T)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    mean = torch.einsum("...n,...nd->...d", w, p) / wsum
    centered = p - mean[..., None, :]
    rms = torch.sqrt(
        torch.einsum("...n,...n->...", w, torch.sum(centered ** 2, dim=-1)) / wsum[..., 0]
    )
    s = (2.0 ** 0.5) / torch.clamp(rms, min=1e-9)
    p_norm = centered * s[..., None, None]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, z, -s * mean[..., 0]], dim=-1),
            torch.stack([z, s, -s * mean[..., 1]], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )
    return p_norm, T


def _dlt_rows(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    rows = torch.cat([r1, r2], dim=-2)
    w2 = torch.cat([w, w], dim=-1)[..., None]
    return rows * w2


def homography_from_points(
    p: torch.Tensor, q: torch.Tensor, w: Optional[torch.Tensor] = None,
    method: str = "eigh",
) -> torch.Tensor:
    """Weighted Hartley-normalised DLT, (..., N, 2) -> (..., 3, 3).
    "eigh": nullspace of A^T A; "solve": gauge h9 = 1 and a closed-form
    8x8 normal solve (the RANSAC hypothesis batch)."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    pn, Tp = _normalize(p, w)
    qn, Tq = _normalize(q, w)
    A = _dlt_rows(pn, qn, w)
    if method == "solve":
        A8 = A[..., :8]
        a9 = A[..., 8]
        M = torch.einsum("...ni,...nj->...ij", A8, A8)
        b = -torch.einsum("...ni,...n->...i", A8, a9)
        tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        M = M + (1e-7 * tr / 8.0) * torch.eye(8, dtype=M.dtype, device=M.device)
        h8 = torch.einsum("...ij,...j->...i", inv_spd(M), b)
        h = torch.cat([h8, torch.ones((*h8.shape[:-1], 1), dtype=h8.dtype, device=h8.device)], dim=-1)
    else:
        AtA = torch.einsum("...ni,...nj->...ij", A, A)
        _, vecs = torch.linalg.eigh(AtA)
        h = vecs[..., :, 0]
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    H = torch.einsum("...ij,...jk->...ik", inv3(Tq), Hn @ Tp)
    h33 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h33) < 1e-12, torch.ones_like(h33), h33)


def transfer_error(H: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Forward transfer error |Hp - q| (..., N)."""
    ph = torch.cat([p, torch.ones((*p.shape[:-1], 1), dtype=p.dtype, device=p.device)], dim=-1)
    qp = torch.einsum("...ij,...nj->...ni", H, ph)
    w = qp[..., 2]
    small = torch.abs(w) < 1e-9
    w_safe = torch.where(small, torch.full_like(w, 1e-9), w)
    proj = qp[..., :2] / w_safe[..., None]
    err = torch.linalg.vector_norm(proj - q, dim=-1)
    return torch.where(small, torch.full_like(err, float("inf")), err)


class HomographyResult(NamedTuple):
    H: torch.Tensor          # (3, 3)
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int


def ransac_homography(
    p: torch.Tensor,
    q: torch.Tensor,
    valid: torch.Tensor,
    iters: int = 200,
    threshold: float = 3.0,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> HomographyResult:
    """Robust homography p -> q; inliers under forward transfer error.

    `idx` (iters, 4) injects the hypothesis indices (the JAX package draws
    them from `jax.random`); without it they come from `generator`."""
    from .ransac import sample_valid_indices

    if idx is None:
        idx = sample_valid_indices(valid, iters, 4, generator)
    idx = idx.long()
    Hs = homography_from_points(p[idx], q[idx], method="solve")
    err = transfer_error(Hs, p[None], q[None])           # (K, N)
    inl = (err < threshold) & valid[None]
    scores = torch.sum(inl, dim=-1)
    best = torch.argmax(scores)                          # first maximum
    w_in = inl[best].to(p.dtype)
    H_ref = homography_from_points(p, q, w_in)
    err_f = transfer_error(H_ref, p, q)
    inl_f = (err_f < threshold) & valid
    better = torch.sum(inl_f) >= scores[best]
    H_out = torch.where(better, H_ref, Hs[best])
    inl_out = torch.where(better, inl_f, inl[best])
    return HomographyResult(H_out, inl_out, torch.sum(inl_out).to(torch.int32))
