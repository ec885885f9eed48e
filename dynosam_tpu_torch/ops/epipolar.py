"""Batched essential-matrix estimation, 2d2d relative pose (port of
`dynosam_tpu/ops/epipolar.py`; the reference's 2d-2d ego-motion mode,
`EgoMotionSolver::geometricOutlierRejection2d2d`,
`src/frontend/vision/MotionSolver.cc:111-200`).

All K 8-point hypotheses are solved at once (one batched 9x9 `eigh` and
one batched 3x3 SVD), scored by one Sampson-error table, and the best is
refit on its inliers; the four (R, t) candidates are told apart by
cheirality voting.  Everything stays float32, as in the JAX package.

Random draws: each RANSAC takes an optional `idx` of hypothesis indices
(the JAX package's draws in the parity tests); without it they come from
`sample_valid_indices` and the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.camera import CameraParams
from ..core.lie import SE3
from .ransac import sample_valid_indices

_MIN_SET = 8


def normalize_points(cam: CameraParams, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image coordinates (bearing xy at z = 1)."""
    return torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _epipolar_rows(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rows of q^T E p = 0 for normalized coords: (..., N, 2) -> (..., N, 9),
    E raveled row-major."""
    x1, y1 = p[..., 0], p[..., 1]
    x2, y2 = q[..., 0], q[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1)


def _rank2(E: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) onto the essential manifold: singular values
    (s, s, 0) with s the mean of the first two."""
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S2 = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return U @ (S2[..., :, None] * Vt)


def _smallest_eigvec(A: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of A^T diag(w)^2 A."""
    if w is not None:
        A = A * w[..., None]
    AtA = A.transpose(-1, -2) @ A
    return torch.linalg.eigh(AtA)[1][..., :, 0]


def essential_from_points(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Least-squares essential matrix (..., 3, 3) with rank-2 projection."""
    v = _smallest_eigvec(_epipolar_rows(p, q))
    return _rank2(v.reshape(*v.shape[:-1], 3, 3))


def sampson_error(E: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error (..., N) in normalized coords."""
    ph, qh = _homog(p), _homog(q)
    Ep = ph @ E.transpose(-1, -2)              # (..., N, 3): E p
    Etq = qh @ E                               # (..., N, 3): E^T q
    num = torch.sum(qh * Ep, dim=-1) ** 2
    den = Ep[..., 0] ** 2 + Ep[..., 1] ** 2 + Etq[..., 0] ** 2 + Etq[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def triangulate_depth_ref(rel: SE3, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Depth of each reference point along its bearing given x2 ~ R x1 + t:
    from lambda2 q = lambda1 R p + t, eliminating lambda2 with cross
    products, (q x (R p)) lambda1 = -(q x t).  p, q (N, 2) normalized;
    returns lambda1 (N,), the z-depth in frame 1."""
    ph, qh = _homog(p), _homog(q)
    Rp = ph @ rel.R.transpose(-1, -2)
    cx = torch.linalg.cross(qh, Rp, dim=-1)
    ct = torch.linalg.cross(qh, rel.t.expand_as(qh), dim=-1)
    return -torch.sum(cx * ct, dim=-1) / torch.clamp(torch.sum(cx * cx, dim=-1), min=1e-12)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without reading it to the host."""
    return x.index_select(0, i.reshape(1))[0]


def decompose_essential(E: torch.Tensor, p: torch.Tensor, q: torch.Tensor, valid: torch.Tensor) -> SE3:
    """E -> relative pose (R, t), |t| = 1, by cheirality voting among the
    four candidates (ties go to the first): x2 ~ R x1 + t."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vt)
    U = U * torch.where(d < 0, -1.0, 1.0).to(E.dtype)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.t() @ Vt
    t = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2])                                  # (4, 3, 3)
    ts = torch.stack([t, -t, t, -t])                                    # (4, 3)
    # midpoint depth test of each candidate, as `triangulate_depth_ref`
    ph, qh = _homog(p), _homog(q)
    Rp = torch.einsum("cij,nj->cni", Rs, ph)                            # (4, N, 3)
    qb = qh.expand_as(Rp)
    cx = torch.linalg.cross(qb, Rp, dim=-1)
    ct = torch.linalg.cross(qb, ts[:, None, :].expand_as(Rp), dim=-1)
    l1 = -torch.sum(cx * ct, dim=-1) / torch.clamp(torch.sum(cx * cx, dim=-1), min=1e-12)
    x1 = ph[None] * l1[..., None]
    x2 = torch.einsum("cij,cnj->cni", Rs, x1) + ts[:, None, :]
    votes = torch.sum((x1[..., 2] > 0) & (x2[..., 2] > 0) & valid[None], dim=-1)
    best = torch.argmax(votes)
    return SE3(_at(Rs, best), _at(ts, best))


class EpipolarResult(NamedTuple):
    rel_pose: SE3            # x2 ~ R x1 + t, |t| = 1 (scale-free)
    E: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def ransac_essential(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraParams,
    iters: int = 200,
    threshold: float = 2e-4,      # Sampson, normalized coords (ref 2d2d default)
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> EpipolarResult:
    """8-point RANSAC on (N, 2) pixel pairs; `idx` (iters, 8) injects the
    hypotheses."""
    p = normalize_points(cam, uv1)
    q = normalize_points(cam, uv2)
    if idx is None:
        idx = sample_valid_indices(valid, iters, _MIN_SET, generator)
    idx = idx.long()
    Es = essential_from_points(p[idx], q[idx])                        # (K, 3, 3)
    inl = (sampson_error(Es, p[None], q[None]) < threshold) & valid[None]
    scores = torch.sum(inl, dim=-1)
    best = torch.argmax(scores)
    inl_b = _at(inl, best)
    # refit on the best hypothesis' inliers (rows weighted 0/1)
    E_ref = _rank2(_smallest_eigvec(_epipolar_rows(p, q), inl_b.to(p.dtype)).reshape(3, 3))
    inl_f = (sampson_error(E_ref, p, q) < threshold) & valid
    better = torch.sum(inl_f) >= _at(scores, best)
    E_out = torch.where(better, E_ref, _at(Es, best))
    inl_out = torch.where(better, inl_f, inl_b)
    rel = decompose_essential(E_out, p, q, inl_out)
    return EpipolarResult(rel, E_out, inl_out, torch.sum(inl_out))


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's nanmedian of a 1-D tensor (the mean of the two middle values
    for an even count; NaN when all are NaN), with no host read."""
    n = torch.sum(~torch.isnan(x))
    s = torch.sort(torch.where(torch.isnan(x), float("inf"), x)).values
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = (_at(s, lo) + _at(s, hi)) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def scale_from_depth(rel: SE3, p: torch.Tensor, q: torch.Tensor, depth_ref: torch.Tensor, valid: torch.Tensor):
    """Metric scale of a unit-baseline relative pose from measured depth:
    the median ratio of measured to triangulated reference depth over the
    inliers.  Returns (scale, ok); ok is False (and scale 1) when fewer
    than 5 valid depths support it."""
    lam = triangulate_depth_ref(rel, p, q)
    good = valid & (lam > 1e-3) & (depth_ref > 0)
    ratio = torch.where(good, depth_ref / torch.clamp(lam, min=1e-6), torch.full_like(lam, float("nan")))
    scale = _nanmedian(ratio)
    ok = torch.sum(good) >= 5
    return torch.where(ok, scale, torch.ones_like(scale)), ok


def _hat(t: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1),
    ], -2)


def ransac_translation_given_rot(
    uv1: torch.Tensor,
    uv2: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraParams,
    R: torch.Tensor,
    iters: int = 200,
    threshold: float = 2e-4,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
) -> EpipolarResult:
    """2-point relative translation with known rotation (the reference's
    2-pt mono mode, `MotionSolver.cc:161-177`): each correspondence
    constrains t linearly, ((R p) x q) . t = 0, so two determine t up to
    scale.  All K hypotheses at once, scored by the Sampson error of
    E = hat(t) R; `idx` (iters, 2) injects them."""
    p = normalize_points(cam, uv1)
    q = normalize_points(cam, uv2)
    ph, qh = _homog(p), _homog(q)
    Rp = ph @ R.transpose(-1, -2)
    rows = torch.linalg.cross(Rp, qh, dim=-1)                          # (N, 3)
    if idx is None:
        idx = sample_valid_indices(valid, iters, 2, generator)
    idx = idx.long()
    t_raw = torch.linalg.cross(rows[idx[:, 0]], rows[idx[:, 1]], dim=-1)   # (K, 3)
    # a duplicate draw gives t = 0, whose E = 0 would score every point an
    # inlier: such hypotheses are kept out of the vote
    t_norm = torch.linalg.vector_norm(t_raw, dim=-1, keepdim=True)
    ok_h = t_norm[:, 0] > 1e-9
    t_hyp = t_raw / torch.clamp(t_norm, min=1e-12)
    Es = _hat(t_hyp) @ R                                                # (K, 3, 3)
    inl = (sampson_error(Es, p[None], q[None]) < threshold) & valid[None]
    scores = torch.where(ok_h, torch.sum(inl, dim=-1), torch.full_like(ok_h, -1, dtype=torch.int64))
    best = torch.argmax(scores)
    inl_b = _at(inl, best)
    # least-squares refit of t on the best inliers
    t_ref = _smallest_eigvec(rows, inl_b.to(p.dtype))
    t_ref = t_ref / torch.clamp(torch.linalg.vector_norm(t_ref), min=1e-12)
    inl_f = (sampson_error(_hat(t_ref) @ R, p, q) < threshold) & valid
    better = torch.sum(inl_f) >= _at(scores, best)
    t_out = torch.where(better, t_ref, _at(t_hyp, best))
    inl_out = torch.where(better, inl_f, inl_b)
    E_out = _hat(t_out) @ R
    # cheirality: the majority of inliers must triangulate in front
    lam = triangulate_depth_ref(SE3(R, t_out), p, q)
    front = torch.sum((lam > 0) & inl_out)
    back = torch.sum((lam < 0) & inl_out)
    t_out = torch.where(front >= back, t_out, -t_out)
    return EpipolarResult(SE3(R, t_out), E_out, inl_out, torch.sum(inl_out))
