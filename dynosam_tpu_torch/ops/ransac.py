"""Batched fixed-iteration RANSAC rigid-motion solvers (port of
`dynosam_tpu/ops/ransac.py`).

All K minimal sets are drawn at once, solved in closed form
(`rigid_from_minimal`), scored as one (K, N) residual table, and the best
hypothesis is polished by Gauss-Newton on its inliers.  The port runs a
leading batch dimension B natively (the JAX package `vmap`s over objects):
inputs are (B, N, ...) and every problem of the batch is independent.

After the draw, `ransac_rigid` solves, scores and polishes through
`hypotheses_and_polish`, the wrapper of kernel K6: on CUDA tensors the
kernel (`kernels/ransac.py`, `csrc/ransac.cu`, two launches a call), on CPU
tensors its plain version, `hypotheses_and_polish_plain`.

Random draws: the JAX package draws hypothesis indices with `jax.random`.
Torch cannot reproduce those streams, so every solver takes an optional
`idx` of hypothesis indices; without it they come from a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.camera import CameraParams, project_jacobian_pose, project_local
from ..core.lie import SE3, _mm, _mv, se3_apply, se3_inverse, se3_retract, so3_hat
from ..kernels import ransac as ransac_kernel
from .linalg import inv_spd

STATUS_VALID = 0
STATUS_FEW_MATCHES = 1
STATUS_INVALID = 2

_MIN_SET = 3


class RansacResult(NamedTuple):
    pose: SE3                # best model (B,)
    inliers: torch.Tensor    # (B, N) bool
    n_inliers: torch.Tensor  # (B,) int32
    status: torch.Tensor     # (B,) int32 TrackingStatus


def procrustes(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> SE3:
    """Weighted Kabsch/Arun: argmin sum w ||dst - T src||^2; (..., N, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    c_src = torch.einsum("...n,...nd->...d", wn, src)
    c_dst = torch.einsum("...n,...nd->...d", wn, dst)
    src0 = src - c_src[..., None, :]
    dst0 = dst - c_dst[..., None, :]
    Hcov = torch.einsum("...n,...ni,...nj->...ij", wn, dst0, src0)
    U, _, Vt = torch.linalg.svd(Hcov)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones((*det.shape, 2), dtype=det.dtype, device=det.device), det[..., None]], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    t = c_dst - _mv(R, c_src)
    return SE3(R, t)


def rigid_from_minimal(src3: torch.Tensor, dst3: torch.Tensor):
    """(..., 3, 3) three-point correspondences -> (SE3, ok): orthonormal-triad
    alignment, exact for rigid noise-free sets; ok=False for (near-)
    collinear sets."""
    a1 = src3[..., 1, :] - src3[..., 0, :]
    a2 = src3[..., 2, :] - src3[..., 0, :]
    b1 = dst3[..., 1, :] - dst3[..., 0, :]
    b2 = dst3[..., 2, :] - dst3[..., 0, :]

    def triad(u, v):
        nu = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        e1 = u / torch.clamp(nu, min=1e-12)
        wv = v - torch.sum(v * e1, dim=-1, keepdim=True) * e1
        nw = torch.linalg.vector_norm(wv, dim=-1, keepdim=True)
        e2 = wv / torch.clamp(nw, min=1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        ok = (nu[..., 0] > 1e-9) & (nw[..., 0] > 1e-4 * nu[..., 0])
        return torch.stack([e1, e2, e3], dim=-1), ok

    E, ok_e = triad(a1, a2)
    F_, ok_f = triad(b1, b2)
    R = torch.sum(F_[..., :, None, :] * E[..., None, :, :], dim=-1)   # F E^T
    c_src = torch.mean(src3, dim=-2)
    c_dst = torch.mean(dst3, dim=-2)
    t = c_dst - _mv(R, c_src)
    return SE3(R, t), ok_e & ok_f


def draw_uniforms(batch_shape: tuple, iters: int, k: int, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """The (*batch_shape, iters * k) float64 uniforms `sample_valid_indices`
    turns into hypothesis indices, drawn from `generator`."""
    return torch.rand((*batch_shape, iters * k), generator=generator, dtype=torch.float64, device=device)


def sample_valid_indices(
    valid: torch.Tensor, iters: int, k: int,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., iters, k) indices drawn uniformly (with replacement) from the
    valid slots of `valid` (..., N) by inverse CDF on the cumulative valid
    count.  With no valid slot the indices are arbitrary in-range slots;
    callers gate on their own inlier counts.  The uniforms come from
    `generator`, or are `uniforms` drawn from it beforehand by
    `draw_uniforms` (the same numbers: a CUDA graph of the frontend step
    takes them as an input)."""
    n = valid.shape[-1]
    c = torch.cumsum(valid.to(torch.int64), dim=-1)            # (..., N)
    m = c[..., -1:]                                            # (..., 1)
    r = uniforms if uniforms is not None else draw_uniforms(valid.shape[:-1], iters, k, generator, valid.device)
    m1 = torch.clamp(m, min=1)
    u = torch.minimum(torch.floor(r * m1).to(torch.int64), m1 - 1)
    # index of the (u+1)-th valid slot == #[prefix counts <= u]
    idx = torch.searchsorted(c.contiguous(), u.contiguous(), right=True)
    idx = torch.clamp(idx, max=n - 1)
    return idx.reshape(*valid.shape[:-1], iters, k)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, d), idx (B, ...) -> (B, ..., d)."""
    b = x.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(*idx.shape, x.shape[-1])


def ransac_rigid(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    iters: int = 500,
    threshold: float = 0.1,
    uv: Optional[torch.Tensor] = None,
    cam: Optional[CameraParams] = None,
    refine_steps: int = 5,
    min_inliers: int = 5,
    score_cap: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Robustly estimate T with dst ~ T(src), batched: src/dst (B, N, 3),
    valid (B, N), uv (B, N, 2) for the 3d2d mode (then T = ^w X_c and the
    score is the reprojection of `src` against `uv`).

    `score_cap` compacts the valid slots to the front and solves on the
    first `score_cap` rows (exact while the live count <= cap); `idx`
    (B, iters, 3) then indexes the compacted rows, as the JAX draw does.
    `uniforms` (B, iters * 3) are `generator`'s draws made beforehand
    (`draw_uniforms`)."""
    bsz, n_pool = src.shape[0], src.shape[1]
    dev = src.device
    scatter_order = None
    if score_cap is not None and n_pool > score_cap:
        order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices[:, :score_cap]
        src = _gather_rows(src, order)
        dst = _gather_rows(dst, order)
        if uv is not None:
            uv = _gather_rows(uv, order)
        valid = torch.gather(valid, 1, order)
        scatter_order = order
    if idx is None:
        idx = sample_valid_indices(valid, iters, _MIN_SET, generator, uniforms)
    res = hypotheses_and_polish(src, dst, valid, idx, uv, cam, threshold, refine_steps, min_inliers)
    if scatter_order is not None:
        full = torch.zeros((bsz, n_pool), dtype=torch.bool, device=dev)
        res = res._replace(inliers=full.scatter(1, scatter_order, res.inliers))
    return res


def hypotheses_and_polish(src, dst, valid, idx, uv, cam, threshold: float, refine_steps: int,
                          min_inliers: int) -> RansacResult:
    """K6's wrapper: `ransac_rigid` after the draw and the compaction.  On
    CUDA tensors kernel K6, which raises if it cannot build or launch; on
    CPU tensors the plain version, `hypotheses_and_polish_plain`."""
    if src.device.type == "cpu":
        return hypotheses_and_polish_plain(src, dst, valid, idx.long(), uv, cam, threshold, refine_steps,
                                           min_inliers)
    R, t, inliers, n_inliers, status = ransac_kernel.ransac(src, dst, valid, idx, uv, cam, threshold, refine_steps,
                                                            min_inliers)
    return RansacResult(SE3(R, t), inliers, n_inliers, status)


def hypotheses_and_polish_plain(src, dst, valid, idx, uv, cam, threshold: float, refine_steps: int,
                                min_inliers: int, diagnostics: Optional[dict] = None) -> RansacResult:
    """K6's plain version: the minimal sets `idx` (B, K, 3) solved, scored
    over the rows, the first best polished by Gauss-Newton on its inliers,
    the final inliers and status.  A `diagnostics` dict receives the scores
    (B, K), the scoring errors (B, K, N), the best hypothesis (B,), which
    hypotheses are proper (B, K), each Gauss-Newton step's largest
    component (B, refine_steps) and the final errors (B, N)."""
    bsz = src.shape[0]
    dt, dev = src.dtype, src.device
    src_min = _gather_rows(src, idx)                           # (B, K, 3, 3)
    dst_min = _gather_rows(dst, idx)
    hyp, proper = rigid_from_minimal(src_min, dst_min)         # (B, K)
    reproj = uv is not None
    if reproj:
        hyp = se3_inverse(hyp)

    if reproj:
        # p_cam = R^T (src - t) for every hypothesis: (B, K, N, 3)
        Rt = hyp.R.transpose(-1, -2)
        diff = src[:, None] - hyp.t[:, :, None, :]
        p_cam = torch.sum(Rt[:, :, None] * diff[..., None, :], dim=-1)
        pred, z = project_local(cam, p_cam)
        err = torch.linalg.vector_norm(pred - uv[:, None], dim=-1)
        err = torch.where(z > 0.05, err, torch.full_like(err, float("inf")))
    else:
        moved = torch.sum(hyp.R[:, :, None] * src[:, None, :, None, :], dim=-1) + hyp.t[:, :, None, :]
        err = torch.linalg.vector_norm(moved - dst[:, None], dim=-1)
    inl = (err < threshold) & valid[:, None, :] & proper[..., None]
    scores = torch.sum(inl, dim=-1)                            # (B, K)
    best = torch.argmax(scores, dim=-1)                        # first maximum
    ar = torch.arange(bsz, device=dev)
    T = SE3(hyp.R[ar, best], hyp.t[ar, best])                  # (B,)
    best_inl = inl[ar, best]                                   # (B, N)
    if diagnostics is not None:
        diagnostics.update(scores=scores, err=err, best=best, proper=proper)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    steps = []
    for _ in range(refine_steps):
        if reproj:
            p_cam = se3_apply(se3_inverse(T)[:, None], src)    # (B, N, 3)
            pred, z = project_local(cam, p_cam)
            r = pred - uv                                      # (B, N, 2)
            wrow = (best_inl & (z > 0.05)).to(dt)
            # d r / d xi at xi = 0 for T Exp(xi): the pose Jacobian of the
            # projection; rows with zero weight use a sanitised point so
            # they stay finite
            z_safe = torch.where(z > 0.05, z, torch.ones_like(z))
            p_safe = torch.cat([p_cam[..., :2], z_safe[..., None]], dim=-1)
            J = project_jacobian_pose(cam, p_safe)             # (B, N, 2, 6)
        else:
            moved = se3_apply(T[:, None], src)
            r = moved - dst                                    # (B, N, 3)
            wrow = best_inl.to(dt)
            # d/dxi T Exp(xi) src = R [-hat(src) | I]
            Rb = T.R[:, None].expand(-1, src.shape[1], -1, -1)
            J = torch.cat([_mm(Rb, -so3_hat(src)), Rb], dim=-1)
        Jw = J * wrow[..., None, None]
        A = torch.einsum("bndi,bndj->bij", Jw, J) + 1e-6 * eye6
        g = torch.einsum("bndi,bnd->bi", Jw, r)
        # the reference's closed-form SPD inverse, in the inputs' dtype: on
        # a small object patch A's condition number reaches 1e6, where a
        # float32 step may diverge and drop the motion (ROADMAP.md, Faults)
        xi = -_mv6(inv_spd(A), g)
        T = se3_retract(T, xi)
        if diagnostics is not None:
            steps.append(xi.abs().amax(-1))

    if reproj:
        p_cam = se3_apply(se3_inverse(T)[:, None], src)
        pred, z = project_local(cam, p_cam)
        final_err = torch.linalg.vector_norm(pred - uv, dim=-1)
        final_err = torch.where(z > 0.05, final_err, torch.full_like(final_err, float("inf")))
    else:
        final_err = torch.linalg.vector_norm(se3_apply(T[:, None], src) - dst, dim=-1)
    final_inl = (final_err < threshold) & valid
    if diagnostics is not None:
        diagnostics.update(final_err=final_err, steps=torch.stack(steps, -1) if steps else final_err[:, :0])
    n_final = torch.sum(final_inl, dim=-1).to(torch.int32)
    n_valid = torch.sum(valid, dim=-1)
    status = torch.where(
        n_valid < _MIN_SET + 2,
        torch.full_like(n_final, STATUS_FEW_MATCHES),
        torch.where(
            n_final >= min_inliers,
            torch.full_like(n_final, STATUS_VALID),
            torch.full_like(n_final, STATUS_INVALID),
        ),
    )
    ok = status == STATUS_VALID
    eye3 = torch.eye(3, dtype=dt, device=dev).expand(bsz, 3, 3)
    pose = SE3(
        torch.where(ok[:, None, None], T.R, eye3),
        torch.where(ok[:, None], T.t, torch.zeros_like(T.t)),
    )
    return RansacResult(pose, final_inl & ok[:, None], n_final, status)


def _mv6(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.sum(A * x[..., None, :], dim=-1)


def ransac_pose_3d2d(
    p_world: torch.Tensor,
    uv: torch.Tensor,
    xyz_cur: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraParams,
    iters: int = 500,
    threshold_px: float = 2.0,
    refine_steps: int = 5,
    min_inliers: int = 5,
    score_cap: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    idx: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> RansacResult:
    """Camera-pose PnP ^wX_c with pi(X^-1 p_w) = uv, hypotheses from 3-point
    alignment of current camera-frame points onto world landmarks; batched
    over a leading B like `ransac_rigid`."""
    return ransac_rigid(
        src=p_world, dst=xyz_cur, valid=valid, iters=iters,
        threshold=threshold_px, uv=uv, cam=cam, refine_steps=refine_steps,
        min_inliers=min_inliers, score_cap=score_cap, generator=generator,
        idx=idx, uniforms=uniforms,
    )
