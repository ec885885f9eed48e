"""Trajectory & object-motion metrics: ATE, RPE, AME, RME (a copy of
`dynosam_tpu/eval/metrics.py`: numpy, float64; the port imports nothing of
the JAX package).

Native implementation of the reference's evo-based evaluation
(`dynosam_utils/dynosam_utils/evaluation/core/metrics.py`,
`evaluation_lib.py:171-683`):

  * **ATE** (camera): evo-APE equivalent — optional SE(3) alignment, then
    per-frame absolute pose error statistics.
  * **RPE** (camera/object): relative pose error over consecutive frames,
    translation (m) and rotation (deg) parts.
  * **AME** (objects): APE over the estimated world-frame motion
    "trajectory" H_k vs GT motions (`core/metrics.py:49-52`).
  * **RME** (objects): motion error mapped into the object frame:
    E_k = L_{k-1}^gt^-1 · (H_k^est)^-1 · H_k^gt · L_{k-1}^gt  vs identity
    (`core/metrics.py:55-108`, the `lie.se3_inverse(pose) @ motion @ pose`
    composition at :93).

All functions take (N, 4, 4) pose arrays (numpy) and return per-frame error
arrays plus summary statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class ErrorStats:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float

    @staticmethod
    def from_errors(e: np.ndarray) -> "ErrorStats":
        e = np.asarray(e, np.float64)
        if e.size == 0:
            return ErrorStats(*([float("nan")] * 6))
        return ErrorStats(
            rmse=float(np.sqrt(np.mean(e**2))),
            mean=float(np.mean(e)),
            median=float(np.median(e)),
            std=float(np.std(e)),
            min=float(np.min(e)),
            max=float(np.max(e)),
        )

    def as_dict(self):
        return dataclasses.asdict(self)


def _trans_err(T: np.ndarray) -> np.ndarray:
    return np.linalg.norm(T[..., :3, 3], axis=-1)


def _rot_err_deg(T: np.ndarray) -> np.ndarray:
    tr = np.trace(T[..., :3, :3], axis1=-2, axis2=-1)
    c = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(c))


def umeyama_alignment(est_t: np.ndarray, gt_t: np.ndarray, with_scale=False):
    """SE(3) (optionally Sim(3)) alignment of est onto gt (evo's -a)."""
    mu_e = est_t.mean(axis=0)
    mu_g = gt_t.mean(axis=0)
    e0 = est_t - mu_e
    g0 = gt_t - mu_g
    C = g0.T @ e0 / est_t.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (e0**2).sum() / est_t.shape[0]
        s = np.trace(np.diag(D) @ S) / var_e
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate(
    est: np.ndarray,
    gt: np.ndarray,
    align: bool = True,
    align_mode: str = "umeyama",
) -> Dict[str, object]:
    """Absolute trajectory error (translation, meters).  est/gt: (N,4,4).

    `align_mode="umeyama"` (default) is evo-APE parity: one position
    Umeyama fit, exactly what the reference's evaluation computes
    (`evaluation_lib.py:575-683`) — reported numbers are comparable with
    the reference's evo pipeline.  `align_mode="best"` additionally tries
    the first-pose alignment and keeps the better combined (trans+rot)
    fit: position-only Umeyama can pick a ~180-deg flipped fit on
    near-straight trajectories (rotation about the path axis is barely
    constrained).  Useful diagnostically; NOT comparable with evo.
    """
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)

    def apply(sRt):
        s, R, t = sRt
        out = est.copy()
        for i in range(est.shape[0]):
            out[i, :3, :3] = R @ est[i, :3, :3]
            out[i, :3, 3] = s * R @ est[i, :3, 3] + t
        return out

    candidates = [est]
    if align and est.shape[0] >= 3:
        candidates = [apply(umeyama_alignment(est[:, :3, 3], gt[:, :3, 3]))]
        if align_mode == "best":
            A = gt[0] @ np.linalg.inv(est[0])
            candidates.append(apply((1.0, A[:3, :3], A[:3, 3])))

    def score(est_a):
        rel = np.einsum("nij,njk->nik", np.linalg.inv(gt), est_a)
        errs = _trans_err(rel)
        rot = _rot_err_deg(rel)
        combined = float(np.sqrt(np.mean(errs**2))) * (
            1.0 + float(np.sqrt(np.mean(rot**2))) / 30.0
        )
        return combined, errs, rot

    scored = [score(c) for c in candidates]
    _, errs, rot = min(scored, key=lambda x: x[0])
    return {
        "trans": ErrorStats.from_errors(errs),
        "rot": ErrorStats.from_errors(rot),
        "per_frame": errs,
    }


def rpe(
    est: np.ndarray, gt: np.ndarray, delta: int = 1
) -> Dict[str, object]:
    """Relative pose error over `delta`-frame steps."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    n = est.shape[0]
    if n <= delta:
        return {
            "trans": ErrorStats.from_errors(np.array([])),
            "rot": ErrorStats.from_errors(np.array([])),
            "per_frame": np.array([]),
        }
    rel_est = np.einsum(
        "nij,njk->nik", np.linalg.inv(est[:-delta]), est[delta:]
    )
    rel_gt = np.einsum(
        "nij,njk->nik", np.linalg.inv(gt[:-delta]), gt[delta:]
    )
    err = np.einsum("nij,njk->nik", np.linalg.inv(rel_gt), rel_est)
    return {
        "trans": ErrorStats.from_errors(_trans_err(err)),
        "rot": ErrorStats.from_errors(_rot_err_deg(err)),
        "per_frame": _trans_err(err),
    }


def ame(H_est: np.ndarray, H_gt: np.ndarray) -> Dict[str, object]:
    """Absolute motion error: APE over world-frame motions (objects)."""
    err = np.einsum(
        "nij,njk->nik", np.linalg.inv(np.asarray(H_gt, np.float64)),
        np.asarray(H_est, np.float64),
    )
    return {
        "trans": ErrorStats.from_errors(_trans_err(err)),
        "rot": ErrorStats.from_errors(_rot_err_deg(err)),
    }


def rme(
    H_est: np.ndarray, H_gt: np.ndarray, L_gt_prev: np.ndarray
) -> Dict[str, object]:
    """Relative motion error in the object frame (`core/metrics.py:55-108`):
    E_k = L_{k-1}^-1 · (H^est_k)^-1 · H^gt_k · L_{k-1} vs identity."""
    Hl = np.asarray(H_est, np.float64)
    Hg = np.asarray(H_gt, np.float64)
    L = np.asarray(L_gt_prev, np.float64)
    E = np.einsum(
        "nij,njk,nkl,nlm->nim",
        np.linalg.inv(L),
        np.linalg.inv(Hl),
        Hg,
        L,
    )
    return {
        "trans": ErrorStats.from_errors(_trans_err(E)),
        "rot": ErrorStats.from_errors(_rot_err_deg(E)),
    }
