"""All windows of a sequence solved at once (port of
`dynosam_tpu/backend/batch_windows.py`).

For offline processing the windows are independent given their frontend
initialisations (the reference likewise reconstructs every window graph
from the map, `RGBDBackendModule::constructGraph`), so every window of
the trajectory solves in one batched direct-Schur LM
(`schur.lm_optimize_schur_batched`: the windows on a leading axis, one
host read per LM iteration for all of them); windows above
`schur_max_window` or with `use_schur=False` solve one after another with
the LM-PCG.  Stitching: windows are written back in order, so overlap
frames keep the later window's estimate.  WorldMotion (updater 0), as in
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.lie import se3_identity
from ..utils.config import BackendConfig
from . import formulation as fm
from .backend import stack_trees
from .map import MeasurementMap, slice_window
from .schur import lm_optimize_schur_batched, world_motion_normal_product
from .solver import LMConfig, lm_optimize


def window_starts(n_frames: int, size: int, overlap: int) -> list:
    """Window start indices covering [0, n_frames) (SlidingWindow logic)."""
    stride = size - overlap
    starts = list(range(0, max(n_frames - size, 0) + 1, stride)) or [0]
    if starts[-1] + size < n_frames:            # cover the tail
        starts.append(max(n_frames - size, 0))
    return starts


def _solve_windows(m: MeasurementMap, starts: list, window: int, cfg: BackendConfig, lm_cfg: LMConfig):
    """Every window from its frontend initialisation, anchored at its
    frontend pose, on the whole pool: ([LMResult], [WindowMasks])."""
    ws = [slice_window(m, s, window) for s in starts]
    masks = [fm.build_masks(w, cfg) for w in ws]
    values = [fm.init_values(w, mk, cfg) for w, mk in zip(ws, masks)]
    if cfg.use_schur and window <= cfg.schur_max_window:
        results = lm_optimize_schur_batched(stack_trees(values), stack_trees(ws), stack_trees(masks), cfg, lm_cfg,
                                            stack_trees([w.X_init[0] for w in ws]))
    else:
        specs = fm.world_motion_families(cfg).robust
        results = [lm_optimize(lambda v, w=w, mk=mk: fm.world_motion_residuals(v, w, mk, cfg), specs, v, lm_cfg,
                               gn_diag_fn=lambda x, sw, w=w, mk=mk: fm.world_motion_gn_diag(x, sw, w, mk, cfg),
                               normal_fn=lambda x, sw, r, w=w, mk=mk: world_motion_normal_product(
                                   x, sw, r, w, mk, cfg, w.X_init[0]))
                   for v, w, mk in zip(values, ws, masks)]
    return results, masks


def solve_all_windows(m: MeasurementMap, n_frames: int, cfg: BackendConfig, lm_cfg: Optional[LMConfig] = None):
    """Solve every window of the sequence together; returns (stitched
    estimates {X (F,) SE3, X_valid, H (F, O) SE3, H_valid}, per-window
    final errors, per-window initial errors (numpy), starts)."""
    lm_cfg = lm_cfg or LMConfig(max_iterations=cfg.lm_max_iterations, cg_max_iterations=cfg.cg_max_iterations)
    size = cfg.opt_window_size
    starts = window_starts(n_frames, size, cfg.opt_window_overlap)
    results, masks = _solve_windows(m, starts, size, cfg, lm_cfg)

    F, O = m.motion_valid.shape
    dt, dev = m.static_xyz.dtype, m.static_xyz.device
    X, H = se3_identity((F,), dt, dev), se3_identity((F, O), dt, dev)
    X_valid = torch.zeros(F, dtype=torch.bool, device=dev)
    H_valid = torch.zeros((F, O), dtype=torch.bool, device=dev)
    for s, r, mk in zip(starts, results, masks):
        e = min(s + size, F)
        n = e - s
        sel, act = mk.frame[:n], mk.motion_active[:n]
        vX, vH = r.values["X"], r.values["H"]
        X.R[s:e] = torch.where(sel[:, None, None], vX.R[:n], X.R[s:e])
        X.t[s:e] = torch.where(sel[:, None], vX.t[:n], X.t[s:e])
        X_valid[s:e] |= sel
        H.R[s:e] = torch.where(act[..., None, None], vH.R[:n], H.R[s:e])
        H.t[s:e] = torch.where(act[..., None], vH.t[:n], H.t[s:e])
        H_valid[s:e] |= act
    errors = torch.stack([torch.stack([r.error, r.initial_error]) for r in results]).cpu().numpy()
    est = {"X": X, "X_valid": X_valid, "H": H, "H_valid": H_valid}
    return est, errors[:, 0], errors[:, 1], starts
