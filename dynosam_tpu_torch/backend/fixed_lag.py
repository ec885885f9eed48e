"""Fixed-lag smoothing by boundary marginalisation (port of
`dynosam_tpu/backend/fixed_lag.py`).

When the sliding window moves from [s, s+W) to [s', s'+W), the
information of the frames that left is marginalised onto the boundary
camera pose X_{s'} and carried into the next window as a full-information
prior replacing the isotropic gauge anchor
(`schur.lm_optimize_schur(anchor_prior_L=...)`):

  1. build the sub-window [s, s'] normal system at the current estimates,
     the boundary frame's own point observations masked out (the next
     window rebuilds them);
  2. reduce it by the production landmark elimination
     (`schur_step(with_reduced=True)`) to the {X, P} system;
  3. take the Schur complement of everything but the boundary X block:
     Lam = H_bb - H_bm H_mm^-1 H_mb (6 x 6), and hand the next window
     L = chol(Lam).

The marginal is formed at the current linearisation point and never
relinearised; landmarks seen by leaving frames are marginalised even when
re-observed later; boundary object motions or poses are marginalised, and
the sub-window's own anchor (the previous prior) adds its information.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.lie import SE3
from ..utils.config import BackendConfig
from . import formulation as fm
from .map import MeasurementMap, compact_window, slice_window
from .schur import build_normal_system, build_normal_system_pose, schur_step
from .solver import sqrt_weights


def boundary_prior(m: MeasurementMap, start: int, n_sub: int, cfg: BackendConfig, est_values: dict,
                   updater: int = 0, anchor: Optional[SE3] = None,
                   prev_prior_L: Optional[torch.Tensor] = None):
    """(L, xbar): the Cholesky factor (6, 6) of the boundary marginal
    information and the boundary pose estimate.

    `est_values` holds the current estimates over the sub-window frames
    [start, start + n_sub): {"X": SE3 (n_sub,), "H" or "L": SE3 (n_sub, O),
    "sp": (NS, 3), "dp": (n_sub, ND, 3)}.  `prev_prior_L` chains the
    previous slide's marginal through the sub-window's own anchor, so the
    gauge information carries over."""
    w = slice_window(m, start, n_sub)
    _, NS, ND, O = m.capacity
    ns_win = min(NS, cfg.window_max_static or NS)
    nd_win = min(ND, cfg.window_max_dynamic or ND)
    no_win = min(O, cfg.window_max_objects or O)
    key = fm.pose_key(updater)
    vals = dict(est_values)
    if ns_win < NS or nd_win < ND or no_win < O:
        w, sp_idx, dp_idx, obj_idx = compact_window(w, ns_win, nd_win, no_win)
        vals = {"X": vals["X"], key: vals[key][:, obj_idx], "sp": vals["sp"][sp_idx],
                "dp": vals["dp"][:, dp_idx]}
    masks = fm.build_masks(w, cfg)
    # the boundary frame keeps only its coupling factors (odometry and
    # motion factors into the leaving frames); the next window rebuilds
    # its point observations
    last = torch.arange(n_sub, device=w.frame_valid.device) == n_sub - 1
    masks = masks._replace(static_obs=masks.static_obs & ~last[:, None], dyn_obs=masks.dyn_obs & ~last[:, None])
    anchor_pose = anchor if anchor is not None else w.X_init[0]
    if updater == 0:
        families, residuals, build = fm.world_motion_families, fm.world_motion_residuals, build_normal_system
    else:
        families, residuals, build = fm.world_pose_families, fm.world_pose_residuals, build_normal_system_pose
    res = residuals(vals, w, masks, cfg, anchor_pose, prev_prior_L)
    sys = build(vals, sqrt_weights(res, families(cfg).robust), w, masks, cfg, anchor_pose, res, prev_prior_L)
    lam = torch.full((), 1e-8, dtype=w.static_xyz.dtype, device=w.static_xyz.device)
    _, (Hred, _) = schur_step(sys, lam, 1e-8, updater, with_reduced=True)
    b0, nc = 6 * (n_sub - 1), 6 * n_sub
    n = Hred.shape[0]
    keep = torch.arange(b0, nc, device=Hred.device)
    drop = torch.cat([torch.arange(b0, device=Hred.device), torch.arange(nc, n, device=Hred.device)])
    Hbm = Hred[keep][:, drop]
    # `solve_ex`: no error check, so no host read (JAX's solve checks nothing)
    Lam = Hred[keep][:, keep] - Hbm @ torch.linalg.solve_ex(Hred[drop][:, drop], Hbm.T).result
    Lam = 0.5 * (Lam + Lam.T)
    # relative + tiny absolute floor: structurally weak directions keep the
    # Cholesky finite without drowning the marginal
    dmax = torch.max(torch.abs(torch.diagonal(Lam)))
    Lam = Lam + (1e-6 * dmax + 1e-4) * torch.eye(6, dtype=Lam.dtype, device=Lam.device)
    # a failed factorisation gives NaN, as JAX's cholesky does, without a host read
    L, info = torch.linalg.cholesky_ex(Lam)
    return torch.where(info == 0, L, torch.full_like(L, float("nan"))), vals["X"][n_sub - 1]
