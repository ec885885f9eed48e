"""Backend window solve (port of `dynosam_tpu/backend/backend.py:optimize_window`,
the direct-Schur sliding-window path of updater 0).

Slices a window from the measurement map, compacts it to its most-observed
slots, builds and solves its WorldMotion graph, and scatters the result
back to pool coordinates.  The online runtime of the JAX module
(`RGBDBackend`, `EstimateStore`, checkpoints, object-pose propagation) is
ROADMAP.md item 13; `throughput.run_offline` drives the backend today.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.lie import SE3, se3_identity, se3_where
from ..utils.config import BackendConfig
from . import formulation as fm
from .map import MeasurementMap, compact_window, slice_window
from .schur import lm_optimize_schur
from .solver import LMConfig


def check_backend_config(cfg: BackendConfig, window: Optional[int] = None) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item that ports it,
    for every backend option outside the ported path (WorldMotion,
    sliding windows solved one at a time by the direct Schur LM)."""
    window = cfg.opt_window_size if window is None else window
    if cfg.backend_updater_enum != 0:
        raise NotImplementedError(
            "backend_updater_enum=1 (WorldPose) is ported by ROADMAP.md item 11")
    if cfg.use_fixed_lag_prior:
        raise NotImplementedError("use_fixed_lag_prior=True is ported by ROADMAP.md item 11")
    if cfg.use_full_batch_opt or cfg.use_varpro or not cfg.use_schur or window > cfg.schur_max_window:
        raise NotImplementedError(
            "full-batch, varpro and LM-PCG solves (use_full_batch_opt=True, use_varpro=True, "
            "use_schur=False or opt_window_size > schur_max_window) are ported by ROADMAP.md item 12")
    if cfg.opt_windows_per_dispatch > 1:
        raise NotImplementedError(
            "opt_windows_per_dispatch > 1 (batched window solves) is ported by ROADMAP.md item 12")


def optimize_window(m: MeasurementMap, start: int, window: int, cfg: BackendConfig, lm_cfg: LMConfig,
                    anchor: SE3, use_anchor: torch.Tensor, prev: Optional[dict] = None,
                    prev_mask: Optional[dict] = None):
    """Slice frames [start, start + window) from the map, build and solve
    their graph; returns (LMResult, WindowMasks), both in pool coordinates.

    `anchor` pins the first window pose where `use_anchor` (a 0-d bool
    tensor) is set, else the frontend pose does; `prev`/`prev_mask`
    warm-start the values from the estimate store."""
    check_backend_config(cfg, window)
    w = slice_window(m, start, window)
    _, NS, ND, O = m.capacity
    ns_win = min(NS, cfg.window_max_static or NS)
    nd_win = min(ND, cfg.window_max_dynamic or ND)
    no_win = min(O, cfg.window_max_objects or O)
    compacting = ns_win < NS or nd_win < ND or no_win < O
    if compacting:
        w, sp_idx, dp_idx, obj_idx = compact_window(w, ns_win, nd_win, no_win)
        if prev is not None:
            prev = {"X": prev["X"], "H": prev["H"][:, obj_idx], "sp": prev["sp"][sp_idx],
                    "dp": prev["dp"][:, dp_idx]}
            prev_mask = {"X": prev_mask["X"], "H": prev_mask["H"][:, obj_idx],
                         "sp": prev_mask["sp"][sp_idx], "dp": prev_mask["dp"][:, dp_idx]}
    masks = fm.build_masks(w, cfg)
    anchor_pose = se3_where(use_anchor, anchor, w.X_init[0])
    values = fm.init_values(w, masks, cfg, prev=prev, prev_mask=prev_mask)
    result = lm_optimize_schur(values, w, masks, cfg, lm_cfg, anchor_pose)
    if not compacting:
        return result, masks

    # scatter the compacted values and masks back to pool coordinates
    vals = dict(result.values)
    dt, dev = vals["sp"].dtype, vals["sp"].device
    sp = torch.zeros((NS, 3), dtype=dt, device=dev)
    sp[sp_idx] = vals["sp"]
    dp = torch.zeros((window, ND, 3), dtype=dt, device=dev)
    dp[:, dp_idx] = vals["dp"]
    H = se3_identity((window, O), dt, dev)
    H.R[:, obj_idx] = vals["H"].R
    H.t[:, obj_idx] = vals["H"].t
    vals.update(sp=sp, dp=dp, H=H)

    def scatter(mask, n, idx):
        full = torch.zeros((window, n), dtype=torch.bool, device=dev)
        full[:, idx] = mask
        return full

    masks = masks._replace(
        static_obs=scatter(masks.static_obs, NS, sp_idx), dyn_obs=scatter(masks.dyn_obs, ND, dp_idx),
        ternary=scatter(masks.ternary, ND, dp_idx), smoothing=scatter(masks.smoothing, O, obj_idx),
        motion_active=scatter(masks.motion_active, O, obj_idx),
    )
    return result._replace(values=vals), masks

