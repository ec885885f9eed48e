"""RGB-D backend module: map update and windowed or full-batch optimisation
(port of `dynosam_tpu/backend/backend.py`), WorldMotion (updater 0) or
WorldPose (updater 1).

Per frame `RGBDBackend.spin` writes the frontend packet into the
measurement map and, when `SlidingWindowTrigger` completes a window,
solves it (`solve_window`) warm-started from the estimate store and
writes the result back; `finish` runs the final partial window or the one
full-batch solve.  Windows up to `schur_max_window` frames use the direct
Schur LM (`backend/schur.py`) on a compacted window, with the fixed-lag
boundary prior as their anchor under `use_fixed_lag_prior`; longer
windows (full batch) use the matrix-free LM-PCG
(`backend/solver.py:lm_optimize`) on the whole pool, and `use_varpro`
(updater 0) the variable-projection solve (`backend/varpro.py`), as in
the JAX package.  `solve_windows` solves several windows from one
pre-state, the direct-Schur ones batched on a leading axis.  The spin
path never reads the device: the anchor gate stays a 0-d device bool and
the write-back is in-place indexing; inside a solve the LM reads once per
iteration (and PCG once per chunk of CG iterations).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.lie import SE3, se3_compose, se3_exp, se3_identity, se3_inverse, se3_log, se3_where
from ..core.types import FrontendOutput
from ..frontend.frontend import to_device
from ..utils.config import BackendConfig, CapacityConfig
from ..utils.device import resolve_device
from . import formulation as fm
from . import varpro
from .fixed_lag import boundary_prior
from .formulation import WindowMasks, pose_key
from .map import MeasurementMap, WindowData, compact_window, slice_window, update_map
from .schur import lm_optimize_schur, lm_optimize_schur_batched, world_motion_normal_product, world_pose_normal_product
from .solver import LMConfig, LMResult, lm_optimize


class WindowProblem(NamedTuple):
    """One window ready for its solve: the (compacted) window, its masks,
    initial values and anchor, and the compaction's slot indices (None
    when the window is the whole pool)."""

    w: WindowData
    masks: WindowMasks
    values: dict
    anchor: SE3
    compacted: Optional[tuple]      # (sp_idx, dp_idx, obj_idx)
    pool: tuple                     # (window, NS, ND, O)


def prepare_window(m: MeasurementMap, start: int, window: int, cfg: BackendConfig, anchor: SE3,
                   use_anchor: torch.Tensor, updater: int = 0, prev: Optional[dict] = None,
                   prev_mask: Optional[dict] = None) -> WindowProblem:
    """Slice frames [start, start + window) from the map and build the
    window's masks and initial values.  Direct-Schur windows are compacted
    to their most-observed slots; longer ones (full batch) and varpro stay
    on the whole pool: a full-batch solve over a long sequence carries
    more active tracks than the window caps, and compaction would silently
    drop its thinnest tracks.  `anchor` pins the first window pose where
    `use_anchor` (a 0-d bool tensor) is set, else the frontend pose does;
    `prev`/`prev_mask` warm-start the values from the estimate store."""
    w = slice_window(m, start, window)
    _, NS, ND, O = m.capacity
    key = pose_key(updater)
    ns_win = min(NS, cfg.window_max_static or NS)
    nd_win = min(ND, cfg.window_max_dynamic or ND)
    no_win = min(O, cfg.window_max_objects or O)
    compacted = None
    if not cfg.use_varpro and window <= cfg.schur_max_window and (ns_win < NS or nd_win < ND or no_win < O):
        w, sp_idx, dp_idx, obj_idx = compact_window(w, ns_win, nd_win, no_win)
        compacted = (sp_idx, dp_idx, obj_idx)
        if prev is not None:
            def take(d):
                return {"X": d["X"], key: d[key][:, obj_idx], "sp": d["sp"][sp_idx], "dp": d["dp"][:, dp_idx]}
            prev, prev_mask = take(prev), take(prev_mask)
    masks = fm.build_masks(w, cfg)
    anchor_pose = se3_where(use_anchor, anchor, w.X_init[0])
    if updater == 0 and cfg.use_varpro:
        full = fm.init_values(w, masks, cfg)
        values = {"X": full["X"], "H": full["H"]}
    elif updater == 0:
        values = fm.init_values(w, masks, cfg, prev=prev, prev_mask=prev_mask)
    else:
        values = fm.init_values_world_pose(w, masks, cfg, prev=prev, prev_mask=prev_mask)
    return WindowProblem(w, masks, values, anchor_pose, compacted, (window, NS, ND, O))


def uses_schur(cfg: BackendConfig, window: int, updater: int) -> bool:
    """Whether a window of this length goes to the direct Schur LM."""
    return cfg.use_schur and window <= cfg.schur_max_window and not (updater == 0 and cfg.use_varpro)


def solve_problem(p: WindowProblem, cfg: BackendConfig, lm_cfg: LMConfig, updater: int = 0,
                  anchor_prior_L: Optional[torch.Tensor] = None) -> LMResult:
    """The LM solve of one prepared window (values in window coordinates):
    varpro (updater 0, `use_varpro`; landmarks recovered in closed form
    afterwards, Hutchinson probes from a generator seeded 0 as the JAX
    package seeds its key), the direct Schur LM with the anchor or the
    fixed-lag prior `anchor_prior_L`, or the LM-PCG, whose anchor is
    always isotropic (as in the JAX package)."""
    w, masks, values, anchor = p.w, p.masks, p.values, p.anchor
    if updater == 0 and cfg.use_varpro:
        resid = lambda v: varpro.world_motion_varpro_residuals(v, w, masks, cfg, anchor)  # noqa: E731
        result = lm_optimize(resid, fm.world_motion_families(cfg).robust, values, lm_cfg,
                             normal_fn=varpro.linearized_normal_product(resid))
        X, H = result.values["X"], result.values["H"]
        return result._replace(values=varpro.recover_points(X, H, w, masks, cfg))
    if uses_schur(cfg, p.pool[0], updater):
        return lm_optimize_schur(values, w, masks, cfg, lm_cfg, anchor, formulation=updater,
                                 anchor_prior_L=anchor_prior_L)
    if updater == 0:
        families, residuals, gn_diag, product = (fm.world_motion_families, fm.world_motion_residuals,
                                                 fm.world_motion_gn_diag, world_motion_normal_product)
    else:
        families, residuals, gn_diag, product = (fm.world_pose_families, fm.world_pose_residuals,
                                                 fm.world_pose_gn_diag, world_pose_normal_product)
    return lm_optimize(
        lambda v: residuals(v, w, masks, cfg, anchor), families(cfg).robust, values, lm_cfg,
        gn_diag_fn=lambda v, sw: gn_diag(v, sw, w, masks, cfg),
        normal_fn=lambda v, sw, res: product(v, sw, res, w, masks, cfg, anchor),
    )


def finish_window(p: WindowProblem, result: LMResult, updater: int = 0):
    """(LMResult, WindowMasks) in pool coordinates: a compacted window's
    values and masks scattered back to the pool slots."""
    if p.compacted is None:
        return result, p.masks
    sp_idx, dp_idx, obj_idx = p.compacted
    window, NS, ND, O = p.pool
    key = pose_key(updater)
    vals = dict(result.values)
    dt, dev = vals["sp"].dtype, vals["sp"].device
    sp = torch.zeros((NS, 3), dtype=dt, device=dev)
    sp[sp_idx] = vals["sp"]
    dp = torch.zeros((window, ND, 3), dtype=dt, device=dev)
    dp[:, dp_idx] = vals["dp"]
    P = se3_identity((window, O), dt, dev)
    P.R[:, obj_idx] = vals[key].R
    P.t[:, obj_idx] = vals[key].t
    vals.update({"sp": sp, "dp": dp, key: P})

    def scatter(mask, n, idx):
        full = torch.zeros((window, n), dtype=torch.bool, device=dev)
        full[:, idx] = mask
        return full

    masks = p.masks
    masks = masks._replace(
        static_obs=scatter(masks.static_obs, NS, sp_idx), dyn_obs=scatter(masks.dyn_obs, ND, dp_idx),
        ternary=scatter(masks.ternary, ND, dp_idx), smoothing=scatter(masks.smoothing, O, obj_idx),
        motion_active=scatter(masks.motion_active, O, obj_idx),
    )
    return result._replace(values=vals), masks


def stack_trees(trees: list):
    """Stack equal-shaped trees (tensors, dicts, NamedTuples) on a new
    leading axis; other leaves (a window's `start`) are taken from the
    first."""
    a = trees[0]
    if isinstance(a, torch.Tensor):
        return torch.stack(trees)
    if isinstance(a, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in a}
    if isinstance(a, tuple):
        return type(a)(*(stack_trees(list(x)) for x in zip(*trees)))
    return a


def optimize_windows(m: MeasurementMap, starts: list, window: int, cfg: BackendConfig, lm_cfg: LMConfig,
                     inputs: list, updater: int = 0, anchor_prior_L: Optional[torch.Tensor] = None) -> list:
    """Slice each window [start, start + window) from the map, build and
    solve its graph from its own (anchor, use_anchor, prev, prev_mask) in
    `inputs`: [(LMResult, WindowMasks)] in pool coordinates
    (`prepare_window`, `solve_problem`, `finish_window`).  Several
    direct-Schur windows solve together on a leading window axis
    (`schur.lm_optimize_schur_batched`, the JAX package's vmapped solve);
    LM-PCG and varpro windows solve one after another.  `anchor_prior_L`
    anchors a single window."""
    problems = [prepare_window(m, s, window, cfg, anchor, use_anchor, updater, prev, prev_mask)
                for s, (anchor, use_anchor, prev, prev_mask) in zip(starts, inputs)]
    if len(problems) > 1 and uses_schur(cfg, window, updater):
        results = lm_optimize_schur_batched(
            stack_trees([p.values for p in problems]), stack_trees([p.w for p in problems]),
            stack_trees([p.masks for p in problems]), cfg, lm_cfg, stack_trees([p.anchor for p in problems]),
            formulation=updater)
    else:
        results = [solve_problem(p, cfg, lm_cfg, updater, anchor_prior_L) for p in problems]
    return [finish_window(p, r, updater) for p, r in zip(problems, results)]


def optimize_window(m: MeasurementMap, start: int, window: int, cfg: BackendConfig, lm_cfg: LMConfig,
                    anchor: SE3, use_anchor: torch.Tensor, updater: int = 0, prev: Optional[dict] = None,
                    prev_mask: Optional[dict] = None, anchor_prior_L: Optional[torch.Tensor] = None):
    """One window of `optimize_windows`: (LMResult, WindowMasks)."""
    return optimize_windows(m, [start], window, cfg, lm_cfg, [(anchor, use_anchor, prev, prev_mask)], updater,
                            anchor_prior_L)[0]


def lm_config(cfg: BackendConfig) -> LMConfig:
    """The LM settings of a backend config."""
    return LMConfig(
        max_iterations=cfg.lm_max_iterations, initial_lambda=cfg.lm_initial_lambda,
        lambda_factor=cfg.lm_lambda_factor, max_lambda=cfg.lm_max_lambda, min_lambda=cfg.lm_min_lambda,
        rel_error_tol=cfg.lm_rel_error_tol, abs_error_tol=cfg.lm_abs_error_tol,
        cg_max_iterations=cfg.cg_max_iterations, cg_tol=cfg.cg_tol,
    )


class EstimateStore(NamedTuple):
    """Global state estimates over all frames (device tensors), written in
    place by `solve_window`: the store of the online backend and of the
    offline runner alike.  The JAX package keeps two (`EstimateStore`, and
    `throughput.EstStore` for traced code, whose P holds H or L)."""

    X: SE3                        # (F,) camera poses
    H: SE3                        # (F, O) object motions (updater 0)
    L: SE3                        # (F, O) object poses (updater 1)
    static_points: torch.Tensor   # (NS, 3)
    static_valid: torch.Tensor    # (NS,)
    dyn_points: torch.Tensor      # (F, ND, 3)
    dyn_valid: torch.Tensor       # (F, ND)
    X_valid: torch.Tensor         # (F,)
    motion_valid: torch.Tensor    # (F, O)

    @staticmethod
    def create(f: int, ns: int, nd: int, no: int, dtype=torch.float32, device=None) -> "EstimateStore":
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)  # noqa: E731
        return EstimateStore(
            X=se3_identity((f,), dtype, device), H=se3_identity((f, no), dtype, device),
            L=se3_identity((f, no), dtype, device),
            static_points=torch.zeros((ns, 3), dtype=dtype, device=device), static_valid=zb(ns),
            dyn_points=torch.zeros((f, nd, 3), dtype=dtype, device=device), dyn_valid=zb(f, nd),
            X_valid=zb(f), motion_valid=zb(f, no),
        )


def window_inputs(est: EstimateStore, start: int, window: int, updater: int = 0):
    """(anchor, use_anchor, prev, prev_mask) of the window at `start`: the
    anchor is the previous estimate of the first window pose if it was
    already optimised (window overlap), else the frontend's, and the
    values warm-start from the store where it holds estimates.  The gate
    stays a device bool, so the caller never waits for a solve."""
    use_anchor = est.X_valid[start]
    sl = slice(start, start + window)
    key = pose_key(updater)
    prev = {"X": est.X[sl], key: getattr(est, key)[sl], "sp": est.static_points, "dp": est.dyn_points[sl]}
    prev_mask = {"X": est.X_valid[sl] & use_anchor, key: est.motion_valid[sl] & use_anchor,
                 "sp": est.static_valid & use_anchor, "dp": est.dyn_valid[sl] & use_anchor}
    return est.X[start], use_anchor, prev, prev_mask


def write_back(est: EstimateStore, start: int, values: dict, masks: WindowMasks, updater: int = 0) -> None:
    """Write a solved window (pool coordinates) into the store, in place:
    X, H or L, the points, and their validity."""
    sl = slice(start, start + masks.frame.shape[0])
    key = pose_key(updater)
    P = getattr(est, key)
    est.X.R[sl] = values["X"].R
    est.X.t[sl] = values["X"].t
    est.X_valid[sl] = masks.frame
    P.R[sl] = values[key].R
    P.t[sl] = values[key].t
    est.motion_valid[sl] = masks.motion_active
    seen = masks.static_obs.any(0)
    est.static_points.copy_(torch.where(seen[:, None], values["sp"], est.static_points))
    est.static_valid.logical_or_(seen)
    est.dyn_points[sl] = values["dp"]
    est.dyn_valid[sl] = masks.dyn_obs


def solve_windows(est: EstimateStore, m: MeasurementMap, starts: list, window: int, cfg: BackendConfig,
                  lm_cfg: LMConfig, anchor_prior_L: Optional[torch.Tensor] = None) -> list:
    """Solve the windows at `starts` together (`optimize_windows`) and
    write them back into `est`, in place: every window warm-starts from
    the store as it stood before any of them solved, and the write-backs
    apply in order, so overlap frames keep the later window's estimate.
    Returns [(LMResult, WindowMasks in pool coordinates)]."""
    updater = cfg.backend_updater_enum
    inputs = [window_inputs(est, s, window, updater) for s in starts]
    out = optimize_windows(m, starts, window, cfg, lm_cfg, inputs, updater, anchor_prior_L)
    for s, (result, masks) in zip(starts, out):
        write_back(est, s, result.values, masks, updater)
    return out


def solve_window(est: EstimateStore, m: MeasurementMap, start: int, window: int, cfg: BackendConfig,
                 lm_cfg: LMConfig, anchor_prior_L: Optional[torch.Tensor] = None):
    """Solve frames [start, start + window) warm-started from `est` (the
    fixed-lag prior `anchor_prior_L` as its anchor, if given) and write the
    result back into it: (LMResult, WindowMasks)."""
    return solve_windows(est, m, [start], window, cfg, lm_cfg, anchor_prior_L)[0]


class SlidingWindowTrigger:
    """Frame-count arithmetic of `SlidingWindow::check`
    (`backend/RGBDBackendModule.hpp:120-144`)."""

    def __init__(self, size: int, overlap: int, first_frame: int = 0):
        assert 0 <= overlap < size
        self.size = size
        self.overlap = overlap
        self.start = first_frame

    def check(self, frame_idx: int):
        """The window start if [start, start + size) is complete at this
        frame, else None."""
        if frame_idx >= self.start + self.size - 1:
            s = self.start
            self.start = s + (self.size - self.overlap)
            return s
        return None


class RGBDBackend:
    """Owns the measurement map, the estimate store and the window solves, on one device
    (CUDA unless `device="cpu"`)."""

    def __init__(self, cfg: BackendConfig, cap: CapacityConfig, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.cap = cap
        self.dtype = dtype
        self.device = resolve_device(device)
        f, ns, nd, no = cap.max_frames, cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects
        self.map = MeasurementMap.create(f, ns, nd, no, dtype, self.device)
        self.est = EstimateStore.create(f, ns, nd, no, dtype, self.device)
        self.n_frames = 0
        self.trigger = SlidingWindowTrigger(cfg.opt_window_size, cfg.opt_window_overlap)
        self.lm_cfg = lm_config(cfg)
        self.last_result: Optional[LMResult] = None
        self.solves: list = []      # (start, window, LMResult, CUDA events or None) per solve
        # fixed-lag state (`use_fixed_lag_prior`): the previous window's
        # start and the running boundary-marginal Cholesky factor
        self._last_window_start: Optional[int] = None
        self._prior_L: Optional[torch.Tensor] = None

    def spin(self, packet: FrontendOutput):
        """Insert one frontend packet; optimise if a window completed."""
        k = self.n_frames
        update_map(self.map, to_device(packet, self.device), k)
        self.n_frames += 1
        if self.cfg.use_full_batch_opt:
            return None
        start = self.trigger.check(k)
        if start is not None:
            self._optimize(start, self.cfg.opt_window_size)
        return self.last_result

    def finish(self):
        """End of sequence: the full-batch solve or the final partial window."""
        if self.cfg.use_full_batch_opt:
            self._optimize(0, self._full_batch_len())
        elif self.n_frames > self.trigger.start + 1:
            self._optimize(self.trigger.start, min(self.cfg.opt_window_size, self.cap.max_frames))
        return self.last_result

    def _full_batch_len(self) -> int:
        return min(self.cap.max_frames, max(self.cfg.opt_window_size, self.n_frames))

    def _optimize(self, start: int, window: int):
        window = min(window, self.cap.max_frames - start)
        if window < 2:
            return
        prior_L = self._slide_prior(start) if self.cfg.use_fixed_lag_prior else None
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        result, _ = solve_window(self.est, self.map, start, window, self.cfg, self.lm_cfg, prior_L)
        self.last_result = result
        self._last_window_start = start
        if events is not None:
            events[1].record()
        self.solves.append((start, window, result, events))

    def _slide_prior(self, start: int) -> torch.Tensor:
        """(6, 6) anchor-prior Cholesky factor of the window at `start`
        (fixed-lag mode): the isotropic anchor in L-form for the first
        window, then the boundary marginal of the frames that left since
        the previous solve (`fixed_lag.boundary_prior`), chained through
        the previous factor."""
        iso = torch.eye(6, dtype=self.dtype, device=self.device) / self.cfg.initial_pose_prior_sigma
        last = self._last_window_start
        if last is None or start <= last:
            self._prior_L = iso
            return iso
        n_sub = start - last + 1
        updater = self.cfg.backend_updater_enum
        key = pose_key(updater)
        sl = slice(last, last + n_sub)
        est_values = {"X": self.est.X[sl], key: getattr(self.est, key)[sl], "sp": self.est.static_points,
                      "dp": self.est.dyn_points[sl]}
        self._prior_L, _ = boundary_prior(self.map, last, n_sub, self.cfg, est_values, updater, self.est.X[last],
                                          iso if self._prior_L is None else self._prior_L)
        return self._prior_L

    # ------------------------------------------------------------------
    # Accessors (`Accessor<MAP>`, `backend/Accessor.hpp:51-207`)
    # ------------------------------------------------------------------
    def camera_poses(self):
        """(F,) SE3 and validity of the optimised camera trajectory."""
        return self.est.X, self.est.X_valid

    def object_motions(self):
        """(F, O) object motions and validity; under WorldPose H_k = L_k
        L_{k-1}^-1 (`WorldPoseAccessor::getObjectMotion`), valid where both
        poses are, identity at frame 0."""
        if self.cfg.backend_updater_enum == 0:
            return self.est.H, self.est.motion_valid
        L, mv = self.est.L, self.est.motion_valid
        H = se3_compose(L[1:], se3_inverse(L[:-1]))
        pad = se3_identity((1, L.batch_shape[1]), L.t.dtype, L.t.device)
        return SE3(torch.cat([pad.R, H.R]), torch.cat([pad.t, H.t])), mv & fm.shift_prev(mv)

    def object_poses(self):
        """(F, O) object poses and validity: the optimised L under
        WorldPose; under WorldMotion L_k = H_k L_{k-1} propagated from the
        centroids, with the reference's slerp gap-fill
        (`propagate_object_poses`)."""
        if self.cfg.backend_updater_enum == 1:
            return self.est.L, self.est.motion_valid
        centroids, cvalid = self.object_centroids()
        return propagate_object_poses(self.est.H, self.est.motion_valid, centroids, cvalid)

    def object_centroids(self):
        """Per (frame, object) centroid of the optimised dynamic points
        (`Accessor::computeObjectCentroid`): sums and counts by `index_add_`
        over the (frame, track) rows, valid rows weighted 1."""
        dp, dv, obj = self.est.dyn_points, self.est.dyn_valid, self.map.dyn_obj
        F, ND = dv.shape
        O = self.cap.max_objects
        wgt = (dv & (obj >= 0)).to(dp.dtype)
        idx = (torch.arange(F, device=dp.device)[:, None] * O + obj.clamp(min=0)).reshape(-1)
        sums = torch.zeros((F * O, 3), dtype=dp.dtype, device=dp.device)
        sums.index_add_(0, idx, (dp * wgt[..., None]).reshape(-1, 3))
        counts = torch.zeros(F * O, dtype=dp.dtype, device=dp.device)
        counts.index_add_(0, idx, wgt.reshape(-1))
        counts = counts.reshape(F, O)
        return sums.reshape(F, O, 3) / torch.clamp(counts[..., None], min=1.0), counts > 0


def propagate_object_poses(H: SE3, hvalid: torch.Tensor, cen: torch.Tensor, cvalid: torch.Tensor,
                           max_gap: int = 3):
    """`propogateObjectPoses` (`src/common/DynamicObjects.cc:48-191`) over
    every (frame, object) slot, the JAX package's two scans as host loops
    over frames, each step batched over objects.

    Forward: propagate L_k = H_k L_{k-1}; a motion resuming after a gap of
    fewer than `max_gap` frames restarts from (last rotation, current
    centroid), a longer gap re-initialises from the centroid.  Backward:
    slerp-fill the interior frames of every short gap between the last
    recorded pose and the resumption pose (`Pose3::slerp`)."""
    F, O = hvalid.shape
    dtype, dev = H.t.dtype, H.t.device
    eye = torch.eye(3, dtype=dtype, device=dev).expand(O, 3, 3)
    zeros3 = torch.zeros((O, 3), dtype=dtype, device=dev)
    have = torch.zeros(O, dtype=torch.bool, device=dev)
    R_p, t_p, R_last, t_last = eye, zeros3, eye, zeros3
    age = torch.full((O,), 10 * F, dtype=torch.int32, device=dev)
    f_last = torch.full((O,), -1, dtype=torch.int32, device=dev)
    fwd = []
    for k in range(F):
        hv, cv = hvalid[k], cvalid[k]
        prop = have & hv
        resume = ~have & hv & (age < max_gap) & (f_last >= 0) & cv
        start = ~have & ~resume & cv
        valid = prop | resume | start
        R_new = torch.where(prop[:, None, None], H.R[k] @ R_p, torch.where(resume[:, None, None], R_last, eye))
        t_prop = torch.einsum("oij,oj->oi", H.R[k], t_p) + H.t[k]
        t_new = torch.where(prop[:, None], t_prop, torch.where((resume | start)[:, None], cen[k], zeros3))
        fwd.append((R_new, t_new, valid, resume, R_last, t_last, f_last))
        R_last = torch.where(valid[:, None, None], R_new, R_last)
        t_last = torch.where(valid[:, None], t_new, t_last)
        f_last = torch.where(valid, torch.full_like(f_last, k), f_last)
        age = torch.where(valid, torch.zeros_like(age), age + 1)
        have, R_p, t_p = valid, R_new, t_new

    active = torch.zeros(O, dtype=torch.bool, device=dev)
    R0, t0, R1, t1 = eye, zeros3, eye, zeros3
    f0 = torch.full((O,), -1, dtype=torch.int32, device=dev)
    f1 = f0
    R_out, t_out, v_out = [None] * F, [None] * F, [None] * F
    for k in reversed(range(F)):
        R_k, t_k, vk, rk, R_lk, t_lk, f_lk = fwd[k]
        active = torch.where(rk, True, torch.where(vk, False, active))
        R0 = torch.where(rk[:, None, None], R_lk, R0)
        t0 = torch.where(rk[:, None], t_lk, t0)
        R1 = torch.where(rk[:, None, None], R_k, R1)
        t1 = torch.where(rk[:, None], t_k, t1)
        f0 = torch.where(rk, f_lk, f0)
        f1 = torch.where(rk, torch.full_like(f1, k), f1)
        fill = active & ~vk & (k > f0) & (k < f1)
        s = (k - f0).to(dtype) / torch.clamp((f1 - f0).to(dtype), min=1.0)
        X0 = SE3(R0, t0)
        Xf = se3_compose(X0, se3_exp(s[:, None] * se3_log(se3_compose(se3_inverse(X0), SE3(R1, t1)))))
        R_out[k] = torch.where(fill[:, None, None], Xf.R, R_k)
        t_out[k] = torch.where(fill[:, None], Xf.t, t_k)
        v_out[k] = vk | fill
    return SE3(torch.stack(R_out), torch.stack(t_out)), torch.stack(v_out)


# --------------------------------------------------------------------------
# Checkpoints
# --------------------------------------------------------------------------


def _backend_state(backend: RGBDBackend) -> dict:
    est = backend.est
    dev = backend.device
    return {
        "map": backend.map,
        "est": est._asdict(),
        "n_frames": torch.tensor(backend.n_frames, device=dev),
        "window_start": torch.tensor(backend.trigger.start, device=dev),
    }


def save_backend_checkpoint(backend: RGBDBackend, path: str) -> None:
    """The full solver state (map, estimates, window cursor) in one file
    (`torch.save`; the JAX package writes an orbax checkpoint)."""
    from ..utils.serialization import save_checkpoint

    save_checkpoint(path, _backend_state(backend))


def load_backend_checkpoint(backend: RGBDBackend, path: str) -> RGBDBackend:
    """Restore the solver state into a fresh backend of the same config and
    capacities, on its device, and resume."""
    from ..utils.serialization import load_checkpoint

    restored = load_checkpoint(path, _backend_state(backend))
    backend.map = restored["map"]
    backend.est = EstimateStore(**restored["est"])
    backend.n_frames = int(restored["n_frames"])
    backend.trigger.start = int(restored["window_start"])
    return backend
