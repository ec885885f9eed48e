"""RGB-D instance frontend: the per-frame vision step (port of
`dynosam_tpu/frontend/frontend.py`).

  track -> depth association -> ego motion (3d2d PnP, 3d3d Arun or 2d2d
  epipolar RANSAC) -> scene-flow
  dynamicity -> per-object motion RANSAC -> fused joint flow+pose
  refinement (ego + objects in one batch) -> motion-only refinement ->
  object pose propagation -> output packet

The JAX package `vmap`s the per-object solves; here the objects are a
batch dimension of the solvers.  Every point lookup is one launch of
kernel K2 (the per-object refined-keypoint sample is one launch over
k_act * DPO rows).

The step runs as three stretches between its host reads (`_variants`,
driven by `_schedule`): tracking, the homography refit's `eigh` (the only
host read on the card), and the rest (`_seg_rest`).  On the card the
motion RANSACs are kernel K6 and each refinement is one launch of kernel
K5, which runs its outlier rounds and LM iterations on the device; on the
CPU both run their plain versions, whose host loops read the rounds' and
the LM's flags inside `rest`.  On the card each stretch but the `eigh` is
a CUDA graph replay (`_FrameGraphs`), captured once per process for each
shape and setting, and the RANSAC uniforms are drawn before the step
(`_draw_uniforms`) so that the graphs take them as inputs.
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .. import kernels
from ..core.camera import CameraParams, backproject, project
from ..core.lie import (
    SE3,
    se3_apply,
    se3_compose,
    se3_identity,
    se3_inverse,
    se3_where,
)
from ..core.types import INVALID_ID, DynamicObs, FrontendOutput, ObjectObs, StaticObs
from ..ops import homography
from ..ops.epipolar import normalize_points, ransac_essential, ransac_translation_given_rot, scale_from_depth
from ..ops.klt import bilinear_sample, sample_channels
from ..ops.ransac import (
    STATUS_INVALID,
    STATUS_VALID,
    RansacResult,
    draw_uniforms,
    ransac_pose_3d2d,
    ransac_rigid,
)
from ..utils import graphs
from ..utils.config import FrontendConfig
from ..utils.device import resolve_device
from . import refine
from .tracker import TrackerState, track_rest, track_static

# per-object correspondence capacity for the motion solvers
DPO = 512


class FrameImages(NamedTuple):
    gray: torch.Tensor    # (H, W) float
    depth: torch.Tensor   # (H, W) float metric depth (0/neg = invalid)
    flow: torch.Tensor    # (H, W, 2) dense flow mapping frame k -> k+1
    mask: torch.Tensor    # (H, W) int32 instance labels (0 = background)


class FrontendState(NamedTuple):
    tracker: TrackerState
    X_world: SE3                  # ^wX_{k-1}
    s_lmk: torch.Tensor           # (NS, 3) static landmarks in world
    s_lmk_valid: torch.Tensor
    d_lmk: torch.Tensor           # (ND, 3) dynamic landmarks in world
    d_lmk_valid: torch.Tensor
    obj_pose: SE3                 # (O,) propagated ^wL_{k-1}
    obj_pose_valid: torch.Tensor
    obj_H_prev: SE3               # (O,) last frame's object motions
    obj_H_prev_valid: torch.Tensor
    obj_static: torch.Tensor      # (O,) object classified static at k-1
    obj_gap: torch.Tensor         # (O,) frames since L was last updated
    rel_prev: SE3                 # X_{k-2}^-1 X_{k-1}
    rel_prev_valid: torch.Tensor
    frame_idx: torch.Tensor

    @staticmethod
    def create(ns: int, nd: int, no: int, dtype=torch.float32, device=None) -> "FrontendState":
        b = torch.bool
        return FrontendState(
            tracker=TrackerState.create(ns, nd, no, dtype, device),
            X_world=se3_identity((), dtype, device),
            s_lmk=torch.zeros((ns, 3), dtype=dtype, device=device),
            s_lmk_valid=torch.zeros((ns,), dtype=b, device=device),
            d_lmk=torch.zeros((nd, 3), dtype=dtype, device=device),
            d_lmk_valid=torch.zeros((nd,), dtype=b, device=device),
            obj_pose=se3_identity((no,), dtype, device),
            obj_pose_valid=torch.zeros((no,), dtype=b, device=device),
            obj_H_prev=se3_identity((no,), dtype, device),
            obj_H_prev_valid=torch.zeros((no,), dtype=b, device=device),
            obj_static=torch.zeros((no,), dtype=b, device=device),
            obj_gap=torch.full((no,), 10000, dtype=torch.int32, device=device),
            rel_prev=se3_identity((), dtype, device),
            rel_prev_valid=torch.zeros((), dtype=b, device=device),
            frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        )


def to_device(tree, device):
    """Move every tensor of a (nested) NamedTuple to `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    return tree


EGO_MODES = ("3d2d", "3d3d", "2d2d")


def ego_mode(cfg: FrontendConfig) -> str:
    """The ego-motion solver a config selects: `use_ego_motion_pnp=False`
    is the legacy alias for "3d3d"."""
    return cfg.ego_motion_solver if cfg.use_ego_motion_pnp else "3d3d"


def check_frontend_config(cfg: FrontendConfig) -> None:
    """Raise for an unknown ego-motion solver before any work runs."""
    if ego_mode(cfg) not in EGO_MODES:
        raise ValueError(f"unknown ego_motion_solver {cfg.ego_motion_solver!r}; one of {EGO_MODES}")


def _first_k_selected(sel: torch.Tensor, k: int) -> torch.Tensor:
    """Per row of `sel` (B, N): the first k column indices, selected ones
    first, each group in ascending order.  This is the order `lax.top_k`
    gives the JAX package's `gather_obj` scores (its `- arange * 1e-9`
    tie-break is a non-increasing staircase in f32)."""
    return torch.sort((~sel).to(torch.int8), dim=1, stable=True).indices[:, :k]


def _ego_2d2d(state: FrontendState, prev_images: FrameImages, prev_uv_s: torch.Tensor, trk: TrackerState,
              cam: CameraParams, cfg: FrontendConfig, generator: Optional[torch.Generator]) -> RansacResult:
    """2d-2d epipolar ego motion (`geometricOutlierRejection2d2d`) on the
    static tracks seen at k-1 and k.  With `ransac_use_2point_mono` the
    2-point solver with the constant-velocity rotation prior
    R(T_{k,k-1}) = rel_prev.R^T runs where the previous relative motion is
    valid, and the 8-point solver elsewhere (both are solved and one is
    selected on the device).  Metric scale comes from the previous frame's
    depth; X_k = X_{k-1} T_{k,k-1}^-1."""
    cs = cfg.camera_solver
    corr2d = trk.s_active & (trk.s_age > 0)
    kw = dict(iters=cs.ransac_iterations_2d2d, threshold=cs.ransac_threshold_mono, generator=generator)
    ep5 = ransac_essential(prev_uv_s, trk.s_uv, corr2d, cam, **kw)
    if cs.ransac_use_2point_mono:
        R_prior = state.rel_prev.R.transpose(-1, -2)
        ep2 = ransac_translation_given_rot(prev_uv_s, trk.s_uv, corr2d, cam, R_prior, **kw)
        use2 = state.rel_prev_valid
        ep_rel = se3_where(use2, ep2.rel_pose, ep5.rel_pose)
        ep_inl = torch.where(use2, ep2.inliers, ep5.inliers)
        ep_n = torch.where(use2, ep2.n_inliers, ep5.n_inliers)
    else:
        ep_rel, ep_inl, ep_n = ep5.rel_pose, ep5.inliers, ep5.n_inliers
    prev_d2, prev_d2ok = _depth_at(prev_images.depth, prev_uv_s, cfg.max_background_depth, corr2d)
    scale, _ = scale_from_depth(
        ep_rel, normalize_points(cam, prev_uv_s), normalize_points(cam, trk.s_uv),
        torch.where(prev_d2ok, prev_d2, torch.zeros_like(prev_d2)), ep_inl,
    )
    # x_k ~ R x_{k-1} + t  =>  T_{k,k-1}; X_k = X_{k-1} T_{k,k-1}^-1
    T_rel = SE3(ep_rel.R, ep_rel.t * scale)
    return RansacResult(
        pose=se3_compose(state.X_world, se3_inverse(T_rel)),
        inliers=ep_inl,
        n_inliers=ep_n.to(torch.int32),
        status=torch.where(ep_n >= cs.min_inliers, STATUS_VALID, STATUS_INVALID).to(torch.int32),
    )


def _depth_at(depth: torch.Tensor, uv: torch.Tensor, max_depth: float, valid=None):
    d = bilinear_sample(depth, uv, valid)
    return d, (d > 0.0) & (d < max_depth)


class _Step(NamedTuple):
    """What one step's stretches take besides their tensors: the camera,
    the configuration, the tracking mode, whether this is the first frame,
    the generator of the draws not made beforehand (the 2d2d ego modes'),
    and the two refinements' settings (None where the step skips one)."""

    cam: CameraParams
    cfg: FrontendConfig
    use_klt: bool
    first_frame: bool
    generator: Optional[torch.Generator]
    fp: Optional[refine.FlowPose]
    mo: Optional[refine.MotionOnly]


def _step_settings(cam, cfg: FrontendConfig, use_klt: bool, first_frame: bool, generator) -> _Step:
    run_fp = (cfg.refine_camera_pose_with_joint_of or cfg.refine_motion_with_joint_of) and not first_frame
    fp = refine.FlowPose(cam, max_iterations=cfg.refinement_max_lm_iterations,
                         outlier_rounds=cfg.refinement_outlier_rounds if cfg.joint_of_outlier_reject else 0)
    mo = refine.MotionOnly(cam, max_iterations=cfg.refinement_max_lm_iterations,
                           outlier_rounds=cfg.refinement_outlier_rounds if cfg.refinement_3d_outlier_reject else 0)
    return _Step(cam, cfg, use_klt, first_frame, generator, fp if run_fp else None,
                 mo if cfg.refine_motion_with_3d else None)


def _draw_uniforms(state: FrontendState, cfg: FrontendConfig, first_frame: bool, generator, dev) -> dict:
    """The step's RANSAC uniforms, drawn from `generator` in the order the
    step consumes them (homography, ego motion, objects) and at their
    shapes, so that a CUDA graph of the step takes them as inputs.  The
    2d2d ego modes draw inside the step (None here, the objects' too, to
    keep the order)."""
    hom = None if first_frame else draw_uniforms((), 128, 4, generator, dev)
    if ego_mode(cfg) == "2d2d":
        return dict(hom=hom, ego=None, obj=None)
    k_act = min(cfg.max_active_objects, state.tracker.obj_labels.shape[0])
    ego = draw_uniforms((1,), cfg.camera_solver.ransac_iterations, 3, generator, dev)
    obj = draw_uniforms((k_act,), cfg.object_solver.ransac_iterations, 3, generator, dev)
    return dict(hom=hom, ego=ego, obj=obj)


# ---------------------------------------------------------------------------
# The step's stretches.  Each reads the step's tensors from the dict `s`
# and returns the entries it writes; `_schedule` runs them in order.  On
# the CPU they run as they are; on the card `_FrameGraphs` captures each but
# the `eigh` as a CUDA graph and replays it.  s["in"] holds the inputs: the state, the previous and current
# images, and the uniforms.
# ---------------------------------------------------------------------------


def _seg_track(s: dict, c: _Step) -> dict:
    """Tracking up to the homography refit's eigen-decomposition."""
    state, prev, images = s["in"]["state"], s["in"]["prev"], s["in"]["images"]
    return {"track": track_static(
        state.tracker, prev.gray, images.gray, prev.flow, images.mask, c.cfg.tracker,
        use_klt=c.use_klt, first_frame=c.first_frame, generator=c.generator,
        mask_prev=prev.mask, hom_uniforms=s["in"]["u"]["hom"],
    )}


def _seg_eigh(s: dict, c: _Step) -> dict:
    """The homography refit's eigen-decomposition: a host read on the card
    (`homography.normal_eigenvectors`), run eagerly between two graphs."""
    return {"vecs": homography.normal_eigenvectors(s["track"].hom.AtA)}


def _seg_pre(s: dict, c: _Step) -> dict:
    """The rest of tracking, depth association, ego motion, scene-flow
    dynamicity, object selection and motion RANSAC, and the joint flow +
    pose refinement's inputs."""
    state, prev_images, images = s["in"]["state"], s["in"]["prev"], s["in"]["images"]
    cam, cfg, first_frame = c.cam, c.cfg, c.first_frame
    dev = images.gray.device
    prev_uv_s = state.tracker.s_uv
    prev_uv_d = state.tracker.d_uv
    trk, report = track_rest(state.tracker, images.gray, cfg.tracker, first_frame, s["track"], s.get("vecs"))

    # ---------------- depth association: ONE merged K2 sample for both pools
    ns_slots = trk.s_uv.shape[0]
    depth_both = bilinear_sample(
        images.depth,
        torch.cat([trk.s_uv, trk.d_uv], dim=0),
        torch.cat([trk.s_active, trk.d_active], dim=0),
    )
    s_depth = depth_both[:ns_slots]
    d_depth = depth_both[ns_slots:]
    s_dok = (s_depth > 0.0) & (s_depth < cfg.max_background_depth)
    d_dok = (d_depth > 0.0) & (d_depth < cfg.max_object_depth)
    s_xyz = backproject(cam, trk.s_uv, s_depth)
    d_xyz = backproject(cam, trk.d_uv, d_depth)
    s_obs_ok = trk.s_active & s_dok
    d_obs_ok = trk.d_active & d_dok

    # ---------------- ego motion
    ego_corr = s_obs_ok & (trk.s_age > 0) & state.s_lmk_valid
    ns_pool = ego_corr.shape[0]
    no = trk.obj_labels.shape[0]
    if cfg.use_static_object_points_for_ego and not first_frame:
        d_obj_c = torch.clamp(trk.d_obj, 0, no - 1).long()
        demoted = (
            (trk.d_obj >= 0) & state.obj_static[d_obj_c] & d_obs_ok
            & (trk.d_age > 0) & state.d_lmk_valid
        )
        ego_lmk = torch.cat([state.s_lmk, state.d_lmk], dim=0)
        ego_uv = torch.cat([trk.s_uv, trk.d_uv], dim=0)
        ego_xyz = torch.cat([s_xyz, d_xyz], dim=0)
        ego_valid = torch.cat([ego_corr, demoted], dim=0)
    else:
        ego_lmk, ego_uv, ego_xyz, ego_valid = state.s_lmk, trk.s_uv, s_xyz, ego_corr
    cs = cfg.camera_solver
    mode = ego_mode(cfg)
    generator, u = c.generator, s["in"]["u"]
    if mode == "3d2d":
        # 3d-2d PnP (the RGB-D default, `geometricOutlierRejection3d2d`)
        eb = ransac_pose_3d2d(
            ego_lmk[None], ego_uv[None], ego_xyz[None], ego_valid[None], cam,
            iters=cs.ransac_iterations, threshold_px=cs.ransac_threshold_px,
            min_inliers=cs.min_inliers, score_cap=cs.ransac_score_cap or None,
            generator=generator, uniforms=u["ego"],
        )
        ego = RansacResult(eb.pose[0], eb.inliers[0], eb.n_inliers[0], eb.status[0])
    elif mode == "3d3d":
        # 3d-3d Arun (`geometricOutlierRejection3d3d`): p_world = X(y_cam)
        eb = ransac_rigid(
            ego_xyz[None], ego_lmk[None], ego_valid[None],
            iters=cs.ransac_iterations, threshold=cs.ransac_threshold_stereo_m,
            min_inliers=5, score_cap=cs.ransac_score_cap or None, generator=generator, uniforms=u["ego"],
        )
        ego = RansacResult(eb.pose[0], eb.inliers[0], eb.n_inliers[0], eb.status[0])
    else:
        ego = _ego_2d2d(state, prev_images, prev_uv_s, trk, cam, cfg, generator)
    ego_ok = ego.status == STATUS_VALID
    accept_ego = ego_ok & (not first_frame)
    X_k = se3_where(accept_ego, ego.pose, state.X_world)

    # ---------------- scene-flow dynamicity
    prop = d_obs_ok & (trk.d_age > 0) & state.d_lmk_valid
    m_cur_w = se3_apply(X_k, d_xyz)
    sf = torch.linalg.vector_norm(m_cur_w - state.d_lmk, dim=-1)
    is_static_pt = sf < cfg.scene_flow_mag_threshold
    obj_of = torch.where(prop, trk.d_obj, torch.full_like(trk.d_obj, -1))
    ids = torch.arange(no, device=dev)
    onehot = (obj_of[:, None] == ids[None, :]).to(s_xyz.dtype)            # (ND, O)
    n_per_obj = onehot.sum(0)
    n_static = (onehot * is_static_pt[:, None].to(s_xyz.dtype)).sum(0)
    frac_static = n_static / torch.clamp(n_per_obj, min=1.0)
    enough_pts = trk.obj_active & (n_per_obj >= cfg.min_dynamic_features_per_object)
    obj_is_dynamic = enough_pts & (frac_static <= cfg.scene_flow_percentage)
    if first_frame:
        obj_static_new = torch.zeros_like(enough_pts)
    else:
        obj_static_new = enough_pts & (frac_static > cfg.scene_flow_percentage)

    # ---------------- object selection and correspondence gather
    dpo = min(DPO, prop.shape[0])
    k_act = min(cfg.max_active_objects, no)
    if k_act < no:
        score = torch.where(
            trk.obj_active & obj_is_dynamic, n_per_obj, torch.full_like(n_per_obj, -1.0)
        )
        act = torch.sort(score, descending=True, stable=True).indices[:k_act]
    else:
        act = ids
    sel = prop[None, :] & (trk.d_obj[None, :] == act[:, None].to(trk.d_obj.dtype))
    idxs = _first_k_selected(sel, dpo)                                   # (k_act, dpo)
    oks = torch.gather(sel, 1, idxs)

    run_ego_ref = cfg.refine_camera_pose_with_joint_of and not first_frame
    if run_ego_ref:
        pd_both = bilinear_sample(
            prev_images.depth,
            torch.cat([prev_uv_d, prev_uv_s], dim=0),
            torch.cat([prop, ego.inliers[:ns_pool]], dim=0),
        )
        d_depth_prev = pd_both[: prev_uv_d.shape[0]]
        prev_d = pd_both[prev_uv_d.shape[0]:]
        prev_dok = (prev_d > 0.0) & (prev_d < cfg.max_background_depth)
    else:
        d_depth_prev = bilinear_sample(prev_images.depth, prev_uv_d, prop)

    # ---------------- per-object motion RANSAC, batched over objects
    p_prev_w = state.d_lmk[idxs]                                         # (k, dpo, 3)
    uv_cur = trk.d_uv[idxs]
    xyz_cur = d_xyz[idxs]
    uv_prev = prev_uv_d[idxs]
    ok_o = oks
    if cfg.use_motion_model_gating:
        Hp = state.obj_H_prev[act]
        pred_w = se3_apply(Hp[:, None], p_prev_w)
        pred_uv, zpred = project(cam, X_k, pred_w)
        mm_err = torch.linalg.vector_norm(pred_uv - uv_cur, dim=-1)
        gate = (mm_err < cfg.motion_model_threshold_px) | (zpred <= 0.05)
        ok_o = ok_o & torch.where(state.obj_H_prev_valid[act][:, None], gate, torch.ones_like(gate))
    ro = ransac_pose_3d2d(
        p_prev_w, uv_cur, xyz_cur, ok_o, cam,
        iters=cfg.object_solver.ransac_iterations,
        threshold_px=cfg.object_solver.ransac_threshold_px,
        min_inliers=cfg.object_solver.min_inliers,
        generator=generator, uniforms=u["obj"],
    )
    G_act, inl_act, solved_act = ro.pose, ro.inliers, ro.status == STATUS_VALID

    f = dict(s_depth=s_depth, d_depth=d_depth, s_xyz=s_xyz, d_xyz=d_xyz, s_obs_ok=s_obs_ok, d_obs_ok=d_obs_ok,
             X_k=X_k, ego_ok=ego_ok, prop=prop, onehot=onehot, n_per_obj=n_per_obj, obj_is_dynamic=obj_is_dynamic,
             obj_static_new=obj_static_new, act=act, idxs=idxs, oks=oks, p_prev_w=p_prev_w, uv_cur=uv_cur,
             uv_prev=uv_prev, G_act=G_act, inl_act=inl_act, solved_act=solved_act)
    out = {"trk": trk, "report": report, "ego": ego}

    # ---------------- fused joint flow+pose refinement (ego + objects)
    run_obj_ref = cfg.refine_motion_with_joint_of and not first_frame
    part_obj = inl_act & (d_depth_prev[idxs] > 0.0)
    f["part_obj"] = part_obj
    if c.fp is not None:
        width = max(ns_pool if run_ego_ref else 0, dpo if run_obj_ref else 0)

        def padw(a, fill):
            pad = width - a.shape[1]
            if pad == 0:
                return a
            shape = (a.shape[0], pad, *a.shape[2:])
            return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=dev)], dim=1)

        Rs, ts, kps, dps, fls, vas = [], [], [], [], [], []
        if run_ego_ref:
            participated = ego.inliers[:ns_pool] & prev_dok
            f["participated"] = participated
            Rs.append(X_k.R[None])
            ts.append(X_k.t[None])
            kps.append(padw(prev_uv_s[None], 0.0))
            dps.append(padw(prev_d[None], 0.0))
            fls.append(padw((trk.s_uv - prev_uv_s)[None], 0.0))
            vas.append(padw(participated[None], False))
        if run_obj_ref:
            Rs.append(G_act.R)
            ts.append(G_act.t)
            kps.append(padw(uv_prev, 0.0))
            dps.append(padw(d_depth_prev[idxs], 0.0))
            fls.append(padw(uv_cur - uv_prev, 0.0))
            vas.append(padw(part_obj, False))
        flow_init = torch.cat(fls)
        out["fp_P"] = refine.flow_pose_inputs(cam, SE3(torch.cat(Rs), torch.cat(ts)), state.X_world,
                                              torch.cat(kps), torch.cat(dps), flow_init)
        out["fp_R"] = refine.rounds_start(c.fp, torch.cat(vas), {"flow": flow_init})
    out["f"] = f
    return out


def _seg_mid(s: dict, c: _Step) -> dict:
    """The refined ego pose and flows written back, the objects' refined
    flows written back, their motions, and the motion-only refinement's
    inputs."""
    state, images = s["in"]["state"], s["in"]["images"]
    cam, cfg, first_frame = c.cam, c.cfg, c.first_frame
    f, trk = dict(s["f"]), s["trk"]
    dev = images.gray.device
    prev_uv_s = state.tracker.s_uv
    ns_pool = trk.s_uv.shape[0]
    dpo = f["idxs"].shape[1]
    X_k, ego_ok = f["X_k"], f["ego_ok"]
    run_ego_ref = cfg.refine_camera_pose_with_joint_of and not first_frame
    run_obj_ref = cfg.refine_motion_with_joint_of and not first_frame
    if c.fp is not None:
        fp_all = c.fp.result(s["fp_R"])
    o0 = 1 if run_ego_ref else 0

    if run_ego_ref:
        participated = f["participated"]
        fp_flow = fp_all.flow[0, :ns_pool]
        fp_inl = fp_all.inliers[0, :ns_pool]
        X_k = se3_where(ego_ok, fp_all.pose[0], X_k)
        # refined-flow write-back into the static pool; depth and label are
        # sampled at the refined keypoints in ONE K2 launch
        refined_uv = prev_uv_s + fp_flow
        hgt, wid = images.gray.shape
        inb = (
            (refined_uv[:, 0] >= 0.0) & (refined_uv[:, 0] <= wid - 1.0)
            & (refined_uv[:, 1] >= 0.0) & (refined_uv[:, 1] <= hgt - 1.0)
        )
        d_ref, lab = sample_channels(
            (images.depth, images.mask), ("bilinear", "nearest"), refined_uv,
            valid=participated & fp_inl & ego_ok,
        )
        wb = participated & fp_inl & inb & (lab == 0) & ego_ok
        new_outlier = participated & ~wb & ego_ok
        trk = trk._replace(
            s_uv=torch.where(wb[:, None], refined_uv, trk.s_uv),
            s_active=trk.s_active & ~new_outlier,
        )
        s_depth = torch.where(wb, d_ref, f["s_depth"])
        s_dok = (s_depth > 0.0) & (s_depth < cfg.max_background_depth)
        f["s_xyz"] = backproject(cam, trk.s_uv, s_depth)
        f["s_obs_ok"] = trk.s_active & s_dok

    # ---------------- per-object post-processing, batched over objects
    G_act, inl_act, solved_act, oks = f["G_act"], f["inl_act"], f["solved_act"], f["oks"]
    uv_prev, uv_cur = f["uv_prev"], f["uv_cur"]
    solved_m = solved_act[:, None]
    G = G_act
    inl = inl_act
    ref_uvs = uv_cur
    wbs = torch.zeros_like(oks)
    d_refs = torch.zeros(oks.shape, dtype=f["d_xyz"].dtype, device=dev)
    if run_obj_ref:
        fpo = fp_all.pose[o0:]
        fpo_flow = fp_all.flow[o0:, :dpo]
        fpo_inl = fp_all.inliers[o0:, :dpo]
        G = se3_where(solved_act, fpo, G_act)
        if cfg.joint_of_outlier_reject:
            inl = torch.where(solved_m, fpo_inl, inl_act)
        ref_uv = uv_prev + fpo_flow
        hgt, wid = images.gray.shape
        inb = (
            (ref_uv[..., 0] >= 0.0) & (ref_uv[..., 0] <= wid - 1.0)
            & (ref_uv[..., 1] >= 0.0) & (ref_uv[..., 1] <= hgt - 1.0)
        )
        # one K2 launch over all k_act * DPO refined keypoints
        sample_ok = f["part_obj"] & fpo_inl & solved_m
        d_flat, lab_flat = sample_channels(
            (images.depth, images.mask), ("bilinear", "nearest"),
            ref_uv.reshape(-1, 2), valid=sample_ok.reshape(-1),
        )
        d_refs = d_flat.reshape(oks.shape)
        lab_ok = lab_flat.reshape(oks.shape) == trk.obj_labels[f["act"]][:, None]
        wbs = sample_ok & inb & lab_ok
        ref_uvs = torch.where(wbs[..., None], ref_uv, uv_cur)
    H = se3_compose(X_k, se3_inverse(G))                                 # (k,)
    f.update(X_k=X_k, inl=inl, ref_uvs=ref_uvs, wbs=wbs, d_refs=d_refs, H=H)
    out = {"trk": trk, "f": f}
    if c.mo is not None:
        out["mo_P"] = refine.motion_only_inputs(H, state.X_world, X_k, f["p_prev_w"], uv_prev, uv_cur)
        out["mo_R"] = refine.rounds_start(c.mo, inl, {"mp": f["p_prev_w"], "mc": out["mo_P"]["m_cur_init"]})
    return out


def _seg_tail(s: dict, c: _Step) -> dict:
    """The refined motions, object pose propagation, the output packet and
    the next state."""
    state, images = s["in"]["state"], s["in"]["images"]
    cfg, first_frame = c.cfg, c.first_frame
    f, trk = s["f"], s["trk"]
    dev = images.gray.device
    X_k, H, inl, solved_act, act = f["X_k"], f["H"], f["inl"], f["solved_act"], f["act"]
    idxs, prop, oks, d_depth, n_per_obj = f["idxs"], f["prop"], f["oks"], f["d_depth"], f["n_per_obj"]
    no = trk.obj_labels.shape[0]
    k_act = act.shape[0]
    if c.mo is not None:
        mr = c.mo.result(s["mo_R"])
        H = se3_where(solved_act, mr.motion, H)
        if cfg.refinement_3d_outlier_reject:
            inl = torch.where(solved_act[:, None], mr.inliers, inl)
    if k_act < no:
        H_all = se3_identity((no,), X_k.dtype, dev)
        H_all.R[act] = H.R
        H_all.t[act] = H.t
        solved = torch.zeros((no,), dtype=torch.bool, device=dev)
        solved[act] = solved_act
    else:
        H_all, solved = H, solved_act
    motion_valid = solved & f["obj_is_dynamic"]
    if first_frame:
        motion_valid = torch.zeros_like(motion_valid)

    # per-object inliers back to the (ND,) pool; fresh samples stay eligible
    idx_flat = idxs.reshape(-1)
    d_inl = torch.zeros(prop.shape, dtype=torch.int32, device=dev)
    d_inl.scatter_reduce_(0, idx_flat, (inl & oks).reshape(-1).to(torch.int32), reduce="amax")
    d_inlier = (d_inl > 0) | ~prop

    # refined-flow write-back for dynamic tracks: masked deltas added at the
    # gathered slots (a slot gets a nonzero delta from one object at most;
    # duplicate padding rows add zero, so the order of the adds is moot)
    d_xyz = f["d_xyz"]
    wb_flat = (f["wbs"] & oks).reshape(-1)
    delta_uv = torch.where(
        wb_flat[:, None], f["ref_uvs"].reshape(-1, 2) - trk.d_uv[idx_flat],
        torch.zeros((), dtype=d_xyz.dtype, device=dev),
    )
    trk = trk._replace(d_uv=trk.d_uv.index_add(0, idx_flat, delta_uv))
    delta_d = torch.where(
        wb_flat, f["d_refs"].reshape(-1) - d_depth[idx_flat],
        torch.zeros((), dtype=d_xyz.dtype, device=dev),
    )
    d_depth = d_depth.index_add(0, idx_flat, delta_d)
    d_dok = (d_depth > 0.0) & (d_depth < cfg.max_object_depth)
    d_xyz = backproject(c.cam, trk.d_uv, d_depth)
    d_obs_ok = trk.d_active & d_dok
    m_cur_w = se3_apply(X_k, d_xyz)

    # ---------------- object pose propagation
    onehot = f["onehot"]
    denom = torch.clamp(n_per_obj[:, None], min=1.0)
    centroid = onehot.t() @ m_cur_w / denom
    cen_prev = onehot.t() @ state.d_lmk / denom
    gap = state.obj_gap
    fresh = gap == 0
    prop_ok = motion_valid & state.obj_pose_valid & fresh
    resume_ok = motion_valid & state.obj_pose_valid & (gap >= 1) & (gap < 3)
    reinit_m = motion_valid & ~(prop_ok | resume_ok)
    hold = state.obj_pose_valid & ~motion_valid
    first_init = ~state.obj_pose_valid & ~motion_valid & trk.obj_active & (n_per_obj > 0)

    prop_pose = se3_compose(H_all, state.obj_pose)
    reinit_t = torch.sum(H_all.R * cen_prev[:, None, :], dim=-1) + H_all.t
    eye_R = torch.eye(3, dtype=centroid.dtype, device=dev).expand_as(prop_pose.R)

    def pick(mask, a, b):
        return torch.where(mask.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    L_R = pick(prop_ok, prop_pose.R, pick(resume_ok, state.obj_pose.R,
               pick(reinit_m, H_all.R, pick(hold, state.obj_pose.R, eye_R))))
    L_t = pick(prop_ok, prop_pose.t, pick(resume_ok, centroid,
               pick(reinit_m, reinit_t, pick(hold, state.obj_pose.t, centroid))))
    L_k = SE3(L_R, L_t)
    updated = prop_ok | resume_ok | reinit_m | first_init
    pose_valid = updated | hold
    obj_gap_new = torch.where(
        updated, torch.zeros_like(gap), torch.clamp(gap + 1, max=10000)
    )

    # ---------------- output packet
    ego_ok = f["ego_ok"]
    s_xyz, s_obs_ok = f["s_xyz"], f["s_obs_ok"]
    dyn_valid_out = d_obs_ok & d_inlier & torch.where(
        trk.d_obj >= 0,
        motion_valid[torch.clamp(trk.d_obj, 0, no - 1).long()],
        torch.zeros_like(d_obs_ok),
    )
    packet = FrontendOutput(
        frame_id=state.frame_idx,
        timestamp=state.frame_idx.to(images.gray.dtype),
        X_world=X_k,
        static_obs=StaticObs(uv=trk.s_uv, xyz=s_xyz, valid=s_obs_ok),
        dynamic_obs=DynamicObs(
            uv=trk.d_uv,
            xyz=d_xyz,
            obj=torch.where(dyn_valid_out, trk.d_obj, torch.full_like(trk.d_obj, INVALID_ID)),
            valid=dyn_valid_out,
        ),
        objects=ObjectObs(
            motion=H_all, motion_valid=motion_valid, pose=L_k,
            pose_valid=pose_valid, label=trk.obj_labels,
        ),
    )
    new_state = FrontendState(
        tracker=trk,
        X_world=X_k,
        s_lmk=se3_apply(X_k, s_xyz),
        s_lmk_valid=s_obs_ok,
        d_lmk=m_cur_w,
        d_lmk_valid=d_obs_ok,
        obj_pose=L_k,
        obj_pose_valid=pose_valid,
        obj_H_prev=H_all,
        obj_H_prev_valid=motion_valid,
        obj_static=f["obj_static_new"],
        obj_gap=obj_gap_new,
        rel_prev=se3_compose(se3_inverse(state.X_world), X_k),
        rel_prev_valid=ego_ok & (not first_frame),
        frame_idx=state.frame_idx + 1,
    )
    return {"out": (new_state, packet, s["report"], s["ego"])}


def _seg_rest(s: dict, c: _Step) -> dict:
    """Everything after the `eigh` as one stretch: `pre`, the joint flow +
    pose refinement's rounds (`refine.run_rounds`: one launch of K5 on the
    card), `mid`, the motion-only refinement's, and `tail`."""
    t = dict(s)
    t.update(_seg_pre(t, c))
    if c.fp is not None:
        t["fp_R"] = refine.run_rounds(c.fp, t["fp_P"], t["fp_R"])
    t.update(_seg_mid(t, c))
    if c.mo is not None:
        t["mo_R"] = refine.run_rounds(c.mo, t["mo_P"], t["mo_R"])
    return {"out": _seg_tail(t, c)["out"]}


def _variants(c: _Step) -> dict:
    """Every stretch of the step under `c`, by name (`_schedule` runs them)."""
    out = {"track": lambda s: _seg_track(s, c), "rest": lambda s: _seg_rest(s, c)}
    if not c.first_frame:
        out["eigh"] = lambda s: _seg_eigh(s, c)
    return out


# the stretches that read the host, run eagerly between two graphs
_EAGER = ("eigh",)


def _schedule(run, c: _Step) -> None:
    """The step's stretches in order: `run(name)` runs one of `_variants(c)`."""
    run("track")
    if not c.first_frame:
        run("eigh")
    run("rest")


def _run_eagerly(s: dict, c: _Step) -> dict:
    variants = _variants(c)
    _schedule(lambda name: s.update(variants[name](s)), c)
    return s


def frontend_step(
    state: FrontendState,
    prev_images: FrameImages,
    images: FrameImages,
    cam: CameraParams,
    cfg: FrontendConfig,
    generator: Optional[torch.Generator] = None,
    use_klt: bool = True,
    first_frame: bool = False,
    device=None,
    _graphs: bool = True,
):
    """Process one frame: (state at k-1, images) -> (state at k, packet,
    tracking report, ego RANSAC result).  Runs on CUDA unless `device`
    says otherwise; `generator` draws every RANSAC hypothesis of the step.

    The step runs as stretches between its host reads (`_schedule`).  On
    the card, past the first frame and where the configuration allows it
    (`graphable`), each stretch is a CUDA graph replay (`_FrameGraphs`),
    captured once per process, shape and setting; `_graphs=False` or any
    `TorchDispatchMode` runs the stretches eagerly there too."""
    check_frontend_config(cfg)
    dev = resolve_device(device)
    state = to_device(state, dev)
    prev_images = to_device(prev_images, dev)
    images = to_device(images, dev)
    if generator is not None and generator.device.type != dev.type:
        raise ValueError("generator must live on the step's device")
    inputs = dict(state=state, prev=prev_images, images=images,
                  u=_draw_uniforms(state, cfg, first_frame, generator, dev))
    c = _step_settings(cam, cfg, use_klt, first_frame, generator)
    if dev.type == "cuda" and _graphs and not first_frame and graphable(cfg) and _get_current_dispatch_mode() is None:
        return _captured_step(inputs, c).step(inputs)
    return _run_eagerly({"in": inputs}, c)["out"]


def graphable(cfg: FrontendConfig) -> bool:
    """Whether the card runs this configuration's step as CUDA graphs.  Not
    the 2d2d ego modes (their essential-matrix RANSACs draw inside the step,
    and their SVD and `eigh` check their status on the host) nor
    `redetect_min_free_fraction > 0` (the tracker reads the tracked count
    to decide on re-detection): those step eagerly."""
    return ego_mode(cfg) != "2d2d" and cfg.tracker.redetect_min_free_fraction <= 0.0


class _FrameGraphs:
    """The steady step of one shape and setting as CUDA graphs: its tensors
    in a dict `s` allocated once, and each stretch of `_variants` (but the
    eager ones, `_EAGER`) captured as a graph that reads and writes only
    `s` (`utils/graphs.py`).

    Made on a frame: the stretches run eagerly on it once, which allocates
    `s` (`graphs.tree_buffers`: each tensor laid out as the eager step
    passed it on, so each graph reads what the eager step reads); then
    `graphs.capture` warms every stretch up on the capture stream and
    captures it.  Kernel launches of the making are not counted: `step`
    counts the frame's.  `step` copies
    a frame's inputs into `s["in"]`, runs `_schedule` over the replays and
    clones the outputs out of `s`, which the next replay overwrites."""

    def __init__(self, inputs: dict, c: _Step):
        launches = kernels.launch_counts()
        self.s = graphs.tree_buffers(_run_eagerly({"in": inputs}, c))
        self.c = c
        variants = _variants(c)
        self.eager = {name: variants.pop(name) for name in _EAGER if name in variants}
        self.graphs = graphs.capture(
            {name: (lambda fn=fn: graphs.tree_copy_(self.s, fn(self.s))) for name, fn in variants.items()},
            inputs["images"].gray.device)
        kernels.set_launch_counts(launches)

    def _run(self, name: str) -> None:
        if name in self.eager:
            graphs.tree_copy_(self.s, self.eager[name](self.s))
        else:
            self.graphs[name].replay()
            graphs.count("frontend", "replays")

    def step(self, inputs: dict):
        graphs.tree_copy_(self.s["in"], inputs)
        _schedule(self._run, self.c)
        return graphs.tree_clone(self.s["out"])


# Captured steps by everything a capture bakes in, least recently used
# first: a fresh pipeline (a benchmark's next rep) reuses the captures.
_FRAME_GRAPHS: OrderedDict = OrderedDict()
_FRAME_GRAPHS_MAX = 4


def graph_counts() -> dict:
    """{"captures", "replays"}: frontend-step graph sets captured and
    graphs replayed in this process."""
    return graphs.counts("frontend")


def _pieces() -> tuple:
    """Every function the step's stretches reach through the port's module
    names, resolved now: a capture bakes them in, so they belong to its
    key (a function replaced for a run captures anew)."""
    from ..backend import small_schur, solver
    from ..core import camera, lie
    from ..kernels import lk, point_sample, response
    from ..kernels import ransac as ransac_kernel
    from ..kernels import refine as refine_kernel
    from ..ops import clahe, factors, klt, linalg, ransac, robust
    from . import detect, mask_ops, tracker

    return graphs.module_functions(sys.modules[__name__], tracker, refine, detect, mask_ops, homography, ransac,
                                   klt, clahe, linalg, factors, robust, camera, lie, small_schur, solver, lk,
                                   point_sample, response, ransac_kernel, refine_kernel)


def _captured_step(inputs: dict, c: _Step) -> _FrameGraphs:
    """The cached `_FrameGraphs` of this step's shapes and settings,
    made on these inputs on first use."""
    key = (inputs["images"].gray.device, c.cam, c.cfg, c.use_klt, _pieces(), graphs.signature(inputs))

    def make():
        fg = _FrameGraphs(inputs, c)
        graphs.count("frontend", "captures")
        return fg

    return graphs.lru(_FRAME_GRAPHS, key, make, _FRAME_GRAPHS_MAX)
