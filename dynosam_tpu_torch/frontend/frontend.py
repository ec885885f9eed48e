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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
from ..ops.epipolar import normalize_points, ransac_essential, ransac_translation_given_rot, scale_from_depth
from ..ops.klt import bilinear_sample, sample_channels
from ..ops.ransac import STATUS_INVALID, STATUS_VALID, RansacResult, ransac_pose_3d2d, ransac_rigid
from ..utils.config import FrontendConfig
from ..utils.device import resolve_device
from . import refine
from .tracker import TrackerState, track_frame

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
):
    """Process one frame: (state at k-1, images) -> (state at k, packet,
    tracking report, ego RANSAC result).  Runs on CUDA unless `device`
    says otherwise; `generator` draws every RANSAC hypothesis of the step."""
    check_frontend_config(cfg)
    dev = resolve_device(device)
    state = to_device(state, dev)
    prev_images = to_device(prev_images, dev)
    images = to_device(images, dev)
    if generator is not None and generator.device.type != dev.type:
        raise ValueError("generator must live on the step's device")

    tcfg = cfg.tracker
    prev_uv_s = state.tracker.s_uv
    prev_uv_d = state.tracker.d_uv
    trk, report = track_frame(
        state.tracker, prev_images.gray, images.gray, prev_images.flow,
        images.mask, tcfg, use_klt=use_klt, first_frame=first_frame,
        generator=generator, mask_prev=prev_images.mask,
    )

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
    if mode == "3d2d":
        # 3d-2d PnP (the RGB-D default, `geometricOutlierRejection3d2d`)
        eb = ransac_pose_3d2d(
            ego_lmk[None], ego_uv[None], ego_xyz[None], ego_valid[None], cam,
            iters=cs.ransac_iterations, threshold_px=cs.ransac_threshold_px,
            min_inliers=cs.min_inliers, score_cap=cs.ransac_score_cap or None,
            generator=generator,
        )
        ego = RansacResult(eb.pose[0], eb.inliers[0], eb.n_inliers[0], eb.status[0])
    elif mode == "3d3d":
        # 3d-3d Arun (`geometricOutlierRejection3d3d`): p_world = X(y_cam)
        eb = ransac_rigid(
            ego_xyz[None], ego_lmk[None], ego_valid[None],
            iters=cs.ransac_iterations, threshold=cs.ransac_threshold_stereo_m,
            min_inliers=5, score_cap=cs.ransac_score_cap or None, generator=generator,
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
        generator=generator,
    )
    G_act, inl_act, solved_act = ro.pose, ro.inliers, ro.status == STATUS_VALID

    # ---------------- fused joint flow+pose refinement (ego + objects)
    run_obj_ref = cfg.refine_motion_with_joint_of and not first_frame
    part_obj = inl_act & (d_depth_prev[idxs] > 0.0)
    outlier_rounds = cfg.refinement_outlier_rounds if cfg.joint_of_outlier_reject else 0
    if run_ego_ref or run_obj_ref:
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
        fp_all = refine.optimize_flow_and_pose(
            cam, SE3(torch.cat(Rs), torch.cat(ts)), state.X_world,
            torch.cat(kps), torch.cat(dps), torch.cat(fls), torch.cat(vas),
            max_iterations=cfg.refinement_max_lm_iterations,
            outlier_rounds=outlier_rounds,
        )
    o0 = 1 if run_ego_ref else 0

    if run_ego_ref:
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
        s_depth = torch.where(wb, d_ref, s_depth)
        s_dok = (s_depth > 0.0) & (s_depth < cfg.max_background_depth)
        s_xyz = backproject(cam, trk.s_uv, s_depth)
        s_obs_ok = trk.s_active & s_dok

    # ---------------- per-object post-processing, batched over objects
    solved_m = solved_act[:, None]
    G = G_act
    inl = inl_act
    ref_uvs = uv_cur
    wbs = torch.zeros_like(oks)
    d_refs = torch.zeros(oks.shape, dtype=d_xyz.dtype, device=dev)
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
        sample_ok = part_obj & fpo_inl & solved_m
        d_flat, lab_flat = sample_channels(
            (images.depth, images.mask), ("bilinear", "nearest"),
            ref_uv.reshape(-1, 2), valid=sample_ok.reshape(-1),
        )
        d_refs = d_flat.reshape(oks.shape)
        lab_ok = lab_flat.reshape(oks.shape) == trk.obj_labels[act][:, None]
        wbs = sample_ok & inb & lab_ok
        ref_uvs = torch.where(wbs[..., None], ref_uv, uv_cur)
    H = se3_compose(X_k, se3_inverse(G))                                 # (k,)
    if cfg.refine_motion_with_3d:
        mr = refine.optimize_motion_only(
            cam, H, state.X_world, X_k, p_prev_w, uv_prev, uv_cur, inl,
            max_iterations=cfg.refinement_max_lm_iterations,
            outlier_rounds=(
                cfg.refinement_outlier_rounds if cfg.refinement_3d_outlier_reject else 0
            ),
        )
        H = se3_where(solved_act, mr.motion, H)
        if cfg.refinement_3d_outlier_reject:
            inl = torch.where(solved_m, mr.inliers, inl)
    if k_act < no:
        H_all = se3_identity((no,), X_k.dtype, dev)
        H_all.R[act] = H.R
        H_all.t[act] = H.t
        solved = torch.zeros((no,), dtype=torch.bool, device=dev)
        solved[act] = solved_act
    else:
        H_all, solved = H, solved_act
    motion_valid = solved & obj_is_dynamic
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
    wb_flat = (wbs & oks).reshape(-1)
    delta_uv = torch.where(
        wb_flat[:, None], ref_uvs.reshape(-1, 2) - trk.d_uv[idx_flat],
        torch.zeros((), dtype=d_xyz.dtype, device=dev),
    )
    trk = trk._replace(d_uv=trk.d_uv.index_add(0, idx_flat, delta_uv))
    delta_d = torch.where(
        wb_flat, d_refs.reshape(-1) - d_depth[idx_flat],
        torch.zeros((), dtype=d_xyz.dtype, device=dev),
    )
    d_depth = d_depth.index_add(0, idx_flat, delta_d)
    d_dok = (d_depth > 0.0) & (d_depth < cfg.max_object_depth)
    d_xyz = backproject(cam, trk.d_uv, d_depth)
    d_obs_ok = trk.d_active & d_dok
    m_cur_w = se3_apply(X_k, d_xyz)

    # ---------------- object pose propagation
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
        obj_static=obj_static_new,
        obj_gap=obj_gap_new,
        rel_prev=se3_compose(se3_inverse(state.X_world), X_k),
        rel_prev_valid=ego_ok & (not first_frame),
        frame_idx=state.frame_idx + 1,
    )
    return new_state, packet, report, ego
