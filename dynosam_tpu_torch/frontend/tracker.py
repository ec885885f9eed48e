"""Static + dynamic feature tracking over fixed slot pools (port of
`dynosam_tpu/frontend/tracker.py`).

* Static tracks: dense-flow warm start, LK polish (kernel K1), mask-label
  check, homography-RANSAC verification, then re-detection into free
  slots on the (optionally CLAHE'd) image with one of four detectors:
  Shi-Tomasi (kernel K3, the default), Harris or FAST responses with grid
  NMS, or ORB (`frontend/orb.py`: pyramid FAST, orientation and steered
  BRIEF from kernel K4), whose descriptors are kept per slot and can revive
  recently lost tracklets (`orb_reassociate`).  Tracklets older than
  `max_feature_track_age` are recycled.
* Dynamic tracks: flow propagation with label consistency and dense grid
  sampling of uncovered object pixels.
* Object table: instance labels -> object slots (allocate-only).
* Optional mask propagation (`use_propogate_mask`): labels the segmenter
  lost this frame are carried forward from the previous frame's mask.

Every point lookup goes through kernel K2.  Tracklet ids are slot indices;
a freed slot stays blocked for `slot_cooldown_frames` before reuse.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.types import INVALID_ID
from ..ops import homography
from ..ops.clahe import clahe
from ..ops.klt import flow_at, klt_track_lk, nearest_at
from ..utils.config import TrackerConfig
from .detect import (
    Detections,
    border_mask,
    detect_grid_nms,
    fast_response,
    grid_subsample_i32,
    harris_response,
    occupancy_at_grid,
    occupancy_mask,
    shi_tomasi_response,
)
from .mask_ops import label_counts, propagate_mask
from .orb import extract_orb, match_descriptors, response_order


class TrackerState(NamedTuple):
    # static pool (NS,)
    s_uv: torch.Tensor
    s_active: torch.Tensor
    s_age: torch.Tensor
    s_cooldown: torch.Tensor
    s_desc: torch.Tensor   # (NS, 256) int8 ORB descriptor at detection (zero unless ORB)
    # dynamic pool (ND,)
    d_uv: torch.Tensor
    d_active: torch.Tensor
    d_obj: torch.Tensor
    d_age: torch.Tensor
    d_cooldown: torch.Tensor
    # object table (O,)
    obj_labels: torch.Tensor
    obj_active: torch.Tensor

    @staticmethod
    def create(ns: int, nd: int, no: int, dtype=torch.float32, device=None) -> "TrackerState":
        i32 = torch.int32
        return TrackerState(
            s_uv=torch.zeros((ns, 2), dtype=dtype, device=device),
            s_active=torch.zeros((ns,), dtype=torch.bool, device=device),
            s_age=torch.zeros((ns,), dtype=i32, device=device),
            s_cooldown=torch.zeros((ns,), dtype=i32, device=device),
            s_desc=torch.zeros((ns, 256), dtype=torch.int8, device=device),
            d_uv=torch.zeros((nd, 2), dtype=dtype, device=device),
            d_active=torch.zeros((nd,), dtype=torch.bool, device=device),
            d_obj=torch.full((nd,), INVALID_ID, dtype=i32, device=device),
            d_age=torch.zeros((nd,), dtype=i32, device=device),
            d_cooldown=torch.zeros((nd,), dtype=i32, device=device),
            obj_labels=torch.full((no,), INVALID_ID, dtype=i32, device=device),
            obj_active=torch.zeros((no,), dtype=torch.bool, device=device),
        )


def assign_slots(free: torch.Tensor, want: torch.Tensor):
    """Pair the first n wanted candidates (in priority order) with the first
    n free slots: (slot_idx (K,), cand_idx (K,), pair_ok (K,)), K = min(M, C).
    Stable sorts keep the JAX package's order."""
    m, c = free.shape[0], want.shape[0]
    k = min(m, c)
    slot_order = torch.sort((~free).to(torch.int8), stable=True).indices
    cand_order = torch.sort((~want).to(torch.int8), stable=True).indices
    n = torch.minimum(free.sum(), want.sum())
    ok = torch.arange(k, device=free.device) < n
    return slot_order[:k], cand_order[:k], ok


class PerObjectStatus(NamedTuple):
    """(O,) per-object-slot tracking counters (FeatureTrackerInfo::PerObjectStatus)."""

    num_previous_track: torch.Tensor
    num_track: torch.Tensor
    num_sampled: torch.Tensor
    num_outside_shrunken_image: torch.Tensor
    num_zero_flow: torch.Tensor
    num_tracked_with_different_label: torch.Tensor
    num_tracked_with_background_label: torch.Tensor


class TrackOutputs(NamedTuple):
    """Per-frame tracking report (FeatureTrackerInfo)."""

    n_static_tracked: torch.Tensor
    n_static_new: torch.Tensor
    n_dynamic_tracked: torch.Tensor
    n_dynamic_new: torch.Tensor
    homography_inliers: torch.Tensor
    n_reassociated: torch.Tensor   # tracklets revived by ORB re-association
    per_object: Optional[PerObjectStatus] = None


def _set_rows(x: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor, new: torch.Tensor):
    """x.at[idx].set(where(ok, new, x[idx])) for distinct idx."""
    out = x.clone()
    m = ok.reshape(-1, *([1] * (new.dim() - 1)))
    out[idx] = torch.where(m, new, x[idx])
    return out


def _one_hot(x: torch.Tensor, n: int) -> torch.Tensor:
    """`F.one_hot(x.long(), n)` for x in [0, n), without its range check
    (a host read on the CPU)."""
    return (x.long()[:, None] == torch.arange(n, device=x.device)).long()


def _inb(uv: torch.Tensor, cfg: TrackerConfig, h: int, w: int) -> torch.Tensor:
    return (
        (uv[:, 0] >= cfg.shrink_col)
        & (uv[:, 0] < w - cfg.shrink_col)
        & (uv[:, 1] >= cfg.shrink_row)
        & (uv[:, 1] < h - cfg.shrink_row)
    )


class StaticTrack(NamedTuple):
    """`track_frame` up to the homography refit's eigen-decomposition:
    the frame's (propagated) mask, the static pool's tracked positions and
    flags, the dynamic pool's flow and labels, and the homography RANSAC's
    head (None on the first frame)."""

    mask_cur: torch.Tensor
    s_uv: torch.Tensor
    s_ok: torch.Tensor
    fl_d: Optional[torch.Tensor]
    cur_label_d: Optional[torch.Tensor]
    hom: Optional[homography.HomographyHead]


def track_frame(
    state: TrackerState,
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    flow_prev: torch.Tensor,      # (H, W, 2): maps pixels of frame k-1 into k
    mask_cur: torch.Tensor,       # (H, W) int32 instance labels of frame k
    cfg: TrackerConfig,
    use_klt: bool = True,
    first_frame: bool = False,
    generator: Optional[torch.Generator] = None,
    hom_idx: Optional[torch.Tensor] = None,
    mask_prev: Optional[torch.Tensor] = None,
    hom_uniforms: Optional[torch.Tensor] = None,
):
    """One tracking step: (state at k-1, images) -> (state at k, report).

    `generator` draws the homography-RANSAC hypotheses; `hom_idx` (128, 4)
    injects them instead, and `hom_uniforms` (512,) are the generator's
    draws made beforehand.  With `use_propogate_mask`, labels of
    `mask_prev` (the segmenter's mask of k-1) that the segmenter lost at k
    are carried forward through the flow (`mask_ops.propagate_mask`).

    Runs `track_static`, the homography refit's eigen-decomposition (a
    host read on the card) and `track_rest`; the frontend step runs the
    three apart."""
    st = track_static(state, prev_gray, cur_gray, flow_prev, mask_cur, cfg, use_klt, first_frame, generator,
                      hom_idx, mask_prev, hom_uniforms)
    vecs = None if st.hom is None else homography.normal_eigenvectors(st.hom.AtA)
    return track_rest(state, cur_gray, cfg, first_frame, st, vecs)


def track_static(
    state: TrackerState,
    prev_gray: torch.Tensor,
    cur_gray: torch.Tensor,
    flow_prev: torch.Tensor,
    mask_cur: torch.Tensor,
    cfg: TrackerConfig,
    use_klt: bool = True,
    first_frame: bool = False,
    generator: Optional[torch.Generator] = None,
    hom_idx: Optional[torch.Tensor] = None,
    mask_prev: Optional[torch.Tensor] = None,
    hom_uniforms: Optional[torch.Tensor] = None,
) -> StaticTrack:
    """The static pool's tracking through the homography RANSAC's head;
    see `track_frame`."""
    if cfg.use_propogate_mask and not first_frame and mask_prev is not None:
        mask_cur = propagate_mask(mask_prev, flow_prev, mask_cur)
    h, w = cur_gray.shape

    # ------------------------------------------------------------ static
    ns_pool = state.s_uv.shape[0]
    if first_frame:
        return StaticTrack(mask_cur, state.s_uv, torch.zeros_like(state.s_active), None, None, None)
    # one merged dense-flow sample (K2) for both pools
    need_s_flow = cfg.klt_flow_warm_start or not use_klt
    if need_s_flow:
        fl_both = flow_at(
            flow_prev,
            torch.cat([state.s_uv, state.d_uv], dim=0),
            torch.cat([state.s_active, state.d_active], dim=0),
        )
        fl_s, fl_d = fl_both[:ns_pool], fl_both[ns_pool:]
    else:
        fl_s = None
        fl_d = flow_at(flow_prev, state.d_uv, state.d_active)
    if use_klt:
        if cfg.klt_flow_warm_start:
            g0, levels, iters = fl_s, cfg.klt_warm_levels, cfg.klt_warm_iterations
        else:
            g0, levels, iters = None, cfg.klt_levels, cfg.klt_iterations
        res = klt_track_lk(
            prev_gray, cur_gray, state.s_uv, state.s_active,
            win=cfg.klt_window, levels=levels, iters=iters,
            eps=cfg.klt_eps, g0=g0,
        )
        s_uv, s_ok = res.uv, res.ok
    else:
        s_uv = state.s_uv + fl_s
        s_ok = state.s_active
    inb = _inb(s_uv, cfg, h, w)
    # one merged mask-label sample (K2): static pool at tracked
    # positions + dynamic pool at flow-propagated positions
    labels_both = nearest_at(
        mask_cur,
        torch.cat([s_uv, state.d_uv + fl_d], dim=0),
        torch.cat([state.s_active, state.d_active], dim=0),
    )
    on_bg = labels_both[:ns_pool] == 0
    cur_label_d = labels_both[ns_pool:]
    s_ok = s_ok & inb & on_bg & state.s_active
    hom = homography.ransac_homography_head(
        state.s_uv, s_uv, s_ok, iters=128, threshold=3.0,
        generator=generator, idx=hom_idx, uniforms=hom_uniforms,
    )
    return StaticTrack(mask_cur, s_uv, s_ok, fl_d, cur_label_d, hom)


def track_rest(
    state: TrackerState,
    cur_gray: torch.Tensor,
    cfg: TrackerConfig,
    first_frame: bool,
    st: StaticTrack,
    hom_vecs: Optional[torch.Tensor],
):
    """`track_frame` from the homography refit's eigenvectors
    (`homography.normal_eigenvectors(st.hom.AtA)`) on: the homography
    check, re-detection, the object table and the dynamic pool."""
    mask_cur, s_uv, s_ok, fl_d, cur_label_d = st.mask_cur, st.s_uv, st.s_ok, st.fl_d, st.cur_label_d
    h, w = cur_gray.shape
    dev, dtype = cur_gray.device, cur_gray.dtype
    i32 = torch.int32
    if first_frame:
        homo_inl = torch.zeros((), dtype=i32, device=dev)
    else:
        hres = homography.ransac_homography_tail(st.hom, hom_vecs, threshold=3.0)
        enough = hres.n_inliers >= 10
        s_ok = torch.where(enough, s_ok & hres.inliers, s_ok)
        homo_inl = hres.n_inliers

    s_age = torch.where(s_ok, state.s_age + 1, torch.zeros_like(state.s_age))
    recycle = s_age > cfg.max_feature_track_age
    s_ok = s_ok & ~recycle
    n_tracked = s_ok.sum()
    s_died = state.s_active & ~s_ok
    s_cooldown = torch.clamp(state.s_cooldown - 1, min=0)
    s_cooldown = torch.where(s_died, torch.full_like(s_cooldown, cfg.slot_cooldown_frames), s_cooldown)

    # ------------------------------------------------- re-detection
    def det_inputs():
        # detector input optionally CLAHE-equalised; tracking uses the raw image
        det_gray = clahe(cur_gray, n_bins=cfg.clahe_bins) if cfg.use_clahe_filter else cur_gray
        occupied = occupancy_mask(
            (h, w), s_uv, s_ok, int(cfg.min_distance_btw_tracked_and_detected_features)
        )
        forbid = (
            occupied
            | (mask_cur != 0)
            | border_mask((h, w), max(cfg.shrink_row, 4), max(cfg.shrink_col, 4), device=dev)
        )
        return det_gray, forbid

    s_desc = state.s_desc
    n_reassoc = torch.zeros((), dtype=i32, device=dev)
    cand_desc = None
    skip = False
    if cfg.feature_detector_type == "orb":
        # ORB runs every frame: pyramid FAST + steered BRIEF (kernel K4);
        # the forbid mask is sampled at the candidates (kernel K2)
        det_gray, forbid = det_inputs()
        feats = extract_orb(
            det_gray.contiguous(),
            n_features=cfg.max_nr_keypoints_before_anms,
            n_levels=cfg.orb_n_levels,
            scale_factor=cfg.orb_scale_factor,
            init_threshold=float(cfg.orb_init_threshold_fast),
            min_threshold=float(cfg.orb_min_threshold_fast),
        )
        order = response_order(feats)[:cfg.max_features_per_frame]
        cand_uv, cand_score = feats.uv[order], feats.response[order]
        cand_valid, cand_desc = feats.valid[order], feats.desc[order]
        revive = torch.zeros_like(cand_valid)
        if cfg.orb_reassociate and not first_frame:
            # revive recently lost tracklets whose stored descriptor mutually
            # best-matches a new detection near their last position; matched
            # before the keep-away filter, since revival re-attaches an id
            eligible = ~s_ok & (s_cooldown > 0)
            mm = match_descriptors(
                cand_desc, cand_valid, s_desc, eligible,
                max_hamming=cfg.orb_reassoc_max_hamming, ratio=0.9, cross_check=True,
            )
            slot = mm.index.long()
            d2 = torch.linalg.norm(cand_uv - state.s_uv[slot], dim=-1)
            revive = mm.ok & (d2 <= cfg.orb_reassoc_radius_px)
            # every candidate names SOME slot, so scatter with max/add gated
            # on `revive`; the cross-check leaves at most one revival per slot
            ns = s_ok.shape[0]
            rev_slot = torch.zeros((ns,), dtype=i32, device=dev).scatter_reduce_(
                0, slot, revive.to(i32), reduce="amax") > 0
            uv_new = torch.zeros_like(s_uv).index_add_(
                0, slot, torch.where(revive[:, None], cand_uv, torch.zeros_like(cand_uv)))
            desc_new = torch.zeros((ns, s_desc.shape[1]), dtype=i32, device=dev).index_add_(
                0, slot, torch.where(revive[:, None], cand_desc.to(i32), 0)).to(s_desc.dtype)
            s_uv = torch.where(rev_slot[:, None], uv_new, s_uv)
            s_ok = s_ok | rev_slot
            s_age = torch.where(rev_slot, state.s_age + 1, s_age)
            s_cooldown = torch.where(rev_slot, torch.zeros_like(s_cooldown), s_cooldown)
            s_desc = torch.where(rev_slot[:, None], desc_new, s_desc)
            n_reassoc = revive.sum().to(i32)
            n_tracked = n_tracked + n_reassoc
        # K2 reads the bool mask in place; the (N,) samples are negated
        allowed = ~nearest_at(forbid, cand_uv)
        dets = Detections(uv=cand_uv, score=cand_score, valid=cand_valid & allowed & ~revive)
    else:
        frac = cfg.redetect_min_free_fraction
        if frac > 0.0 and not first_frame:
            floor_n = int(round((1.0 - frac) * cfg.max_features_per_frame))
            skip = int(n_tracked) >= floor_n
        if not skip:
            det_gray, forbid = det_inputs()
            if cfg.feature_detector_type == "harris":
                resp = harris_response(det_gray)
            elif cfg.feature_detector_type == "fast":
                resp = fast_response(det_gray, float(cfg.orb_init_threshold_fast))
            else:
                resp = shi_tomasi_response(det_gray.contiguous())   # kernel K3
            dets = detect_grid_nms(
                resp, forbid, max_corners=cfg.max_features_per_frame,
                cell_size=max(8, cfg.cell_size // 2),
            )
    if skip:
        s_active_new, n_new_static = s_ok, torch.zeros((), dtype=i32, device=dev)
    else:
        budget = cfg.max_features_per_frame - n_tracked
        want = dets.valid & (torch.cumsum(dets.valid.to(torch.int64), 0) <= budget)
        slot_i, cand_i, pair_ok = assign_slots(~s_ok & (s_cooldown == 0), want)
        s_uv = _set_rows(s_uv, slot_i, pair_ok, dets.uv[cand_i])
        s_active_new = _set_rows(s_ok, slot_i, pair_ok, s_ok[slot_i] | pair_ok)
        s_age = _set_rows(s_age, slot_i, pair_ok, torch.zeros_like(s_age[slot_i]))
        n_new_static = pair_ok.sum()
        if cand_desc is not None:
            s_desc = _set_rows(s_desc, slot_i, pair_ok, cand_desc[cand_i])

    # ------------------------------------------------------------ objects
    label_cap = cfg.max_instance_labels
    counts = label_counts(mask_cur, label_cap)
    counts[0].zero_()          # a fill: assigning a Python scalar copies it from the host
    present = counts >= cfg.min_object_pixels
    table = state.obj_labels
    label_ids = torch.arange(label_cap, dtype=i32, device=dev)
    in_table = torch.any(table[None, :] == label_ids[:, None], dim=1)
    new_label = present & ~in_table
    slot_i2, cand_i2, ok2 = assign_slots(table == INVALID_ID, new_label)
    table = _set_rows(table, slot_i2, ok2, label_ids[cand_i2])
    obj_active = torch.where(
        table >= 0, present[torch.clamp(table, 0, label_cap - 1).long()],
        torch.zeros_like(present[:1]),
    )

    # ------------------------------------------------------------ dynamic
    no_ = state.obj_labels.shape[0]
    d_oh = _one_hot(torch.clamp(state.d_obj, 0, no_ - 1), no_).to(i32) * (state.d_obj >= 0)[:, None].to(i32)

    def _cnt(cond):
        return torch.sum(d_oh * cond[:, None].to(i32), dim=0).to(i32)

    if first_frame:
        d_uv, d_ok = state.d_uv, torch.zeros_like(state.d_active)
        zero_o = torch.zeros((no_,), dtype=i32, device=dev)
        n_outside = n_zero_flow = n_diff_label = n_bg_label = zero_o
    else:
        fl = fl_d
        d_uv = state.d_uv + fl
        inb_d = _inb(d_uv, cfg, h, w)
        my_label = torch.where(
            state.d_obj >= 0,
            table[torch.clamp(state.d_obj, 0, no_ - 1).long()],
            torch.full_like(state.d_obj, -2),
        )
        same = cur_label_d == my_label
        d_ok = state.d_active & inb_d & same
        n_outside = _cnt(state.d_active & ~inb_d)
        n_zero_flow = _cnt(state.d_active & (torch.sum(fl * fl, dim=-1) < 1e-8))
        n_diff_label = _cnt(state.d_active & inb_d & (cur_label_d > 0) & ~same)
        n_bg_label = _cnt(state.d_active & inb_d & (cur_label_d == 0))
    if not cfg.use_dynamic_track:
        d_ok = d_ok & (state.d_age < 1)
    d_age = torch.where(d_ok, state.d_age + 1, torch.zeros_like(state.d_age))
    d_ok = d_ok & ~(d_age > cfg.max_feature_track_age)
    n_dyn_tracked = d_ok.sum()
    d_died = state.d_active & ~d_ok
    d_cooldown = torch.clamp(state.d_cooldown - 1, min=0)
    d_cooldown = torch.where(d_died, torch.full_like(d_cooldown, cfg.slot_cooldown_frames), d_cooldown)

    # dense grid sampling of uncovered object pixels (regular integer grid:
    # its mask/occupancy samples are strided slices, not point lookups)
    step = cfg.semantic_mask_step_size
    gy = torch.arange(step // 2, h, step, device=dev)
    gx = torch.arange(step // 2, w, step, device=dev)
    gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
    cand_uv = torch.stack([gxx.reshape(-1), gyy.reshape(-1)], dim=-1).to(dtype)
    cand_label = grid_subsample_i32(mask_cur, step, step // 2).reshape(-1)
    cand_free = ~occupancy_at_grid((h, w), d_uv, d_ok, step // 2, step, step // 2).reshape(-1)
    eq = cand_label[:, None] == table[None, :]
    cand_slot = torch.argmax(eq.to(torch.int8), dim=1).to(i32)    # first match
    cand_has_obj = torch.any(eq, dim=1) & (cand_label > 0)
    cand_want = cand_has_obj & cand_free
    slot_i3, cand_i3, ok3 = assign_slots(~d_ok & (d_cooldown == 0), cand_want)
    d_uv = _set_rows(d_uv, slot_i3, ok3, cand_uv[cand_i3])
    d_obj = _set_rows(state.d_obj, slot_i3, ok3, cand_slot[cand_i3])
    d_active_new = _set_rows(d_ok, slot_i3, ok3, d_ok[slot_i3] | ok3)
    d_age = _set_rows(d_age, slot_i3, ok3, torch.zeros_like(d_age[slot_i3]))
    n_dyn_new = ok3.sum()

    new_state = TrackerState(
        s_uv=s_uv, s_active=s_active_new, s_age=s_age, s_cooldown=s_cooldown, s_desc=s_desc,
        d_uv=d_uv, d_active=d_active_new, d_obj=d_obj, d_age=d_age,
        d_cooldown=d_cooldown, obj_labels=table, obj_active=obj_active,
    )
    n_sampled = torch.sum(
        _one_hot(cand_slot[cand_i3], no_).to(i32)
        * ok3[:, None].to(i32), dim=0,
    ).to(i32)
    per_object = PerObjectStatus(
        num_previous_track=_cnt(state.d_active),
        num_track=_cnt(d_ok),
        num_sampled=n_sampled,
        num_outside_shrunken_image=n_outside,
        num_zero_flow=n_zero_flow,
        num_tracked_with_different_label=n_diff_label,
        num_tracked_with_background_label=n_bg_label,
    )
    report = TrackOutputs(
        n_static_tracked=n_tracked.to(i32),
        n_static_new=n_new_static.to(i32),
        n_dynamic_tracked=n_dyn_tracked.to(i32),
        n_dynamic_new=n_dyn_new.to(i32),
        homography_inliers=homo_inl,
        n_reassociated=n_reassoc,
        per_object=per_object,
    )
    return new_state, report


def format_tracker_report(report: TrackOutputs, obj_labels=None) -> str:
    """Human-readable per-frame report (the reference's `FeatureTrackerInfo`
    print, `RGBDInstanceFrontendModule.cc:119`), with a line per object slot
    that had or sampled tracks; `obj_labels` (`TrackerState.obj_labels`)
    names the slots, else their indices do, and a negative label is skipped."""
    lines = [
        f"static: tracked {int(report.n_static_tracked)} (+{int(report.n_static_new)} new, "
        f"homography inliers {int(report.homography_inliers)}) | "
        f"dynamic: tracked {int(report.n_dynamic_tracked)} (+{int(report.n_dynamic_new)} sampled)"
    ]
    po = report.per_object
    if po is not None:
        cols = {k: torch.as_tensor(v).tolist() for k, v in po._asdict().items()}
        prev = cols["num_previous_track"]
        labels = torch.as_tensor(obj_labels).tolist() if obj_labels is not None else range(len(prev))
        for j in range(len(prev)):
            if labels[j] < 0 or not (prev[j] or cols["num_sampled"][j]):
                continue
            lines.append(
                f"  obj {int(labels[j])}: prev {prev[j]} -> tracked {cols['num_track'][j]} "
                f"(+{cols['num_sampled'][j]} sampled; outside {cols['num_outside_shrunken_image'][j]}, "
                f"zero-flow {cols['num_zero_flow'][j]}, diff-label {cols['num_tracked_with_different_label'][j]}, "
                f"bg-label {cols['num_tracked_with_background_label'][j]})")
    return "\n".join(lines)
