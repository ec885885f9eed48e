"""Device-resident measurement map (port of `dynosam_tpu/backend/map.py`).

Fixed-capacity struct-of-arrays indexed by ``(frame, slot)``:

  * static observations:   (F, NS)
  * dynamic observations:  (F, ND)
  * per-object estimates:  (F, O)

`update_map` writes one packet's rows in place (the host loop owns the
map); `slice_window` returns views of a frame range; `compact_window`
gathers a window's most-observed slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.lie import SE3, se3_identity
from ..core.types import INVALID_ID, FrontendOutput


class MeasurementMap(NamedTuple):
    """All measurements observed so far, on the device, static shapes."""

    static_xyz: torch.Tensor      # (F, NS, 3) camera-frame point measurement
    static_uv: torch.Tensor       # (F, NS, 2)
    static_valid: torch.Tensor    # (F, NS) bool
    dyn_xyz: torch.Tensor         # (F, ND, 3)
    dyn_uv: torch.Tensor          # (F, ND, 2)
    dyn_obj: torch.Tensor         # (F, ND) int32 object slot, -1 if none
    dyn_valid: torch.Tensor       # (F, ND) bool
    X_init: SE3                   # (F,) frontend camera pose ^w X_k
    timestamps: torch.Tensor      # (F,)
    frame_ids: torch.Tensor       # (F,) int32 dataset frame id
    frame_valid: torch.Tensor     # (F,) bool
    motion_init: SE3              # (F, O) frontend ^w H_k
    motion_valid: torch.Tensor    # (F, O) bool
    obj_pose_init: SE3            # (F, O) propagated ^w L_k
    obj_label: torch.Tensor       # (F, O) int32 global instance label

    @property
    def capacity(self):
        f, ns = self.static_valid.shape
        return f, ns, self.dyn_valid.shape[1], self.motion_valid.shape[1]

    @staticmethod
    def create(max_frames: int, ns: int, nd: int, no: int, dtype=torch.float32, device=None):
        f = max_frames
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)  # noqa: E731
        inv = lambda *s: torch.full(s, INVALID_ID, dtype=torch.int32, device=device)  # noqa: E731
        return MeasurementMap(
            static_xyz=z(f, ns, 3), static_uv=z(f, ns, 2), static_valid=zb(f, ns),
            dyn_xyz=z(f, nd, 3), dyn_uv=z(f, nd, 2), dyn_obj=inv(f, nd), dyn_valid=zb(f, nd),
            X_init=se3_identity((f,), dtype, device), timestamps=z(f), frame_ids=inv(f),
            frame_valid=zb(f),
            motion_init=se3_identity((f, no), dtype, device), motion_valid=zb(f, no),
            obj_pose_init=se3_identity((f, no), dtype, device), obj_label=inv(f, no),
        )


def update_map(m: MeasurementMap, out: FrontendOutput, k: int) -> MeasurementMap:
    """Write one frontend packet into row ``k`` of every field, in place
    (the JAX package's functional scatter); returns ``m``."""
    rows = (
        (m.static_xyz, out.static_obs.xyz), (m.static_uv, out.static_obs.uv),
        (m.static_valid, out.static_obs.valid),
        (m.dyn_xyz, out.dynamic_obs.xyz), (m.dyn_uv, out.dynamic_obs.uv),
        (m.dyn_obj, out.dynamic_obs.obj), (m.dyn_valid, out.dynamic_obs.valid),
        (m.X_init.R, out.X_world.R), (m.X_init.t, out.X_world.t),
        (m.timestamps, out.timestamp), (m.frame_ids, out.frame_id),
        (m.motion_init.R, out.objects.motion.R), (m.motion_init.t, out.objects.motion.t),
        (m.motion_valid, out.objects.motion_valid),
        (m.obj_pose_init.R, out.objects.pose.R), (m.obj_pose_init.t, out.objects.pose.t),
        (m.obj_label, out.objects.label),
    )
    for dst, src in rows:
        dst[k] = src
    m.frame_valid[k] = True
    return m


class WindowData(NamedTuple):
    """A contiguous frame window gathered from the map."""

    static_xyz: torch.Tensor    # (W, NS, 3)
    static_valid: torch.Tensor  # (W, NS)
    dyn_xyz: torch.Tensor       # (W, ND, 3)
    dyn_obj: torch.Tensor       # (W, ND)
    dyn_valid: torch.Tensor     # (W, ND)
    X_init: SE3                 # (W,)
    motion_init: SE3            # (W, O)
    motion_valid: torch.Tensor  # (W, O)
    obj_pose_init: SE3          # (W, O)
    frame_valid: torch.Tensor   # (W,)
    start: int                  # first frame index in the map


def slice_window(m: MeasurementMap, start: int, window: int) -> WindowData:
    """Frames [start, start + window) as views of the map.  The range must
    lie inside the map: the JAX package's `dynamic_slice` would clamp it."""
    f = m.frame_valid.shape[0]
    if not 0 <= start <= f - window:
        raise ValueError(f"window [{start}, {start + window}) is outside the map's {f} frames")
    sl = slice(start, start + window)
    return WindowData(
        static_xyz=m.static_xyz[sl], static_valid=m.static_valid[sl],
        dyn_xyz=m.dyn_xyz[sl], dyn_obj=m.dyn_obj[sl], dyn_valid=m.dyn_valid[sl],
        X_init=m.X_init[sl], motion_init=m.motion_init[sl], motion_valid=m.motion_valid[sl],
        obj_pose_init=m.obj_pose_init[sl], frame_valid=m.frame_valid[sl], start=start,
    )


def top_k_lowest_first(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the lower index
    (`jax.lax.top_k`'s order; `torch.topk` promises none)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def compact_window(w: WindowData, ns_win: int, nd_win: int, no_win: int):
    """Gather the window's most-observed static/dynamic slots and objects
    into a smaller WindowData (top-k by in-window observation count, ties to
    the lower slot).  Dynamic observations of objects outside the top-k get
    object INVALID_ID, which disables their factors in `build_masks`.

    Returns ``(w_c, sp_idx, dp_idx, obj_idx)``."""
    O = w.motion_valid.shape[1]
    f32 = torch.float32
    sp_idx = top_k_lowest_first(w.static_valid.sum(0).to(f32), ns_win)
    dp_idx = top_k_lowest_first(w.dyn_valid.sum(0).to(f32), nd_win)
    # object score: dynamic observations per object slot + frontend motion
    # validity (keeps objects the frontend solved even if thinly observed)
    dev = w.dyn_obj.device
    onehot = w.dyn_obj[..., None] == torch.arange(O, dtype=w.dyn_obj.dtype, device=dev)
    o_score = (onehot & w.dyn_valid[..., None]).sum((0, 1)).to(f32) + w.motion_valid.sum(0).to(f32)
    obj_idx = top_k_lowest_first(o_score, no_win)

    # remap dyn_obj to compacted slots; objects outside the top-k -> INVALID_ID
    inv = torch.full((O,), INVALID_ID, dtype=torch.int32, device=dev)
    inv[obj_idx] = torch.arange(no_win, dtype=torch.int32, device=dev)
    dyn_obj_c = w.dyn_obj[:, dp_idx]
    new_obj = inv[dyn_obj_c.clamp(min=0).long()]
    dyn_obj_new = torch.where(dyn_obj_c >= 0, new_obj, torch.full_like(new_obj, INVALID_ID))

    w_c = WindowData(
        static_xyz=w.static_xyz[:, sp_idx], static_valid=w.static_valid[:, sp_idx],
        dyn_xyz=w.dyn_xyz[:, dp_idx], dyn_obj=dyn_obj_new, dyn_valid=w.dyn_valid[:, dp_idx],
        X_init=w.X_init, motion_init=w.motion_init[:, obj_idx],
        motion_valid=w.motion_valid[:, obj_idx], obj_pose_init=w.obj_pose_init[:, obj_idx],
        frame_valid=w.frame_valid, start=w.start,
    )
    return w_c, sp_idx, dp_idx, obj_idx
