"""Oxford Multimotion Dataset (OMD) loader, reference loader type 3 (port
of `dynosam_tpu/data/omd.py`).

Implements the reference's ACTIVE loader `OMDOldAllLoader`
(`src/dataprovider/OMDDataProvider.cc`, the preprocessed folder-per-modality
layout; the raw-vicon loader in the same file is commented out upstream):

    <root>/times.txt            timestamps, one float per line
    <root>/image_0/*.png        RGB frames (arbitrary sorted names)
    <root>/depth/*.png          disparity PNGs; depth = baseline * fx /
                                (disp / 256)   (OMDDataProvider.cc getDepthImage)
    <root>/semantic/*.txt       TEXT-format instance masks (one int per pixel)
    <root>/flow/*.flo           dense optical flow k -> k+1
    <root>/pose_gt.txt          `frame  r11..r33 t (4x4 row-major, 16 vals)`
                                camera poses, ALIGNED so the first pose is
                                identity (initial_pose^-1 * pose)
    <root>/object_pose.txt      `frame object tx ty tz rx ry rz` with
                                (rx,ry,rz) an angle-scaled Rodrigues vector;
                                L_world re-expressed in the aligned world:
                                L' = X_aligned * (X_orig^-1 * L)
    <root>/oxford.yaml          Camera.{fx,fy,cx,cy,width,height,baseline}

GT object motions are the world-centric ^wH_k = ^wL_k (^wL_{k-1})^-1
(`GroundTruthInputPacket::calculateAndSetMotions`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraParams
from ..frontend.frontend import FrameImages
from .base import DatasetProvider, GroundTruthFrame, to_gray
from .kitti import KittiDataset, _read_flo

# OMD RGB-D rig defaults (kalibr, used when oxford.yaml is absent)
OMD_FX = 528.174
OMD_FY = 528.967
OMD_CX = 312.339
OMD_CY = 242.119
OMD_BASELINE_M = 0.05


def _sorted_files(d: str, suffix: str):
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if f.endswith(suffix))


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Angle-scaled axis -> rotation matrix (OMDDataProvider.cc:ObjPose)."""
    angle = float(np.linalg.norm(rvec))
    if angle < 1e-12:
        return np.eye(3)
    x, y, z = rvec / angle
    s, c = np.sin(angle), np.cos(angle)
    v = 1.0 - c
    return np.array(
        [
            [x * x * v + c, x * y * v - z * s, x * z * v + y * s],
            [x * y * v + z * s, y * y * v + c, y * z * v - x * s],
            [x * z * v - y * s, y * z * v + x * s, z * z * v + c],
        ]
    )


class OMDDataset(DatasetProvider):
    def __init__(
        self,
        path: str,
        starting_frame: int = -1,
        ending_frame: int = -1,
        device=None,
    ):
        super().__init__(path, starting_frame, ending_frame, device=device)
        self.rgb_dir = os.path.join(path, "image_0")
        self.depth_dir = os.path.join(path, "depth")
        self.flow_dir = os.path.join(path, "flow")
        self.mask_dir = os.path.join(path, "semantic")

        self.rgb_files = _sorted_files(self.rgb_dir, ".png")
        self.depth_files = _sorted_files(self.depth_dir, ".png")
        self.flow_files = _sorted_files(self.flow_dir, ".flo")
        self.mask_files = _sorted_files(self.mask_dir, ".txt")

        # ---- intrinsics + baseline (oxford.yaml, setCameraParams)
        fx, fy, cx, cy = OMD_FX, OMD_FY, OMD_CX, OMD_CY
        wh = None
        self.baseline_m = OMD_BASELINE_M
        yaml_path = os.path.join(path, "oxford.yaml")
        if os.path.exists(yaml_path):
            import yaml

            with open(yaml_path) as f:
                y = yaml.safe_load(f) or {}
            fx = y.get("Camera.fx", fx)
            fy = y.get("Camera.fy", fy)
            cx = y.get("Camera.cx", cx)
            cy = y.get("Camera.cy", cy)
            self.baseline_m = y.get("Camera.baseline", self.baseline_m)
            if "Camera.width" in y and "Camera.height" in y:
                wh = (int(y["Camera.width"]), int(y["Camera.height"]))
        self._intrinsics = (fx, fy, cx, cy)
        self._wh = wh
        self._cam: Optional[CameraParams] = None

        self.timestamps = self._load_times()
        self.gt_poses = self._load_pose_gt()
        self.gt_objects = self._load_object_pose_gt()

    # ------------------------------------------------------------------
    def _load_times(self):
        p = os.path.join(self.path, "times.txt")
        if os.path.exists(p):
            return np.loadtxt(p).reshape(-1)
        return np.arange(len(self.rgb_files), dtype=np.float64) * 0.1

    def _load_pose_gt(self):
        """`frame` + 16 row-major 4x4 values; aligned to the first pose
        (OMDDataProvider.cc loadAll: initial_pose.inverse() * pose).  The
        ORIGINAL poses are kept too — object GT needs them for
        re-expression."""
        p = os.path.join(self.path, "pose_gt.txt")
        if not os.path.exists(p):
            self._gt_poses_orig = None
            return None
        rows = np.loadtxt(p, ndmin=2)
        orig = []
        for r in rows:
            vals = r[1:17] if r.shape[0] >= 17 else r[:16]
            orig.append(np.asarray(vals, np.float64).reshape(4, 4))
        self._gt_poses_orig = orig
        first_inv = np.linalg.inv(orig[0])
        return [first_inv @ T for T in orig]

    def _load_object_pose_gt(self):
        """`frame object tx ty tz rx ry rz`; L_world (original world) via
        Rodrigues, then re-expressed in the aligned world through the
        camera: L' = X_aligned * (X_orig^-1 * L)."""
        p = os.path.join(self.path, "object_pose.txt")
        if not os.path.exists(p) or self.gt_poses is None:
            return None
        rows = np.loadtxt(p, ndmin=2)
        per_frame: dict = {}
        for r in rows:
            if r.shape[0] < 8:
                continue
            k = int(r[0])
            if k >= len(self.gt_poses):
                continue
            obj = int(r[1])
            L = np.eye(4)
            L[:3, :3] = _rodrigues(np.asarray(r[5:8], np.float64))
            L[:3, 3] = r[2:5]
            rel = np.linalg.inv(self._gt_poses_orig[k]) @ L
            per_frame.setdefault(k, {})[obj] = self.gt_poses[k] @ rel
        return per_frame

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.rgb_files)

    def camera_params(self) -> CameraParams:
        if self._cam is None:
            if self._wh is not None:
                w, h = self._wh
            else:
                img = KittiDataset._imread(
                    os.path.join(self.rgb_dir, self.rgb_files[0])
                )
                h, w = img.shape[:2]
            fx, fy, cx, cy = self._intrinsics
            self._cam = CameraParams.create(fx, fy, cx, cy, w, h)
        return self._cam

    def frame(self, idx: int) -> FrameImages:
        rgb = KittiDataset._imread(
            os.path.join(self.rgb_dir, self.rgb_files[idx])
        )
        gray = to_gray(rgb)

        disp = KittiDataset._imread(
            os.path.join(self.depth_dir, self.depth_files[idx])
        ).astype(np.float64)
        if disp.ndim == 3:
            disp = disp[..., 0]
        fx = self._intrinsics[0]
        d = disp / 256.0
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(
                d > 0, self.baseline_m * fx / np.maximum(d, 1e-9), 0.0
            )

        if idx < len(self.flow_files):
            flow = _read_flo(os.path.join(self.flow_dir, self.flow_files[idx]))
        else:
            flow = np.zeros((*gray.shape, 2), np.float32)

        if idx < len(self.mask_files):
            mask = np.loadtxt(
                os.path.join(self.mask_dir, self.mask_files[idx]),
                dtype=np.int32,
            ).reshape(gray.shape)
        else:
            mask = np.zeros(gray.shape, np.int32)

        return FrameImages(
            gray=torch.as_tensor(np.asarray(gray, np.float32)),
            depth=torch.as_tensor(np.asarray(depth, np.float32)),
            flow=torch.as_tensor(np.asarray(flow, np.float32)),
            mask=torch.as_tensor(np.asarray(mask, np.int32)),
        )

    def ground_truth(self, idx: int) -> Optional[GroundTruthFrame]:
        if self.gt_poses is None or idx >= len(self.gt_poses):
            return None
        obj_poses = {}
        obj_motions = {}
        if self.gt_objects is not None:
            obj_poses = dict(self.gt_objects.get(idx, {}))
            prev = self.gt_objects.get(idx - 1, {})
            for obj, L in obj_poses.items():
                if obj in prev:
                    obj_motions[obj] = L @ np.linalg.inv(prev[obj])
        return GroundTruthFrame(
            frame_id=idx,
            timestamp=float(
                self.timestamps[min(idx, len(self.timestamps) - 1)]
            ),
            X_world=self.gt_poses[idx],
            object_poses=obj_poses,
            object_motions=obj_motions,
        )
