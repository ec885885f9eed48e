"""KITTI-tracking dataset loader, reference loader type 0 (port of
`dynosam_tpu/data/kitti.py`; PNGs decode through the native loader,
`data/native_loader.py`, when its library is present, else through `cv2`).

Layout and semantics match `KittiDataLoader`
(`dataprovider/KittiDataProvider.hpp:352+`):

    <root>/image_0/%06d.png      grayscale/rgb images
    <root>/depth/%06d.png        16-bit disparity; depth = baseline /
                                 (disp / scale) with baseline 387.5744,
                                 scale 256 (`KittiDataProvider.hpp:482-512`)
    <root>/flow/%06d.flo         dense optical flow k -> k+1
    <root>/motion/%06d.png       motion instance masks (preferred) or
    <root>/semantic/%06d.png     semantic instance masks
    <root>/pose_gt.txt           camera pose per frame (4x4 rows),
                                 aligned so frame 0 = identity
    <root>/object_pose.txt       per-frame object poses (KITTI format)
    <root>/times.txt             timestamps
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraParams
from ..frontend.frontend import FrameImages
from .base import DatasetProvider, GroundTruthFrame, to_gray

KITTI_BASELINE = 387.5744
KITTI_DEPTH_SCALE = 256.0


def _read_flo(path: str) -> np.ndarray:
    """Middlebury .flo reader (cv::readOpticalFlow format)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != 202021.25:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


class KittiDataset(DatasetProvider):
    def __init__(
        self,
        path: str,
        starting_frame: int = -1,
        ending_frame: int = -1,
        baseline: float = KITTI_BASELINE,
        depth_scale: float = KITTI_DEPTH_SCALE,
        prefer_motion_mask: bool = True,
        device=None,
    ):
        super().__init__(path, starting_frame, ending_frame, device=device)
        self.baseline = baseline
        # sequences 0018-0020 use the second rig's baseline
        # (`KittiDataProvider.hpp:538-558`)
        if baseline == KITTI_BASELINE and 18 <= self._sequence_id() <= 20:
            self.baseline = 388.1822
        self.depth_scale = depth_scale
        self.rgb_dir = os.path.join(path, "image_0")
        self.depth_dir = os.path.join(path, "depth")
        self.flow_dir = os.path.join(path, "flow")
        mask_dir = os.path.join(path, "motion")
        if not (prefer_motion_mask and os.path.isdir(mask_dir)):
            mask_dir = os.path.join(path, "semantic")
        self.mask_dir = mask_dir
        self._n = len(
            [f for f in os.listdir(self.rgb_dir) if f.endswith(".png")]
        )
        self.timestamps = self._load_times()
        self.gt_poses = self._load_pose_gt()
        self.gt_objects = self._load_object_pose_gt()
        self._cam: Optional[CameraParams] = None

    # ------------------------------------------------------------------
    def _load_times(self):
        p = os.path.join(self.path, "times.txt")
        if os.path.exists(p):
            return np.loadtxt(p).reshape(-1)
        return np.arange(self._n, dtype=np.float64) * 0.1

    def _load_pose_gt(self):
        p = os.path.join(self.path, "pose_gt.txt")
        if not os.path.exists(p):
            return None
        rows = np.loadtxt(p)
        poses = []
        first_inv = None
        for r in rows:
            vals = r[1:] if r.shape[0] in (13, 17) else r
            T = np.eye(4)
            T[:3, :4] = np.asarray(vals[:12]).reshape(3, 4)
            if first_inv is None:
                first_inv = np.linalg.inv(T)
            poses.append(first_inv @ T)  # align first frame to identity
        return poses

    def _load_object_pose_gt(self):
        """Parse object_pose.txt rows `FrameID ObjectID B1-B4 t1 t2 t3 ry`
        into per-frame {object_id: L_world} following the reference's
        `constructObjectPoseGT` (`KittiDataProvider.hpp:214-295`):
        L_camera = (R_y(ry + pi/2), t); L_world = X_gt * L_camera."""
        p = os.path.join(self.path, "object_pose.txt")
        if not os.path.exists(p) or self.gt_poses is None:
            return None
        rows = np.loadtxt(p, ndmin=2)
        per_frame: dict = {}
        for r in rows:
            if r.shape[0] < 10:
                continue
            k = int(r[0])
            obj = int(r[1])
            t = r[6:9]
            y = r[9] + np.pi / 2
            cy, sy = np.cos(y), np.sin(y)
            # the reference's Euler composition with x = z = 0 reduces to a
            # rotation about Y
            R = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
            L_cam = np.eye(4)
            L_cam[:3, :3] = R
            L_cam[:3, 3] = t
            if k >= len(self.gt_poses):
                continue
            L_world = self.gt_poses[k] @ L_cam
            per_frame.setdefault(k, {})[obj] = L_world
        return per_frame

    def __len__(self):
        return self._n

    def _sequence_id(self) -> int:
        """Sequence number from the dataset folder name (the reference
        derives the rig from `<path/to/kitti/XXXX>`,
        `KittiDataProvider.hpp:520-527`)."""
        name = os.path.basename(os.path.normpath(self.path))
        try:
            return int(name)
        except ValueError:
            return -1

    def camera_params(self) -> CameraParams:
        """Per-sequence KITTI-tracking rig (`setCameraParams`,
        `KittiDataProvider.hpp:520-565`): sequences 0000-0013 use the
        (721.5377, 609.5593, 172.854) rig with baseline 387.5744; 0018-0020
        the (718.8560, 607.1928, 185.2157) rig with baseline 388.1822.  A
        `calib.txt` with a `P2: fx 0 cx . 0 fy cy .` row (raw KITTI format)
        overrides both."""
        if self._cam is None:
            calib = os.path.join(self.path, "calib.txt")
            fx = fy = cx = cy = None
            if os.path.exists(calib):
                with open(calib) as f:
                    for line in f:
                        key, _, rest = line.partition(":")
                        if key.strip() in ("P2", "P0"):
                            v = [float(x) for x in rest.split()]
                            if len(v) >= 12:
                                fx, cx = v[0], v[2]
                                fy, cy = v[5], v[6]
                            break
            if fx is None:
                sid = self._sequence_id()
                if 18 <= sid <= 20:
                    fx = fy = 718.8560
                    cx, cy = 607.1928, 185.2157
                else:
                    fx = fy = 721.5377
                    cx, cy = 609.5593, 172.854
            img = self._imread(
                os.path.join(self.rgb_dir, f"{0:06d}.png")
            )
            h, w = img.shape[:2]
            self._cam = CameraParams.create(fx, fy, cx, cy, w, h)
        return self._cam

    # ------------------------------------------------------------------
    @staticmethod
    def _imread(path: str, decode=None) -> np.ndarray:
        """PNG decode through the native loader when built, or through
        `decode` (a path -> array callable with the native loader's output,
        such as `native_loader.PrefetchDecoder.get`) when given (RGB channel
        order, flipped to cv2's BGR), else cv2 (16-bit kept either way)."""
        from . import native_loader

        if decode is not None or native_loader.available():
            img = (decode or native_loader.decode_png)(path)
            if img.ndim == 3 and img.shape[2] >= 3:
                img = img[..., :3][..., ::-1]  # RGB -> BGR (cv2 convention)
            return img
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def frame(self, idx: int, decode=None) -> FrameImages:
        """Frame `idx`; its PNGs decoded by `decode` when given (see
        `_imread`)."""
        name = f"{idx:06d}"
        rgb = self._imread(os.path.join(self.rgb_dir, name + ".png"), decode)
        gray = to_gray(rgb)

        disp = self._imread(
            os.path.join(self.depth_dir, name + ".png"), decode
        ).astype(np.float64)
        d = disp / self.depth_scale
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(d > 0, self.baseline / np.maximum(d, 1e-9), 0.0)

        flow_path = os.path.join(self.flow_dir, name + ".flo")
        if os.path.exists(flow_path):
            flow = _read_flo(flow_path)
        else:
            flow = np.zeros((*gray.shape, 2), np.float32)

        mask_path = os.path.join(self.mask_dir, name + ".png")
        if os.path.exists(mask_path):
            mask = self._imread(mask_path, decode).astype(np.int32)
            if mask.ndim == 3:
                mask = mask[..., 0].astype(np.int32)
        else:
            # text-format semantic mask (`loadSemanticMask`)
            txt = os.path.join(self.mask_dir, name + ".txt")
            if os.path.exists(txt):
                mask = np.loadtxt(txt, dtype=np.int32).reshape(gray.shape)
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
            # ^wH_k = ^wL_k (^wL_{k-1})^-1 (world-centric motion)
            for obj, L in obj_poses.items():
                if obj in prev:
                    obj_motions[obj] = L @ np.linalg.inv(prev[obj])
        return GroundTruthFrame(
            frame_id=idx,
            timestamp=float(self.timestamps[min(idx, len(self.timestamps) - 1)]),
            X_world=self.gt_poses[idx],
            object_poses=obj_poses,
            object_motions=obj_motions,
        )
