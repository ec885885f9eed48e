"""ClusterSLAM / CARLA dataset loader, reference loader type 2 (port of
`dynosam_tpu/data/cluster.py`).

Implements the full `ClusterSlamAllLoader` semantics
(`src/dataprovider/ClusterSlamDataProvider.cc:46-420`):

    <root>/images/left/*.png     <root>/images/right/*.png
    <root>/optical_flow/*.flo
    <root>/instance_masks/*.png
    <root>/pose/<frame>          per-frame "pantheon" pose files: one line
                                 `x y z qx qy qz qw` per body; line 0 is the
                                 camera, line i>=1 is object i.  All poses
                                 aligned to the first camera pose
                                 (initial_pose^-1 * pose, :333-340)
    <root>/landmarks/left/<frame>   lines `landmark_id u v`
    <root>/landmark_mapping.txt     lines `landmark_id cluster_id`
    <root>/intrinsic.txt         two 3x4 projection matrices (3 lines each,
                                 separated by a blank line); K = P[:, :3],
                                 stereo baseline from the right camera's
                                 extrinsics (:145-200)

Depth is *computed* by dense stereo reconstruction from the left/right pair
(`denseStereoReconstruction`, :203-214) — host OpenCV SGBM by default (the
reference's `StereoMatcher` wraps the same machinery) or the port's block
matcher (`frontend/stereo.py:block_match`) on the loader's device (the
card unless `device` says otherwise) with `stereo_backend="device"` (the
JAX package's `"jax"`); the depth comes back to the host with the frame.

Instance masks are RELABELLED to cluster ids by counting each cluster's
landmarks inside every detected instance's bounding box and solving the
assignment (`associateDetectedBBWithObject`, :258-314 — Hungarian on
inverted counts) so mask labels match the pantheon object indexing.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraParams
from ..frontend.frontend import FrameImages
from .base import DatasetProvider, GroundTruthFrame, to_gray
from .kitti import _read_flo


def _quat_to_R(qw, qx, qy, qz) -> np.ndarray:
    n = np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array(
        [
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ]
    )


class ClusterSlamDataset(DatasetProvider):
    def __init__(
        self,
        path: str,
        starting_frame: int = -1,
        ending_frame: int = -1,
        stereo_backend: str = "sgbm",   # "sgbm" (host cv2) | "device" (block matcher)
        device=None,
    ):
        super().__init__(path, starting_frame, ending_frame, device=device)
        if stereo_backend not in ("sgbm", "device"):
            raise ValueError(
                f"stereo_backend {stereo_backend!r}: use 'sgbm' (host OpenCV) or 'device' (the block "
                "matcher on the loader's device, the JAX package's 'jax')")
        self.left_dir = os.path.join(path, "images/left")
        self.right_dir = os.path.join(path, "images/right")
        self.flow_dir = os.path.join(path, "optical_flow")
        self.mask_dir = os.path.join(path, "instance_masks")
        self.pose_dir = os.path.join(path, "pose")
        self.lmk_dir = os.path.join(path, "landmarks/left")
        self.stereo_backend = stereo_backend

        self.left_files = sorted(os.listdir(self.left_dir))
        self.right_files = sorted(os.listdir(self.right_dir))
        self.flow_files = (
            sorted(os.listdir(self.flow_dir))
            if os.path.isdir(self.flow_dir) else []
        )
        self.mask_files = (
            sorted(os.listdir(self.mask_dir))
            if os.path.isdir(self.mask_dir) else []
        )
        self._cam: Optional[CameraParams] = None
        self._sgbm = None
        self.baseline = 0.5
        self._load_intrinsics()
        self.landmarks = self._load_landmarks()          # frame -> (id, u, v)
        self.landmark_cluster = self._load_landmark_mapping()
        self.gt = self._load_pantheon_poses()

    # ------------------------------------------------------------------
    def _load_intrinsics(self):
        """Two 3x4 projection matrices; K from the top-left 3x3, baseline
        from the right camera's extrinsics (`setIntrisics`)."""
        p = os.path.join(self.path, "intrinsic.txt")
        self._P1 = self._P2 = None
        if not os.path.exists(p):
            return
        with open(p) as f:
            lines = [ln.strip() for ln in f.readlines()]
        rows = [ln for ln in lines if ln]
        if len(rows) >= 6:
            P1 = np.array([[float(v) for v in rows[i].split()] for i in range(3)])
            P2 = np.array([[float(v) for v in rows[i].split()] for i in range(3, 6)])
            self._P1, self._P2 = P1, P2
            K2 = P2[:, :3]
            # P = K [R | t]; for a rectified pair t_x = -fx * baseline
            ext = np.linalg.inv(K2) @ P2
            self.baseline = abs(float(ext[0, 3]))

    def _load_landmarks(self):
        out = {}
        if not os.path.isdir(self.lmk_dir):
            return out
        for fn in os.listdir(self.lmk_dir):
            try:
                frame = int(os.path.splitext(fn)[0])
            except ValueError:
                continue
            rows = np.loadtxt(os.path.join(self.lmk_dir, fn), ndmin=2)
            if rows.size:
                out[frame] = rows
        return out

    def _load_landmark_mapping(self):
        p = os.path.join(self.path, "landmark_mapping.txt")
        if not os.path.exists(p):
            return {}
        rows = np.loadtxt(p, dtype=np.int64, ndmin=2)
        return {int(r[0]): int(r[1]) for r in rows}

    def _load_pantheon_poses(self):
        """pose/<frame> files: line 0 camera, line i object i; aligned to
        the first camera pose (`setGroundTruthPacket`)."""
        out = {}
        if not os.path.isdir(self.pose_dir):
            return out
        frames = []
        for fn in os.listdir(self.pose_dir):
            try:
                frames.append((int(os.path.splitext(fn)[0]), fn))
            except ValueError:
                continue
        initial_inv = None
        for frame, fn in sorted(frames):
            rows = np.loadtxt(os.path.join(self.pose_dir, fn), ndmin=2)
            poses = []
            for r in rows:
                T = np.eye(4)
                T[:3, :3] = _quat_to_R(r[6], r[3], r[4], r[5])
                T[:3, 3] = r[:3]
                if initial_inv is None:
                    initial_inv = np.linalg.inv(T)
                poses.append(initial_inv @ T)
            out[frame] = poses
        return out

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.left_files)

    def camera_params(self) -> CameraParams:
        if self._cam is None:
            import cv2

            img = cv2.imread(os.path.join(self.left_dir, self.left_files[0]))
            h, w = img.shape[:2]
            if self._P1 is not None:
                K = self._P1[:, :3]
                fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
            else:
                fx = fy = 0.5 * w
                cx, cy = w / 2, h / 2
            self._cam = CameraParams.create(fx, fy, cx, cy, w, h)
        return self._cam

    # ------------------------------------------------------------------
    def _stereo_depth(self, left_gray, right_gray):
        cam = self.camera_params()
        fx = float(np.asarray(cam.fx))
        if self.stereo_backend == "device":
            # plane-sweep block matcher (frontend/stereo.py) on the device
            from ..core.camera import StereoParams
            from ..frontend.stereo import dense_stereo
            from ..utils.device import resolve_device

            dev = resolve_device(self.device)
            res = dense_stereo(
                torch.as_tensor(np.asarray(left_gray, np.float32), device=dev),
                torch.as_tensor(np.asarray(right_gray, np.float32), device=dev),
                StereoParams(left=cam, baseline=float(self.baseline)),
            )
            return res.depth.cpu().numpy()
        import cv2

        if self._sgbm is None:
            # disparity range must fit the image width (16-multiple)
            nd = int(min(128, max(16, (left_gray.shape[1] - 8) // 16 * 16)))
            self._sgbm = cv2.StereoSGBM_create(
                minDisparity=0,
                numDisparities=nd,
                blockSize=7,
                P1=8 * 49,
                P2=32 * 49,
                uniquenessRatio=10,
                speckleWindowSize=100,
                speckleRange=2,
            )
        disp = (
            self._sgbm.compute(
                left_gray.astype(np.uint8), right_gray.astype(np.uint8)
            ).astype(np.float32)
            / 16.0
        )
        with np.errstate(divide="ignore"):
            return np.where(
                disp > 0.5, fx * self.baseline / np.maximum(disp, 0.5), 0.0
            )

    def _relabel_mask(self, mask: np.ndarray, idx: int) -> np.ndarray:
        """Relabel detected instances to pantheon cluster ids by counting
        each cluster's landmarks inside the instance's bounding box and
        solving the assignment (`associateDetectedBBWithObject`)."""
        labels = [int(l) for l in np.unique(mask) if l != 0]
        lmks = self.landmarks.get(idx)
        if not labels or lmks is None or not self.landmark_cluster:
            return mask
        # cluster -> keypoints
        clusters: dict = {}
        for r in lmks:
            cid = self.landmark_cluster.get(int(r[0]))
            if cid is None:
                continue
            clusters.setdefault(cid, []).append((r[1], r[2]))
        if not clusters:
            return mask
        cluster_ids = sorted(clusters)
        cost = np.zeros((len(labels), len(cluster_ids)))
        keep = []
        for i, lab in enumerate(labels):
            ys, xs = np.nonzero(mask == lab)
            if xs.size == 0:
                continue
            keep.append(i)
            x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
            for jc, cid in enumerate(cluster_ids):
                pts = np.asarray(clusters[cid])
                inside = (
                    (pts[:, 0] >= x0) & (pts[:, 0] <= x1)
                    & (pts[:, 1] >= y0) & (pts[:, 1] <= y1)
                )
                cost[i, jc] = inside.sum() + 1e-6
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(10.0 / cost)
        out = mask.copy()
        for i, jc in zip(rows, cols):
            out[mask == labels[i]] = cluster_ids[jc]
        return out

    def frame(self, idx: int) -> FrameImages:
        import cv2

        left = cv2.imread(os.path.join(self.left_dir, self.left_files[idx]))
        right = cv2.imread(os.path.join(self.right_dir, self.right_files[idx]))
        gray = to_gray(left)  # cv2 BGR; to_gray uses BGR weights
        gray_r = to_gray(right)
        depth = self._stereo_depth(gray, gray_r)

        if idx < len(self.flow_files):
            fp = os.path.join(self.flow_dir, self.flow_files[idx])
            flow = (
                _read_flo(fp)
                if fp.endswith(".flo")
                else np.zeros((*gray.shape, 2), np.float32)
            )
        else:
            flow = np.zeros((*gray.shape, 2), np.float32)

        if idx < len(self.mask_files):
            mask = cv2.imread(
                os.path.join(self.mask_dir, self.mask_files[idx]),
                cv2.IMREAD_UNCHANGED,
            )
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = self._relabel_mask(mask.astype(np.int32), idx)
        else:
            mask = np.zeros(gray.shape, np.int32)

        return FrameImages(
            gray=torch.as_tensor(np.asarray(gray, np.float32)),
            depth=torch.as_tensor(np.asarray(depth, np.float32)),
            flow=torch.as_tensor(np.asarray(flow, np.float32)),
            mask=torch.as_tensor(np.asarray(mask, np.int32)),
        )

    def ground_truth(self, idx: int) -> Optional[GroundTruthFrame]:
        poses = self.gt.get(idx)
        if not poses:
            return None
        obj_poses = {i: T for i, T in enumerate(poses) if i > 0}
        prev = self.gt.get(idx - 1) or []
        obj_motions = {}
        for i, L in obj_poses.items():
            if i < len(prev):
                obj_motions[i] = L @ np.linalg.inv(prev[i])
        return GroundTruthFrame(
            frame_id=idx,
            timestamp=float(idx) * 0.1,
            X_world=poses[0],
            object_poses=obj_poses,
            object_motions=obj_motions,
        )
