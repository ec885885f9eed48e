"""Virtual KITTI 2 dataset loader, reference loader type 1 (port of
`dynosam_tpu/data/vkitti.py`).

Layout and decode semantics match `VirtualKittiDataLoader`
(`src/dataprovider/VirtualKittidataProvider.cc:60-900`):

    <root>/vkitti_2.0.3_rgb/<scene>/<type>/frames/rgb/Camera_0/rgb_%05d.jpg
    <root>/vkitti_2.0.3_depth/.../depth/Camera_0/depth_%05d.png
        16-bit PNG in centimetres -> metres (/100)
    <root>/vkitti_2.0.3_forwardFlow/.../forwardFlow/Camera_0/flow_%05d.png
        16UC3 BGR encoding: R,G = x,y flow normalized to [0, 2^16-1] over
        (w-1, h-1); B==0 marks invalid flow
    <root>/vkitti_2.0.3_instanceSegmentation/.../instanceSegmentation/
        Camera_0/instancegt_%05d.png
    <root>/vkitti_2.0.3_textgt/<scene>/<type>/{intrinsic.txt, extrinsic.txt,
        pose.txt, bbox.txt, info.txt}

Note the flow file for step k->k+1 lives at index k (the reference fetches
`idx-1` when asked for the flow *into* idx; our convention — `flow[k]`
maps frame k into k+1 — reads file k directly).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraParams
from ..frontend.frontend import FrameImages
from .base import DatasetProvider, GroundTruthFrame, to_gray


def decode_vkitti_flow(bgr16: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint16 BGR -> (H, W, 2) float32 flow, invalid -> 0."""
    h, w, _ = bgr16.shape
    f = bgr16.astype(np.float32)
    unscaled = 2.0 / (2.0**16 - 1.0) * f - 1.0
    # BGR order: [:, :, 2] = R = x-flow, [:, :, 1] = G = y-flow
    fx = unscaled[..., 2] * (w - 1.0)
    fy = unscaled[..., 1] * (h - 1.0)
    flow = np.stack([fx, fy], axis=-1)
    invalid = bgr16[..., 0] == 0
    flow[invalid] = 0.0
    return flow


class VirtualKittiDataset(DatasetProvider):
    def __init__(
        self,
        path: str,
        scene: str = "Scene01",
        scene_type: str = "clone",
        starting_frame: int = -1,
        ending_frame: int = -1,
        device=None,
    ):
        super().__init__(path, starting_frame, ending_frame, device=device)
        sub = f"{scene}/{scene_type}/frames"
        self.rgb_dir = os.path.join(path, "vkitti_2.0.3_rgb", sub, "rgb/Camera_0")
        self.depth_dir = os.path.join(
            path, "vkitti_2.0.3_depth", sub, "depth/Camera_0"
        )
        self.flow_dir = os.path.join(
            path, "vkitti_2.0.3_forwardFlow", sub, "forwardFlow/Camera_0"
        )
        self.inst_dir = os.path.join(
            path,
            "vkitti_2.0.3_instanceSegmentation",
            sub,
            "instanceSegmentation/Camera_0",
        )
        self.textgt_dir = os.path.join(
            path, "vkitti_2.0.3_textgt", scene, scene_type
        )
        self._n = len(
            [f for f in os.listdir(self.rgb_dir) if f.startswith("rgb_")]
        )
        self._cam: Optional[CameraParams] = None
        self.gt_poses = self._load_extrinsics()
        self.gt_objects = self._load_object_gt()
        self.gt_bboxes = self._load_bbox_meta()

    def _load_extrinsics(self):
        p = os.path.join(self.textgt_dir, "extrinsic.txt")
        if not os.path.exists(p):
            return None
        poses = []
        first_inv = None
        with open(p) as f:
            next(f)  # header
            for line in f:
                vals = line.split()
                if len(vals) < 18 or vals[1] != "0":  # camera 0 only
                    continue
                T_wc_inv = np.asarray(list(map(float, vals[2:18]))).reshape(4, 4)
                T = np.linalg.inv(T_wc_inv)  # extrinsic is world->camera
                if first_inv is None:
                    first_inv = np.linalg.inv(T)
                poses.append(first_inv @ T)
        return poses

    @staticmethod
    def _header_columns(line: str) -> dict:
        return {name: i for i, name in enumerate(line.split())}

    def _load_bbox_meta(self):
        """bbox.txt -> per-frame {track: (bbox ltrb, is_moving)}
        (`VirtualKittidataProvider.cc:308-385` loadBBoxMetaData)."""
        p = os.path.join(self.textgt_dir, "bbox.txt")
        if not os.path.exists(p):
            return None
        per_frame: dict = {}
        with open(p) as f:
            cols = self._header_columns(next(f))
            for line in f:
                v = line.split()
                if len(v) != len(cols) or int(v[cols["cameraID"]]) != 0:
                    continue
                k = int(v[cols["frame"]])
                tid = int(v[cols["trackID"]])
                bbox = (
                    float(v[cols["left"]]), float(v[cols["top"]]),
                    float(v[cols["right"]]), float(v[cols["bottom"]]),
                )
                moving = v[cols["isMoving"]].lower() in ("true", "1")
                per_frame.setdefault(k, {})[tid] = (bbox, moving)
        return per_frame

    def _load_object_gt(self):
        """pose.txt -> per-frame {track: L_world 4x4}.

        Decode matches the reference's `loadPoseTxt`
        (`VirtualKittidataProvider.cc:387-527`): camera-space translation
        + the y-x-z Euler rotation matrix built from
        rotation_camera_space_{y,x,z}; world pose through the (first-
        frame-aligned) camera extrinsic, like the KITTI loader's
        `L_world = X_gt @ L_cam`.
        """
        p = os.path.join(self.textgt_dir, "pose.txt")
        if not os.path.exists(p) or self.gt_poses is None:
            return None
        per_frame: dict = {}
        with open(p) as f:
            cols = self._header_columns(next(f))
            for line in f:
                v = line.split()
                if len(v) != len(cols) or int(v[cols["cameraID"]]) != 0:
                    continue
                k = int(v[cols["frame"]])
                if k >= len(self.gt_poses):
                    continue
                tid = int(v[cols["trackID"]])
                t = np.array(
                    [
                        float(v[cols["camera_space_X"]]),
                        float(v[cols["camera_space_Y"]]),
                        float(v[cols["camera_space_Z"]]),
                    ]
                )
                y = float(v[cols["rotation_camera_space_y"]])
                x = float(v[cols["rotation_camera_space_x"]])
                z = float(v[cols["rotation_camera_space_z"]])
                cy, sy = np.cos(y), np.sin(y)
                cx, sx = np.cos(x), np.sin(x)
                cz, sz = np.cos(z), np.sin(z)
                R = np.array(
                    [
                        [cy * cz + sy * sx * sz, -cy * sz + sy * sx * cz, sy * cx],
                        [cx * sz, cx * cz, -sx],
                        [-sy * cz + cy * sx * sz, sy * sz + cy * sx * cz, cy * cx],
                    ]
                )
                L_cam = np.eye(4)
                L_cam[:3, :3] = R
                L_cam[:3, 3] = t
                per_frame.setdefault(k, {})[tid] = self.gt_poses[k] @ L_cam
        return per_frame

    def __len__(self):
        return self._n

    def camera_params(self) -> CameraParams:
        if self._cam is None:
            p = os.path.join(self.textgt_dir, "intrinsic.txt")
            fx, fy, cx, cy = 725.0087, 725.0087, 620.5, 187.0  # vkitti2 default
            if os.path.exists(p):
                with open(p) as f:
                    next(f)
                    for line in f:
                        vals = line.split()
                        if len(vals) >= 6 and vals[1] == "0":
                            fx, fy, cx, cy = map(float, vals[2:6])
                            break
            import cv2

            img = cv2.imread(os.path.join(self.rgb_dir, "rgb_00000.jpg"))
            h, w = img.shape[:2]
            self._cam = CameraParams.create(fx, fy, cx, cy, w, h)
        return self._cam

    def frame(self, idx: int) -> FrameImages:
        import cv2

        name = f"{idx:05d}"
        rgb = cv2.imread(os.path.join(self.rgb_dir, f"rgb_{name}.jpg"))
        gray = to_gray(rgb)  # cv2 BGR; to_gray uses BGR weights

        depth16 = cv2.imread(
            os.path.join(self.depth_dir, f"depth_{name}.png"),
            cv2.IMREAD_UNCHANGED,
        )
        depth = depth16.astype(np.float32) / 100.0  # cm -> m

        flow_path = os.path.join(self.flow_dir, f"flow_{name}.png")
        if os.path.exists(flow_path):
            bgr16 = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
            flow = decode_vkitti_flow(bgr16)
        else:
            flow = np.zeros((*gray.shape, 2), np.float32)

        inst_path = os.path.join(self.inst_dir, f"instancegt_{name}.png")
        if os.path.exists(inst_path):
            mask = cv2.imread(inst_path, cv2.IMREAD_UNCHANGED)
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = mask.astype(np.int32)
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
            timestamp=idx * 0.1,
            X_world=self.gt_poses[idx],
            object_poses=obj_poses,
            object_motions=obj_motions,
        )
