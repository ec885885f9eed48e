"""Project Aria dataset loader, the reference's `ProjectAriaDataProvider`
(port of `dynosam_tpu/data/aria.py`).

Implements `ProjectAriaAllLoader`
(`src/dataprovider/ProjectAriaDataProvider.cc:30-145`):

    <root>/rgb_sync/*.png          synchronized RGB frames
    <root>/depth_sync/*.png        depth PNGs (see depth_scale below)
    <root>/optical_flow/*.flo      dense flow; the flow folder DEFINES the
                                   dataset size, and each flow file's stem
                                   is its nanosecond timestamp
                                   (`loadFlowImagesAndSize`, :89-101)
    <root>/instance_masks/*.png
    <root>/calibration_undistort.json   {fx, fy, cx, cy} (optional; the
                                   reference hardcodes the undistorted rig
                                   fu=267.644012, fv=311.656128,
                                   cu=267.644012, cv=174.2612 @ 640x360,
                                   `loadCalibration` :112-127)

Depth units: the reference's `loadDepth` passes raw PNG values through
unscaled (`DataProviderUtils.cc:62-66`); preprocessed Aria depth is usually
millimetre-valued, so `depth_scale` defaults to 1000 (mm -> m) and can be
set to 1.0 for the reference's raw behaviour.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraParams
from ..frontend.frontend import FrameImages
from .base import DatasetProvider, to_gray
from .kitti import _read_flo

# reference hardcoded undistorted rig (ProjectAriaDataProvider.cc:113-118)
ARIA_FU = 267.644012
ARIA_FV = 311.656128
ARIA_CU = 267.644012
ARIA_CV = 174.2612
ARIA_W, ARIA_H = 640, 360


class ProjectAriaDataset(DatasetProvider):
    def __init__(self, path: str, starting_frame: int = -1, ending_frame: int = -1,
                 depth_scale: float = 1000.0, device=None):
        super().__init__(path, starting_frame, ending_frame, device=device)
        self.rgb_dir = os.path.join(path, "rgb_sync")
        self.depth_dir = os.path.join(path, "depth_sync")
        self.flow_dir = os.path.join(path, "optical_flow")
        self.mask_dir = os.path.join(path, "instance_masks")
        self.depth_scale = depth_scale
        self.rgb_files = sorted(os.listdir(self.rgb_dir))
        self.depth_files = sorted(os.listdir(self.depth_dir))
        self.flow_files = (
            sorted(os.listdir(self.flow_dir)) if os.path.isdir(self.flow_dir) else []
        )
        self.mask_files = (
            sorted(os.listdir(self.mask_dir)) if os.path.isdir(self.mask_dir) else []
        )
        # the flow folder defines the dataset size; its file stems are
        # nanosecond timestamps (`loadFlowImagesAndSize`)
        self.timestamps = None
        if self.flow_files:
            try:
                self.timestamps = np.asarray(
                    [float(os.path.splitext(f)[0]) / 1e9 for f in self.flow_files]
                )
            except ValueError:
                self.timestamps = None
        if self.timestamps is None:
            ts = os.path.join(path, "sync_timestamp.csv")
            self.timestamps = (
                np.loadtxt(ts, delimiter=",", skiprows=1, ndmin=2)[:, -1]
                if os.path.exists(ts)
                else np.arange(len(self.rgb_files)) * 0.1
            )
        self._cam: Optional[CameraParams] = None

    def __len__(self):
        # dataset size == number of flow files (reference semantics); fall
        # back to rgb count when no flow folder exists
        return len(self.flow_files) or len(self.rgb_files)

    def timestamp(self, idx: int) -> float:
        return float(self.timestamps[min(idx, len(self.timestamps) - 1)])

    def camera_params(self) -> CameraParams:
        if self._cam is None:
            import cv2

            img = cv2.imread(os.path.join(self.rgb_dir, self.rgb_files[0]))
            h, w = img.shape[:2] if img is not None else (ARIA_H, ARIA_W)
            p = os.path.join(self.path, "calibration_undistort.json")
            if os.path.exists(p):
                with open(p) as f:
                    c = json.load(f)
                self._cam = CameraParams.create(
                    c["fx"], c["fy"], c["cx"], c["cy"], w, h
                )
            else:
                # the reference's hardcoded undistorted rig
                self._cam = CameraParams.create(
                    ARIA_FU, ARIA_FV, ARIA_CU, ARIA_CV, w, h
                )
        return self._cam

    def frame(self, idx: int) -> FrameImages:
        import cv2

        rgb = cv2.imread(os.path.join(self.rgb_dir, self.rgb_files[idx]))
        gray = to_gray(rgb)
        depth_raw = cv2.imread(
            os.path.join(self.depth_dir, self.depth_files[idx]),
            cv2.IMREAD_UNCHANGED,
        ).astype(np.float32)
        depth = depth_raw / self.depth_scale

        if idx < len(self.flow_files):
            flow = _read_flo(os.path.join(self.flow_dir, self.flow_files[idx]))
        else:
            flow = np.zeros((*gray.shape, 2), np.float32)
        if idx < len(self.mask_files):
            mask = cv2.imread(
                os.path.join(self.mask_dir, self.mask_files[idx]),
                cv2.IMREAD_UNCHANGED,
            )
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
