"""CSV state loggers in the reference's exact formats (a copy of
`dynosam_tpu/utils/logger.py`; numpy).

Analog of `EstimationModuleLogger`/`BackendLogger`
(`logger/Logger.hpp:235-297`, formats documented `README.md:301-323`):

  <prefix>_camera_pose_log.csv: frame_id,tx,ty,tz,qx,qy,qz,qw,gt_tx,...,gt_qw
  <prefix>_object_motion_log.csv: frame_id,object_id,tx,...,qw,gt_tx,...,gt_qw
  <prefix>_object_pose_log.csv:   frame_id,object_id,tx,...,qw,gt_tx,...,gt_qw
  <prefix>_map_points_log.csv:    frame_id,tracklet_id,x,y,z
  <prefix>_frame_id_timestamp_log.csv: frame_id,timestamp

These logs feed the evaluation suite the same way the reference's feed
evo (`evaluation_lib.py:1047`).
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np


def _rot_to_quat(R: np.ndarray):
    """Rotation matrix -> (qx, qy, qz, qw)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # x, y, z, w
    return q


def _pose_row(T: np.ndarray):
    t = T[:3, 3]
    q = _rot_to_quat(T[:3, :3])
    return [*t, *q]


class EstimationLogger:
    """Per-module CSV logger; writes on `flush()`."""

    def __init__(self, output_path: str, prefix: str):
        os.makedirs(output_path, exist_ok=True)
        self.dir = output_path
        self.prefix = prefix
        self.camera_rows = []
        self.motion_rows = []
        self.obj_pose_rows = []
        self.point_rows = []
        self.ts_rows = []
        self.bbox_rows = []

    def log_camera_pose(self, frame_id: int, T: np.ndarray,
                        T_gt: Optional[np.ndarray] = None):
        row = [frame_id] + _pose_row(T)
        if T_gt is not None:
            row += _pose_row(T_gt)
        self.camera_rows.append(row)

    def log_object_motion(self, frame_id: int, object_id: int, H: np.ndarray,
                          H_gt: Optional[np.ndarray] = None):
        row = [frame_id, object_id] + _pose_row(H)
        if H_gt is not None:
            row += _pose_row(H_gt)
        self.motion_rows.append(row)

    def log_object_pose(self, frame_id: int, object_id: int, L: np.ndarray,
                        L_gt: Optional[np.ndarray] = None):
        row = [frame_id, object_id] + _pose_row(L)
        if L_gt is not None:
            row += _pose_row(L_gt)
        self.obj_pose_rows.append(row)

    def log_map_point(self, frame_id: int, tracklet_id: int, xyz: np.ndarray):
        self.point_rows.append([frame_id, tracklet_id, *xyz])

    def log_timestamp(self, frame_id: int, timestamp: float):
        self.ts_rows.append([frame_id, timestamp])

    def log_bbox(self, frame_id: int, object_id: int, box):
        """[x1, y1, x2, y2] image bounding box per object (reference bbox
        log)."""
        self.bbox_rows.append([frame_id, object_id, *box])

    def _write(self, name, header, rows):
        with open(os.path.join(self.dir, f"{self.prefix}_{name}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(rows)

    def flush(self):
        pose_hdr = ["tx", "ty", "tz", "qx", "qy", "qz", "qw"]
        gt_hdr = ["gt_" + h for h in pose_hdr]
        self._write(
            "camera_pose_log", ["frame_id", *pose_hdr, *gt_hdr][: len(
                self.camera_rows[0]) if self.camera_rows else 8],
            self.camera_rows,
        )
        self._write(
            "object_motion_log",
            ["frame_id", "object_id", *pose_hdr, *gt_hdr][: len(
                self.motion_rows[0]) if self.motion_rows else 9],
            self.motion_rows,
        )
        self._write(
            "object_pose_log",
            ["frame_id", "object_id", *pose_hdr, *gt_hdr][: len(
                self.obj_pose_rows[0]) if self.obj_pose_rows else 9],
            self.obj_pose_rows,
        )
        self._write("map_points_log", ["frame_id", "tracklet_id", "x", "y", "z"],
                    self.point_rows)
        self._write("frame_id_timestamp_log", ["frame_id", "timestamp"],
                    self.ts_rows)
        self._write("bbox_log",
                    ["frame_id", "object_id", "x1", "y1", "x2", "y2"],
                    self.bbox_rows)


def read_pose_log(path: str):
    """Read a *_camera_pose_log.csv into (frame_ids, (N,4,4) est, gt|None)."""
    from scipy.spatial.transform import Rotation

    rows = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    frames = rows[:, 0].astype(int)

    def to_T(block):
        T = np.tile(np.eye(4), (block.shape[0], 1, 1))
        T[:, :3, 3] = block[:, :3]
        T[:, :3, :3] = Rotation.from_quat(block[:, 3:7]).as_matrix()
        return T

    est = to_T(rows[:, 1:8])
    gt = to_T(rows[:, 8:15]) if rows.shape[1] >= 15 else None
    return frames, est, gt
