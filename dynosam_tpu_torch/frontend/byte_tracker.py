"""ByteTrack-style instance-mask association across frames (the port's own
copy of `dynosam_tpu/frontend/byte_tracker.py`).

Re-implementation of the vendored ByteTracker the reference can enable with
`--use_byte_tracker` (`common/byte_tracker/ByteTracker.hpp:47-78`,
`src/common/Types.cc:38`): per-frame object detections (bounding boxes from
instance masks) are associated to persistent tracks with a constant-velocity
Kalman filter + two-stage IoU matching (high-score first, then low-score),
Hungarian assignment.  Output: a relabelled instance mask whose ids are
temporally consistent — exactly what the downstream tracker expects when
dataset instance ids are not temporally stable.

Host-side numpy: object counts are tiny (<100) and the reference runs this
on the CPU too.  The pipeline relabels a frame's mask on the host before the
frame goes to its device, so no device-to-host read is added per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


def hungarian(cost: np.ndarray) -> List[Tuple[int, int]]:
    """Minimum-cost assignment (the reference vendors LAPJV + a generic
    `HungarianAlgorithm`, `common/Algorithms.hpp:42`); scipy's
    linear_sum_assignment is the same Jonker-Volgenant family."""
    from scipy.optimize import linear_sum_assignment

    if cost.size == 0:
        return []
    r, c = linear_sum_assignment(cost)
    return list(zip(r.tolist(), c.tolist()))


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) [x1,y1,x2,y2] -> (N,M) IoU."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


class _KalmanBox:
    """Constant-velocity KF on (cx, cy, area, aspect) like ByteTrack's."""

    def __init__(self, box):
        cx, cy, s, r = self._to_z(box)
        self.x = np.array([cx, cy, s, r, 0.0, 0.0, 0.0], np.float64)
        self.P = np.diag([10, 10, 10, 10, 1e4, 1e4, 1e4]).astype(np.float64)

    @staticmethod
    def _to_z(box):
        x1, y1, x2, y2 = box
        w, h = x2 - x1, y2 - y1
        return (x1 + x2) / 2, (y1 + y2) / 2, w * h, w / max(h, 1e-9)

    def predict(self):
        F = np.eye(7)
        F[0, 4] = F[1, 5] = F[2, 6] = 1.0
        self.x = F @ self.x
        Q = np.diag([1, 1, 1, 0.01, 0.01, 0.01, 1e-4])
        self.P = F @ self.P @ F.T + Q

    def update(self, box):
        z = np.asarray(self._to_z(box))
        H = np.zeros((4, 7))
        H[0, 0] = H[1, 1] = H[2, 2] = H[3, 3] = 1.0
        R = np.diag([1, 1, 10, 0.01])
        y = z - H @ self.x
        S = H @ self.P @ H.T + R
        K = self.P @ H.T @ np.linalg.inv(S)
        self.x = self.x + K @ y
        self.P = (np.eye(7) - K @ H) @ self.P

    def box(self):
        cx, cy, s, r = self.x[:4]
        w = np.sqrt(max(s * r, 1e-9))
        h = max(s, 1e-9) / w
        return np.array([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2])


@dataclasses.dataclass
class Track:
    track_id: int
    kf: _KalmanBox
    score: float
    missed: int = 0


class ByteTracker:
    """Two-stage IoU association (`ByteTracker::update/iou_association/
    low_score_association`)."""

    def __init__(
        self,
        high_thresh: float = 0.5,
        iou_thresh: float = 0.3,
        max_missed: int = 10,
    ):
        self.high_thresh = high_thresh
        self.iou_thresh = iou_thresh
        self.max_missed = max_missed
        self.tracks: List[Track] = []
        self._next_id = 1

    def update(self, boxes: np.ndarray, scores: np.ndarray) -> List[int]:
        """boxes (N,4), scores (N,) -> track id per detection (-1 = dropped)."""
        for t in self.tracks:
            t.kf.predict()
        n = boxes.shape[0]
        assigned = np.full(n, -1, int)
        hi = np.nonzero(scores >= self.high_thresh)[0]
        lo = np.nonzero(scores < self.high_thresh)[0]

        track_boxes = np.asarray([t.kf.box() for t in self.tracks]).reshape(-1, 4)
        free_tracks = list(range(len(self.tracks)))

        def match(det_idx):
            nonlocal free_tracks
            if len(det_idx) == 0 or len(free_tracks) == 0:
                return []
            m = iou(track_boxes[free_tracks], boxes[det_idx])
            pairs = hungarian(1.0 - m)
            out = []
            used_t = []
            for ti, di in pairs:
                if m[ti, di] >= self.iou_thresh:
                    out.append((free_tracks[ti], det_idx[di]))
                    used_t.append(free_tracks[ti])
            free_tracks = [t for t in free_tracks if t not in used_t]
            return out

        # stage 1: high-score detections
        for ti, di in match(hi):
            self.tracks[ti].kf.update(boxes[di])
            self.tracks[ti].missed = 0
            self.tracks[ti].score = scores[di]
            assigned[di] = self.tracks[ti].track_id
        # stage 2: low-score detections against remaining tracks
        for ti, di in match(lo):
            self.tracks[ti].kf.update(boxes[di])
            self.tracks[ti].missed = 0
            assigned[di] = self.tracks[ti].track_id
        # new tracks from unmatched high-score detections
        for di in hi:
            if assigned[di] < 0:
                t = Track(self._next_id, _KalmanBox(boxes[di]), scores[di])
                self._next_id += 1
                self.tracks.append(t)
                assigned[di] = t.track_id
        # age out
        matched_ids = set(assigned[assigned >= 0].tolist())
        for t in self.tracks:
            if t.track_id not in matched_ids:
                t.missed += 1
        self.tracks = [t for t in self.tracks if t.missed <= self.max_missed]
        return assigned.tolist()


def mask_boxes(mask: np.ndarray):
    """Instance mask -> (labels, (N,4) boxes, (N,) pixel counts)."""
    labels = np.unique(mask)
    labels = labels[labels > 0]
    boxes, counts = [], []
    for l in labels:
        ys, xs = np.nonzero(mask == l)
        boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        counts.append(len(xs))
    return labels, np.asarray(boxes, np.float64).reshape(-1, 4), np.asarray(counts)


def relabel_mask(
    tracker: ByteTracker, mask: np.ndarray, score_pixel_norm: float = 200.0
) -> np.ndarray:
    """Associate this frame's instances and return a temporally-consistent
    relabelled mask.  `score_pixel_norm` is the mask area at which the
    detection score saturates (TrackerConfig.byte_score_pixel_norm)."""
    labels, boxes, counts = mask_boxes(mask)
    if len(labels) == 0:
        return mask.copy()
    scores = np.minimum(counts / score_pixel_norm, 1.0)
    ids = tracker.update(boxes, scores)
    out = np.zeros_like(mask)
    for l, tid in zip(labels, ids):
        if tid > 0:
            out[mask == l] = tid
    return out
