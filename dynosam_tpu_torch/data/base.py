"""Dataset provider base: host-side image loading -> FrameImages (port of
`dynosam_tpu/data/base.py`).

Per-dataset loaders decode with numpy and return `FrameImages` of CPU
tensors plus optional ground truth; the pipeline moves each frame to its
device.  A background thread prefetches frames so that disk decode
overlaps device work.  Rectification of distorted rigs is ROADMAP.md item
14 and the push-based `OnlineDataProvider` item 15.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Iterator, Optional

import numpy as np

from ..core.camera import CameraParams
from ..frontend.frontend import FrameImages


@dataclasses.dataclass
class GroundTruthFrame:
    """Analog of `GroundTruthInputPacket` (`common/GroundTruthPacket.hpp`)."""

    frame_id: int
    timestamp: float
    X_world: np.ndarray                  # (4, 4) camera pose
    object_poses: dict                   # label -> (4, 4) pose ^wL_k
    object_motions: dict                 # label -> (4, 4) motion ^wH_k


class DatasetProvider:
    """Sequential dataset interface."""

    def __init__(self, path: str, starting_frame: int = -1, ending_frame: int = -1):
        self.path = path
        self.start = max(0, starting_frame)
        self.end = ending_frame
        # lens distortion (a loader sets it when its calibration carries
        # coefficients); rectifying such frames is not ported
        self.distortion = None

    def __len__(self) -> int:
        raise NotImplementedError

    def camera_params(self) -> CameraParams:
        raise NotImplementedError

    def frame(self, idx: int) -> FrameImages:
        raise NotImplementedError

    def ground_truth(self, idx: int) -> Optional[GroundTruthFrame]:
        return None

    def frames(self) -> Iterator[FrameImages]:
        if self.distortion is not None:
            raise NotImplementedError(
                "rectifying a distorted rig (frontend/rectify.py) is ported by ROADMAP.md item 14")
        n = len(self)
        end = n if self.end < 0 else min(self.end, n)
        for i in range(self.start, end):
            yield self.frame(i)

    def prefetched_frames(self, depth: int = 2) -> Iterator[FrameImages]:
        """Background-thread prefetch (host decode overlaps device work)."""
        q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        stop = object()
        failure = []

        def worker():
            try:
                for f in self.frames():
                    q.put(f)
            except BaseException as e:      # re-raised in the consumer
                failure.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
        if failure:
            raise failure[0]


def to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 3:
        img = img[..., :3].astype(np.float32)
        return img[..., 0] * 0.114 + img[..., 1] * 0.587 + img[..., 2] * 0.299
    return img.astype(np.float32)
