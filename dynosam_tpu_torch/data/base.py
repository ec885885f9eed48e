"""Dataset provider base: host-side image loading -> FrameImages (port of
`dynosam_tpu/data/base.py`).

Per-dataset loaders decode with numpy and return `FrameImages` of CPU
tensors plus optional ground truth; the pipeline moves each frame to its
device.  A background thread prefetches frames so that disk decode
overlaps device work.  A loader whose `distortion` is set has every frame
rectified (`frontend/rectify.py`) on its `device` (the card unless the
caller asks for another); such frames come out on that device, but for
the mask, which is rectified on the host.
`OnlineDataProvider` is the push-based provider.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Iterator, Optional

import numpy as np
import torch

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

    def __init__(self, path: str, starting_frame: int = -1, ending_frame: int = -1, device=None):
        self.path = path
        self.start = max(0, starting_frame)
        self.end = ending_frame
        # the device of the rectifier and of device-side depth (a loader's
        # block matcher); resolved when first needed
        self.device = device
        # optional lens distortion (core.distortion.Distortion): every frame
        # is then rectified before tracking, the reference's
        # UndistorterRectifier stage (UndistortRectifier.hpp:58)
        self.distortion = None
        self._rectifier = None

    def __len__(self) -> int:
        raise NotImplementedError

    def camera_params(self) -> CameraParams:
        raise NotImplementedError

    def frame(self, idx: int) -> FrameImages:
        raise NotImplementedError

    def ground_truth(self, idx: int) -> Optional[GroundTruthFrame]:
        return None

    def frames(self) -> Iterator[FrameImages]:
        n = len(self)
        end = n if self.end < 0 else min(self.end, n)
        rectify = self._get_rectifier()
        for i in range(self.start, end):
            f = self.frame(i)
            yield rectify(f) if rectify is not None else f

    def _get_rectifier(self):
        if self.distortion is None:
            return None
        if self._rectifier is None:
            from ..frontend.rectify import make_rectifier

            self._rectifier = make_rectifier(self.camera_params(), self.distortion, device=self.device)
        return self._rectifier

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


class OnlineDataProvider(DatasetProvider):
    """Push-based provider, the analog of the reference's ROS online
    provider (`OnlineDataProviderRos`, subscribing rgb/depth/mask/flow): the
    application pushes synchronized frames into a queue and the pipeline
    consumes them as a stream."""

    def __init__(self, cam: CameraParams, max_queue: int = 8):
        super().__init__("<online>")
        self._cam = cam
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=max_queue)
        self._closed = False
        self._count = 0

    def push(self, gray: np.ndarray, depth: np.ndarray, flow: Optional[np.ndarray] = None,
             mask: Optional[np.ndarray] = None, timeout: Optional[float] = None):
        if self._closed:
            raise RuntimeError("provider closed")
        h, w = gray.shape
        frame = FrameImages(
            gray=torch.as_tensor(np.asarray(gray, np.float32)),
            depth=torch.as_tensor(np.asarray(depth, np.float32)),
            flow=torch.as_tensor(np.asarray(flow if flow is not None else np.zeros((h, w, 2)), np.float32)),
            mask=torch.as_tensor(np.asarray(mask if mask is not None else np.zeros((h, w)), np.int32)),
        )
        self._queue.put(frame, timeout=timeout)
        self._count += 1

    def close(self):
        self._closed = True
        self._queue.put(None)

    def __len__(self):
        return self._count

    def camera_params(self) -> CameraParams:
        return self._cam

    def frames(self):
        while True:
            item = self._queue.get()
            if item is None:
                break
            yield item
