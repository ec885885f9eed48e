"""Pipeline manager (port of `dynosam_tpu/pipeline.py`, frontend-only).

A host loop dispatching one frontend step per frame.  The backend
(`use_backend=True`) is ported by the next slice (ROADMAP.md items 8-10)
and raises here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

import torch

from .core.camera import CameraParams
from .core.types import FrontendOutput
from .frontend.frontend import (
    FrameImages,
    FrontendState,
    check_frontend_config,
    frontend_step,
    to_device,
)
from .utils.config import DynoConfig
from .utils.device import resolve_device


@dataclasses.dataclass
class PipelineResult:
    packets: list                 # FrontendOutput per frame
    frontend_state: FrontendState
    fps: float


class DynoPipeline:
    """Sequential frontend-only pipeline on one device (CUDA unless
    `device="cpu"`).  `seed` seeds the generator that draws every RANSAC
    hypothesis."""

    def __init__(self, cam: CameraParams, cfg: DynoConfig, use_klt: bool = True,
                 device=None, seed: int = 0):
        if cfg.pipeline.use_backend:
            raise NotImplementedError(
                "use_backend=True is ported by ROADMAP.md items 8-10 (the "
                "backend window slice); set PipelineConfig(use_backend=False)"
            )
        check_frontend_config(cfg.frontend)
        self.device = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.use_klt = use_klt
        cap = cfg.capacity
        self.frontend_state = FrontendState.create(
            cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects,
            device=self.device,
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.packets: list = []
        self._prev_images: Optional[FrameImages] = None
        self._k = 0

    def spin_once(self, images: FrameImages) -> FrontendOutput:
        images = to_device(images, self.device)
        first = self._k == 0
        prev = self._prev_images if self._prev_images is not None else images
        self.frontend_state, packet, _, _ = frontend_step(
            self.frontend_state, prev, images, self.cam, self.cfg.frontend,
            generator=self.generator, use_klt=self.use_klt,
            first_frame=first, device=self.device,
        )
        self.packets.append(packet)
        self._prev_images = images
        self._k += 1
        return packet

    def run(self, frames: Iterable[FrameImages]) -> PipelineResult:
        t0 = time.perf_counter()
        n = 0
        for images in frames:
            self.spin_once(images)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        return PipelineResult(
            packets=self.packets, frontend_state=self.frontend_state,
            fps=n / max(dt, 1e-9),
        )
