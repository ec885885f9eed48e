"""The KITTI-width scene and configuration that the smoke run
(`chip_smoke.py`) and the frame tracer (`testing/trace.py`) drive.

The bench's setting of the JAX package (`bench.py:62-95,285-299`): 1280x384
rendered frames, fx 718, 3 objects, background/object depth 14/9 m,
camera/object step 0.10/0.18 m, N(0, 0.5) px flow noise from numpy seed 0;
1000 features per frame, capacities NS 2048, ND 4096, NO 16, frontend only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import CapacityConfig, DynoConfig, FrontendConfig, PipelineConfig, TrackerConfig
from .render import RenderConfig, RenderedScene


def kitti_scene(device, n_frames: int = 12, h: int = 384, w: int = 1280):
    """(scene, frames): the rendered scene and its frames with the flow
    noise added."""
    scene = RenderedScene(
        RenderConfig(n_frames=n_frames, h=h, w=w, fx=718.0, n_objects=3,
                     bg_depth=14.0, obj_depth=9.0, cam_step=0.10, obj_step=0.18),
        device=device,
    )
    fr = np.random.default_rng(0)
    frames = [
        f._replace(flow=f.flow + torch.as_tensor(
            fr.normal(0.0, 0.5, tuple(f.flow.shape)).astype(np.float32), device=f.flow.device))
        for f in scene.frames()
    ]
    return scene, frames


def kitti_config() -> DynoConfig:
    return DynoConfig(
        frontend=FrontendConfig(tracker=TrackerConfig(max_features_per_frame=1000)),
        capacity=CapacityConfig(max_static_tracks=2048, max_dynamic_tracks=4096, max_objects=16),
        pipeline=PipelineConfig(use_backend=False),
    )
