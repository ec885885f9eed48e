"""The KITTI-width scene and configurations that the smoke run
(`chip_smoke.py`) and the frame tracer (`testing/trace.py`) drive.

The bench's setting of the JAX package (`bench.py:62-95,285-299`): 1280x384
rendered frames, fx 718, 3 objects, background/object depth 14/9 m,
camera/object step 0.10/0.18 m, N(0, 0.5) px flow noise from numpy seed 0;
1000 features per frame, capacities NS 2048, ND 4096, NO 16, frontend only.
`kitti_orb_config` is the same with the ORB detector, the JAX sweep's
"frontend ORB detector" setting (`scripts/tpu_sweep.py:64-72,97-99`):
8 levels at scale 1.2, FAST thresholds 20/7, 2000 keypoints before the
1000-feature cut.  `kitti_pipeline_config` is the bench's pipeline setting
(`bench.py:285-328`): the same frontend with the sliding-window backend
(window 10, overlap 4, 7 LM iterations).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.config import (
    BackendConfig,
    CapacityConfig,
    DynoConfig,
    FrontendConfig,
    PipelineConfig,
    TrackerConfig,
)
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


def kitti_orb_config() -> DynoConfig:
    cfg = kitti_config()
    tracker = dataclasses.replace(cfg.frontend.tracker, feature_detector_type="orb")
    return dataclasses.replace(cfg, frontend=dataclasses.replace(cfg.frontend, tracker=tracker))


def kitti_pipeline_config(n_frames: int) -> DynoConfig:
    """Frontend every frame and a window-10 direct-Schur solve every 6
    frames (compaction caps 1024/1024/8, Huber 1e-4: the backend
    defaults), for a run of `n_frames` frames."""
    return DynoConfig(
        frontend=FrontendConfig(tracker=TrackerConfig(max_features_per_frame=1000)),
        backend=BackendConfig(use_full_batch_opt=False, lm_max_iterations=7),
        capacity=CapacityConfig(max_static_tracks=2048, max_dynamic_tracks=4096, max_objects=16,
                                max_frames=n_frames),
        pipeline=PipelineConfig(use_backend=True),
    )
