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
(window 10, overlap 4, 7 LM iterations).  `kitti_online_config` is the
default backend behind the same frontend, as a CLI user runs it.

`RenderedDataset` serves a rendered scene as a `DatasetProvider` with its
ground truth (the port's counterpart of `tests/test_pipeline.py:21-55`),
and `golden_dataset`/`golden_config` are the golden run of
`tests/test_accuracy_regression.py:45-91`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.base import DatasetProvider, GroundTruthFrame
from ..utils.config import (
    BackendConfig,
    CapacityConfig,
    DynoConfig,
    FrontendConfig,
    PipelineConfig,
    TrackerConfig,
)
from .render import RenderConfig, RenderedScene, pose_matrix


def kitti_scene(device, n_frames: int = 12, h: int = 384, w: int = 1280, seed: int = 0):
    """(scene, frames): the rendered scene and its frames with the flow
    noise added; `seed` seeds the render and the noise (0: the bench's
    scene)."""
    scene = RenderedScene(
        RenderConfig(n_frames=n_frames, h=h, w=w, fx=718.0, n_objects=3,
                     bg_depth=14.0, obj_depth=9.0, cam_step=0.10, obj_step=0.18, seed=seed),
        device=device,
    )
    fr = np.random.default_rng(seed)
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


def kitti_online_config() -> DynoConfig:
    """`kitti_config` with the default backend (`BackendConfig()`: window
    10, overlap 4, 30 LM iterations, compaction caps 1024/1024/8) and the
    default `max_frames` 512: the map a CLI user's run allocates."""
    return dataclasses.replace(kitti_config(), backend=BackendConfig(), pipeline=PipelineConfig(use_backend=True))


class RenderedDataset(DatasetProvider):
    """A `RenderedScene` (or its frames with noise added) as a dataset with
    the scene's ground truth."""

    def __init__(self, scene: RenderedScene, frames=None):
        super().__init__("<rendered>")
        self.scene = scene
        self._frames = list(scene.frames() if frames is None else frames)

    def __len__(self):
        return len(self._frames)

    def camera_params(self):
        return self.scene.cam

    def frame(self, idx):
        return self._frames[idx]

    def ground_truth(self, idx):
        sc = self.scene
        poses = {lab: pose_matrix(sc.object_pose_at(idx, o)) for o, lab in enumerate(sc.object_labels)}
        motions = {lab: pose_matrix(sc.H_gt_list[o]) for o, lab in enumerate(sc.object_labels)}
        return GroundTruthFrame(frame_id=idx, timestamp=idx * 0.1, X_world=pose_matrix(sc.X_gt[idx]),
                                object_poses=poses, object_motions=motions)


GOLDEN_FRAMES = 32


def golden_dataset(device) -> RenderedDataset:
    """The golden scene (32 frames 160x120, 2 moving objects, seed 0) with
    the golden noise: per frame, depth x (1 + N(0, 0.01)) then flow +
    N(0, 0.5) px, drawn from numpy seed 1 in that order."""
    scene = RenderedScene(RenderConfig(n_frames=GOLDEN_FRAMES, n_objects=2, seed=0), device=device)
    fr = np.random.default_rng(1)
    frames = []
    for f in scene.frames():
        depth_n = torch.as_tensor(fr.normal(0, 0.01, tuple(f.depth.shape)).astype(np.float32), device=device)
        flow_n = torch.as_tensor(fr.normal(0, 0.5, tuple(f.flow.shape)).astype(np.float32), device=device)
        frames.append(f._replace(depth=f.depth * (1.0 + depth_n), flow=f.flow + flow_n))
    return RenderedDataset(scene, frames)


def golden_config(full_batch: bool = True) -> DynoConfig:
    """`tests/test_accuracy_regression.py:_make_cfg(full_batch, 0)`."""
    return DynoConfig(
        frontend=FrontendConfig(
            tracker=TrackerConfig(max_features_per_frame=300, klt_window=13, klt_levels=2),
            min_dynamic_features_per_object=20),
        backend=BackendConfig(use_full_batch_opt=full_batch, backend_updater_enum=0, lm_max_iterations=15),
        capacity=CapacityConfig(max_static_tracks=400, max_dynamic_tracks=1024, max_objects=8,
                                max_frames=GOLDEN_FRAMES),
        pipeline=PipelineConfig(use_backend=True),
    )
