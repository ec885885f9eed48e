"""Pipeline manager: dataset -> frontend -> backend -> logs (port of
`dynosam_tpu/pipeline.py`).

A host loop dispatching one frontend step per frame and, with
`use_backend=True` (the default config), one `RGBDBackend.spin` per frame
(a window solve when the sliding-window trigger fires) and
`RGBDBackend.finish` at the end.  `run_and_log` writes the reference's CSV
logs of the frontend and the backend and the statistics CSVs;
`run_from_packets` replays saved packets through the backend alone.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from .backend.backend import RGBDBackend
from .core.camera import CameraParams, camera_params_from_yaml
from .convert import frontend_output_to_numpy as to_numpy
from .core.types import FrontendOutput
from .frontend.frontend import (
    FrameImages,
    FrontendState,
    check_frontend_config,
    frontend_step,
    to_device,
)
from .utils import stats as stats_mod
from .utils.config import DynoConfig
from .utils.device import resolve_device


@dataclasses.dataclass
class PipelineResult:
    packets: list                      # FrontendOutput per frame
    backend: Optional[RGBDBackend]
    frontend_state: FrontendState
    fps: float


class DynoPipeline:
    """Sequential pipeline on one device (CUDA unless `device="cpu"`).
    `seed` seeds the generator that draws every RANSAC hypothesis."""

    def __init__(self, cam: CameraParams, cfg: DynoConfig, use_klt: bool = True,
                 device=None, seed: int = 0):
        check_frontend_config(cfg.frontend)
        self.device = resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.use_klt = use_klt
        cap = cfg.capacity
        self.backend = (RGBDBackend(cfg.backend, cap, device=self.device)
                        if cfg.pipeline.use_backend else None)
        self.frontend_state = FrontendState.create(
            cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects,
            device=self.device,
        )
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.packets: list = []
        self._prev_images: Optional[FrameImages] = None
        self._k = 0
        self._byte_tracker = None
        if cfg.frontend.tracker.use_byte_tracker:
            from .frontend.byte_tracker import ByteTracker

            self._byte_tracker = ByteTracker()

    def spin_once(self, images: FrameImages) -> FrontendOutput:
        if self._byte_tracker is not None:
            # temporally consistent instance ids (reference --use_byte_tracker),
            # relabelled on the host before the frame goes to the device; a
            # loader's mask is on the host, rectified or not
            # (frontend/rectify.py), and a mask already on a card is read
            # back for it
            from .frontend.byte_tracker import relabel_mask

            relabelled = relabel_mask(self._byte_tracker, images.mask.cpu().numpy(),
                                      score_pixel_norm=self.cfg.frontend.tracker.byte_score_pixel_norm)
            images = images._replace(mask=torch.as_tensor(relabelled))
        images = to_device(images, self.device)
        first = self._k == 0
        prev = self._prev_images if self._prev_images is not None else images
        with stats_mod.timer("frontend.spin"):
            self.frontend_state, packet, _, _ = frontend_step(
                self.frontend_state, prev, images, self.cam, self.cfg.frontend,
                generator=self.generator, use_klt=self.use_klt,
                first_frame=first, device=self.device,
            )
        self.packets.append(packet)
        if self.backend is not None:
            with stats_mod.timer("backend.spin"):
                self.backend.spin(packet)
        self._prev_images = images
        self._k += 1
        return packet

    def finish(self):
        """End of sequence: the backend's final window or full-batch solve."""
        if self.backend is not None:
            with stats_mod.timer("backend.finish"):
                self.backend.finish()

    def run(self, frames: Iterable[FrameImages]) -> PipelineResult:
        t0 = time.perf_counter()
        n = 0
        for images in frames:
            self.spin_once(images)
            n += 1
        self.finish()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        return PipelineResult(
            packets=self.packets, backend=self.backend, frontend_state=self.frontend_state,
            fps=n / max(dt, 1e-9),
        )


def backend_log_prefix(updater: int) -> str:
    """The backend module's log prefix: the reference's WorldMotion
    (updater 0) and LLWorld (updater 1) estimator names."""
    return "rgbd_motion_world_backend" if updater == 0 else "rgbd_LL_world_backend"


def _mat(R, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def run_and_log(dataset, cfg: DynoConfig, output_path: str, use_klt: bool = True,
                module_prefix: str = "frontend", device=None, seed: int = 0) -> PipelineResult:
    """Run the full pipeline over a dataset and write the reference-format
    CSV logs (frontend and backend modules) and the statistics CSVs."""
    from .utils.logger import EstimationLogger

    device = resolve_device(device)
    # `prefer_data_provider_camera_params`: the dataset's own calibration
    # wins unless a camera_params_yaml overrides it
    if not cfg.pipeline.prefer_data_provider_camera_params and cfg.pipeline.camera_params_yaml:
        cam = camera_params_from_yaml(cfg.pipeline.camera_params_yaml)
    else:
        cam = dataset.camera_params()
    pipe = DynoPipeline(cam, cfg, use_klt=use_klt, device=device, seed=seed)
    result = pipe.run(dataset.prefetched_frames())

    os.makedirs(output_path, exist_ok=True)
    fe_log = EstimationLogger(output_path, module_prefix)
    base = dataset.start
    for k, pkt in enumerate(result.packets):
        p = to_numpy(pkt)
        gt = dataset.ground_truth(base + k)
        fe_log.log_camera_pose(base + k, _mat(p.X_world.R, p.X_world.t), None if gt is None else gt.X_world)
        fe_log.log_timestamp(base + k, float(p.timestamp))
        for j in np.nonzero(p.objects.motion_valid)[0]:
            label = int(p.objects.label[j])
            gt_H = gt.object_motions.get(label) if gt is not None else None
            fe_log.log_object_motion(base + k, label, _mat(p.objects.motion.R[j], p.objects.motion.t[j]), gt_H)
            gt_L = gt.object_poses.get(label) if gt is not None else None
            fe_log.log_object_pose(base + k, label, _mat(p.objects.pose.R[j], p.objects.pose.t[j]), gt_L)
    fe_log.flush()

    if result.backend is not None:
        be_log = EstimationLogger(output_path, backend_log_prefix(cfg.backend.backend_updater_enum))
        X, xvalid = map(to_numpy, result.backend.camera_poses())
        H, hvalid = map(to_numpy, result.backend.object_motions())
        labels_map = to_numpy(result.backend.map.obj_label)
        for k in range(len(result.packets)):
            if not xvalid[k]:
                continue
            gt = dataset.ground_truth(base + k)
            be_log.log_camera_pose(base + k, _mat(X.R[k], X.t[k]), None if gt is None else gt.X_world)
            be_log.log_timestamp(base + k, k * 0.1)
            for j in np.nonzero(hvalid[k])[0]:
                label = int(labels_map[k, j])
                if label < 0:
                    continue
                gt_H = gt.object_motions.get(label) if gt is not None else None
                be_log.log_object_motion(base + k, label, _mat(H.R[k, j], H.t[k, j]), gt_H)
        be_log.flush()

    stats_mod.write_summary_csv(os.path.join(output_path, "statistics_summary.csv"))
    stats_mod.write_samples_csv(os.path.join(output_path, "statistics_samples.csv"))
    return result


def run_from_packets(packets, cfg: DynoConfig, output_path: Optional[str] = None,
                     device=None) -> RGBDBackend:
    """Offline replay: feed saved frontend packets straight to the backend,
    bypassing vision (`--frontend_from_file`)."""
    backend = RGBDBackend(cfg.backend, cfg.capacity, device=device)
    for pkt in packets:
        backend.spin(pkt)
    backend.finish()
    if output_path is not None:
        os.makedirs(output_path, exist_ok=True)
        stats_mod.write_summary_csv(os.path.join(output_path, "statistics_summary.csv"))
    return backend
