"""Offline pipeline: the frontend on every frame and the sliding-window
backend (port of `dynosam_tpu/throughput.py`, one window per solve).

The JAX package fuses the whole run into one XLA program (a scan over
trigger segments).  Here a host loop keeps the same order: frame 0, the
warm-up frames 1..V-1 (V = window overlap), then per segment `stride =
W - V` frontend steps, each followed by `update_map`, then one direct-Schur
solve of the window [s * stride, s * stride + W) that just completed, with
its estimates written back into the store.  A sequence has V + S * stride
frames for a whole number S of segments.

The frontend's RANSAC hypotheses come from a `torch.Generator` seeded by
`seed` (the JAX package draws them from `online_keys`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .backend.backend import check_backend_config, optimize_window
from .backend.formulation import WindowMasks
from .backend.map import MeasurementMap, update_map
from .backend.solver import LMConfig, LMResult
from .core.camera import CameraParams
from .core.lie import SE3, se3_identity
from .core.types import FrontendOutput
from .frontend.frontend import FrameImages, FrontendState, check_frontend_config, frontend_step, to_device
from .utils.config import BackendConfig, DynoConfig
from .utils.device import resolve_device


class EstStore(NamedTuple):
    """Global estimates over all frames (the JAX package's `EstStore`,
    updater 0: P holds the object motions H)."""

    X: SE3                        # (F,) camera poses
    P: SE3                        # (F, O) object motions
    static_points: torch.Tensor   # (NS, 3)
    static_valid: torch.Tensor    # (NS,)
    dyn_points: torch.Tensor      # (F, ND, 3)
    dyn_valid: torch.Tensor       # (F, ND)
    X_valid: torch.Tensor         # (F,)
    motion_valid: torch.Tensor    # (F, O)

    @staticmethod
    def create(f: int, ns: int, nd: int, no: int, dtype=torch.float32, device=None) -> "EstStore":
        zb = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)  # noqa: E731
        return EstStore(
            X=se3_identity((f,), dtype, device), P=se3_identity((f, no), dtype, device),
            static_points=torch.zeros((ns, 3), dtype=dtype, device=device), static_valid=zb(ns),
            dyn_points=torch.zeros((f, nd, 3), dtype=dtype, device=device), dyn_valid=zb(f, nd),
            X_valid=zb(f), motion_valid=zb(f, no),
        )


def _window_inputs(est: EstStore, start: int, window: int):
    """Anchor and warm-start values/masks for the window at `start`."""
    use_anchor = est.X_valid[start]
    sl = slice(start, start + window)
    prev = {"X": est.X[sl], "H": est.P[sl], "sp": est.static_points, "dp": est.dyn_points[sl]}
    prev_mask = {"X": est.X_valid[sl] & use_anchor, "H": est.motion_valid[sl] & use_anchor,
                 "sp": est.static_valid & use_anchor, "dp": est.dyn_valid[sl] & use_anchor}
    return est.X[start], use_anchor, prev, prev_mask


def _writeback(est: EstStore, values: dict, masks: WindowMasks, start: int) -> EstStore:
    """Write a solved window into the store, in place (the JAX package's
    dynamic-slice updates); returns ``est``."""
    sl = slice(start, start + masks.frame.shape[0])
    est.X.R[sl] = values["X"].R
    est.X.t[sl] = values["X"].t
    est.X_valid[sl] = masks.frame
    est.P.R[sl] = values["H"].R
    est.P.t[sl] = values["H"].t
    est.motion_valid[sl] = masks.motion_active
    est.dyn_points[sl] = values["dp"]
    est.dyn_valid[sl] = masks.dyn_obs
    seen = masks.static_obs.any(0)
    est.static_points.copy_(torch.where(seen[:, None], values["sp"], est.static_points))
    est.static_valid.logical_or_(seen)
    return est


def _solve_window(est: EstStore, m: MeasurementMap, start: int, window: int, cfg: DynoConfig,
                  lm_cfg: LMConfig):
    """Solve the window at `start` warm-started from the store and write it
    back; returns (est, LMResult, WindowMasks in pool coordinates)."""
    anchor, use_anchor, prev, prev_mask = _window_inputs(est, start, window)
    result, masks = optimize_window(m, start, window, cfg.backend, lm_cfg, anchor, use_anchor,
                                    prev, prev_mask)
    return _writeback(est, result.values, masks, start), result, masks


class SegmentPlan(NamedTuple):
    """Trigger arithmetic for a fixed sequence length."""

    window: int
    overlap: int
    stride: int
    n_segments: int
    n_frames: int


def _plan(cfg: DynoConfig, n_frames: int) -> SegmentPlan:
    W, V = cfg.backend.opt_window_size, cfg.backend.opt_window_overlap
    stride = W - V
    if not (n_frames >= W and (n_frames - V) % stride == 0):
        raise ValueError(f"sequence length {n_frames} must equal overlap {V} + n_segments * stride {stride}")
    return SegmentPlan(W, V, stride, (n_frames - V) // stride, n_frames)


def _lm_cfg(bcfg: BackendConfig) -> LMConfig:
    return LMConfig(
        max_iterations=bcfg.lm_max_iterations, initial_lambda=bcfg.lm_initial_lambda,
        lambda_factor=bcfg.lm_lambda_factor, max_lambda=bcfg.lm_max_lambda,
        min_lambda=bcfg.lm_min_lambda, rel_error_tol=bcfg.lm_rel_error_tol,
        abs_error_tol=bcfg.lm_abs_error_tol, cg_max_iterations=bcfg.cg_max_iterations,
        cg_tol=bcfg.cg_tol,
    )


@dataclasses.dataclass
class WindowSolve:
    """One window solve: its first frame, the LM result and masks (pool
    coordinates), and on a card the CUDA events around the solve."""

    start: int
    result: LMResult
    masks: WindowMasks
    events: Optional[tuple] = None

    def solve_ms(self) -> Optional[float]:
        """Device time between the solve's CUDA events (None on the CPU);
        call after the device has been synchronised."""
        return None if self.events is None else self.events[0].elapsed_time(self.events[1])


class OfflineResult(NamedTuple):
    packets: list           # FrontendOutput per frame
    est: EstStore
    windows: list           # WindowSolve per window, in order


class OfflineRunner:
    """The offline pipeline over a fixed number of frames, one host step at
    a time: `step(frame)` runs the frontend on the next frame, writes its
    packet into the measurement map, and solves the window that frame
    completes, if any.  `run(frames)` steps through a whole sequence."""

    def __init__(self, cam: CameraParams, cfg: DynoConfig, n_frames: int, use_klt: bool = True,
                 device=None, seed: int = 0):
        check_frontend_config(cfg.frontend)
        check_backend_config(cfg.backend)
        self.plan = _plan(cfg, n_frames)
        self.device = resolve_device(device)
        self.cam, self.cfg, self.use_klt = cam, cfg, use_klt
        self.lm_cfg = _lm_cfg(cfg.backend)
        cap = cfg.capacity
        f = max(n_frames, cap.max_frames)
        ns, nd, no = cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects
        self.fe_state = FrontendState.create(ns, nd, no, device=self.device)
        self.map = MeasurementMap.create(f, ns, nd, no, device=self.device)
        self.est = EstStore.create(f, ns, nd, no, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.packets: list = []
        self.windows: list = []
        self._prev: Optional[FrameImages] = None

    def frontend(self, frame: FrameImages) -> FrontendOutput:
        """The frontend step of the next frame, its packet written into the map."""
        k = len(self.packets)
        if k >= self.plan.n_frames:
            raise ValueError(f"the runner was planned for {self.plan.n_frames} frames")
        frame = to_device(frame, self.device)
        prev = frame if self._prev is None else self._prev
        self.fe_state, packet, _, _ = frontend_step(
            self.fe_state, prev, frame, self.cam, self.cfg.frontend, generator=self.generator,
            use_klt=self.use_klt, first_frame=k == 0, device=self.device,
        )
        self._prev = frame
        return self.add_packet(packet)

    def add_packet(self, packet: FrontendOutput) -> FrontendOutput:
        """Write the next frame's packet into the map (`frontend` calls it;
        a caller with packets of its own may feed them here instead)."""
        update_map(self.map, packet, len(self.packets))
        self.packets.append(packet)
        return packet

    def window_due(self) -> Optional[int]:
        """The first frame of the window that the frames so far complete,
        or None (windows [s * stride, s * stride + W) complete at frame
        s * stride + W - 1)."""
        k = len(self.packets) - 1
        W, stride = self.plan.window, self.plan.stride
        if k >= W - 1 and (k - (W - 1)) % stride == 0:
            return k - (W - 1)
        return None

    def solve(self, start: int) -> WindowSolve:
        """Solve the window at `start` and write it into the estimate store."""
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.est, result, masks = _solve_window(self.est, self.map, start, self.plan.window, self.cfg,
                                                self.lm_cfg)
        if events is not None:
            events[1].record()
        win = WindowSolve(start, result, masks, events)
        self.windows.append(win)
        return win

    def step(self, frame: FrameImages) -> Optional[WindowSolve]:
        self.frontend(frame)
        start = self.window_due()
        return None if start is None else self.solve(start)

    def result(self) -> OfflineResult:
        return OfflineResult(self.packets, self.est, self.windows)

    def run(self, frames) -> OfflineResult:
        for frame in frames:
            self.step(frame)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.result()


def make_offline_runner(cam: CameraParams, cfg: DynoConfig, n_frames: int, use_klt: bool = True,
                        device=None, seed: int = 0) -> OfflineRunner:
    """The offline runner for a fixed sequence length, on `device` (the card
    unless the caller asks for another).  Raises before any work for an
    option outside the ported path or a length the plan cannot split."""
    return OfflineRunner(cam, cfg, n_frames, use_klt=use_klt, device=device, seed=seed)


def run_offline(frames, cam: CameraParams, cfg: DynoConfig, use_klt: bool = True, seed: int = 0,
                device=None) -> OfflineResult:
    """Offline entry: a list of FrameImages -> (packets, EstStore, window
    solves); the JAX package's last LM result is `windows[-1].result`."""
    frames = list(frames)
    return make_offline_runner(cam, cfg, len(frames), use_klt=use_klt, device=device, seed=seed).run(frames)
