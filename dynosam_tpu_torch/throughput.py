"""Offline pipeline: the frontend on every frame and the sliding-window
backend (port of `dynosam_tpu/throughput.py`).

The JAX package fuses the whole run into one XLA program (a scan over
trigger segments).  Here a host loop keeps the same order: frame 0, the
warm-up frames 1..V-1 (V = window overlap), then per segment `stride =
W - V` frontend steps, each followed by `update_map`, then one solve (direct
Schur, or LM-PCG above `schur_max_window` frames) of the window
[s * stride, s * stride + W) that just completed, with
its estimates written back into the store.  A sequence has V + S * stride
frames for a whole number S of segments.  With `opt_windows_per_dispatch`
wpd > 1 the windows solve in groups of wpd once the group's last window
completes, all from the store as it stood before the group
(`backend.solve_windows`); a wpd that does not divide S falls back to 1.
The fixed-lag prior is not applied here, as in the JAX package's runner.

The frontend's RANSAC hypotheses come from a `torch.Generator` seeded by
`seed` (the JAX package draws them from `online_keys`).

`run_streaming` runs it on frames that stream in from the host (decoded as
they arrive); `make_streaming_runner` cuts it into the JAX package's
warm-up and per-segment calls.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .backend.backend import EstimateStore, lm_config, solve_windows
from .backend.formulation import WindowMasks
from .backend.map import MeasurementMap, update_map
from .backend.solver import LMResult
from .core.camera import CameraParams
from .core.types import FrontendOutput
from .frontend.frontend import FrameImages, FrontendState, check_frontend_config, frontend_step, to_device
from .utils.config import DynoConfig
from .utils.device import resolve_device


class SegmentPlan(NamedTuple):
    """Trigger arithmetic for a fixed sequence length."""

    window: int
    overlap: int
    stride: int
    n_segments: int
    n_frames: int


def _plan(cfg: DynoConfig, n_frames: int) -> SegmentPlan:
    if cfg.backend.use_full_batch_opt:
        raise ValueError("fused segments implement the sliding-window mode; use "
                         "pipeline.run_from_packets for full-batch")
    W, V = cfg.backend.opt_window_size, cfg.backend.opt_window_overlap
    stride = W - V
    if not (n_frames >= W and (n_frames - V) % stride == 0):
        raise ValueError(f"sequence length {n_frames} must equal overlap {V} + n_segments * stride {stride}")
    return SegmentPlan(W, V, stride, (n_frames - V) // stride, n_frames)


@dataclasses.dataclass
class WindowSolve:
    """One window solve: its first frame, the LM result and masks (pool
    coordinates), and on a card the CUDA events around the solve (around
    the whole dispatch, shared by its windows, when windows solve in
    groups)."""

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
    est: EstimateStore
    windows: list           # WindowSolve per window, in order


class OfflineRunner:
    """The offline pipeline over a fixed number of frames, one host step at
    a time: `step(frame)` runs the frontend on the next frame, writes its
    packet into the measurement map, and solves the windows that frame
    makes due, if any.  `run(frames)` steps through a whole sequence."""

    def __init__(self, cam: CameraParams, cfg: DynoConfig, n_frames: int, use_klt: bool = True,
                 device=None, seed: int = 0):
        check_frontend_config(cfg.frontend)
        self.plan = _plan(cfg, n_frames)
        wpd = max(1, int(cfg.backend.opt_windows_per_dispatch))
        self.wpd = wpd if self.plan.n_segments % wpd == 0 else 1
        self.device = resolve_device(device)
        self.cam, self.cfg, self.use_klt = cam, cfg, use_klt
        self.lm_cfg = lm_config(cfg.backend)
        cap = cfg.capacity
        f = max(n_frames, cap.max_frames)
        ns, nd, no = cap.max_static_tracks, cap.max_dynamic_tracks, cap.max_objects
        self.fe_state = FrontendState.create(ns, nd, no, device=self.device)
        self.map = MeasurementMap.create(f, ns, nd, no, device=self.device)
        self.est = EstimateStore.create(f, ns, nd, no, device=self.device)
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

    def windows_due(self) -> list:
        """The first frames of the windows to solve now: the window just
        completed, or with wpd > 1 the group of wpd consecutive windows
        once its last one completes ([] if none)."""
        start = self.window_due()
        stride = self.plan.stride
        if start is None or (start // stride + 1) % self.wpd:
            return []
        return [start - i * stride for i in reversed(range(self.wpd))]

    def solve(self, start: int) -> WindowSolve:
        """Solve the window at `start` and write it into the estimate store."""
        return self.solve_group([start])[0]

    def solve_group(self, starts: list) -> list:
        """Solve the windows at `starts` in one dispatch
        (`backend.solve_windows`) and write them into the store in order."""
        events = None
        if self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        out = solve_windows(self.est, self.map, starts, self.plan.window, self.cfg.backend, self.lm_cfg)
        if events is not None:
            events[1].record()
        wins = [WindowSolve(s, r, mk, events) for s, (r, mk) in zip(starts, out)]
        self.windows.extend(wins)
        return wins

    def step(self, frame: FrameImages) -> list:
        """The frontend on the next frame, then the windows due: [WindowSolve]."""
        self.frontend(frame)
        due = self.windows_due()
        return self.solve_group(due) if due else []

    def result(self) -> OfflineResult:
        return OfflineResult(self.packets, self.est, self.windows)

    def run(self, frames) -> OfflineResult:
        for frame in frames:
            self.step(frame)
        if len(self.packets) != self.plan.n_frames:
            raise ValueError(f"{len(self.packets)} of the {self.plan.n_frames} planned frames arrived")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.result()


def make_offline_runner(cam: CameraParams, cfg: DynoConfig, n_frames: int, use_klt: bool = True,
                        device=None, seed: int = 0) -> OfflineRunner:
    """The offline runner for a fixed sequence length, on `device` (the card
    unless the caller asks for another).  Raises before any work for an
    option outside the ported path, full batch, or a length the plan
    cannot split."""
    return OfflineRunner(cam, cfg, n_frames, use_klt=use_klt, device=device, seed=seed)


def run_offline(frames, cam: CameraParams, cfg: DynoConfig, use_klt: bool = True, seed: int = 0,
                device=None) -> OfflineResult:
    """Offline entry: a list of FrameImages -> (packets, EstimateStore, window
    solves); the JAX package's last LM result is `windows[-1].result`."""
    frames = list(frames)
    return make_offline_runner(cam, cfg, len(frames), use_klt=use_klt, device=device, seed=seed).run(frames)


def make_streaming_runner(cam: CameraParams, cfg: DynoConfig, n_frames: int, use_klt: bool = True,
                          device=None, seed: int = 0):
    """Per-segment driver for host-streamed frames (native PNG decode and
    prefetch feeding the device while it computes), with the shape of the
    JAX package's `make_streaming_runner`, over one `OfflineRunner` that
    holds the state.  Returns ``(warmup, segment, plan)``:

      * ``warmup(frames) -> runner``: frames 0..V-1 (V = plan.overlap);
      * ``segment(frames, s) -> chk``: `frames` are the stride + 1 frames
        [seg_first - 1 .. seg_first + stride - 1] with seg_first = V + s *
        stride, the first being the previous frame, which the runner already
        holds; steps the rest.  `chk` is the final error of window s, or
        None while its group of `opt_windows_per_dispatch` waits.

    The JAX package needs this second entry because its offline runner is
    one fused scan; here it only cuts `OfflineRunner.step` into segments,
    so the store is `run_offline`'s on the same frames and seed."""
    runner = make_offline_runner(cam, cfg, n_frames, use_klt=use_klt, device=device, seed=seed)
    plan = runner.plan

    def warmup(frames) -> OfflineRunner:
        frames = list(frames)
        if len(frames) != plan.overlap or runner.packets:
            raise ValueError(f"warmup takes the first {plan.overlap} frames, got {len(frames)}")
        for frame in frames:
            runner.step(frame)
        return runner

    def segment(frames, s: int):
        frames = list(frames)
        if len(frames) != plan.stride + 1 or len(runner.packets) != plan.overlap + s * plan.stride:
            raise ValueError(f"segment {s} takes frames {plan.overlap + s * plan.stride - 1}.."
                             f"{plan.overlap + (s + 1) * plan.stride - 1}")
        solved = [w for frame in frames[1:] for w in runner.step(frame)]
        return solved[-1].result.error if solved else None

    return warmup, segment, plan


def run_streaming(frames, cam: CameraParams, cfg: DynoConfig, n_frames: int, use_klt: bool = True,
                  seed: int = 0, device=None) -> OfflineResult:
    """`run_offline` over an iterable of `n_frames` frames that arrive one
    at a time (a loader's `prefetched_frames()`, or frames decoded by
    `data.native_loader.PrefetchDecoder`), each stepped as it arrives."""
    return make_offline_runner(cam, cfg, n_frames, use_klt=use_klt, device=device, seed=seed).run(frames)
