"""Debug visualization: tracks, masks, flow, depth (port of
`dynosam_tpu/viz/visualizer.py`).

Host-side (numpy/cv2) analog of the reference's OpenCV debug imagery
(`RGBDInstanceFrontendModule.cc:152-170`, `visualizer/ColourMap.hpp`,
`visualizer/Display.hpp:36`).  Tensors are accepted and moved to the
host; `cv2` is imported inside the functions that draw with it, so the
package imports without it.  No effect on the compute path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def _colour(i: int):
    """Deterministic distinct colour per id (ColourMap analog)."""
    rng = np.random.default_rng(int(i) * 7919 + 13)
    c = rng.integers(60, 255, 3)
    return int(c[0]), int(c[1]), int(c[2])


def gray_to_bgr(gray) -> np.ndarray:
    g = np.clip(_np(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_tracks(image_bgr, uv, valid, prev_uv=None, colour=(0, 255, 0), radius: int = 2) -> np.ndarray:
    import cv2

    out = _np(image_bgr).copy()
    uv = _np(uv)
    for i in np.nonzero(_np(valid))[0]:
        p = tuple(np.round(uv[i]).astype(int))
        cv2.circle(out, p, radius, colour, -1)
        if prev_uv is not None:
            q = tuple(np.round(_np(prev_uv)[i]).astype(int))
            cv2.line(out, q, p, colour, 1)
    return out


def draw_object_tracks(image_bgr, uv, obj, valid) -> np.ndarray:
    import cv2

    out = _np(image_bgr).copy()
    uv, obj = _np(uv), _np(obj)
    for i in np.nonzero(_np(valid))[0]:
        p = tuple(np.round(uv[i]).astype(int))
        cv2.circle(out, p, 2, _colour(int(obj[i]) + 1), -1)
    return out


def overlay_mask(image_bgr, mask, alpha=0.45):
    out = _np(image_bgr).astype(np.float32)
    mask = _np(mask)
    for lab in np.unique(mask):
        if lab <= 0:
            continue
        c = np.asarray(_colour(lab), np.float32)
        sel = mask == lab
        out[sel] = (1 - alpha) * out[sel] + alpha * c
    return out.astype(np.uint8)


def flow_to_bgr(flow, max_mag: Optional[float] = None):
    """HSV flow visualization (hue = direction, value = magnitude)."""
    import cv2

    flow = _np(flow)
    mag = np.linalg.norm(flow, axis=-1)
    ang = np.arctan2(flow[..., 1], flow[..., 0])
    if max_mag is None:
        max_mag = max(float(np.percentile(mag, 95)), 1e-6)
    hsv = np.zeros((*mag.shape, 3), np.uint8)
    hsv[..., 0] = ((ang + np.pi) / (2 * np.pi) * 179).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = np.clip(mag / max_mag * 255, 0, 255).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)


def depth_to_bgr(depth, max_depth: float = 40.0):
    import cv2

    d = np.clip(_np(depth), 0, max_depth) / max_depth
    d8 = (d * 255).astype(np.uint8)
    return cv2.applyColorMap(255 - d8, cv2.COLORMAP_JET)


def frontend_debug_image(images, packet, prev_uv_s=None) -> np.ndarray:
    """Composite debug frame: static tracks (green) + per-object dynamic
    tracks + mask overlay (the reference's tracking debug image)."""
    base = overlay_mask(gray_to_bgr(images.gray), images.mask)
    base = draw_tracks(base, packet.static_obs.uv, packet.static_obs.valid, prev_uv=prev_uv_s)
    return draw_object_tracks(base, packet.dynamic_obs.uv, packet.dynamic_obs.obj, packet.dynamic_obs.valid)


class FrontendDisplay:
    """Display loop with video dump, the analog of the reference's
    `DisplayBase`/`OpenCVFrontendDisplay` (`visualizer/Display.hpp:36`,
    `OpenCVFrontendDisplay.cc:32-42`), and the `display` hook of
    `pipeline.DynoPipeline`.

    `spin_once(images, packet)` composes the tracking debug image and
    (a) appends it to an mp4/avi via cv2.VideoWriter when `video_path` is
    set, (b) shows it in a window when `show=True` and a GUI exists,
    (c) keeps it readable at `.last_frame`.
    """

    def __init__(self, video_path: Optional[str] = None, fps: float = 10.0, show: bool = False,
                 window: str = "dynosam_tpu frontend"):
        self.video_path = video_path
        self.fps = fps
        self.show = show
        self.window = window
        self._writer = None
        self.last_frame: Optional[np.ndarray] = None
        self._prev_uv_s: Optional[np.ndarray] = None

    def spin_once(self, images, packet) -> np.ndarray:
        frame = frontend_debug_image(images, packet, prev_uv_s=self._prev_uv_s)
        self._prev_uv_s = _np(packet.static_obs.uv).copy()
        self.last_frame = frame
        if self.video_path is not None:
            import cv2

            if self._writer is None:
                h, w = frame.shape[:2]
                fourcc = cv2.VideoWriter_fourcc(*("mp4v" if self.video_path.endswith(".mp4") else "MJPG"))
                self._writer = cv2.VideoWriter(self.video_path, fourcc, self.fps, (w, h))
            self._writer.write(frame)
        if self.show:
            import cv2

            try:
                cv2.imshow(self.window, frame)
                cv2.waitKey(1)
            except cv2.error:
                self.show = False  # headless environment: disable quietly, as the reference does
        return frame

    def close(self):
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        if self.show:
            import cv2

            try:
                cv2.destroyWindow(self.window)
            except cv2.error:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
