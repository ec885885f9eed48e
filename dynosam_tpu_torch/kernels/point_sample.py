"""K2 — batched point sampling (bilinear / nearest) of a channel stack.

Replaces the Pallas kernel `dynosam_tpu/ops/pallas/point_sample.py`
(`point_sample`) and the TPU production form
`dynosam_tpu/ops/onehot_sample.py:point_sample_mxu`.  CUDA source:
`csrc/point_sample.cu`.

Bound on the card: launch latency — a main-path call moves < 0.3 MB.  The
kernel runs one thread per point and one pass over the channels, so the
2-hot weights are built once per point whatever the channel count; call
sites that share positions merge their channels into one launch.

`point_sample` launches the kernel for CUDA tensors and runs
`point_sample_plain` for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import torch

from . import build

launches = 0   # kernel launches by `point_sample` (CUDA tensors only)

BILINEAR = "bilinear"
NEAREST = "nearest"


def _sanitize(xy: torch.Tensor) -> torch.Tensor:
    # a NaN coordinate samples pixel 0, as the kernel's fmaxf clamp does
    return torch.nan_to_num(xy, nan=0.0)


def bilinear_gather(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (..., 2) float (x, y) locations of a (H, W) image: coordinates
    clamped to the image, +1 taps clamped to the border
    (`dynosam_tpu/ops/klt.py:bilinear_sample`)."""
    h, w = img.shape
    xy = _sanitize(xy)
    x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    xf = torch.floor(x)
    yf = torch.floor(y)
    x0 = xf.long()
    y0 = yf.long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = x - xf
    fy = y - yf
    flat = img.reshape(-1)
    v00 = flat[y0 * w + x0]
    v01 = flat[y0 * w + x1]
    v10 = flat[y1 * w + x0]
    v11 = flat[y1 * w + x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def nearest_gather(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample: round half to even, then clamp
    (`dynosam_tpu/ops/klt.py:nearest_at`)."""
    h, w = img.shape
    xy = _sanitize(xy)
    x = torch.clamp(torch.round(xy[..., 0]), 0, w - 1).long()
    y = torch.clamp(torch.round(xy[..., 1]), 0, h - 1).long()
    return img.reshape(-1)[y * w + x]


def point_sample_plain(
    stack: torch.Tensor,
    uv: torch.Tensor,
    modes: tuple,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2: (C, H, W) f32, (N, 2) f32 -> (N, C) f32;
    rows with valid False come back 0."""
    cols = [
        bilinear_gather(stack[c], uv) if m == BILINEAR
        else nearest_gather(stack[c], uv)
        for c, m in enumerate(modes)
    ]
    out = torch.stack(cols, dim=-1)
    if valid is not None:
        out = torch.where(valid[:, None], out, torch.zeros_like(out))
    return out


def point_sample(
    stack: torch.Tensor,
    uv: torch.Tensor,
    modes: tuple,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2 wrapper: sample a (C, H, W) float32 stack at (N, 2) float32 (x, y)
    points with per-channel `modes` ("bilinear" | "nearest"); (N, C)."""
    global launches
    if stack.dim() != 3 or stack.dtype != torch.float32:
        raise ValueError("stack must be (C, H, W) float32")
    if uv.dim() != 2 or uv.shape[1] != 2 or uv.dtype != torch.float32:
        raise ValueError("uv must be (N, 2) float32")
    c, h, w = stack.shape
    n = uv.shape[0]
    if len(modes) != c or any(m not in (BILINEAR, NEAREST) for m in modes):
        raise ValueError(f"modes must give one of bilinear/nearest per channel: {modes}")
    if valid is not None and (valid.shape != (n,) or valid.dtype != torch.bool):
        raise ValueError("valid must be (N,) bool")
    if stack.device.type == "cpu":
        return point_sample_plain(stack, uv, modes, valid)
    if stack.device.type != "cuda" or uv.device != stack.device:
        raise ValueError("stack and uv must lie on the same CUDA device")
    if c > 31:
        raise ValueError("at most 31 channels per launch")
    stack = stack.contiguous()
    uv = uv.contiguous()
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=uv.device)
    valid = valid.contiguous().to(uv.device)
    out = torch.empty((n, c), dtype=torch.float32, device=uv.device)
    mask = sum(1 << i for i, m in enumerate(modes) if m == NEAREST)
    lib = build.load()
    code = lib.dyno_point_sample(
        stack.data_ptr(), c, h, w, uv.data_ptr(), valid.data_ptr(), n, mask,
        out.data_ptr(), build.stream_handle(uv),
    )
    build.check(code, "point_sample")
    launches += 1
    return out
