"""K2 — batched point sampling (bilinear / nearest) of image channels.

Replaces the Pallas kernel `dynosam_tpu/ops/pallas/point_sample.py`
(`point_sample`) and the TPU production form
`dynosam_tpu/ops/onehot_sample.py:point_sample_mxu`.  CUDA source:
`csrc/point_sample.cu`.

`point_sample(channels, uv, modes, valid=None)`: `channels` is a sequence of
(H, W) tensors of one shape on one device, each float32, int32, bool or
uint8 with any strides (a (C, H, W) tensor passes as its planes); `uv` is
(N, 2) float32 (x, y); `modes` gives "bilinear" or "nearest" per channel;
rows with `valid` False come back 0.  The result is (N, C) float32 (int
labels below 2^24 are exact).

Bound on the card: launch latency — a main-path call moves < 0.3 MB and the
kernel takes about 2 us, so a call costs what the host spends on it.  The
kernel reads the caller's tensors in place (base pointer, element type and
strides per channel), so call sites pass views — the planes of a flow
field, an int32 label image, a bool mask — instead of a stacked, permuted
or converted copy of a whole image.  The launch is thin: each layout
(modes, dtypes, shapes, strides, devices) is validated once and its C block
cached; a call fills a thread-local block of pointers, allocates only the
output, takes the raw current-stream handle and passes two pointers to the
C launcher.

`point_sample` launches the kernel for CUDA tensors and runs
`point_sample_plain` for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from . import build

launches = 0   # kernel launches by `point_sample` (CUDA tensors only)

BILINEAR = "bilinear"
NEAREST = "nearest"
MAX_CHANNELS = 8
# element type codes of `csrc/point_sample.cu`
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bool: 2, torch.uint8: 2}


def _sanitize(xy: torch.Tensor) -> torch.Tensor:
    # a NaN coordinate samples pixel 0, as the kernel's fmaxf clamp does
    return torch.nan_to_num(xy, nan=0.0)


def bilinear_gather(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (..., 2) float (x, y) locations of a (H, W) image (any
    strides): coordinates clamped to the image, +1 taps clamped to the
    border (`dynosam_tpu/ops/klt.py:bilinear_sample`).  An int or bool image
    gives float32, as if converted first."""
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
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x1] * fx * (1 - fy)
        + img[y1, x0] * (1 - fx) * fy
        + img[y1, x1] * fx * fy
    )


def nearest_gather(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour sample: round half to even, then clamp
    (`dynosam_tpu/ops/klt.py:nearest_at`); the image's dtype."""
    h, w = img.shape
    xy = _sanitize(xy)
    x = torch.clamp(torch.round(xy[..., 0]), 0, w - 1).long()
    y = torch.clamp(torch.round(xy[..., 1]), 0, h - 1).long()
    return img[y, x]


def point_sample_plain(channels, uv: torch.Tensor, modes: tuple, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of K2: the same inputs as `point_sample`,
    (N, C) float32; rows with valid False come back 0."""
    cols = [
        (bilinear_gather(ch, uv) if m == BILINEAR else nearest_gather(ch, uv)).float()
        for ch, m in zip(channels, modes)
    ]
    out = torch.stack(cols, dim=-1)
    if valid is not None:
        out = torch.where(valid[:, None], out, torch.zeros_like(out))
    return out


class _Layout(NamedTuple):
    block: ctypes.Array     # [C, H, W, nearest_mask, (dtype, sy, sx) per channel]
    addr: int
    channels: int
    uv_contiguous: bool
    valid_contiguous: bool
    launch: object          # the C launcher (looked up once)


_layouts: dict = {}
_local = threading.local()


def _layout(key, channels, uv: torch.Tensor, modes, valid) -> _Layout:
    """Validate one call layout (raises on what the kernel does not take)
    and cache its C block under `key`."""
    c = len(channels)
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"1 to {MAX_CHANNELS} channels per call, got {c}")
    if len(modes) != c or any(m not in (BILINEAR, NEAREST) for m in modes):
        raise ValueError(f"modes must give one of bilinear/nearest per channel: {modes}")
    shape = channels[0].shape
    if len(shape) != 2 or min(shape) < 1 or any(ch.shape != shape for ch in channels):
        raise ValueError("channels must be non-empty (H, W) tensors of one shape")
    if any(ch.dtype not in DTYPE_CODES for ch in channels):
        raise ValueError(f"channel dtypes must be among {list(DTYPE_CODES)}")
    if uv.dtype != torch.float32 or uv.dim() != 2:
        raise ValueError("uv must be (N, 2) float32")
    if any(ch.device != uv.device for ch in channels):
        raise ValueError("channels and uv must lie on one device")
    if valid is not None and (valid.dtype != torch.bool or valid.dim() != 1 or valid.device != uv.device):
        raise ValueError("valid must be (N,) bool on uv's device")
    mask = sum(1 << i for i, m in enumerate(modes) if m == NEAREST)
    vals = [c, shape[0], shape[1], mask]
    for ch in channels:
        vals += [DTYPE_CODES[ch.dtype], *ch.stride()]
    block = (ctypes.c_longlong * len(vals))(*vals)
    lay = _Layout(block, ctypes.addressof(block), c, uv.stride() == (2, 1),
                  valid is None or valid.stride() == (1,),
                  build.function("dyno_point_sample") if uv.is_cuda else None)
    _layouts[key] = lay
    return lay


def _new_call_block():
    """This thread's per-call argument block and its address."""
    b = (ctypes.c_longlong * (5 + MAX_CHANNELS))()
    _local.block = (b, ctypes.addressof(b))
    return _local.block


def point_sample(channels, uv: torch.Tensor, modes: tuple, valid: torch.Tensor | None = None) -> torch.Tensor:
    """K2 wrapper: sample `channels` at (N, 2) float32 (x, y) points with
    per-channel `modes` (a tuple of "bilinear" | "nearest"); (N, C) float32."""
    global launches
    if isinstance(channels, torch.Tensor):
        if channels.dim() != 3:
            raise ValueError("a channel tensor must be (C, H, W)")
        channels = channels.unbind(0)
    dev = uv.get_device()       # -1 on the CPU
    key = (modes, uv.dtype, uv.stride(), dev,
           None if valid is None else (valid.dtype, valid.stride(), valid.get_device()),
           *[(ch.dtype, ch.shape, ch.stride(), ch.get_device()) for ch in channels])
    lay = _layouts.get(key) or _layout(key, channels, uv, modes, valid)
    n, two = uv.shape
    if two != 2 or (valid is not None and len(valid) != n):
        raise ValueError("uv must be (N, 2) and valid (N,)")
    if dev < 0:
        return point_sample_plain(channels, uv, modes, valid)
    if not lay.uv_contiguous:
        uv = uv.contiguous()
    uv_ptr = uv.data_ptr()
    if uv_ptr & 7:          # the kernel loads each point as one float2
        uv = uv.clone()
        uv_ptr = uv.data_ptr()
    if valid is None:
        valid_ptr = 0
    else:
        if not lay.valid_contiguous:
            valid = valid.contiguous()   # held until the launch is queued
        valid_ptr = valid.data_ptr()
    out = uv.new_empty(n, lay.channels)
    blk, addr = getattr(_local, "block", None) or _new_call_block()
    blk[0:5 + lay.channels] = (n, uv_ptr, valid_ptr, out.data_ptr(),
                               torch._C._cuda_getCurrentRawStream(dev), *[ch.data_ptr() for ch in channels])
    code = lay.launch(addr, lay.addr)
    if code:
        build.check(code, "point_sample")
    launches += 1
    return out
