"""K1 — one pyramid level of batched Lucas-Kanade.

Replaces the Pallas kernel `dynosam_tpu/ops/pallas/lk.py:lk_level` (four
TPU schedules of one contract; wrapper `klt_track_pallas`).  CUDA source:
`csrc/lk.cu`.

Contract per slot (see the source for the full statement): template and
central-difference gradients from `prev` at p + o, the 2x2 structure
tensor with the det > 1e-6 guard, up to `iters` clipped Gauss-Newton steps
on `cur`, a slot stops after the first step with |step|^2 <= eps^2 (eps
<= 0 never stops early), err = mean |cur(p + g + o) - T|.  Inactive slots
return g0 and err 0.

Bound on the card: the latency of each slot's chain of dependent
iterations (the window's sums decide the next position); bytes and FLOPs
are well under a microsecond at the card's rates.  The kernel runs one warp
per slot (warp-shuffle sums, no block barrier in the loop, a warp-uniform
solve and eps exit), keeps each lane's taps of the template and its
gradients in registers, and samples `prev` and `cur` from shared-memory
tiles staged once with replicated borders (the `cur` tile restaged only
when a step moves the window past its margin).  Windows up to 31.

`lk_level` launches the kernel for CUDA tensors and runs `lk_level_plain`
for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import torch

from . import build
from .point_sample import bilinear_gather

launches = 0   # kernel launches by `lk_level` (CUDA tensors only)

MAX_WIN = 31   # `csrc/lk.cu`: at most 32 taps per lane


def patch_offsets(win: int, dtype, device) -> torch.Tensor:
    """(win*win, 2) integer (x, y) offsets in [-win//2, win//2], row-major
    like `dynosam_tpu/ops/klt.py:_patch_offsets`."""
    r = (win - 1) / 2.0
    o = torch.linspace(-r, r, win, dtype=torch.float64).to(dtype)
    oy, ox = torch.meshgrid(o, o, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1).to(device)


def lk_level_plain(
    prev: torch.Tensor,
    cur: torch.Tensor,
    p: torch.Tensor,
    g0: torch.Tensor,
    valid: torch.Tensor | None,
    win: int,
    iters: int,
    eps: float = 0.0,
    return_iters: bool = False,
):
    """Plain PyTorch version of K1: returns (g (N, 2), err (N,)), and with
    `return_iters` also the (N,) count of Gauss-Newton steps each slot took.

    `valid=None` iterates every slot (the `ops/klt.py:klt_track` form)."""
    offs = patch_offsets(win, prev.dtype, prev.device)       # (P, 2)
    ex, ey = torch.eye(2, dtype=prev.dtype, device=prev.device)
    coords = p[:, None, :] + offs[None]                       # (N, P, 2)
    t = bilinear_gather(prev, coords)
    gx = (bilinear_gather(prev, coords + ex) - bilinear_gather(prev, coords - ex)) * 0.5
    gy = (bilinear_gather(prev, coords + ey) - bilinear_gather(prev, coords - ey)) * 0.5
    gxx = torch.sum(gx * gx, dim=-1)
    gxy = torch.sum(gx * gy, dim=-1)
    gyy = torch.sum(gy * gy, dim=-1)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-6
    det_safe = torch.where(inv_ok, det, torch.ones_like(det))

    n = p.shape[0]
    live = (
        torch.ones((n,), dtype=torch.bool, device=p.device)
        if valid is None else valid.clone()
    )
    g = g0.clone()
    n_steps = torch.zeros((n,), dtype=torch.int64, device=p.device)
    for _ in range(iters):
        n_steps += live
        patch = bilinear_gather(cur, (p + g)[:, None, :] + offs[None])
        r = patch - t
        bx = torch.sum(r * gx, dim=-1)
        by = torch.sum(r * gy, dim=-1)
        dx = -(gyy * bx - gxy * by) / det_safe
        dy = -(-gxy * bx + gxx * by) / det_safe
        step = torch.stack([dx, dy], dim=-1)
        step = torch.where(inv_ok[:, None], step, torch.zeros_like(step))
        step = torch.clamp(step, -float(win), float(win))
        step = torch.where(live[:, None], step, torch.zeros_like(step))
        g = g + step
        if eps > 0.0:
            live = live & (torch.sum(step * step, dim=-1) > eps * eps)
    patch = bilinear_gather(cur, (p + g)[:, None, :] + offs[None])
    err = torch.mean(torch.abs(patch - t), dim=-1)
    if valid is not None:
        err = torch.where(valid, err, torch.zeros_like(err))
    if return_iters:
        return g, err, n_steps
    return g, err


def lk_level(
    prev: torch.Tensor,
    cur: torch.Tensor,
    p: torch.Tensor,
    g0: torch.Tensor,
    valid: torch.Tensor,
    win: int = 21,
    iters: int = 10,
    eps: float = 0.0,
):
    """K1 wrapper: (H, W) float32 images, (N, 2) float32 positions and
    incoming flow at this level's scale, (N,) bool active slots.  Returns
    (g (N, 2), err (N,))."""
    global launches
    if prev.dim() != 2 or prev.shape != cur.shape:
        raise ValueError("prev and cur must be (H, W) images of one shape")
    if prev.dtype != torch.float32 or cur.dtype != torch.float32:
        raise ValueError("images must be float32")
    n = p.shape[0]
    if p.shape != (n, 2) or g0.shape != (n, 2) or valid.shape != (n,):
        raise ValueError("p and g0 must be (N, 2) and valid (N,)")
    if p.dtype != torch.float32 or g0.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("p and g0 must be float32 and valid bool")
    if win < 1 or win % 2 == 0:
        raise ValueError("win must be odd")
    if prev.device.type == "cpu":
        return lk_level_plain(prev, cur, p, g0, valid, win, iters, eps)
    dev = prev.get_device()
    if dev < 0 or not cur.get_device() == p.get_device() == g0.get_device() == valid.get_device() == dev:
        raise ValueError("all inputs must lie on one CUDA device")
    if win > MAX_WIN:
        raise ValueError(f"win {win} is above the kernel's {MAX_WIN}")
    h, w = prev.shape
    prev, cur, valid = prev.contiguous(), cur.contiguous(), valid.contiguous()
    p, g0 = p.contiguous(), g0.contiguous()
    if (p.data_ptr() | g0.data_ptr()) % 8:   # both are read as float2
        p, g0 = p.clone(), g0.clone()
    g = p.new_empty((n, 2))
    err = p.new_empty((n,))
    code = build.function("dyno_lk_level")(
        prev.data_ptr(), cur.data_ptr(), h, w, p.data_ptr(), g0.data_ptr(),
        valid.data_ptr(), n, win, iters, float(eps), g.data_ptr(),
        err.data_ptr(), build.stream_handle(p),
    )
    build.check(code, "lk_level")
    launches += 1
    return g, err
