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

Bound on the card: the latency of the dependent iterations (each needs a
block reduction before the next position is known); bytes and FLOPs are
microseconds.  One thread block per slot keeps the template in shared
memory for the whole loop and re-samples the L2-resident current image.

`lk_level` launches the kernel for CUDA tensors and runs `lk_level_plain`
for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import torch

from . import build
from .point_sample import bilinear_gather

launches = 0   # kernel launches by `lk_level` (CUDA tensors only)

_MAX_SMEM = 48 * 1024


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
    ex = torch.tensor([1.0, 0.0], dtype=prev.dtype, device=prev.device)
    ey = torch.tensor([0.0, 1.0], dtype=prev.dtype, device=prev.device)
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
    if prev.device.type != "cuda" or any(
        x.device != prev.device for x in (cur, p, g0, valid)
    ):
        raise ValueError("all inputs must lie on one CUDA device")
    lib = build.load()
    if lib.dyno_lk_smem_bytes(win) > _MAX_SMEM:
        raise ValueError(f"win {win} needs more than 48 KB of shared memory")
    h, w = prev.shape
    prev, cur, p, g0, valid = (x.contiguous() for x in (prev, cur, p, g0, valid))
    g = torch.empty((n, 2), dtype=torch.float32, device=p.device)
    err = torch.empty((n,), dtype=torch.float32, device=p.device)
    code = lib.dyno_lk_level(
        prev.data_ptr(), cur.data_ptr(), h, w, p.data_ptr(), g0.data_ptr(),
        valid.data_ptr(), n, win, iters, float(eps), g.data_ptr(),
        err.data_ptr(), build.stream_handle(p),
    )
    build.check(code, "lk_level")
    launches += 1
    return g, err
