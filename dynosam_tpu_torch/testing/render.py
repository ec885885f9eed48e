"""Synthetic RGB-D + flow + mask sequence renderer and its KITTI-layout
writer (port of `dynosam_tpu/testing/render.py`).

A camera moves through a textured background plane while independently
moving textured object planes cross it; every frame comes with exact depth,
the dense flow to the next frame and the instance mask.  Textures come from
the same numpy noise (same seed) as the JAX renderer; all per-pixel work
runs as batched tensor code on the chosen device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from ..core.camera import CameraParams, backproject
from ..core.lie import SE3, se3_compose, se3_exp
from ..frontend.frontend import FrameImages
from ..utils.device import resolve_device


@dataclasses.dataclass
class RenderConfig:
    n_frames: int = 6
    h: int = 120
    w: int = 160
    fx: float = 120.0
    bg_depth: float = 8.0
    obj_depth: float = 5.0
    obj_label: int = 3           # first object's label; object i gets +i
    n_objects: int = 1
    seed: int = 0
    cam_step: float = 0.08
    obj_step: float = 0.25
    yaw_only_objects: bool = False


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) Keys-cubic resampling weights, the scheme of
    `jax.image.resize(method="cubic")` (upsampling: no kernel scaling;
    weights renormalised; samples outside the input zeroed)."""
    inv_scale = 1.0 / (n_out / n_in)
    f32 = torch.float32
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    kernel_scale = max(inv_scale, 1.0)
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32, device=device)[:, None]) / kernel_scale
    wts = _keys_cubic(x)
    tot = wts.sum(0, keepdim=True)
    wts = torch.where(
        torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
        wts / torch.where(tot != 0, tot, torch.ones_like(tot)),
        torch.zeros_like(wts),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], wts, torch.zeros_like(wts))


def _blur1d(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Separable Gaussian blur (sigma 1, radius 4, edge padding) on one axis."""
    r = 4
    k = torch.exp(-0.5 * torch.arange(-r, r + 1, dtype=x.dtype, device=x.device) ** 2)
    k = k / torch.sum(k)
    xm = x.movedim(axis, -1)
    n = xm.shape[-1]
    lead = xm.shape[:-1]
    xp = torch.nn.functional.pad(
        xm.reshape(1, -1, n), (r, r), mode="replicate"
    ).reshape(*lead, n + 2 * r)
    out = torch.zeros_like(xm)
    for i in range(2 * r + 1):
        out = out + k[i] * xp[..., i:i + n]
    return out.movedim(-1, axis)


def _smooth_texture(base: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Cubic-upsample small noise to (h, w), blur, normalise to [20, 220]."""
    wy = _cubic_weights(base.shape[0], h, base.device)
    wx = _cubic_weights(base.shape[1], w, base.device)
    tex = wy.t() @ base @ wx
    tex = _blur1d(_blur1d(tex, 0), 1)
    lo, hi = torch.min(tex), torch.max(tex)
    return (tex - lo) / (hi - lo + 1e-9) * 200.0 + 20.0


def _bilinear(tex: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear tex[y, x] with coordinates pre-clipped to [0, dim - 2]."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx_ = x - x0
    fy = y - y0
    xi = x0.long()
    yi = y0.long()
    w = tex.shape[1]
    flat = tex.reshape(-1)
    t00 = flat[yi * w + xi]
    t01 = flat[yi * w + xi + 1]
    t10 = flat[(yi + 1) * w + xi]
    t11 = flat[(yi + 1) * w + xi + 1]
    return (
        t00 * (1 - fy) * (1 - fx_) + t01 * (1 - fy) * fx_
        + t10 * fy * (1 - fx_) + t11 * fy * fx_
    )


class RenderedScene:
    """Renders frames; exposes GT camera poses and object motions/poses.
    Object i carries mask label `cfg.obj_label + i`.  Runs on CUDA unless
    `device="cpu"`."""

    _OBJ_TWISTS = [
        [0.0, 0.0, 0.005, None, 0.02, 0.0],
        [0.0, 0.0, -0.004, "neg", 0.012, 0.03],
        [0.002, 0.0, 0.0, "half", -0.015, 0.0],
    ]
    _OBJ_CENTERS = [(0.55, 0.45), (0.25, 0.55), (0.8, 0.35)]
    _OBJ_HALVES = [0.8, 0.7, 0.6]

    def __init__(self, cfg: RenderConfig, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        n_obj = cfg.n_objects
        if n_obj > len(self._OBJ_TWISTS):
            raise ValueError(f"n_objects <= {len(self._OBJ_TWISTS)}")
        rng = np.random.default_rng(cfg.seed)
        self.cam = CameraParams.create(cfg.fx, cfg.fx, cfg.w / 2, cfg.h / 2, cfg.w, cfg.h)
        f32 = torch.float32
        scale = 4
        self._base_bg = torch.as_tensor(
            rng.normal(size=(cfg.h * 3 // scale + 2, cfg.w * 3 // scale + 2)), dtype=f32
        ).to(dev)
        self._base_obj = torch.as_tensor(
            rng.normal(size=(n_obj, cfg.h // scale + 2, cfg.w // scale + 2)), dtype=f32
        ).to(dev)

        eye = torch.eye(3, dtype=f32, device=dev)
        self.X_gt: List[SE3] = [SE3(eye, torch.zeros(3, dtype=f32, device=dev))]
        xi = torch.tensor([0.0, 0.002, 0.0, cfg.cam_step, 0.01, 0.02], dtype=f32, device=dev)
        for _ in range(1, cfg.n_frames):
            self.X_gt.append(se3_compose(self.X_gt[-1], se3_exp(xi)))

        def twist(spec):
            vals = []
            for v in spec:
                if v is None:
                    vals.append(cfg.obj_step)
                elif v == "neg":
                    vals.append(-0.8 * cfg.obj_step)
                elif v == "half":
                    vals.append(0.5 * cfg.obj_step)
                else:
                    vals.append(v)
            tw = torch.tensor(vals, dtype=f32, device=dev)
            if cfg.yaw_only_objects:
                mag = float(np.linalg.norm(tw[:3].cpu().numpy()))
                tw = torch.cat([torch.tensor([0.0, mag, 0.0], dtype=f32, device=dev), tw[3:]])
            return tw

        self.H_gt_list: List[SE3] = [se3_exp(twist(self._OBJ_TWISTS[i])) for i in range(n_obj)]
        self.obj_halves = [self._OBJ_HALVES[i] for i in range(n_obj)]
        self._L_gt_all: List[List[SE3]] = []
        for i in range(n_obj):
            fu, fv = self._OBJ_CENTERS[i]
            depth_i = cfg.obj_depth * (1.0 + 0.12 * i)
            c3 = backproject(
                self.cam,
                torch.tensor([cfg.w * fu, cfg.h * fv], dtype=f32, device=dev),
                torch.tensor(depth_i, dtype=f32, device=dev),
            )
            chain = [SE3(eye, c3)]
            for _ in range(1, cfg.n_frames):
                chain.append(se3_compose(self.H_gt_list[i], chain[-1]))
            self._L_gt_all.append(chain)
        self._frames: List[FrameImages] | None = None

    @property
    def object_labels(self) -> List[int]:
        return [self.cfg.obj_label + i for i in range(self.cfg.n_objects)]

    def object_pose_at(self, k: int, obj: int = 0) -> SE3:
        return self._L_gt_all[obj][k]

    def _render_frame(self, k: int, bg_tex, obj_tex, rays, uv_now) -> FrameImages:
        cfg = self.cfg
        h, w = cfg.h, cfg.w
        fx = cfg.fx
        cx, cy = w / 2.0, h / 2.0
        kn = min(k + 1, cfg.n_frames - 1)
        XRk, Xtk = self.X_gt[k].R, self.X_gt[k].t
        XRn, Xtn = self.X_gt[kn].R, self.X_gt[kn].t
        LR = torch.stack([c[k].R for c in self._L_gt_all])            # (O, 3, 3)
        Lt = torch.stack([c[k].t for c in self._L_gt_all])            # (O, 3)
        HR = torch.stack([H.R for H in self.H_gt_list])
        Ht = torch.stack([H.t for H in self.H_gt_list])
        half = torch.tensor(self.obj_halves, dtype=torch.float32, device=self.device)

        rays_w = rays @ XRk.t()                                       # (P, 3)
        denom = torch.where(torch.abs(rays_w[:, 2]) < 1e-6, torch.full_like(rays_w[:, 2], 1e-6), rays_w[:, 2])
        s_bg = (cfg.bg_depth - Xtk[2]) / denom
        p_bg = Xtk + rays_w * s_bg[:, None]

        Ro = LR.transpose(-1, -2)                                     # (O, 3, 3)
        to = -torch.einsum("oij,oj->oi", Ro, Lt)
        rays_o = torch.einsum("pj,oij->opi", rays_w, Ro)              # (O, P, 3)
        cam_o = torch.einsum("oij,j->oi", Ro, Xtk) + to               # (O, 3)
        dz = rays_o[..., 2]
        denom_o = torch.where(torch.abs(dz) < 1e-6, torch.full_like(dz, 1e-6), dz)
        s_obj = (0.0 - cam_o[:, 2:3]) / denom_o                       # (O, P)
        # one rounding of cam + ray * s, as a fused multiply-add gives: the
        # patch edges of an unrotated object fall exactly on pixel centres,
        # and a second rounding moves a whole row or column of the mask
        p_loc = (
            cam_o[:, None, :].double() + rays_o.double() * s_obj[..., None].double()
        ).float()
        on = (
            (torch.abs(p_loc[..., 0]) < half[:, None])
            & (torch.abs(p_loc[..., 1]) < half[:, None])
            & (s_obj > 0.1)
            & (s_obj < s_bg[None])
        )
        p_w_o = torch.einsum("opj,oij->opi", p_loc, LR) + Lt[:, None, :]

        s_eff = torch.where(on, s_obj, torch.full_like(s_obj, float("inf")))
        best = torch.argmin(s_eff, dim=0)                             # (P,)
        on_obj = torch.any(on, dim=0)
        n_obj = HR.shape[0]
        oh = torch.nn.functional.one_hot(best, n_obj).float() * on_obj[:, None].float()
        p_obj = torch.einsum("po,opj->pj", oh, p_w_o)
        p_obj_local = torch.einsum("po,opj->pj", oh, p_loc)
        p_w = torch.where(on_obj[:, None], p_obj, p_bg)
        depth = (p_w - Xtk) @ XRk[:, 2]

        bh, bw = h * 3, w * 3
        scale = fx / cfg.bg_depth
        bx = torch.clamp(p_w[:, 0] * scale + bw / 2.0, 0.0, bw - 2.0)
        by = torch.clamp(p_w[:, 1] * scale + bh / 2.0, 0.0, bh - 2.0)
        bg_vals = _bilinear(bg_tex, bx, by)
        oscale = fx / cfg.obj_depth * 0.8
        ox = torch.clamp(p_obj_local[:, 0] * oscale + w / 2.0, 0.0, w - 2.0)
        oy = torch.clamp(p_obj_local[:, 1] * oscale + h / 2.0, 0.0, h - 2.0)
        obj_vals_o = torch.stack([_bilinear(t, ox, oy) for t in obj_tex])
        obj_vals = torch.einsum("po,op->p", oh, obj_vals_o)
        gray = torch.where(on_obj, obj_vals, bg_vals).reshape(h, w)
        labels = cfg.obj_label + torch.arange(n_obj, dtype=torch.int32, device=self.device)
        mask = torch.where(on_obj, labels[best], torch.zeros_like(labels[best])).reshape(h, w)

        p_next_o = torch.einsum("pj,oij->opi", p_w, HR) + Ht[:, None, :]
        p_next_obj = torch.einsum("po,opj->pj", oh, p_next_o)
        p_next = torch.where(on_obj[:, None], p_next_obj, p_w)
        pc = (p_next - Xtn) @ XRn
        z = torch.clamp(pc[:, 2], min=1e-6)
        un = torch.stack([pc[:, 0] / z * fx + cx, pc[:, 1] / z * fx + cy], dim=-1)
        flow = (un - uv_now).reshape(h, w, 2)
        return FrameImages(
            gray=gray.contiguous(), depth=depth.reshape(h, w).contiguous(),
            flow=flow.contiguous(), mask=mask.to(torch.int32).contiguous(),
        )

    def _render(self) -> List[FrameImages]:
        cfg = self.cfg
        h, w, fx = cfg.h, cfg.w, cfg.fx
        f32 = torch.float32
        bg_tex = _smooth_texture(self._base_bg, h * 3, w * 3)
        obj_tex = [_smooth_texture(b, h, w) for b in self._base_obj]
        yy, xx = torch.meshgrid(
            torch.arange(h, dtype=f32, device=self.device),
            torch.arange(w, dtype=f32, device=self.device), indexing="ij",
        )
        uv_now = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
        rays = torch.stack(
            [(uv_now[:, 0] - w / 2.0) / fx, (uv_now[:, 1] - h / 2.0) / fx, torch.ones_like(uv_now[:, 0])],
            dim=-1,
        )
        return [self._render_frame(k, bg_tex, obj_tex, rays, uv_now) for k in range(cfg.n_frames)]

    def frame(self, k: int) -> FrameImages:
        return self.frames()[k]

    def frames(self) -> List[FrameImages]:
        if self._frames is None:
            self._frames = self._render()
        return self._frames


# --------------------------------------------------------------------------
# Reference-layout dataset writer (dataset dir -> CLI -> report without
# real sequences)
# --------------------------------------------------------------------------


def _write_flo(path: str, flow: np.ndarray) -> None:
    """Middlebury .flo writer (inverse of `data/kitti._read_flo`)."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([202021.25], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).reshape(-1).tofile(f)


def _write_png(path: str, img: np.ndarray) -> None:
    """A greyscale PNG (8-bit for uint8, 16-bit for uint16; unfiltered rows)
    written with the standard library's zlib."""
    import struct
    import zlib

    h, w = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2" if depth == 16 else np.uint8)).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def pose_matrix(X: SE3) -> np.ndarray:
    """A pose as a float64 (4, 4) numpy matrix."""
    T = np.eye(4)
    T[:3, :3] = X.R.double().cpu().numpy()
    T[:3, 3] = X.t.double().cpu().numpy()
    return T


def write_reference_layout(scene: "RenderedScene", out_dir: str, baseline: float = 387.5744,
                           depth_scale: float = 256.0, frames=None) -> str:
    """Write a `RenderedScene` to disk in the KITTI-tracking layout that
    `data/kitti.py` reads (`dataprovider/KittiDataProvider.hpp:352+`):

      image_0/%06d.png   8-bit grayscale
      depth/%06d.png     16-bit disparity, depth = baseline/(disp/scale)
      flow/%06d.flo      dense flow k -> k+1
      motion/%06d.png    16-bit instance masks
      calib.txt          P2 row (overrides the per-sequence rig)
      times.txt, pose_gt.txt (3x4 rows), object_pose.txt
                         (`FrameID ObjectID B1-B4 t1 t2 t3 ry`)

    The object_pose yaw encoding (L_cam = (R_y(ry + pi/2), t)) is exact
    only for yaw-only object and camera rotations: build the scene with
    `RenderConfig(yaw_only_objects=True)`.  `frames` (the scene's own by
    default) are the images written, e.g. with noise added.  PNGs are
    written with the standard library (`_write_png`), so no image package
    is needed."""
    cfg = scene.cfg
    for sub in ("image_0", "depth", "flow", "motion"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for k, f in enumerate(scene.frames() if frames is None else frames):
        name = f"{k:06d}"
        gray = np.clip(f.gray.cpu().numpy(), 0, 255).astype(np.uint8)
        _write_png(os.path.join(out_dir, "image_0", name + ".png"), gray)
        depth = f.depth.cpu().numpy().astype(np.float64)
        disp = np.where(depth > 0, baseline * depth_scale / np.maximum(depth, 1e-6), 0.0)
        _write_png(os.path.join(out_dir, "depth", name + ".png"), np.clip(np.round(disp), 0, 65535).astype(np.uint16))
        _write_flo(os.path.join(out_dir, "flow", name + ".flo"), f.flow.cpu().numpy().astype(np.float32))
        _write_png(os.path.join(out_dir, "motion", name + ".png"), f.mask.cpu().numpy().astype(np.uint16))

    cam = scene.cam
    with open(os.path.join(out_dir, "calib.txt"), "w") as f:
        f.write(f"P2: {float(cam.fx)} 0 {float(cam.cx)} 0 0 {float(cam.fy)} {float(cam.cy)} 0 0 0 1 0\n")
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        for k in range(cfg.n_frames):
            f.write(f"{k * 0.1:.6f}\n")
    with open(os.path.join(out_dir, "pose_gt.txt"), "w") as f:
        for k in range(cfg.n_frames):
            f.write(" ".join(f"{v:.9f}" for v in pose_matrix(scene.X_gt[k])[:3, :4].reshape(-1)))
            f.write("\n")
    with open(os.path.join(out_dir, "object_pose.txt"), "w") as f:
        for k in range(cfg.n_frames):
            for i, lab in enumerate(scene.object_labels):
                Lc = np.linalg.inv(pose_matrix(scene.X_gt[k])) @ pose_matrix(scene.object_pose_at(k, i))
                ry = float(np.arctan2(Lc[0, 2], Lc[0, 0])) - np.pi / 2
                t = Lc[:3, 3]
                f.write(f"{k} {lab} 0 0 0 0 {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} {ry:.9f}\n")
    return out_dir
