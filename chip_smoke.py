#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`dynosam_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit (`nvcc`).  Phases, in order; any failure exits non-zero and prints
no result line:

1. card   -- `nvidia-smi` name and power limit, `torch.cuda.get_device_name`;
2. build  -- nvcc builds every kernel of the port (`dynosam_tpu_torch/csrc`)
             for sm_90a; prints the build seconds and ptxas' resource usage;
3. kernels -- each kernel (K1 LK level, K2 point sampler, K3 Shi-Tomasi
             response, K4 ORB orientation and steered BRIEF) at the
             frontend's main-path shapes on KITTI-sized rendered frames,
             held against its plain PyTorch version on the card within a
             stated tolerance, then timed with CUDA events beside its plain
             version, the library yardstick where one exists, and its bound.
             K1 is also held on slots within 10 px of the border and on
             slots whose warm start is off by more than its staged window's
             margin; K2 on float32, int32, bool and strided channels read in
             place, `valid=None` and a (C, H, W) tensor, and its main-path
             call forms (C=1 depth, the flow's two planes, depth + int32
             mask) are timed beside `grid_sample`; K3 also on noise at
             shapes off its tile (37x53, 5x1290, 400x7, 1x1); K4 also at
             1, 7 and 33 keypoints and on keypoints off the canvas, NaN
             and within 15 px of a level seam;
4. main path -- the frontend-only pipeline (`DynoPipeline`, use_backend
             False, Shi-Tomasi detector) on 12 rendered 1280x384 frames
             with 3 moving objects: frames/s over the steady frames, kernel
             launches per frame (fails unless K1, K2 and K3 launched on
             every steady frame), camera ATE against the renderer's ground
             truth (fails unless finite and <= 0.05 m) and the objects with
             a valid motion;
5. ORB path -- the same pipeline and frames with the ORB detector
             (`testing/scenes.py:kitti_orb_config`): the same report; fails
             unless K4, K1 and K2 launched on every steady frame and K3 on
             none, or the ATE is above 0.05 m;
6. pipeline path -- the offline pipeline with the sliding-window backend
             (`throughput.make_offline_runner`, `kitti_pipeline_config`:
             window 10, overlap 4, 7 LM iterations) over 22 rendered frames
             of the same scene (4 + 3 segments of 6: three window solves,
             two warm-started from the previous write-back): ms per frame
             and frames/s, each window's solve time between CUDA events,
             LM iterations, initial and final error, host reads (counted
             by PyTorch's sync debug mode) and objects with an active
             motion; fails unless K1, K2 and K3 launched on every frame
             after the first and K4 on none, every window's final error is
             finite and below its initial error, the estimate store covers
             frames 0..21 and the backend camera ATE is under 0.06 m;
7. golden  -- the round's accuracy bar on the card: the golden scene of
             `tests/test_accuracy_regression.py` (32 frames 120x160, 2
             moving objects, 0.5 px flow and 1 % depth noise) through
             `pipeline.run_and_log` with the full-batch backend (one LM-PCG
             solve over 32 frames) and the port's `evaluate_all`: every
             frontend band (`:123-134`), the backend bands and the 0.8x
             object-improvement check (`:137-152`), and the sliding-vs-batch
             ordering (`:155-163`, sliding windows through
             `run_from_packets`); prints the full-batch solve's time (CUDA
             events), LM iterations, CG iterations per LM iteration and host
             reads; fails unless K1, K2 and K3 launched on every frame after
             the first;
8. online -- the default-config online pipeline at KITTI width, as a CLI
             user runs it: `run_and_log` (`DynoPipeline` with `RGBDBackend`,
             `BackendConfig()`: window 10, overlap 4, 30 LM iterations,
             `max_frames` 512) over the 22 frames of the pipeline path, then
             `evaluate_all`: ms per spin and each window's solve time, LM
             iterations and host reads from that run, and frames/s end to
             end (spins and `finish`) from a second, unprobed run; fails
             unless the windows
             start at 0, 6, 12 and (the final partial window) 18, every
             window's final error is below its initial error, the frontend
             and backend camera ATE are under 0.05 and 0.06 m, and K1, K2
             and K3 launched on every frame after the first and K4 on none;
9. world pose -- the online phase's run with WorldPose (`backend_updater_enum`
             1) and the fixed-lag boundary prior: the same report plus
             each boundary-prior build's time and host reads; fails unless
             the windows are those of the online phase, every error drops,
             the backend log is `rgbd_LL_world_backend` with camera ATE
             under 0.06 m, and K1-K3 launched on every frame after the first;
10. batched -- the offline pipeline with `opt_windows_per_dispatch` 2 over
             the first 16 frames of the pipeline path's scene (windows 0
             and 6 in one dispatch): ms per dispatch, LM iterations and host
             reads per window; the same packets replayed through a
             sequential runner give the windows' sequential reads; fails
             unless the batched store's masks equal the sequential store's
             and its camera translations are within twice the later
             window's anchor shift plus BATCHED_TOL_M of them, and K1-K3
             launched on every frame after the first.

The golden phase also runs drift recovery (`tests/test_accuracy_regression.py:166-228`)
for both updaters: the golden packets with a growing camera drift through
the full-batch backend, 100 LM iterations allowed; it fails unless each
recovered ATE is below the corrupted ATE / 1.8 and 0.11 m (JAX's bounds).

Launch counts are set to 0 just before each path and read just after it.

The first line is the card's name and power limit as `nvidia-smi` gives
them; the line before the last is a JSON object with one entry per kernel,
the last line `{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks at the full 700 W (NVIDIA data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# Tolerances of each kernel against its plain version on the same inputs.
LK_TOL_PX = 0.05       # flow; the eps stop may fall one step apart
LK_TOL_ERR = 0.1       # mean |residual| in grey levels, same reason
PS_TOL_REL = 1e-5      # bilinear samples, relative to max |value|
RESP_TOL_REL = 1e-5    # response, relative to max |response|
# K4: the plain version repeats the kernel's float32 arithmetic in its
# order, so only atan2's last place may differ; descriptor bits may flip
# only where a tap pair is tied to that last place
ORB_TOL_ANGLE = 1e-5   # rad
ORB_MIN_BITS = 0.999   # share of descriptor bits that agree
ATE_LIMIT_M = 0.05
BACKEND_ATE_LIMIT_M = 0.06   # the JAX sliding-window band (tests/test_accuracy_regression.py:162)
PIPELINE_FRAMES = 22         # overlap 4 + 3 segments of stride 6
# the golden bands (tests/test_accuracy_regression.py:123-163)
GOLDEN_FRONTEND = {"ate_trans_rmse": 0.010, "rpe_trans_rmse": 0.004, "rpe_rot_deg_rmse": 0.03}
GOLDEN_FRONTEND_OBJECTS = {"ame_trans_rmse": 0.30, "ame_rot_deg_rmse": 3.0, "rme_trans_rmse": 0.08}
GOLDEN_BACKEND_ATE_M = 0.022
GOLDEN_BACKEND_AME_M = 0.15
GOLDEN_IMPROVEMENT = 0.8     # backend AME (both parts) below 0.8x the frontend's
GOLDEN_SLIDING_ATE_M = 0.06
GOLDEN_ORDERING = 1.10       # full-batch ATE at most 1.10x the sliding windows'
# drift recovery (tests/test_accuracy_regression.py:166-228): the drift per
# frame (rotation, translation tangent) and JAX's bounds
DRIFT_PER_FRAME = (0.0, 0.0015, 0.0, 0.02, 0.008, 0.0)
DRIFT_FACTOR = 1.8           # recovered ATE below the corrupted ATE / 1.8
DRIFT_ATE_M = 0.11
# batched windows against the sequential run: the later window of a
# dispatch warm-starts and anchors on the store as it stood before the
# dispatch (there: the frontend pose of its first frame), not on the
# previous window's estimate, so the window moves with the difference
# between the two anchors; the stores may differ by twice that shift plus
# BATCHED_TOL_M for the LM's stopping tolerance
BATCHED_TOL_M = 1e-4
BATCHED_FRAMES = 16          # overlap 4 + 2 segments of 6: one dispatch of 2 windows

# FLOPs counted per unit of work (adds, subtracts, multiplies, divides,
# square roots; clamps and index arithmetic not counted).
FLOP_BILINEAR = 13     # 2 weight complements, 8 products, 3 sums
FLOP_LK_GRAD = 10      # 2 differences, 2 halvings, 3 products, 3 sums
FLOP_LK_STEP = 18      # bilinear sample, residual, 2 multiply-adds
FLOP_LK_SOLVE = 12     # 2x2 solve and clamp of one step
FLOP_LK_ERR = 15       # bilinear sample, residual, abs-add
FLOP_RESPONSE = 100    # Sobel 2x11, 3 products, 3x24 box sums, 3 divides, lambda_min 9
FLOP_ORB_MOMENT = 4    # per disc pixel: 2 products, 2 sums
FLOP_ORB_KEYPOINT = 6  # r (2 products, 1 sum, 1 root), ca and sa (2 divides); atan2 not counted
FLOP_ORB_TAP = 8 + FLOP_BILINEAR   # rotation (4 products, 4 sums), bilinear sample

# the kernels of each path, and each kernel's name in `kernels.launch_counts()`
PATH_KERNELS = {"shi_tomasi": ("lk", "point_sample", "response"),
                "orb": ("orb_sample", "lk", "point_sample"),
                "pipeline": ("lk", "point_sample", "response"),
                "golden": ("lk", "point_sample", "response"),
                "online": ("lk", "point_sample", "response"),
                "world_pose": ("lk", "point_sample", "response"),
                "batched": ("lk", "point_sample", "response")}
COUNTER = {"lk_level": "lk", "point_sample": "point_sample",
           "shi_tomasi_response": "response", "orb_orientation_descriptors": "orb_sample"}


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    _require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds of `fn` over `reps` back-to-back calls, between two
    CUDA events on the current stream, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flop / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def distinct_taps(torch, x, y, h: int, w: int) -> int:
    """Distinct pixels that border-clamped bilinear samples at (x, y) read
    (the 2x2 taps of each sample, as `kernels/point_sample.py:bilinear_gather`);
    x and y broadcast against each other."""
    x, y = torch.broadcast_tensors(x, y)
    x = x.reshape(-1).clamp(0, w - 1)
    y = y.reshape(-1).clamp(0, h - 1)
    x0, y0 = x.floor().long(), y.floor().long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    return int(torch.cat([y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1]).unique().numel())


# ------------------------------------------------------------------ kernels
def check_lk(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import lk
    from dynosam_tpu_torch.ops.klt import flow_at

    f0, f1 = frames[0], frames[1]
    h, w = f0.gray.shape
    n, win, iters, eps = 2048, 21, 10, 0.01
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.uniform([12, 12], [w - 12, h - 12], (n, 2)).astype(np.float32), device=device)
    valid = torch.as_tensor(rng.random(n) < 1000 / n, device=device)
    g0 = flow_at(f0.flow, p, valid)           # warm start from dense flow
    # two more groups, held at the same tolerances: slots within 10 px of
    # an edge (a quarter on each), whose windows leave the image; and slots
    # whose warm start is off by 6-9 px, more than the 4 px margin of the
    # kernel's staged window of `cur`, so their steps leave it
    nb = 256
    side, t, d = rng.integers(0, 4, nb), rng.uniform(0, 1, nb), rng.uniform(0, 10, nb)
    xb = np.where(side == 0, d, np.where(side == 1, w - 1 - d, t * (w - 1)))
    yb = np.where(side == 2, d, np.where(side == 3, h - 1 - d, t * (h - 1)))
    pb = torch.as_tensor(np.stack([xb, yb], -1).astype(np.float32), device=device)
    po = torch.as_tensor(rng.uniform([40, 40], [w - 40, h - 40], (nb, 2)).astype(np.float32), device=device)
    ang, rad = rng.uniform(0, 2 * np.pi, nb), rng.uniform(6, 9, nb)
    off = torch.as_tensor(np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1).astype(np.float32), device=device)
    every = torch.ones(nb, dtype=torch.bool, device=device)
    groups = (("main", p, g0, valid), ("border", pb, flow_at(f0.flow, pb), every),
              ("warm start off the tile", po, flow_at(f0.flow, po) + off, every))
    dg = de = 0.0
    for name, pp, gg, vv in groups:
        g_k, e_k = lk.lk_level(f0.gray, f1.gray, pp, gg, vv, win, iters, eps)
        g_p, e_p = lk.lk_level_plain(f0.gray, f1.gray, pp, gg, vv, win, iters, eps)
        torch.cuda.synchronize()
        dgi = float((g_k - g_p).abs().max())
        dei = float((e_k - e_p).abs().max())
        print(f"K1 lk_level {name}: {int(vv.sum())} of {pp.shape[0]} slots active, win {win}, {iters} iters, "
              f"eps {eps}: max |dg| {dgi:.3g} px (tol {LK_TOL_PX}), max |derr| {dei:.3g} (tol {LK_TOL_ERR}), "
              f"max |g - g0| {float((g_p - gg)[vv].abs().max()):.3g} px", flush=True)
        _require(np.isfinite(dgi) and dgi <= LK_TOL_PX, f"K1 {name} disagrees with its plain version: {dgi}")
        _require(np.isfinite(dei) and dei <= LK_TOL_ERR, f"K1 {name} error disagrees: {dei}")
        dg, de = max(dg, dgi), max(de, dei)

    g_k, _ = lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
    _, _, steps = lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps, return_iters=True)
    ms = cuda_ms(torch, lambda: lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps), reps)
    plain_ms = cuda_ms(torch, lambda: lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps),
                       max(reps // 20, 3), warmup=1)
    n_act = int(valid.sum())
    total_steps = int(steps.sum())
    flop = (n_act * ((win + 2) ** 2 * FLOP_BILINEAR + win * win * (FLOP_LK_GRAD + FLOP_LK_ERR))
            + total_steps * (win * win * FLOP_LK_STEP + FLOP_LK_SOLVE))
    # bytes this call's data needs: the distinct prev pixels under the
    # (win+2)^2 template taps at p, the distinct cur pixels under the win^2
    # taps at the final p+g, p of the active slots, valid and g0 of all
    # slots, and the outputs g and err
    r = win // 2
    o_t = torch.arange(-r - 1, r + 2, device=device, dtype=torch.float32)
    o_c = torch.arange(-r, r + 1, device=device, dtype=torch.float32)
    pa, ga = p[valid], g_k[valid]
    prev_px = distinct_taps(torch, pa[:, 0, None, None] + o_t[None, None, :],
                            pa[:, 1, None, None] + o_t[None, :, None], h, w)
    q = pa + ga
    cur_px = distinct_taps(torch, q[:, 0, None, None] + o_c[None, None, :],
                           q[:, 1, None, None] + o_c[None, :, None], h, w)
    nbytes = (prev_px + cur_px) * 4 + n_act * 8 + n * (1 + 8) + n * (8 + 4)
    b_ms, b_by = bound_ms(nbytes, flop)
    return dict(name="lk_level", route="cuda", source="dynosam_tpu_torch/csrc/lk.cu",
                replaces="dynosam_tpu/ops/pallas/lk.py:873", max_abs_err=dg,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                note=f"timed on the main group: {total_steps} Gauss-Newton steps over {n_act} active slots; "
                     f"{prev_px} prev and {cur_px} cur pixels read; max |derr| {de:.3g} over all groups")


def check_point_sample(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import point_sample as ps

    f = frames[1]
    h, w = f.gray.shape
    n = 6144
    rng = np.random.default_rng(2)
    uv = torch.as_tensor(rng.uniform([-2, -2], [w + 1, h + 1], (n, 2)).astype(np.float32), device=device)
    valid = torch.as_tensor(rng.random(n) >= 0.3, device=device)
    depth, mask = f.depth, f.mask               # float32 and int32, read in place
    flow = f.flow.unbind(-1)                    # the (H, W, 2) field's two strided planes
    forbid = mask != 0                          # bool
    B, NN = "bilinear", "nearest"
    cases = (
        ("C=1 float32 bilinear", (depth,), (B,), valid),
        ("C=1 int32 nearest", (mask,), (NN,), valid),
        ("C=1 bool nearest", (forbid,), (NN,), None),
        ("flow: 2 strided planes", flow, (B, B), valid),
        ("depth + int32 mask", (depth, mask), (B, NN), valid),
        ("8 channels: float32, int32, bool and strided, both modes",
         (depth, mask, mask, forbid, forbid, flow[0], flow[1], depth), (B, NN, B, NN, B, B, B, NN), valid),
        ("(C, H, W) tensor", torch.stack([depth, f.gray]), (B, NN), valid),
    )
    worst = 0.0
    for name, chans, modes, vv in cases:
        before = ps.launches
        got = ps.point_sample(chans, uv, modes, vv)
        _require(ps.launches == before + 1, f"K2 {name}: the launch count rose by {ps.launches - before}")
        want = ps.point_sample_plain(chans, uv, modes, vv)
        torch.cuda.synchronize()
        _require(got.shape == (n, len(modes)) and got.dtype == torch.float32, f"K2 {name}: shape {got.shape}")
        d_near, d_rel = 0.0, 0.0
        for c, m in enumerate(modes):
            d = float((got[:, c] - want[:, c]).abs().max())
            if m == NN:
                d_near = max(d_near, d)
            else:
                d_rel = max(d_rel, d / max(float(want[:, c].abs().max()), 1e-9))
                worst = max(worst, d)
        rows0 = True if vv is None else bool((got[~vv] == 0).all())
        print(f"K2 point_sample {name}: N {n}, {0 if vv is None else int((~vv).sum())} invalid rows: "
              f"nearest max |d| {d_near:.3g} (tol 0), bilinear max |d| / max |value| {d_rel:.3g} "
              f"(tol {PS_TOL_REL}), invalid rows 0: {rows0}", flush=True)
        _require(d_near == 0.0, f"K2 {name}: nearest samples differ: {d_near}")
        _require(np.isfinite(d_rel) and d_rel <= PS_TOL_REL, f"K2 {name}: bilinear samples disagree: {d_rel}")
        _require(rows0, f"K2 {name}: invalid rows not zero")

    ms = cuda_ms(torch, lambda: ps.point_sample((depth,), uv, (B,), valid), reps)
    plain_ms = cuda_ms(torch, lambda: ps.point_sample_plain((depth,), uv, (B,), valid), reps)
    # library yardstick: grid_sample on normalised coordinates (align_corners
    # maps -1/+1 to the first/last pixel centre; border padding clamps)
    grid = torch.stack([uv[:, 0] / (w - 1) * 2 - 1, uv[:, 1] / (h - 1) * 2 - 1], dim=-1)[None, None]
    depth4 = depth[None, None]
    lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        depth4, grid, mode="bilinear", padding_mode="border", align_corners=True)
    lib_d = float((lib()[0, 0, 0] * valid - ps.point_sample_plain((depth,), uv, (B,), valid)[:, 0]).abs().max())
    library_ms = cuda_ms(torch, lib, reps)
    # the main path's other two call forms, timed beside it
    flow_ms = cuda_ms(torch, lambda: ps.point_sample(flow, uv, (B, B), valid), reps)
    pair_ms = cuda_ms(torch, lambda: ps.point_sample((depth, mask), uv, (B, NN), valid), reps)
    # bytes this call's data needs: the distinct pixels its valid rows touch,
    # the valid rows' coordinates (an invalid row reads only its mask), the
    # mask and the output
    n_valid = int(valid.sum())
    taps = distinct_taps(torch, uv[valid, 0], uv[valid, 1], h, w)
    nbytes = taps * 4 + n_valid * 8 + n + n * 4
    flop = n_valid * FLOP_BILINEAR
    b_ms, b_by = bound_ms(nbytes, flop)
    print(f"K2 grid_sample yardstick agrees to {lib_d:.3g}; per call: C=1 depth {ms * 1e3:.2f} us, "
          f"grid_sample {library_ms * 1e3:.2f} us ({'at or under' if ms <= library_ms else 'ABOVE'} it), "
          f"flow (2 strided planes) {flow_ms * 1e3:.2f} us, depth + int32 mask {pair_ms * 1e3:.2f} us", flush=True)
    return dict(name="point_sample", route="cuda", source="dynosam_tpu_torch/csrc/point_sample.cu",
                replaces="dynosam_tpu/ops/pallas/point_sample.py:136", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                ms_flow=flow_ms, ms_depth_mask=pair_ms,
                note=f"timed at N 6144, C 1 (depth), bilinear; {taps} pixels read")


def check_response(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import response

    g = frames[1].gray
    h, w = g.shape
    # the KITTI frame, then uniform noise on shapes that are no multiple of
    # the kernel's tile (28 columns by 32 rows a block), down to one pixel
    rng = np.random.default_rng(3)
    cases = [("KITTI frame", g)] + [
        ("noise", torch.as_tensor(rng.uniform(0, 255, shp).astype(np.float32), device=device))
        for shp in ((37, 53), (5, 1290), (400, 7), (1, 1))]
    worst = 0.0
    for label, img in cases:
        got = response.shi_tomasi_response(img)
        want = response.shi_tomasi_response_plain(img)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        rel = d / max(float(want.abs().max()), 1e-9)
        print(f"K3 shi_tomasi_response {label} {img.shape[0]}x{img.shape[1]}: max |d| {d:.3g} (rel to "
              f"max |response| {rel:.3g}, tol {RESP_TOL_REL})", flush=True)
        _require(np.isfinite(rel) and rel <= RESP_TOL_REL,
                 f"K3 disagrees with its plain version on {img.shape[0]}x{img.shape[1]}: {rel}")
        worst = max(worst, d)
    ms = cuda_ms(torch, lambda: response.shi_tomasi_response(g), reps)
    plain_ms = cuda_ms(torch, lambda: response.shi_tomasi_response_plain(g), max(reps // 10, 3))
    b_ms, b_by = bound_ms(2 * h * w * 4, h * w * FLOP_RESPONSE)
    return dict(name="shi_tomasi_response", route="cuda", source="dynosam_tpu_torch/csrc/response.cu",
                replaces="dynosam_tpu/ops/pallas/response.py:83", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


def check_orb_sample(torch, frames, device, reps):
    from dynosam_tpu_torch.frontend.orb import orb_pyramid
    from dynosam_tpu_torch.kernels import orb_sample as k4
    from dynosam_tpu_torch.ops.clahe import clahe
    from dynosam_tpu_torch.testing.scenes import kitti_orb_config

    # the main path's call: the 8-level canvas of a CLAHE'd KITTI frame and
    # the keypoints the extractor selects on it
    tc = kitti_orb_config().frontend.tracker
    det = clahe(frames[1].gray, n_bins=tc.clahe_bins)
    pyr = orb_pyramid(det, tc.max_nr_keypoints_before_anms, tc.orb_n_levels, tc.orb_scale_factor,
                      float(tc.orb_init_threshold_fast), float(tc.orb_min_threshold_fast))
    raw, blur, uv = pyr.canvas_raw, pyr.canvas_blur, pyr.canvas_uv
    hc, wc = raw.shape
    n = uv.shape[0]
    n_valid = int(sum(int(b[4].sum()) for b in pyr.blocks))
    # the rows where one level of the canvas ends and the next begins
    h0 = frames[1].gray.shape[0]
    heights = [max(int(round(h0 / tc.orb_scale_factor ** lvl)), 1)
               for lvl, b in enumerate(pyr.blocks) if b[5]]
    _require(sum(heights) == hc, f"K4: level heights {heights} do not make the {hc}-row canvas")
    seams = np.cumsum(heights)[:-1]
    # the main path's call, then keypoint counts that fill no block of the
    # kernel (4 keypoints a block), then keypoints off the canvas, NaN and
    # within 15 px of a level seam (their discs and windows cross it)
    rng = np.random.default_rng(4)
    sy = np.repeat(seams, 8) + rng.uniform(-15, 15, 8 * len(seams))
    edge = np.concatenate([
        np.stack([rng.uniform(0, wc - 1, sy.size), sy], -1),
        [[-40.0, 3.0], [wc + 5.0, hc + 9.0], [-3.0, hc + 30.0], [0.0, 0.0], [wc - 1.0, hc - 1.0],
         [np.nan, 20.0], [30.0, np.nan], [np.nan, np.nan]]]).astype(np.float32)
    groups = (("main path", uv), ("N 1", uv[:1]), ("N 7", uv[:7]), ("N 33", uv[:33]),
              ("off the canvas, NaN and near the level seams", torch.as_tensor(edge, device=device)))
    da = 0.0
    for label, u in groups:
        ang, desc = k4.orb_orientation_descriptors(raw, blur, u)
        ang_p, desc_p = k4.orb_orientation_descriptors_plain(raw, blur, u)
        torch.cuda.synchronize()
        d = (ang - ang_p).abs()
        dai = float(torch.minimum(d, 2 * np.pi - d).max())
        bits = float((desc == desc_p).float().mean())
        pm = bool(((desc == 1) | (desc == -1)).all())
        print(f"K4 orb_orientation_descriptors {label}: canvas {hc}x{wc} ({len(heights)} levels), "
              f"{u.shape[0]} keypoints ({n_valid} valid on the main path): max |dangle| {dai:.3g} rad "
              f"(tol {ORB_TOL_ANGLE}), bits agree {bits:.6f} (min {ORB_MIN_BITS}), all bits +-1 {pm}", flush=True)
        _require(np.isfinite(dai) and dai <= ORB_TOL_ANGLE, f"K4 {label}: angles disagree with its plain version: {dai}")
        _require(bits >= ORB_MIN_BITS, f"K4 {label}: descriptors disagree with its plain version: {bits}")
        _require(pm and bool(torch.isfinite(ang).all()), f"K4 {label}: output not finite or not +-1")
        da = max(da, dai)
        if label == "main path":
            main = ang, bits
    ang, bits = main

    ms = cuda_ms(torch, lambda: k4.orb_orientation_descriptors(raw, blur, uv), reps)
    plain_ms = cuda_ms(torch, lambda: k4.orb_orientation_descriptors_plain(raw, blur, uv), max(reps // 10, 3))
    # bytes this call's data needs: the distinct raw pixels under the discs
    # (offsets with a non-zero weight), the distinct blurred pixels under the
    # bilinear taps, the 512 pattern taps, uv in, angle and desc out
    r = 15
    oy, ox = torch.meshgrid(torch.arange(-r, r + 1, device=device), torch.arange(-r, r + 1, device=device),
                            indexing="ij")
    disc = ((ox * ox + oy * oy) <= r * r) & ((ox != 0) | (oy != 0))
    ox, oy = ox[disc].float(), oy[disc].float()
    xs = (uv[:, 0:1].round() + ox[None]).clamp(0, wc - 1).long()
    ys = (uv[:, 1:2].round() + oy[None]).clamp(0, hc - 1).long()
    raw_px = int((ys * wc + xs).unique().numel())
    taps = torch.as_tensor(k4.TAPS, device=device)
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    tx = uv[:, 0:1] + ca * taps[None, :, 0] - sa * taps[None, :, 1]
    ty = uv[:, 1:2] + sa * taps[None, :, 0] + ca * taps[None, :, 1]
    blur_px = distinct_taps(torch, tx, ty, hc, wc)
    nbytes = (raw_px + blur_px) * 4 + taps.numel() * 4 + n * 8 + n * (4 + 256)
    flop = n * (int(disc.sum()) * FLOP_ORB_MOMENT + FLOP_ORB_KEYPOINT + 512 * FLOP_ORB_TAP)
    b_ms, b_by = bound_ms(nbytes, flop)
    return dict(name="orb_orientation_descriptors", route="cuda", source="dynosam_tpu_torch/csrc/orb_sample.cu",
                replaces="dynosam_tpu/ops/pallas/orb_sample.py:248", max_abs_err=da,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                note=f"{n} keypoints on a {hc}x{wc} canvas; {raw_px} raw and {blur_px} blurred pixels read; "
                     f"bits agree {bits:.6f}")


# ---------------------------------------------------------------- main path
def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Camera ATE (m): RMSE of positions after one Umeyama SE(3) fit of the
    estimated positions onto the ground truth (evo's APE with -a)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    u, _, vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e) / est.shape[0])
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    aligned = est @ r.T + (mu_g - r @ mu_e)
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def run_main_path(torch, scene, frames, cfg, device):
    """Drive the frontend-only pipeline over `frames`; returns the summary
    and the per-frame kernel launches.  Launch counts are zeroed just
    before the pipeline starts and read just after each frame."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.pipeline import DynoPipeline

    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    pipe = DynoPipeline(scene.cam, cfg, device=device)
    kernels.reset_launch_counts()
    per_frame, times, prev = [], [], kernels.launch_counts()
    for f in frames:
        sync()
        t0 = time.perf_counter()
        pipe.spin_once(f)
        sync()
        times.append(time.perf_counter() - t0)
        now = kernels.launch_counts()
        per_frame.append({k: now[k] - prev[k] for k in now})
        prev = now
    totals = kernels.launch_counts()
    packets = pipe.packets
    est = np.stack([p.X_world.t.double().cpu().numpy() for p in packets])
    gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:len(packets)]])
    n_motion = [int(p.objects.motion_valid.sum()) for p in packets]
    finite = all(bool(torch.isfinite(p.X_world.t).all() and torch.isfinite(p.X_world.R).all())
                 for p in packets)
    return dict(per_frame=per_frame, totals=totals, times=times, ate=ate_rmse(est, gt),
                finite=finite, n_motion=n_motion,
                n_static=[int(p.static_obs.valid.sum()) for p in packets])


def report_path(res, label, required, frames, card) -> None:
    """Print one path's frames/s, launches, observations and ATE; fail
    unless each `required` kernel launched on every steady frame, every
    other kernel on none, and the ATE is finite and within the limit."""
    n_frames = len(frames)
    h, w = frames[0].gray.shape
    steady = list(range(2, n_frames))
    dt = sum(res["times"][k] for k in steady)
    print(f"{label}: frontend-only pipeline, {n_frames} frames {w}x{h}; steady frames "
          f"{steady[0]}..{steady[-1]}: {len(steady) / dt:.2f} frames/s, "
          f"{dt / len(steady) * 1e3:.1f} ms/frame (host clock, synchronised) on {card}", flush=True)
    print(f"{label}: ms per frame {[round(t * 1e3, 1) for t in res['times']]}", flush=True)
    for k, lf in enumerate(res["per_frame"]):
        print(f"{label}: frame {k} launches {lf} static obs {res['n_static'][k]} "
              f"objects with motion {res['n_motion'][k]}", flush=True)
    for k in range(1, n_frames):
        missing = [n for n in required if res["per_frame"][k][n] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [n for n, c in res["totals"].items() if n not in required and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")
    print(f"{label}: camera ATE {res['ate']:.5f} m (limit {ATE_LIMIT_M})", flush=True)
    _require(res["finite"], f"{label}: camera poses are not finite")
    _require(np.isfinite(res["ate"]) and res["ate"] <= ATE_LIMIT_M, f"{label}: ATE {res['ate']} m")


class SyncCounter:
    """Counts the host synchronisations PyTorch reports in its sync debug
    mode ("warn": one warning per synchronising call) inside the block."""

    def __init__(self, torch):
        self.torch = torch
        self.count = 0

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._log = self._catch.__enter__()
        warnings.simplefilter("always")
        self._mode = self.torch.cuda.get_sync_debug_mode()
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(self._mode)
        self.count = sum("synchroniz" in str(w.message) for w in self._log)
        self._catch.__exit__(*exc)
        return False


def run_pipeline_path(torch, device, card) -> dict:
    """Drive the offline pipeline (frontend every frame, window solve every
    6 frames) over PIPELINE_FRAMES rendered frames; launch counts are
    zeroed just before the run and read after each frame."""
    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.testing.scenes import kitti_pipeline_config, kitti_scene
    from dynosam_tpu_torch.throughput import make_offline_runner

    n = PIPELINE_FRAMES
    scene, frames = kitti_scene(device, n_frames=n)
    runner = make_offline_runner(scene.cam, kitti_pipeline_config(n), n, device=device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    per_frame, times, reads = [], [], []
    for f in frames:
        t0 = time.perf_counter()
        runner.frontend(f)
        start = runner.window_due()
        if start is not None:
            with SyncCounter(torch) as sc:
                runner.solve(start)
            reads.append(sc.count)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        now = kernels.launch_counts()
        per_frame.append({k: now[k] - prev[k] for k in now})
        prev = now
    totals = kernels.launch_counts()
    out = runner.result()
    label = "pipeline path"
    h, w = frames[0].gray.shape
    print(f"{label}: frontend + window-10 backend, {n} frames {w}x{h}: {n / sum(times):.2f} frames/s, "
          f"{sum(times) / n * 1e3:.1f} ms/frame over all {n} frames (host clock, synchronised) on {card}",
          flush=True)
    print(f"{label}: ms per frame {[round(t * 1e3, 1) for t in times]}", flush=True)
    for k, lf in enumerate(per_frame):
        print(f"{label}: frame {k} launches {lf}", flush=True)
    _require(len(out.windows) == 3, f"{label}: {len(out.windows)} window solves, not 3")
    for win, n_reads in zip(out.windows, reads):
        r = win.result
        err0, err = float(r.initial_error), float(r.error)
        n_motion = int(win.masks.motion_active.any(0).sum())
        print(f"{label}: window [{win.start}, {win.start + 10}): solve {win.solve_ms():.2f} ms (CUDA events), "
              f"{r.iterations} LM iterations, error {err0:.6g} -> {err:.6g}, host reads {n_reads} "
              f"(the LM reads once per iteration: {r.iterations}), objects with an active motion {n_motion} "
              f"on {card}", flush=True)
        _require(np.isfinite(err) and err < err0, f"{label}: window {win.start} error {err0} -> {err}")
    for k in range(1, n):
        missing = [name for name in PATH_KERNELS["pipeline"] if per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [name for name, c in totals.items() if name not in PATH_KERNELS["pipeline"] and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")
    est = out.est
    _require(bool(est.X_valid[:n].all()), f"{label}: the estimate store misses frames {est.X_valid[:n]}")
    X = est.X.t[:n].double().cpu().numpy()
    _require(bool(np.isfinite(X).all()), f"{label}: backend poses are not finite")
    gt = np.stack([x.t.double().cpu().numpy() for x in scene.X_gt[:n]])
    fe = np.stack([p.X_world.t.double().cpu().numpy() for p in out.packets])
    ate, fe_ate = ate_rmse(X, gt), ate_rmse(fe, gt)
    print(f"{label}: backend camera ATE {ate:.5f} m (limit {BACKEND_ATE_LIMIT_M}), frontend {fe_ate:.5f} m",
          flush=True)
    _require(np.isfinite(ate) and ate < BACKEND_ATE_LIMIT_M, f"{label}: backend ATE {ate} m")
    return dict(totals=totals)


class PipelineProbe:
    """For one run of the online pipeline: times each `DynoPipeline.spin_once`
    on the host clock between two synchronisations and reads the kernel
    launches after it, counts the host reads of each backend solve
    (`RGBDBackend._optimize`) with `SyncCounter`, and times each fixed-lag
    prior build (`RGBDBackend._slide_prior`, synchronised before and after)
    and counts its reads apart from its solve's.  Launch counts are zeroed
    on entry and read on exit."""

    def __init__(self, torch):
        self.torch = torch
        self.times, self.per_frame, self.reads, self.priors = [], [], [], []

    def __enter__(self):
        from dynosam_tpu_torch import kernels
        from dynosam_tpu_torch.backend.backend import RGBDBackend
        from dynosam_tpu_torch.pipeline import DynoPipeline

        torch, probe = self.torch, self
        self._kernels, self._classes = kernels, (DynoPipeline, RGBDBackend)
        self._spin, self._optimize = DynoPipeline.spin_once, RGBDBackend._optimize
        self._prior = RGBDBackend._slide_prior

        def spin_once(pipe, images):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            out = probe._spin(pipe, images)
            torch.cuda.synchronize()
            probe.times.append(time.perf_counter() - t0)
            now = kernels.launch_counts()
            probe.per_frame.append({k: now[k] - before[k] for k in now})
            return out

        def optimize(backend, start, window):
            with SyncCounter(torch) as sc:
                probe._optimize(backend, start, window)
            probe.reads.append(sc.count)

        def slide_prior(backend, start):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with SyncCounter(torch) as sc:
                out = probe._prior(backend, start)
            torch.cuda.synchronize()
            probe.priors.append((start, (time.perf_counter() - t0) * 1e3, sc.count))
            return out

        DynoPipeline.spin_once, RGBDBackend._optimize = spin_once, optimize
        RGBDBackend._slide_prior = slide_prior
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.totals = self._kernels.launch_counts()
        self._classes[0].spin_once, self._classes[1]._optimize = self._spin, self._optimize
        self._classes[1]._slide_prior = self._prior
        return False


def check_launches(probe, label, required, n_frames) -> None:
    for k in range(1, n_frames):
        missing = [name for name in required if probe.per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")
    stray = [name for name, c in probe.totals.items() if name not in required and c > 0]
    _require(not stray, f"{label}: kernels {stray} launched off their path")


def report_solves(label, backend, reads, card) -> None:
    """Print each backend solve: window, time (CUDA events), LM and CG
    iterations, error and host reads; fail unless every error dropped."""
    for (start, window, r, events), n_reads in zip(backend.solves, reads):
        err0, err = float(r.initial_error), float(r.error)
        cg = "" if r.cg_iterations is None else f", CG iterations per LM iteration {r.cg_iterations}"
        print(f"{label}: solve [{start}, {start + window}): {events[0].elapsed_time(events[1]):.2f} ms (CUDA "
              f"events), {r.iterations} LM iterations{cg}, error {err0:.6g} -> {err:.6g}, host reads {n_reads} "
              f"on {card}", flush=True)
        _require(np.isfinite(err) and err < err0, f"{label}: solve at {start}: error {err0} -> {err}")


def run_golden_phase(torch, device, card) -> dict:
    """The golden run on the card, held to every band of
    `tests/test_accuracy_regression.py:123-163` by the port's evaluator."""
    import tempfile

    from dynosam_tpu_torch.eval import metrics
    from dynosam_tpu_torch.eval.evaluator import evaluate_all
    from dynosam_tpu_torch.pipeline import run_and_log, run_from_packets
    from dynosam_tpu_torch.testing.scenes import GOLDEN_FRAMES, golden_config, golden_dataset

    label = "golden"
    ds = golden_dataset(device)
    with tempfile.TemporaryDirectory() as out:
        with PipelineProbe(torch) as probe:
            result = run_and_log(ds, golden_config(True), out, device=device)
        evals = evaluate_all(out)
    n = GOLDEN_FRAMES
    print(f"{label}: {n} frames 160x120 through run_and_log with the full-batch backend: frontend "
          f"{n / sum(probe.times):.2f} frames/s (host clock, synchronised) on {card}", flush=True)
    check_launches(probe, label, PATH_KERNELS["golden"], n)
    backend = result.backend
    _require([(s, w) for s, w, _, _ in backend.solves] == [(0, n)],
             f"{label}: solves {[(s, w) for s, w, _, _ in backend.solves]}, not one full batch")
    report_solves(label, backend, probe.reads, card)

    fe, be = evals["frontend"], evals["rgbd_motion_world_backend"]
    checks = [(f"frontend camera {k}", fe["camera"][k], lim) for k, lim in GOLDEN_FRONTEND.items()]
    checks += [(f"frontend objects {k}", fe["objects_mean"][k], lim) for k, lim in GOLDEN_FRONTEND_OBJECTS.items()]
    checks += [("backend camera ate_trans_rmse", be["camera"]["ate_trans_rmse"], GOLDEN_BACKEND_ATE_M),
               ("backend objects ame_trans_rmse", be["objects_mean"]["ame_trans_rmse"], GOLDEN_BACKEND_AME_M)]
    for k in ("ame_trans_rmse", "ame_rot_deg_rmse"):
        checks.append((f"backend {k} / frontend's", be["objects_mean"][k] / fe["objects_mean"][k], GOLDEN_IMPROVEMENT))

    be_sw = run_from_packets(result.packets, golden_config(False), device=device)
    X, xv = be_sw.camera_poses()
    xv = xv.cpu().numpy()
    T = np.tile(np.eye(4), (int(xv.sum()), 1, 1))
    T[:, :3, :3] = X.R.double().cpu().numpy()[xv]
    T[:, :3, 3] = X.t.double().cpu().numpy()[xv]
    gt = np.stack([ds.ground_truth(k).X_world for k in range(n)])[xv]
    sw_ate = metrics.ate(T, gt)["trans"].rmse
    fb_ate = be["camera"]["ate_trans_rmse"]
    checks += [("sliding-window camera ATE", sw_ate, GOLDEN_SLIDING_ATE_M),
               ("full-batch ATE / sliding ATE", fb_ate / sw_ate, GOLDEN_ORDERING)]
    for name, value, limit in checks:
        ok = np.isfinite(value) and (value <= limit if "/ sliding" in name else value < limit)
        print(f"{label}: {name} {value:.5g} (limit {limit}): {'ok' if ok else 'FAIL'}", flush=True)
        _require(ok, f"{label}: {name} {value} against {limit}")
    print(f"{label}: sliding windows {[(s, w) for s, w, _, _ in be_sw.solves]}, each "
          f"{[r.iterations for _, _, r, _ in be_sw.solves]} LM iterations", flush=True)
    run_drift_recovery(torch, device, card, result.packets, np.stack([ds.ground_truth(k).X_world for k in range(n)]))
    return dict(totals=probe.totals)


def run_online_phase(torch, device, card, world_pose: bool = False) -> dict:
    """The default-config online pipeline at KITTI width through
    `run_and_log` and `evaluate_all`; with `world_pose`, under WorldPose
    (updater 1) with the fixed-lag boundary prior."""
    import dataclasses
    import tempfile

    from dynosam_tpu_torch.eval.evaluator import evaluate_all
    from dynosam_tpu_torch.pipeline import backend_log_prefix, run_and_log
    from dynosam_tpu_torch.testing.scenes import RenderedDataset, kitti_online_config, kitti_scene

    label = "world pose" if world_pose else "online"
    cfg = kitti_online_config()
    if world_pose:
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, backend_updater_enum=1,
                                                                   use_fixed_lag_prior=True))
    prefix = backend_log_prefix(cfg.backend.backend_updater_enum)
    n = PIPELINE_FRAMES
    scene, frames = kitti_scene(device, n_frames=n)
    with tempfile.TemporaryDirectory() as out:
        with PipelineProbe(torch) as probe:
            result = run_and_log(RenderedDataset(scene, frames), cfg, out, device=device)
        evals = evaluate_all(out)
    h, w = frames[0].gray.shape
    if not world_pose:
        # end to end: a second run timed by `DynoPipeline.run` itself, from
        # the first spin through `finish` (the final window's solve
        # included), synchronised once at the end and not after every spin
        # as the probe is
        with tempfile.TemporaryDirectory() as out:
            timed = run_and_log(RenderedDataset(scene, frames), cfg, out, device=device)
        print(f"{label}: DynoPipeline + RGBDBackend (default BackendConfig, max_frames 512), {n} frames {w}x{h}: "
              f"end to end {timed.fps:.2f} frames/s, {1e3 / timed.fps:.1f} ms/frame ({n} spins and finish, "
              f"DynoPipeline.run's host clock, a second run) on {card}", flush=True)
    steady = list(range(2, n))
    spin_s = sum(probe.times)
    print(f"{label}: per spin_once (host clock, synchronised before and after each; finish not included): "
          f"{spin_s / n * 1e3:.1f} ms mean over {n} spins, steady frames 2..{n - 1} "
          f"{sum(probe.times[k] for k in steady) / len(steady) * 1e3:.1f} ms mean; ms per spin "
          f"{[round(t * 1e3, 1) for t in probe.times]}", flush=True)
    for k, lf in enumerate(probe.per_frame):
        print(f"{label}: frame {k} launches {lf}", flush=True)
    check_launches(probe, label, PATH_KERNELS["world_pose" if world_pose else "online"], n)
    backend = result.backend
    starts = [(s, w_) for s, w_, _, _ in backend.solves]
    _require(starts == [(0, 10), (6, 10), (12, 10), (18, 10)], f"{label}: windows {starts}")
    # a window's reads as counted around `_optimize` exclude its prior build's
    report_solves(label, backend, probe.reads, card)
    for start, ms, reads in probe.priors:
        print(f"{label}: boundary prior for the window at {start}: {ms:.2f} ms (host clock, synchronised), "
              f"host reads {reads} on {card}", flush=True)
    _require(len(probe.priors) == (4 if world_pose else 0), f"{label}: {len(probe.priors)} prior builds")
    _require(bool(torch.isfinite(backend._prior_L).all()) if world_pose else True, f"{label}: prior not finite")
    fe_ate = evals["frontend"]["camera"]["ate_trans_rmse"]
    _require(prefix in evals, f"{label}: no {prefix} logs, modules {sorted(evals)}")
    be_ate = evals[prefix]["camera"]["ate_trans_rmse"]
    print(f"{label}: camera ATE frontend {fe_ate:.5f} m (limit {ATE_LIMIT_M}), backend ({prefix}) {be_ate:.5f} m "
          f"(limit {BACKEND_ATE_LIMIT_M}), backend frames {evals[prefix]['camera']['n_frames']}", flush=True)
    _require(np.isfinite(fe_ate) and fe_ate < ATE_LIMIT_M, f"{label}: frontend ATE {fe_ate} m")
    _require(np.isfinite(be_ate) and be_ate < BACKEND_ATE_LIMIT_M, f"{label}: backend ATE {be_ate} m")
    return dict(totals=probe.totals)


def run_drift_recovery(torch, device, card, packets, ground_truth) -> None:
    """Drift recovery on the golden packets for both updaters
    (`tests/test_accuracy_regression.py:166-228`): a growing camera drift
    on every packet, odometry sigmas loosened 10x, the full-batch backend
    with 100 LM iterations allowed; fails unless each recovered ATE is
    below the corrupted ATE / DRIFT_FACTOR and DRIFT_ATE_M."""
    import dataclasses

    from dynosam_tpu_torch.core.lie import se3_compose, se3_exp
    from dynosam_tpu_torch.eval import metrics
    from dynosam_tpu_torch.pipeline import run_from_packets
    from dynosam_tpu_torch.testing.scenes import golden_config

    label = "drift recovery"
    drift = torch.tensor(DRIFT_PER_FRAME, device=device)
    corrupted = [p._replace(X_world=se3_compose(se3_exp(drift * float(k)), p.X_world)) for k, p in enumerate(packets)]

    def ate(R, t, valid):
        T = np.tile(np.eye(4), (int(valid.sum()), 1, 1))
        T[:, :3, :3] = R.double().cpu().numpy()[valid]
        T[:, :3, 3] = t.double().cpu().numpy()[valid]
        return metrics.ate(T, ground_truth[valid])["trans"].rmse

    every = np.ones(len(packets), bool)
    corrupted_ate = ate(torch.stack([p.X_world.R for p in corrupted]), torch.stack([p.X_world.t for p in corrupted]),
                        every)
    print(f"{label}: corrupted camera ATE {corrupted_ate:.5f} m", flush=True)
    _require(corrupted_ate > 0.08, f"{label}: the drift is not material ({corrupted_ate} m)")
    for updater in (0, 1):
        cfg = golden_config(True)
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, backend_updater_enum=updater, lm_max_iterations=100, odometry_translation_sigma=1.0,
            odometry_rotation_sigma=0.5))
        torch.cuda.synchronize()
        with SyncCounter(torch) as sc:
            be = run_from_packets(corrupted, cfg, device=device)
        torch.cuda.synchronize()
        (start, window, r, events), = be.solves
        X, xv = be.camera_poses()
        rec = ate(X.R, X.t, xv.cpu().numpy())
        cg = sum(r.cg_iterations)
        ms = events[0].elapsed_time(events[1])
        print(f"{label}: updater {updater}: full-batch solve [{start}, {start + window}) {ms:.2f} ms (CUDA events), "
              f"{r.iterations} LM iterations, {cg} CG iterations, host reads {sc.count}, error {float(r.initial_error):.6g} -> {float(r.error):.6g}; recovered ATE {rec:.5f} m (limits "
              f"{corrupted_ate / DRIFT_FACTOR:.5f} and {DRIFT_ATE_M}) on {card}", flush=True)
        _require(np.isfinite(rec) and rec < corrupted_ate / DRIFT_FACTOR and rec < DRIFT_ATE_M,
                 f"{label}: updater {updater} recovered ATE {rec} m against corrupted {corrupted_ate} m")


def run_batched_phase(torch, device, card) -> dict:
    """The offline pipeline with two windows per dispatch over the first
    BATCHED_FRAMES frames of the pipeline path's scene, against a
    sequential runner replaying the same packets."""
    import dataclasses

    from dynosam_tpu_torch import kernels
    from dynosam_tpu_torch.testing.scenes import kitti_pipeline_config, kitti_scene
    from dynosam_tpu_torch.throughput import make_offline_runner

    label = "batched"
    n = BATCHED_FRAMES
    scene, frames = kitti_scene(device, n_frames=PIPELINE_FRAMES)
    frames = frames[:n]
    base = kitti_pipeline_config(n)
    cfg = dataclasses.replace(base, backend=dataclasses.replace(base.backend, opt_windows_per_dispatch=2))
    runner = make_offline_runner(scene.cam, cfg, n, device=device)
    _require(runner.wpd == 2, f"{label}: {runner.wpd} windows per dispatch")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    per_frame, dispatches = [], []
    for f in frames:
        runner.frontend(f)
        due = runner.windows_due()
        if due:
            with SyncCounter(torch) as sc:
                wins = runner.solve_group(due) if len(due) > 1 else [runner.solve(due[0])]
            dispatches.append((wins, sc.count))
        torch.cuda.synchronize()
        now = kernels.launch_counts()
        per_frame.append({k: now[k] - prev[k] for k in now})
        prev = now
    totals = kernels.launch_counts()
    for k in range(1, n):
        missing = [name for name in PATH_KERNELS["batched"] if per_frame[k][name] < 1]
        _require(not missing, f"{label}, frame {k}: kernels {missing} never launched")

    seq = make_offline_runner(scene.cam, base, n, device=device)
    seq_reads = []
    for p in runner.packets:
        seq.add_packet(p)
        for s in seq.windows_due():
            with SyncCounter(torch) as sc:
                seq.solve(s)
            seq_reads.append(sc.count)
    torch.cuda.synchronize()
    _require([[w.start for w in wins] for wins, _ in dispatches] == [[0, 6]],
             f"{label}: dispatches {[[w.start for w in wins] for wins, _ in dispatches]}")
    for wins, reads in dispatches:
        ms = wins[0].solve_ms()
        its = [w.result.iterations for w in wins]
        print(f"{label}: dispatch of windows {[w.start for w in wins]}: {ms:.2f} ms (CUDA events), LM iterations "
              f"{its}, host reads {reads} ({reads / len(wins):.1f} per window); sequential replay of the same "
              f"windows: {[round(w.solve_ms(), 2) for w in seq.windows]} ms, host reads {seq_reads} "
              f"({sum(seq_reads) / len(seq_reads):.1f} per window) on {card}", flush=True)
        for w in wins:
            r = w.result
            _require(np.isfinite(float(r.error)) and float(r.error) < float(r.initial_error),
                     f"{label}: window {w.start} error {float(r.initial_error)} -> {float(r.error)}")
    a, b = runner.est, seq.est
    for f in ("X_valid", "motion_valid", "static_valid", "dyn_valid"):
        _require(bool(torch.equal(getattr(a, f), getattr(b, f))), f"{label}: {f} differs from the sequential run's")
    _require(bool(a.X_valid[:n].all()), f"{label}: the store misses frames")
    diff = float((a.X.t[:n] - b.X.t[:n]).abs().max())
    later = [w.start for wins, _ in dispatches for w in wins[1:]]
    shift = max(float((runner.map.X_init.t[s] - b.X.t[s]).abs().max()) for s in later)
    limit = 2 * shift + BATCHED_TOL_M
    print(f"{label}: camera translations against the sequential run: max |difference| {diff:.3g} m "
          f"(limit {limit:.3g}: anchor shift {shift:.3g} m at frames {later})", flush=True)
    _require(np.isfinite(diff) and diff <= limit, f"{label}: {diff} m from the sequential run")
    return dict(totals=totals)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "dynosam_tpu_torch" / "csrc").is_dir():
        print("FAIL: run chip_smoke.py from the root of a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        return _run(torch)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1


def _run(torch) -> int:
    from dynosam_tpu_torch.kernels import build
    from dynosam_tpu_torch.testing.scenes import kitti_config, kitti_orb_config, kitti_scene

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)     # as nvidia-smi gives it, on a line of its own
    print(f"card: {card} | torch.cuda.get_device_name: {name} | "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    scene, frames = kitti_scene(device)
    torch.cuda.synchronize()
    print(f"render: 12 frames 1280x384 in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = [
        check_lk(torch, frames, device, reps=200),
        check_point_sample(torch, frames, device, reps=500),
        check_response(torch, frames, device, reps=500),
        check_orb_sample(torch, frames, device, reps=200),
    ]
    for r in rows:
        lib_us = "none" if r["library_ms"] is None else "%.1f us" % (r["library_ms"] * 1e3)
        print(f"{r['name']}: {r['ms'] * 1e3:.1f} us per call (plain {r['plain_ms'] * 1e3:.1f} us, "
              f"library {lib_us}, bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; "
              f"{r.get('note', '')}) on {card}", flush=True)

    paths = {}
    for path, label, cfg in (("shi_tomasi", "main path", kitti_config()), ("orb", "ORB path", kitti_orb_config())):
        paths[path] = res = run_main_path(torch, scene, frames, cfg, device)
        report_path(res, label, PATH_KERNELS[path], frames, card)

    paths["pipeline"] = run_pipeline_path(torch, device, card)
    paths["golden"] = run_golden_phase(torch, device, card)
    paths["online"] = run_online_phase(torch, device, card)
    paths["world_pose"] = run_online_phase(torch, device, card, world_pose=True)
    paths["batched"] = run_batched_phase(torch, device, card)

    for r in rows:
        by_path = {p: paths[p]["totals"][COUNTER[r["name"]]] for p in paths}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "launches_by_path", "ms_flow", "ms_depth_mask")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
