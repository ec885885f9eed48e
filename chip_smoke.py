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
             response) at the frontend's main-path shapes on KITTI-sized
             rendered frames, held against its plain PyTorch version on the
             card within a stated tolerance, then timed with CUDA events
             beside its plain version, the library yardstick where one
             exists, and its bound;
4. main path -- the frontend-only pipeline (`DynoPipeline`, use_backend
             False) on 12 rendered 1280x384 frames with 3 moving objects:
             frames/s over the steady frames, kernel launches per frame
             (fails unless every kernel launched on every steady frame),
             camera ATE against the renderer's ground truth (fails unless
             finite and <= 0.05 m) and the objects with a valid motion.

The first line is the card's name and power limit as `nvidia-smi` gives
them; the line before the last is a JSON object with one entry per kernel,
the last line `{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
ATE_LIMIT_M = 0.05

# FLOPs counted per unit of work (adds, subtracts, multiplies, divides,
# square roots; clamps and index arithmetic not counted).
FLOP_BILINEAR = 13     # 2 weight complements, 8 products, 3 sums
FLOP_LK_GRAD = 10      # 2 differences, 2 halvings, 3 products, 3 sums
FLOP_LK_STEP = 18      # bilinear sample, residual, 2 multiply-adds
FLOP_LK_SOLVE = 12     # 2x2 solve and clamp of one step
FLOP_LK_ERR = 15       # bilinear sample, residual, abs-add
FLOP_RESPONSE = 100    # Sobel 2x11, 3 products, 3x24 box sums, 3 divides, lambda_min 9


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
    (the 2x2 taps of each sample, as `csrc/common.cuh:bilinear_clamped`);
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
    g_k, e_k = lk.lk_level(f0.gray, f1.gray, p, g0, valid, win, iters, eps)
    g_p, e_p, steps = lk.lk_level_plain(f0.gray, f1.gray, p, g0, valid, win, iters, eps,
                                        return_iters=True)
    torch.cuda.synchronize()
    dg = float((g_k - g_p).abs().max())
    de = float((e_k - e_p).abs().max())
    rel = dg / max(float(g_p[valid].abs().max()), 1e-9)
    print(f"K1 lk_level: {int(valid.sum())} of {n} slots active, win {win}, "
          f"{iters} iters, eps {eps}: max |dg| {dg:.3g} px (rel {rel:.3g}, tol "
          f"{LK_TOL_PX}), max |derr| {de:.3g} (tol {LK_TOL_ERR})", flush=True)
    _require(np.isfinite(dg) and dg <= LK_TOL_PX, f"K1 disagrees with its plain version: {dg}")
    _require(np.isfinite(de) and de <= LK_TOL_ERR, f"K1 error disagrees: {de}")

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
                note=f"{total_steps} Gauss-Newton steps over {n_act} active slots; "
                     f"{prev_px} prev and {cur_px} cur pixels read")


def check_point_sample(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import point_sample as ps

    f = frames[1]
    h, w = f.gray.shape
    n = 6144
    rng = np.random.default_rng(2)
    uv = torch.as_tensor(rng.uniform([-2, -2], [w + 1, h + 1], (n, 2)).astype(np.float32), device=device)
    valid = torch.as_tensor(rng.random(n) >= 0.3, device=device)
    depth = f.depth[None].contiguous()
    pair = torch.stack([f.depth, f.mask.float()]).contiguous()
    worst = 0.0
    for name, stack, modes in (
        ("C=1 bilinear", depth, ("bilinear",)),
        ("C=1 nearest", f.mask.float()[None].contiguous(), ("nearest",)),
        ("C=2 bilinear+nearest", pair, ("bilinear", "nearest")),
    ):
        got = ps.point_sample(stack, uv, modes, valid)
        want = ps.point_sample_plain(stack, uv, modes, valid)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-9)
        exact = [c for c, m in enumerate(modes) if m == "nearest"]
        d_exact = float((got[:, exact] - want[:, exact]).abs().max()) if exact else 0.0
        print(f"K2 point_sample {name}: N {n}, {int((~valid).sum())} invalid rows: "
              f"max |d| {d:.3g} (rel {d / scale:.3g}, tol {PS_TOL_REL}), nearest "
              f"max |d| {d_exact:.3g} (tol 0)", flush=True)
        _require(np.isfinite(d) and d / scale <= PS_TOL_REL, f"K2 {name} disagrees: {d}")
        _require(d_exact == 0.0, f"K2 {name} nearest samples differ: {d_exact}")
        _require(bool((got[~valid] == 0).all()), f"K2 {name}: invalid rows not zero")
        worst = max(worst, d)

    ms = cuda_ms(torch, lambda: ps.point_sample(depth, uv, ("bilinear",), valid), reps)
    plain_ms = cuda_ms(torch, lambda: ps.point_sample_plain(depth, uv, ("bilinear",), valid), reps)
    # library yardstick: grid_sample on normalised coordinates (align_corners
    # maps -1/+1 to the first/last pixel centre; border padding clamps)
    grid = torch.stack([uv[:, 0] / (w - 1) * 2 - 1, uv[:, 1] / (h - 1) * 2 - 1], dim=-1)[None, None]
    lib = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        depth[None], grid, mode="bilinear", padding_mode="border", align_corners=True)
    lib_d = float((lib()[0, 0, 0] * valid - ps.point_sample_plain(depth, uv, ("bilinear",), valid)[:, 0]).abs().max())
    library_ms = cuda_ms(torch, lib, reps)
    # bytes this call's data needs: the distinct pixels its valid rows touch,
    # the valid rows' coordinates (an invalid row reads only its mask), the
    # mask and the output
    n_valid = int(valid.sum())
    taps = distinct_taps(torch, uv[valid, 0], uv[valid, 1], h, w)
    nbytes = taps * 4 + n_valid * 8 + n + n * 4
    flop = n_valid * FLOP_BILINEAR
    b_ms, b_by = bound_ms(nbytes, flop)
    print(f"K2 grid_sample yardstick agrees to {lib_d:.3g}", flush=True)
    return dict(name="point_sample", route="cuda", source="dynosam_tpu_torch/csrc/point_sample.cu",
                replaces="dynosam_tpu/ops/pallas/point_sample.py:136", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                note=f"timed at N 6144, C 1, bilinear; {taps} pixels read")


def check_response(torch, frames, device, reps):
    from dynosam_tpu_torch.kernels import response

    g = frames[1].gray
    h, w = g.shape
    got = response.shi_tomasi_response(g)
    want = response.shi_tomasi_response_plain(g)
    torch.cuda.synchronize()
    d = float((got - want).abs().max())
    rel = d / max(float(want.abs().max()), 1e-9)
    print(f"K3 shi_tomasi_response {h}x{w}: max |d| {d:.3g} (rel to max |response| "
          f"{rel:.3g}, tol {RESP_TOL_REL})", flush=True)
    _require(np.isfinite(rel) and rel <= RESP_TOL_REL, f"K3 disagrees with its plain version: {rel}")
    ms = cuda_ms(torch, lambda: response.shi_tomasi_response(g), reps)
    plain_ms = cuda_ms(torch, lambda: response.shi_tomasi_response_plain(g), max(reps // 10, 3))
    b_ms, b_by = bound_ms(2 * h * w * 4, h * w * FLOP_RESPONSE)
    return dict(name="shi_tomasi_response", route="cuda", source="dynosam_tpu_torch/csrc/response.cu",
                replaces="dynosam_tpu/ops/pallas/response.py:83", max_abs_err=d,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)


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
    from dynosam_tpu_torch.testing.scenes import kitti_config, kitti_scene

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
    ]
    for r in rows:
        lib_us = "none" if r["library_ms"] is None else "%.1f us" % (r["library_ms"] * 1e3)
        print(f"{r['name']}: {r['ms'] * 1e3:.1f} us per call (plain {r['plain_ms'] * 1e3:.1f} us, "
              f"library {lib_us}, bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; "
              f"{r.get('note', '')}) on {card}", flush=True)

    cfg = kitti_config()
    res = run_main_path(torch, scene, frames, cfg, device)
    steady = list(range(2, len(frames)))
    dt = sum(res["times"][k] for k in steady)
    print(f"main path: frontend-only pipeline, {len(frames)} frames 1280x384; steady frames "
          f"{steady[0]}..{steady[-1]}: {len(steady) / dt:.2f} frames/s, "
          f"{dt / len(steady) * 1e3:.1f} ms/frame (host clock, synchronised) on {card}", flush=True)
    print(f"main path: ms per frame {[round(t * 1e3, 1) for t in res['times']]}", flush=True)
    for k, lf in enumerate(res["per_frame"]):
        print(f"main path: frame {k} launches {lf} static obs {res['n_static'][k]} "
              f"objects with motion {res['n_motion'][k]}", flush=True)
    for k in range(1, len(frames)):
        missing = [n for n, c in res["per_frame"][k].items() if c < 1]
        _require(not missing, f"frame {k}: kernels {missing} never launched")
    print(f"main path: camera ATE {res['ate']:.5f} m (limit {ATE_LIMIT_M})", flush=True)
    _require(res["finite"], "camera poses are not finite")
    _require(np.isfinite(res["ate"]) and res["ate"] <= ATE_LIMIT_M, f"ATE {res['ate']} m")

    for r in rows:
        r["launches"] = res["totals"][{"lk_level": "lk", "point_sample": "point_sample",
                                       "shi_tomasi_response": "response"}[r["name"]]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
