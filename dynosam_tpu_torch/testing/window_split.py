"""One graphed window solve's device time split by kernel, on the card.

    python3 dynosam_tpu_torch/testing/window_split.py [--root TREE] [--label NAME] [--out FILE]

Run by path from a checkout on a machine with a CUDA card and `nvcc`.
`--root` is the tree whose package is measured (default: the checkout
holding this file), so one copy of the script times an older tree
unpacked beside it (`git archive <commit> | tar -x -C build/parent`).

Two windows: the first window solve of the online pipeline
(`testing/scenes.py:kitti_online_config`, the benchmark's online cell)
over `kitti_scene` (12 KITTI-width frames; no active motion factor, F1),
and the window-10 simulator scenario (`testing/window_check.py:
simulator_window`, active motion factors).  Each window is solved graphed
(`schur.lm_optimize_schur`; the first solve captures), then solved again
under `torch.profiler`, whose CUDA activity gives per kernel its launches
and device time.  Printed per window, per kernel and per group -- K7
(`window_build`), K8 (`window_step`), the factorisation (the kernels one
eager `cholesky_ex` + `cholesky_solve` of the reduced system's size
launches, and cuSOLVER's routines by name), K9 (`window_update`), the rest
(the solve's copies)
-- the launches, the device time per launch and per LM iteration, and
K8's and K9's kernels an LM iteration; written as JSON with `--out`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

GROUPS = ("K7", "K8", "factorisation", "K9", "other")
PREFIX = {"K7": "window_build", "K8": "window_step", "K9": "window_update"}


def factorisation_kernels(torch, n: int, device) -> list:
    """The device kernels of one eager `cholesky_ex` + `cholesky_solve` of
    an (n, n) SPD system, as the profiler names them (copies and fills
    left out)."""
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=device)
    spd = a @ a.T + n * torch.eye(n, device=device)
    b = torch.randn((n, 1), generator=g, device=device)
    torch.linalg.cholesky_ex(spd)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        L, _ = torch.linalg.cholesky_ex(spd)
        torch.cholesky_solve(b, L)
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Activity Buffer", "Memcpy", "Memset"))})


def kitti_window(device, n_frames: int = 12) -> tuple:
    """(args, kw) of the first window solve the online pipeline
    (`kitti_online_config`) makes over `kitti_scene(device, n_frames)`."""
    from dynosam_tpu_torch.backend import backend as tbe
    from dynosam_tpu_torch.pipeline import DynoPipeline
    from dynosam_tpu_torch.testing.scenes import kitti_online_config, kitti_scene

    scene, frames = kitti_scene(device, n_frames=n_frames)
    real, calls = tbe.lm_optimize_schur, []

    def recorded(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    tbe.lm_optimize_schur = recorded
    try:
        DynoPipeline(scene.cam, kitti_online_config(), device=device).run(frames)
    finally:
        tbe.lm_optimize_schur = real
    return calls[0]


# cuSOLVER's routines by name, beside the kernels an eager factorisation
# launches (a profile in a long-lived process may miss some of those)
FACTOR_NAMES = ("getrf", "potrf", "trsv", "trsm", "xxtrf")


def group_of(name: str, factor: set) -> str:
    for g, p in PREFIX.items():
        if p in name:
            return g
    return "factorisation" if name in factor or any(f in name for f in FACTOR_NAMES) else "other"


def solve_split(torch, args: tuple, kw: dict) -> dict:
    """The window of `lm_optimize_schur(*args, **kw)` solved graphed once
    (capturing it), then again under the profiler: per kernel name its
    launches and device microseconds, per group the same, the LM
    iterations and the solve's host wall."""
    from dynosam_tpu_torch.backend import schur

    schur.lm_optimize_schur(*args, **kw)
    torch.cuda.synchronize()
    values = args[0]
    W, O = values["H"].t.shape[:2]
    factor = set(factorisation_kernels(torch, 6 * W * (1 + O), values["X"].t.device))
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        got = schur.lm_optimize_schur(*args, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("Activity Buffer"):
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    groups = {g: [0, 0.0] for g in GROUPS}
    for name, (n, us) in kernels.items():
        g = groups[group_of(name, factor)]
        g[0] += n
        g[1] += us
    return dict(iterations=got.iterations, wall_ms=wall, error=(float(got.initial_error), float(got.error)),
                kernels={k: {"launches": n, "us": us, "group": group_of(k, factor)} for k, (n, us) in kernels.items()},
                groups={g: {"launches": n, "us": us} for g, (n, us) in groups.items()},
                shape=dict(W=W, NS=values["sp"].shape[0], ND=values["dp"].shape[1], O=O))


def report(label: str, s: dict, out=print) -> None:
    """Print `solve_split`'s result: per group and per kernel, the launches
    and device time per launch and per LM iteration."""
    it = max(s["iterations"], 1)
    sh = s["shape"]
    dev = sum(g["us"] for g in s["groups"].values())
    out(f"{label}: W {sh['W']}, NS {sh['NS']}, ND {sh['ND']}, O {sh['O']}: {s['iterations']} LM iterations, "
        f"error {s['error'][0]:.6g} -> {s['error'][1]:.6g}; host wall {s['wall_ms']:.2f} ms (profiled), device "
        f"{dev / 1e3:.4f} ms, {dev / it:.1f} us an LM iteration")
    k89 = s["groups"]["K8"]["launches"] + s["groups"]["K9"]["launches"]
    out(f"{label}: K8 and K9 kernels {k89} over {s['iterations']} iterations and the head: "
        f"{s['groups']['K8']['launches'] / it:.2f} + {s['groups']['K9']['launches'] / it:.2f} an iteration")
    for g in GROUPS:
        n, us = s["groups"][g]["launches"], s["groups"][g]["us"]
        out(f"  {g:14s} {n:5d} kernels, {us / 1e3:.4f} ms, {us / it:.2f} us an LM iteration")
        rows = sorted(((k, v) for k, v in s["kernels"].items() if v["group"] == g), key=lambda kv: -kv[1]["us"])
        for k, v in rows[:12]:
            out(f"    {v['launches']:5d} x {v['us'] / v['launches']:8.2f} us = {v['us'] / it:8.2f} us an iteration  "
                f"{k[:110]}")


def main() -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(here), help="tree whose package is measured")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    from dynosam_tpu_torch.testing import window_check as wc

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    print(f"{args.label} ({root}) on {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    results = {"label": args.label, "card": card}
    for label, make in (("kitti window", lambda: kitti_window(dev)),
                        ("simulator window", lambda: (wc.simulator_window(dev), {}))):
        win_args, kw = make()
        s = solve_split(torch, win_args, kw)
        report(f"{args.label}: {label}", s, out=lambda line: print(line, flush=True))
        results[label] = s
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({"label": args.label, "card": card,
                      **{k: {g: v["groups"][g] for g in GROUPS} | {"iterations": v["iterations"]}
                         for k, v in results.items() if isinstance(v, dict)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
