"""Sliding-window vs full-batch backend error (port of the JAX package's
`scripts/sliding_vs_batch.py`, the analog of the reference's
`dynosam_utils/src/sliding_window_vs_batch_error_plot.py`): run the SAME
measurement stream through `RGBDBackend` twice, sliding windows (10/4 by
default) and full batch, and report the per-frame camera translation
error against ground truth for both, as summary lines on stdout and a
plot.

By default the synthetic simulator scenario (`testing/simulator.py`) is
the stream; `--packets FILE` replays saved frontend packets instead
(`utils/serialization.py` format; the error curves are then omitted, as
there is no ground truth).

    python -m dynosam_tpu_torch.scripts.sliding_vs_batch [--frames 24] [--window 10] [--overlap 4] \\
        [--packets FILE] [--out sliding_vs_batch.pdf] [--device cpu]

Runs on the CUDA card unless given `--device cpu`; the plot is written
where matplotlib is installed.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

import numpy as np


def run_backend(packets, cfg, cap, device=None):
    """`RGBDBackend(cfg, cap)` fed every packet, then finished."""
    from ..backend.backend import RGBDBackend

    be = RGBDBackend(cfg, cap, device=device)
    for p in packets:
        be.spin(p)
    be.finish()
    return be


def simulator_stream(frames: int):
    """(packets, ground-truth camera poses (SE3 over frames), capacities)
    of the simulator scenario with `frames` frames."""
    from ..testing.simulator import Scenario, ScenarioConfig
    from ..utils.config import CapacityConfig

    scfg = ScenarioConfig(n_frames=frames)
    sc = Scenario(scfg)
    cap = CapacityConfig(max_static_tracks=scfg.ns, max_dynamic_tracks=scfg.nd, max_objects=scfg.no,
                         max_frames=scfg.n_frames)
    return sc.frontend_outputs(), sc.X_gt, cap


def compare(packets, cap, X_gt=None, window: int = 10, overlap: int = 4, device=None) -> dict:
    """{"sliding-window": run, "full-batch": run}, each run a dict with the
    backend's final and initial error of its last solve and, given the
    ground-truth poses `X_gt`, `curve`: per-frame |t| of Log(X_gt^-1 X)
    (NaN where the frame has no estimate)."""
    import torch

    from ..core.lie import SE3, se3_local
    from ..utils.config import BackendConfig
    from ..utils.device import resolve_device

    device = resolve_device(device)
    runs = {}
    for name, cfg in (("sliding-window", BackendConfig(use_full_batch_opt=False, opt_window_size=window,
                                                       opt_window_overlap=overlap)),
                      ("full-batch", BackendConfig(use_full_batch_opt=True))):
        be = run_backend(packets, cfg, cap, device)
        r = be.last_result
        run = {"error": float(r.error), "initial_error": float(r.initial_error)}
        if X_gt is not None:
            X, xv = be.camera_poses()
            n = len(packets)
            e = se3_local(SE3(X_gt.R[:n].to(device), X_gt.t[:n].to(device)), SE3(X.R[:n], X.t[:n]))
            curve = torch.linalg.norm(e[:, 3:], dim=-1).double().cpu().numpy()
            run["curve"] = np.where(xv[:n].cpu().numpy(), curve, np.nan)
        runs[name] = run
    return runs


def summary_lines(runs: dict) -> list:
    """The JAX script's stdout lines: each run's final error, then, with
    curves, the mean and maximum of each."""
    lines = [f"{name}: final error {r['error']:.4f} (initial {r['initial_error']:.1f})" for name, r in runs.items()]
    for name, r in runs.items():
        if "curve" in r:
            v = r["curve"][~np.isnan(r["curve"])]
            lines.append(f"{name}: ATE trans mean {v.mean():.4f} m, max {v.max():.4f} m")
    return lines


def plot(runs: dict, path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    for name, r in runs.items():
        ax.plot(r["curve"], label=name)
    ax.set_xlabel("frame")
    ax.set_ylabel("camera translation error (m)")
    ax.set_title("sliding-window vs full-batch backend error")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dynosam_tpu_torch.scripts.sliding_vs_batch")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--overlap", type=int, default=4)
    ap.add_argument("--out", default="sliding_vs_batch.pdf")
    ap.add_argument("--packets", default=None, help="replay saved frontend packets instead")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; raises without a card)")
    args = ap.parse_args(argv)

    from ..utils.config import CapacityConfig
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.packets:
        from ..utils.serialization import load_packets

        packets, X_gt = load_packets(args.packets, device=device), None
        cap = CapacityConfig(max_frames=len(packets))
    else:
        packets, X_gt, cap = simulator_stream(args.frames)
    runs = compare(packets, cap, X_gt, args.window, args.overlap, device)
    for line in summary_lines(runs):
        print(line)
    if X_gt is not None and importlib.util.find_spec("matplotlib"):
        plot(runs, args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
